"""Parity of the port's distributed sparse-direct tier with the JAX package
on the CPU, float64 unless named: ``dist_front.dist_partial_ldl`` (the
cases of ``tests/sparse_direct/test_dist_front.py``) on
``Grid([cpu] * 8, height=2)`` against the JAX function on the conftest's
8-device mesh and against the JAX package's one-device column loop, within
1e-10·max|ref|; ``DistSparseLDLFactorization`` with the distributed front
tier and with the batch split against the JAX factor's pool and pivots;
a complex Hermitian factor on a grid; the transfer log's bytes; and
``factor(grid=None)`` bit for bit the level loop of one device."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from elemental_tpu.matrices import sparse_laplacian_3d as jax_laplacian_3d
from elemental_tpu.sparse import DistSparseMatrix as JaxDistSparseMatrix
from elemental_tpu.sparse_direct import (
    DistSparseLDLFactorization as JaxDistLDL)
from elemental_tpu.sparse_direct.dist_front import (
    dist_partial_ldl as jax_dist_partial_ldl)
from elemental_tpu.sparse_direct.numeric import (
    _masked_partial_ldl as jax_masked_partial_ldl)

from elemental_tpu_torch.core import Grid
from elemental_tpu_torch.kernels.extend_add import extend_add
from elemental_tpu_torch.matrices import (sparse_laplacian_2d,
                                          sparse_laplacian_3d)
from elemental_tpu_torch.sparse import DistSparseMatrix
from elemental_tpu_torch.sparse_direct import (DistSparseLDLFactorization,
                                               SparseLDLFactorization,
                                               nested_dissection, numeric)
from elemental_tpu_torch.sparse_direct.dist_front import (
    dist_partial_ldl, dist_partial_spd, padded_size)
from elemental_tpu_torch.utils.transfers import count_transfers

torch.set_num_threads(2)
F64 = torch.float64
CPU = torch.device("cpu")
RNG = np.random.default_rng(3)


def _mesh8():
    devs = np.array(jax.devices("cpu")[:8]).reshape(2, 4)
    return Mesh(devs, ("mc", "mr"))


def _grid8():
    return Grid(devices=[CPU] * 8, height=2)


def _spd_front(S):
    a = RNG.standard_normal((S, S))
    return np.tril(a @ a.T + S * np.eye(S))


def _jax_front(F, ns, pf=None):
    mesh = _mesh8()
    pfj = None if pf is None else jnp.asarray(pf)
    return np.asarray(jax.jit(lambda F: jax_dist_partial_ldl(
        F, ns, mesh, nb=64, pf=pfj))(jnp.asarray(F)))


def _one_front(F, ns, pf=None):
    """The JAX package's one-device column loop on the front."""
    pfj = None if pf is None else jnp.asarray(pf)
    return np.asarray(jax.jit(lambda F: jax_masked_partial_ldl(
        F, jnp.asarray(ns), ns, False, pf=pfj))(jnp.asarray(F)))


@pytest.mark.parametrize("S,ns", [(384, 250), (256, 256), (192, 64)])
def test_dist_front_matches_single(S, ns):
    F = _spd_front(S)
    ref = _jax_front(F, ns)
    out = dist_partial_ldl(torch.tensor(F), ns, _grid8(), nb=64).numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() < 1e-10 * scale
    assert np.abs(out - _one_front(F, ns)).max() < 1e-10 * scale


@pytest.mark.parametrize("floor", ["tiny", "signed"])
def test_dist_front_pivot_floor(floor):
    """The JAX test's floors (1e-8, never reached), and signed floors
    above about half the pivots' magnitudes, so clamps happen."""
    S, ns = 256, 200
    F = _spd_front(S)
    if floor == "tiny":
        pf = np.full(S, 1e-8)
    else:
        pf = np.where(np.arange(S) % 3 == 0, -1.0, 1.0) * 1.5 * S
    ref = _jax_front(F, ns, pf)
    out = dist_partial_ldl(torch.tensor(F), ns, _grid8(), nb=64,
                           pf=torch.tensor(pf)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() < 1e-10 * scale
    assert np.abs(out - _one_front(F, ns, pf)).max() < 1e-10 * scale
    if floor == "signed":
        d = np.diagonal(out)[:ns]
        assert np.all(np.abs(d) >= 1.5 * S * (1 - 1e-12))


def test_dist_partial_spd_is_the_ldl_elimination():
    """``dist_partial_spd`` on a 2×2 grid equals ``dist_partial_ldl`` on
    the 8-position grid: the cut of the rows changes nothing beyond
    rounding."""
    S, ns = 200, 150
    F = _spd_front(S)
    a = dist_partial_spd(torch.tensor(F), ns, Grid([CPU] * 4), nb=32)
    b = dist_partial_ldl(torch.tensor(F), ns, _grid8(), nb=32)
    assert float((a - b).abs().max()) < 1e-10 * float(b.abs().max())


def _panel_bytes(S, ns, nb, P, itemsize=8):
    """Each panel gather brings every position the other positions' rows
    of the panel: (P − 1)·rows_loc·nb elements a position, a panel, over
    the ⌈ns/nb⌉ panels that hold a pivot."""
    rl = padded_size(S, nb, P) // P
    return math.ceil(ns / nb) * P * (P - 1) * rl * nb * itemsize


@pytest.mark.parametrize("S,ns,nb", [(384, 250, 64), (200, 200, 32),
                                     (96, 0, 32)])
def test_dist_front_transfer_bytes(S, ns, nb):
    F = torch.tensor(_spd_front(S))
    with count_transfers() as log:
        dist_partial_ldl(F.clone(), ns, _grid8(), nb=nb)
    assert log.bytes() == log.bytes("all-gather") == _panel_bytes(S, ns, nb,
                                                                  8)
    assert len(log) == 8 * math.ceil(ns / nb)
    with count_transfers() as log:
        out = dist_partial_ldl(F.clone(), ns, Grid([CPU]), nb=nb)
    assert len(log) == 0
    assert float((out - torch.tensor(_one_front(F.numpy(), ns))).abs()
                 .max()) < 1e-10 * float(out.abs().max())


def _lower_pool(f):
    """Each front's lower triangle (the entries the factor defines and the
    solves read), flattened level by level."""
    out = []
    for lev in f.symb.levels:
        fronts = f.numeric._level_fronts(lev)
        out.append(torch.tril(fronts).reshape(-1))
    return torch.cat(out)


@pytest.fixture(scope="module")
def lap10():
    A = sparse_laplacian_3d(10, 10, 10, scaled=False)
    return A, nested_dissection(A, cutoff=32)


def test_facade_dist_front_end_to_end(lap10, monkeypatch):
    """The 10³ Laplacian, dist-front tier from order 96 on both sides (the
    JAX package through its environment variable): pool and pivots within
    1e-10 of the JAX factor's, the tier's panel gathers and front
    replications in the transfer log, the residual under the bound."""
    A, perm = lap10
    monkeypatch.setenv("ELEMENTAL_DIST_FRONT_MIN", "96")
    jf = JaxDistLDL(spd=True)
    jf.initialize(JaxDistSparseMatrix.from_sparse(
        jax_laplacian_3d(10, 10, 10, scaled=False),
        _jax_grid8()), perm=perm)
    jf.factor()
    grid = _grid8()
    f = DistSparseLDLFactorization(dtype=F64, spd=True, dist_front_min=96)
    f.initialize(DistSparseMatrix.from_sparse(A, grid), perm=perm)
    assert f.grid is grid and f.tree_axis == ("mc", "mr")
    assert f.device == CPU
    with count_transfers() as log:
        f.factor()
    jp, jd = np.asarray(jf.numeric.pool), np.asarray(jf.numeric.d)
    scale = np.abs(jp).max()
    assert np.abs(f.numeric.pool.numpy() - jp).max() < 1e-10 * scale
    assert np.abs(f.numeric.d.numpy() - jd).max() < 1e-10 * scale
    # the tier: levels of at most 8 fronts of order ≥ 96
    tier = [lev for lev in f.symb.levels
            if lev.front_size >= 96 and lev.sn_ids.shape[0] <= 8]
    assert tier
    panels = sum(_panel_bytes(lev.front_size, int(ns), 128, 8)
                 for lev in tier for ns in lev.ns)
    assert log.bytes("all-gather") == panels + sum(
        7 * lev.front_size ** 2 * 8 * lev.sn_ids.shape[0] for lev in tier)
    assert log.bytes() == log.bytes("all-gather")
    b = RNG.standard_normal(A.height)
    x = f.solve(b).numpy()
    r = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
    assert r < f.residual_bound()
    # against the one-device SPD factor: the lower triangles agree (the
    # upper ones are never read, and the LDL elimination leaves other
    # values there than the Cholesky kernel)
    f1 = SparseLDLFactorization(device=CPU, dtype=F64, spd=True)
    f1.initialize(A, perm=perm).factor()
    lo1 = _lower_pool(f1)
    assert float((_lower_pool(f) - lo1).abs().max()) \
        < 1e-10 * float(lo1.abs().max())


def _jax_grid8():
    import elemental_tpu as el
    return el.Grid(devices=jax.devices("cpu"), height=2)


@pytest.fixture(scope="module")
def jax_ldl10(lap10):
    """The JAX LDL factor (no SPD kernel) of the 10³ Laplacian on the
    8-device mesh, at its default tiers."""
    A, perm = lap10
    jf = JaxDistLDL()
    jf.initialize(JaxDistSparseMatrix.from_sparse(
        jax_laplacian_3d(10, 10, 10, scaled=False), _jax_grid8()),
        perm=perm)
    jf.factor()
    return np.asarray(jf.numeric.pool), np.asarray(jf.numeric.d)


@pytest.mark.parametrize("tree_axis", [None, "mc", "mr"])
def test_batch_split_matches_jax(lap10, jax_ldl10, tree_axis, monkeypatch):
    """With the split threshold lowered, every level of at least 8 fronts
    is split over the positions of ``tree_axis`` (default: all axes for the
    distributed facade) and each chunk's return recorded; the pool stays
    within 1e-12 of the JAX factor's."""
    A, perm = lap10
    monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", 1.0)
    grid = _grid8()
    f = DistSparseLDLFactorization(dtype=F64, tree_axis=tree_axis)
    f.initialize(DistSparseMatrix.from_sparse(A, grid), perm=perm)
    with count_transfers() as log:
        f.factor()
    jp, jd = jax_ldl10
    scale = np.abs(jp).max()
    assert np.abs(f.numeric.pool.numpy() - jp).max() < 1e-12 * scale
    assert np.abs(f.numeric.d.numpy() - jd).max() < 1e-12 * scale
    chunks = {None: 8, "mc": 2, "mr": 4}[tree_axis]
    split = [lev for lev in f.symb.levels if lev.sn_ids.shape[0] >= 8]
    assert split
    expect = 0
    for lev in split:
        nf, S = lev.sn_ids.shape[0], lev.front_size
        size = -(-nf // chunks)
        sizes = [max(0, min(size, nf - c * size)) for c in range(chunks)]
        # each position receives the chunks it does not hold
        for q in range(8):
            c = {None: q, "mc": q // 4, "mr": q % 4}[tree_axis]
            expect += (nf - sizes[c]) * S * S * 8
    assert log.bytes() == log.bytes("all-gather") == expect


def test_one_position_grid_records_nothing(lap10, monkeypatch):
    """Both tiers forced on a 1×1 grid: the factor equals the one-device
    factor's lower triangles, and no transfer is recorded."""
    A, perm = lap10
    monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", 1.0)
    f = DistSparseLDLFactorization(dtype=F64, spd=True, dist_front_min=96)
    f.initialize(DistSparseMatrix.from_sparse(A, Grid([CPU])), perm=perm)
    with count_transfers() as log:
        f.factor()
    assert len(log) == 0
    f1 = SparseLDLFactorization(device=CPU, dtype=F64, spd=True)
    f1.initialize(A, perm=perm).factor()
    lo1 = _lower_pool(f1)
    assert float((_lower_pool(f) - lo1).abs().max()) \
        < 1e-10 * float(lo1.abs().max())


def _hermitian_laplacian(n):
    """The unscaled n×n grid Laplacian with a Landau phase on its vertical
    bonds, shifted by 0.5 on the diagonal: Hermitian, indefinite-free."""
    A = sparse_laplacian_2d(n, n, scaled=False)
    r, c = A.row_ids(), A.colind
    phase = np.exp(2j * np.pi / 16 * (r % n))
    v = A.vals.astype(np.complex128)
    v = np.where(c - r == n, v * phase, v)
    v = np.where(r - c == n, v * phase.conj(), v)
    return dataclasses.replace(A, vals=np.where(r == c, v + 0.5, v))


def test_complex_hermitian_skips_dist_front(monkeypatch):
    """complex128 LDLᴴ on the 8-position grid: the distributed front tier
    is for real dtypes only (no panel gather), the batch split still
    runs; the factor equals the one-device factor within 1e-12 and solves
    against a dense solve."""
    A = _hermitian_laplacian(24)
    perm = nested_dissection(A, cutoff=16)
    monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", 1.0)
    f = DistSparseLDLFactorization(dtype=torch.complex128, dist_front_min=8)
    f.initialize(DistSparseMatrix.from_sparse(A, _grid8()), hermitian=True,
                 perm=perm, cutoff=16)
    with count_transfers() as log:
        f.factor()
    shapes = {r.shape for r in log}
    assert shapes and all(len(s) == 3 for s in shapes)  # split chunks only
    f1 = SparseLDLFactorization(device=CPU, dtype=torch.complex128)
    f1.initialize(A, hermitian=True, perm=perm).factor()
    p1 = f1.numeric.pool
    assert float((f.numeric.pool - p1).abs().max()) \
        < 1e-12 * float(p1.abs().max())
    b = RNG.standard_normal(A.height) + 1j * RNG.standard_normal(A.height)
    x = f.solve(b).numpy()
    ref = np.linalg.solve(A.to_dense(), b)
    assert np.abs(x - ref).max() < 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("spd", [True, False])
def test_factor_without_grid_is_the_level_loop(lap10, spd):
    """``factor(grid=None)`` equals, bit for bit, the one-device level
    loop written out here: K1's plain version, the kernel of the level's
    tier, the pivots."""
    A, perm = lap10
    f = SparseLDLFactorization(device=CPU, dtype=F64, spd=spd)
    f.initialize(A, perm=perm).factor()
    symb, plan = f.symb, f.ea_plan
    pool = torch.zeros(symb.pool_size, dtype=F64)
    vals = torch.as_tensor(A.vals)
    for lev in symb.levels:
        pool.index_add_(0, lev.asm_dst, vals[lev.asm_src])
    d = torch.zeros(symb.n, dtype=F64)
    with numeric.full_fp32_matmul():
        for li, lev in enumerate(symb.levels):
            if li in plan.levels:
                extend_add(pool, plan.levels[li])
            nf, S = lev.sn_ids.shape[0], lev.front_size
            fronts = pool[lev.offset:lev.offset + nf * S * S].view(nf, S, S)
            max_ns = int(lev.ns.max())
            ns = torch.as_tensor(lev.ns)
            tier = numeric.level_tier(lev, grid=None, spd=spd, dtype=F64,
                                      dist_front_min=numeric.DIST_FRONT_MIN)
            if tier == "spd":
                numeric._masked_partial_spd(fronts, ns, max_ns, False)
            else:
                assert tier == "blocked"
                numeric._masked_partial_ldl_blocked(fronts, ns, max_ns,
                                                    False, nb=32)
            d[lev.diag_cols] = pool[lev.diag_dst]
    assert torch.equal(f.numeric.pool, pool)
    assert torch.equal(f.numeric.d, d)


def test_dist_facade_needs_host_structure(lap10):
    A, _ = lap10
    dA = DistSparseMatrix.from_sparse(A, _grid8())
    dA = dataclasses.replace(dA, host=None)
    with pytest.raises(ValueError, match="host structure"):
        DistSparseLDLFactorization(dtype=F64).initialize(dA)
    with pytest.raises(ValueError, match="no device"):
        SparseLDLFactorization(device=None, dtype=F64).initialize(A)
