"""The 3-D Laplacian's LDLᵀ refactor through ``DistSparseLDLFactorization``
on a 2×2 grid, the benchmark cell ``lap48.dist_refactor`` at a small side.

CPU tests, on grids that repeat torch's one CPU device: the 12³ Laplacian
with ``dist_front_min`` and ``numeric.SPLIT_MIN_WORK`` lowered so that both
grid tiers take levels, refactored by ``change_nonzero_values`` on seeded
diffusion values, held to a dense float64 solve and to the one-device
factor; the distributed front's panels through K8's wrapper
(``ldl_panel``, its plain column loop on the CPU) held to the column loop
the front ran before (``_eliminate_panel``, kept below); and the
``peer_bytes`` counter.

Tests marked ``cuda`` need four cards (they skip with fewer): the factor
on a grid of four distinct cards against the one-card factor, and
``peer_bytes`` against its formula.  The file imports no JAX:

    python -m pytest tests/test_torch_dist_refactor.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve

from elemental_tpu_torch.core import Grid
from elemental_tpu_torch.kernels.front_panel import (NB, _clamp_pivot,
                                                     ldl_panel)
from elemental_tpu_torch.sparse import DistSparseMatrix, SparseMatrix
from elemental_tpu_torch.sparse_direct import (DistSparseLDLFactorization,
                                               SparseLDLFactorization,
                                               nested_dissection, numeric)
from elemental_tpu_torch.sparse_direct.dist_front import (PANEL,
                                                          dist_partial_ldl,
                                                          padded_size)
from elemental_tpu_torch.utils import transfers
from elemental_tpu_torch.utils.transfers import count_transfers

CPU = torch.device("cpu")
F64 = torch.float64
SIDE = 12
DIST_MIN = 96          # levels of ≤ 8 fronts of order ≥ 96: the dist front
SPLIT_MIN = 1e6        # levels of ≥ 4 fronts with nf·S³ ≥ 1e6: the split


def laplacian(side):
    """The unscaled 7-point Laplacian on a side³ grid, sorted CSR (the
    benchmark reference's matrix)."""
    n = side ** 3
    idx = np.arange(n).reshape(side, side, side)
    rows, cols = [np.arange(n)], [np.arange(n)]
    for axis in range(3):
        lo, hi = [slice(None)] * 3, [slice(None)] * 3
        lo[axis], hi[axis] = slice(0, -1), slice(1, None)
        a, b = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        rows += [a, b]
        cols += [b, a]
    r, c = np.concatenate(rows), np.concatenate(cols)
    A = sp.csr_matrix((np.where(r == c, 6.0, -1.0), (r, c)), shape=(n, n))
    A.sort_indices()
    return A


def diffusion(pattern, seed):
    """A variable-coefficient diffusion on ``pattern``'s sorted CSR: edge
    weights in [0.5, 1.5), the diagonal the row's absolute sum + 1."""
    up = sp.triu(pattern, 1).tocoo()
    w = np.random.default_rng(seed).uniform(0.5, 1.5, up.nnz)
    W = sp.coo_matrix((w, (up.row, up.col)), shape=pattern.shape)
    W = (W + W.T).tocsr()
    M = (sp.diags(np.asarray(W.sum(axis=1)).ravel() + 1.0) - W).tocsr()
    M.sort_indices()
    assert np.array_equal(M.indices, pattern.indices)
    return M


@pytest.fixture(scope="module")
def lap():
    L = laplacian(SIDE)
    A = SparseMatrix.from_scipy(L)
    return L, A, nested_dissection(A, cutoff=64)


def tiers(symb, grid, dist_min):
    """The levels each grid tier takes (``numeric.level_tier``)."""
    out = {"dist": [], "split": []}
    for li, lev in enumerate(symb.levels):
        tier = numeric.level_tier(lev, grid=grid, spd=False, dtype=F64,
                                  dist_front_min=dist_min)
        if tier in out:
            out[tier].append(li)
    return out


def lower_pool(f):
    """Each front's lower triangle, level by level (the entries the factor
    defines and the solves read)."""
    return torch.cat([torch.tril(f.numeric._level_fronts(lev)).reshape(-1)
                      .cpu() for lev in f.symb.levels])


def grid_factor(A, perm, grid, tree_axis=None, dist_min=DIST_MIN):
    f = DistSparseLDLFactorization(dtype=F64, tree_axis=tree_axis,
                                   dist_front_min=dist_min)
    return f.initialize(DistSparseMatrix.from_sparse(A, grid), perm=perm)


@pytest.mark.parametrize("tree_axis", [None, "mc", "mr"])
def test_grid_refactor_matches_one_device(lap, monkeypatch, tree_axis):
    """Factor, refactor on a seeded value set, solve: the solve within
    1e-10 of a dense float64 solve, the lower triangles and the pivots
    within 1e-12·max|pool| of the one-device factor's."""
    L, A, perm = lap
    monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", SPLIT_MIN)
    grid = Grid([CPU] * 4, height=2)
    f = grid_factor(A, perm, grid, tree_axis)
    took = tiers(f.symb, grid, DIST_MIN)
    assert took["dist"] and took["split"]
    f.factor()
    M = diffusion(L, 7)
    f.change_nonzero_values(M.data)
    f1 = SparseLDLFactorization(device=CPU, dtype=F64)
    f1.initialize(A, perm=perm).factor()
    f1.change_nonzero_values(M.data)
    lo, lo1 = lower_pool(f), lower_pool(f1)
    scale = float(lo1.abs().max())
    assert float((lo - lo1).abs().max()) <= 1e-12 * scale
    assert float((f.numeric.d - f1.numeric.d).abs().max()) <= 1e-12 * scale
    b = np.random.default_rng(8).standard_normal(L.shape[0])
    x = f.solve(b).numpy()
    ref = np.linalg.solve(M.toarray(), b)
    assert np.linalg.norm(x - ref) <= 1e-10 * np.linalg.norm(ref)


def test_refactor_keeps_the_pattern_and_moves_the_factor(lap, monkeypatch):
    """Two value sets give two factors on one plan: the second refactor is
    no copy of the first (the benchmark's fault)."""
    L, A, perm = lap
    monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", SPLIT_MIN)
    f = grid_factor(A, perm, Grid([CPU] * 4, height=2))
    f.factor()
    symb = f.symb
    f.change_nonzero_values(diffusion(L, 1).data)
    first = f.numeric.pool.clone()
    f.change_nonzero_values(diffusion(L, 2).data)
    assert f.symb is symb
    assert not torch.equal(first, f.numeric.pool)


def _eliminate_panel(Pp, j0, ncols, conjugate, pf):
    """The distributed front's column loop before K8: eliminate the
    panel's first ``ncols`` columns (pivots j0 + kk) in place on the
    gathered Sp×nb panel ``Pp``."""
    for kk in range(ncols):
        k = j0 + kk
        dk = Pp[k, kk]
        if pf is not None:
            dk = _clamp_pivot(dk, pf[k])
        safe = torch.where(dk == 0, torch.ones_like(dk), dk)
        col = Pp[k + 1:, kk] / safe
        rest = Pp.shape[1] - kk - 1
        if rest:
            row = col[:rest]
            if conjugate:
                row = row.conj()
            Pp[k + 1:, kk + 1:] -= col[:, None] * row[None, :] * dk
        Pp[k + 1:, kk] = col
        if pf is not None:
            Pp[k, kk] = dk


def _loop_front(F, ns, nb, pf=None):
    """The distributed front's factor before K8, on one device: each panel
    gathered whole, eliminated by the column loop over its first
    min(nb, ns − j0) columns, then the rank-nb trailing update."""
    S = F.shape[0]
    rows = torch.arange(S)
    for j0 in range(0, ns, nb):
        j1 = min(j0 + nb, S)
        Pp = F[:, j0:j1].clone()
        _eliminate_panel(Pp, j0, min(nb, ns - j0), False, pf)
        prow = torch.arange(j0, j1)
        keep = (rows[:, None] > prow[None, :]) & (prow[None, :] < ns)
        Lp = torch.where(keep, Pp, torch.zeros((), dtype=F.dtype))
        d = Pp[j0:j1].diagonal()
        if j1 < S:
            F[j0 + 1:, j1:] -= torch.matmul(Lp[j0 + 1:] * d[None, :],
                                            Lp[j1:].mT)
        F[:, j0:j1] = Pp
    return F


def _spd_front(S, dtype, seed=3):
    a = np.random.default_rng(seed).standard_normal((S, S))
    return torch.tensor(np.tril(a @ a.T + S * np.eye(S)), dtype=dtype)


FRONT_ULPS = 32     # measured on the CPU: at most 7.4 ulps of max|F|


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("S,ns,nb", [(384, 250, 64), (256, 256, 128),
                                     (300, 200, 32), (520, 450, 128)])
def test_dist_front_panels_match_column_loop(dtype, floor, S, ns, nb):
    """The front on a 2×2 grid, its panels through ``ldl_panel`` (sub-panels
    of 32, and the last panel as wide as the pivots left), equals the
    column loop up to rounding: within 32 ulps of max|F|."""
    F = _spd_front(S, dtype)
    pf = None
    if floor:
        pf = torch.tensor(np.where(np.arange(S) % 3 == 0, -1.0, 1.0)
                          * 1.5 * S, dtype=dtype)
    got = dist_partial_ldl(F.clone(), ns, Grid([CPU] * 4, height=2), nb=nb,
                           pf=pf)
    ref = _loop_front(F.clone(), ns, nb, pf)
    eps = torch.finfo(dtype).eps
    assert float((got - ref).abs().max()) <= FRONT_ULPS * eps * float(
        ref.abs().max())


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("R,w", [(300, 32), (40, 17), (300, 64), (500, 128)])
def test_gathered_panel_through_ldl_panel(dtype, R, w):
    """One gathered panel (its R rows from the first pivot down, w columns)
    through ``ldl_panel``: bit-equal to the column loop for w ≤ 32 (one
    call of the plain loop), within 16 ulps of max|panel| for wider
    panels (sub-panels of 32 and their updates; measured at most 7)."""
    g = torch.Generator().manual_seed(R * w)
    P = torch.randn(R, w, generator=g, dtype=dtype)
    P[:w] += 4 * w * torch.eye(w, dtype=dtype)
    ref = P.clone()
    _eliminate_panel(ref, 0, w, False, None)
    got = P.clone()
    lp = got.new_empty(1, R, w)
    ld = torch.empty_like(lp)
    ldl_panel(got[None], torch.tensor([w]), 0, w, False, None, lp, ld)
    if w <= NB:
        assert torch.equal(got, ref)
    else:
        eps = torch.finfo(dtype).eps
        assert float((got - ref).abs().max()) <= 16 * eps * float(
            ref.abs().max())
    below = torch.tril(got, -1)
    assert torch.equal(lp[0], below)
    assert torch.equal(ld[0], below * got.diagonal()[None, :])


def test_peer_bytes_zero_on_repeated_device(lap, monkeypatch):
    """On a grid that repeats one device nothing leaves it: ``peer_bytes``
    stays, while the transfer log records the JAX schedule's gathers."""
    L, A, perm = lap
    monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", SPLIT_MIN)
    f = grid_factor(A, perm, Grid([CPU] * 4, height=2))
    before = transfers.peer_bytes
    with count_transfers() as log:
        f.factor()
    assert transfers.peer_bytes == before
    assert log.bytes("all-gather") > 0


def test_peer_copy_counts_between_devices():
    """``peer_copy`` returns a tensor already there and counts nothing;
    a copy to another device adds its bytes, as ``peer_copy_`` does."""
    t = torch.arange(10, dtype=F64)
    before = transfers.peer_bytes
    assert transfers.peer_copy(t, CPU) is t
    transfers.peer_copy_(t[:5], t[5:])
    assert transfers.peer_bytes == before
    meta = transfers.peer_copy(t, torch.device("meta"))
    assert meta.device.type == "meta"
    assert transfers.peer_bytes == before + 80
    transfers.peer_copy_(torch.empty(4, dtype=F64, device="meta"), t[:4])
    assert transfers.peer_bytes == before + 112


# -- four cards ---------------------------------------------------------------

CARD_SIDE = 24
CARD_DIST_MIN = 256
CARD_SPLIT_MIN = 1e7


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    return [torch.device("cuda", i) for i in range(4)]


@pytest.fixture(scope="module")
def card_lap():
    L = laplacian(CARD_SIDE)
    A = SparseMatrix.from_scipy(L)
    return L, A, nested_dissection(A, cutoff=64)


def front_peer_bytes(S, ns, devs, nb, itemsize):
    """Bytes one distributed front copies between distinct devices: each
    row block out to its position's device and back, and per panel every
    device of a position holding a row ≥ j0 receives the other devices'
    such rows of the panel's w = min(nb, ns − j0) columns."""
    P = len(devs)
    Sp = padded_size(S, nb, P)
    rl = Sp // P
    home = devs[0]
    total = 2 * sum(dev != home for dev in devs) * rl * Sp
    for j0 in range(0, ns, nb):
        w = min(nb, ns - j0)
        active = range(j0 // rl, P)
        need = set(devs[q] for q in active)
        if len(need) > 1:
            total += sum((rl - max(j0 - q * rl, 0)) * w
                         for dev in need for q in active if devs[q] != dev)
    return total * itemsize


def factor_peer_bytes(symb, grid, dist_min, itemsize):
    """``peer_bytes`` of one factor on ``grid`` with the default tree axis
    (every axis): the dist-front levels' fronts, and each split level's
    chunks held on other devices than the pool's, out and back, with their
    int64 ``ns``."""
    devs = [grid.device(i, j) for i, j in grid.positions()]
    took = tiers(symb, grid, dist_min)
    total = 0
    for li in took["dist"]:
        lev = symb.levels[li]
        total += sum(front_peer_bytes(lev.front_size, int(n), devs, PANEL,
                                      itemsize) for n in lev.ns)
    for li in took["split"]:
        lev = symb.levels[li]
        nf, S = lev.sn_ids.shape[0], lev.front_size
        size = -(-nf // grid.size)
        for c in range(grid.size):
            k = max(0, min(size, nf - c * size))
            if k and devs[c] != devs[0]:
                total += 2 * k * S * S * itemsize + 8 * k
    return total


@pytest.mark.cuda
def test_four_card_factor_matches_one_card(cards, card_lap, monkeypatch):
    """The 24³ Laplacian (both tiers lowered so that they take levels) on
    a 2×2 grid of four cards: factor and refactor equal the one-card
    factor within 1e-12·max|pool|, the solve within 1e-10 of CG's."""
    L, A, perm = card_lap
    monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", CARD_SPLIT_MIN)
    grid = Grid(cards, height=2)
    f = grid_factor(A, perm, grid, dist_min=CARD_DIST_MIN)
    took = tiers(f.symb, grid, CARD_DIST_MIN)
    assert took["dist"] and took["split"]
    assert f.device == cards[0]
    f.factor()
    M = diffusion(L, 11)
    f.change_nonzero_values(M.data)
    f1 = SparseLDLFactorization(device=cards[0], dtype=F64)
    f1.initialize(A, perm=perm).factor()
    f1.change_nonzero_values(M.data)
    torch.cuda.synchronize()
    lo, lo1 = lower_pool(f), lower_pool(f1)
    scale = float(lo1.abs().max())
    assert float((lo - lo1).abs().max()) <= 1e-12 * scale
    assert float((f.numeric.d - f1.numeric.d).abs().max()) <= 1e-12 * scale
    b = np.random.default_rng(12).standard_normal(L.shape[0])
    x = f.solve(b).cpu().numpy()
    ref = spsolve(M.tocsc(), b)
    assert np.linalg.norm(x - ref) <= 1e-10 * np.linalg.norm(ref)


@pytest.mark.cuda
def test_four_card_peer_bytes_formula(cards, card_lap, monkeypatch):
    """One factor on four cards copies between them exactly the bytes of
    :func:`factor_peer_bytes`; the same factor on a grid over one card
    copies none."""
    L, A, perm = card_lap
    monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", CARD_SPLIT_MIN)
    grid = Grid(cards, height=2)
    f = grid_factor(A, perm, grid, dist_min=CARD_DIST_MIN)
    before = transfers.peer_bytes
    f.factor()
    got = transfers.peer_bytes - before
    assert got == factor_peer_bytes(f.symb, grid, CARD_DIST_MIN, 8) > 0
    one = grid_factor(A, perm, Grid([cards[0]] * 4, height=2),
                      dist_min=CARD_DIST_MIN)
    before = transfers.peer_bytes
    one.factor()
    assert transfers.peer_bytes == before


@pytest.mark.cuda
def test_four_card_front_matches_one_card_front(cards):
    """One front of order 1000 (700 pivots) on four cards equals the same
    front on a grid over one card within 1e-12·max|F|, and its panels run
    through K8: one launch a sub-panel of 32 on every card that holds a
    row at or below the panel."""
    F = _spd_front(1000, F64).to(cards[0])
    ns = 700
    before = ldl_panel.launches
    got = dist_partial_ldl(F.clone(), ns, Grid(cards, height=2))
    launches = ldl_panel.launches - before
    ref = dist_partial_ldl(F.clone(), ns, Grid([cards[0]] * 4, height=2))
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    rl = padded_size(1000, PANEL, 4) // 4
    want = sum(-(-min(PANEL, ns - j0) // NB) * (4 - j0 // rl)
               for j0 in range(0, ns, PANEL))
    assert launches == want
