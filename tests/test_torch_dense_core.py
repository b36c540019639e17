"""Parity of the port's dense core (``elemental_tpu_torch.core``: Grid, the
Dist calculus, DistMatrix and its redistributions, block-cyclic layouts,
FLAME partitions, proxies, environment, RNG, profiling) with the JAX
package on the CPU, mirroring ``tests/core/test_distmatrix.py``,
``test_grid_redistribute.py`` and ``test_blockcyclic.py``.

The JAX side runs on the conftest's forced host devices (``grid8``, 2×4;
``grid4``, 2×2); the port's grids repeat torch's one CPU device at the same
shapes.  Both sides are built from the same seeded NumPy arrays.
Tolerances: redistribution, block shapes and layouts are compared exactly
(bit for bit); arithmetic to 1e-12 relative in float64.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

import elemental_tpu as jel
from elemental_tpu.core import blockcyclic as jbc
from elemental_tpu.core import dist as jdist
from elemental_tpu.core import flamepart as jfp
from elemental_tpu.core import redistribute as jred
from elemental_tpu.core.grid import _grid_height as j_grid_height

import elemental_tpu_torch as tel
from elemental_tpu_torch import core as tcore
from elemental_tpu_torch.core import blockcyclic as tbc
from elemental_tpu_torch.core import dist as tdist
from elemental_tpu_torch.core import environment as tenv
from elemental_tpu_torch.core import flamepart as tfp
from elemental_tpu_torch.core import profiling as tprof
from elemental_tpu_torch.core import random_ as trandom
from elemental_tpu_torch.core import redistribute as tred
from elemental_tpu_torch.core.grid import Grid

torch.set_num_threads(1)

CPU = torch.device("cpu")
PAIR_IDS = [f"{c.value}_{r.value}" for c, r in tdist.DIST_PAIRS]


@pytest.fixture(scope="module")
def tgrid8():
    return Grid(devices=[CPU] * 8, height=2)


@pytest.fixture(scope="module")
def tgrid4():
    return Grid(devices=[CPU] * 4, height=2)


def port_dist(d):
    """The port's Dist of the same name as the JAX package's ``d``."""
    return tdist.Dist(d.value)


def from_reference(jdm, grid):
    """The port's DistMatrix holding a JAX DistMatrix's values, in its
    distribution and with its root, on ``grid``."""
    return tcore.distribute(jdm.to_numpy(), port_dist(jdm.coldist),
                            port_dist(jdm.rowdist), grid, root=jdm.root)


def jax_shards(jdm, jgrid):
    """(i, j) → the JAX shard's values at grid position (i, j)."""
    where = {d: (i, j) for (i, j), d in np.ndenumerate(jgrid.mesh.devices)}
    return {where[s.device]: np.asarray(s.data)
            for s in jdm.data.addressable_shards}


def assert_blocks_match(tdm, jdm, jgrid):
    """Each position's block has the JAX shard's shape and values."""
    shards = jax_shards(jdm, jgrid)
    assert len(shards) == tdm.grid.size
    for (i, j), want in shards.items():
        got = tdm.local(i, j).numpy()
        assert got.shape == want.shape, ((i, j), got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


# -- grids -------------------------------------------------------------------

def test_grid_shapes(grid8, tgrid8):
    assert (tgrid8.height, tgrid8.width, tgrid8.size) == (
        grid8.height, grid8.width, grid8.size)
    assert tgrid8.devices.shape == grid8.devices.shape == (2, 4)
    assert all(d == CPU for d in tgrid8.devices.ravel())


@pytest.mark.parametrize("n", range(1, 9))
def test_grid_near_square(n):
    """The default height is the JAX package's for every device count."""
    jg = jel.Grid(devices=jax.devices("cpu")[:n])
    tg = Grid(devices=[CPU] * n)
    assert (tg.height, tg.width) == (jg.height, jg.width)


def test_grid_height_rule_beyond_eight():
    from elemental_tpu_torch.core.grid import _grid_height
    for n in range(1, 65):
        assert _grid_height(n) == j_grid_height(n)


def test_grid_equality_and_subgrid(tgrid8):
    assert tgrid8 == Grid(devices=[CPU] * 8, height=2)
    assert tgrid8 != Grid(devices=[CPU] * 8, height=4)
    sub = tgrid8.subgrid(4, height=2)
    assert sub.size == 4 and len(sub.viewers) == 4
    assert sub.in_grid(CPU)
    with pytest.raises(ValueError):
        Grid(devices=[CPU] * 6, height=4)


def test_grid_without_cuda_raises(monkeypatch):
    """No CUDA device: the default grid, the trivial grid, ``distribute``
    with no grid and the default 3-D mesh raise; nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(Grid, "_default", None)
    for make in (Grid, Grid.default, Grid.trivial, tel.ops.make_3d_mesh,
                 lambda: tcore.distribute(np.ones((2, 2)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# -- the Dist calculus -------------------------------------------------------

@pytest.mark.parametrize("pair", tdist.DIST_PAIRS, ids=PAIR_IDS)
def test_partition_spec_matches_jax(pair):
    c, r = pair
    jspec = jdist.partition_spec(jdist.Dist(c.value), jdist.Dist(r.value))
    assert tdist.partition_spec(c, r) == tuple(jspec)


def test_dist_algebra_matches_jax():
    assert [(c.value, r.value) for c, r in tdist.DIST_PAIRS] == [
        (c.value, r.value) for c, r in jdist.DIST_PAIRS]
    for d in tdist.Dist:
        jd = jdist.Dist(d.value)
        assert tdist.vector_spec(d) == tuple(jdist.vector_spec(jd))
        assert tdist.gathered_dist(d).value == jdist.gathered_dist(jd).value
        assert tdist.partial_dist(d).value == jdist.partial_dist(jd).value
        for e in tdist.Dist:
            je = jdist.Dist(e.value)
            assert tdist.diag_col(d, e).value == jdist.diag_col(jd, je).value
            assert (tdist.partial_union_dist(d, e).value
                    == jdist.partial_union_dist(jd, je).value)
            assert (tdist.is_replicated(d, e)
                    == jdist.is_replicated(jd, je))
            assert ([x.value for x in tdist.transpose_pair(d, e)]
                    == [x.value for x in jdist.transpose_pair(jd, je)])


# -- DistMatrix --------------------------------------------------------------

def test_distribute_and_gather(tgrid8):
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    A = tcore.distribute(a, tcore.MC, tcore.MR, tgrid8)
    assert A.shape == (8, 8) and A.dtype == torch.float32
    np.testing.assert_array_equal(A.to_numpy(), a)


@pytest.mark.parametrize("pair", tdist.DIST_PAIRS, ids=PAIR_IDS)
def test_redistribution_roundtrip(grid8, tgrid8, pair):
    """[MC,MR] → [U,V] → [MC,MR] is bit-exact, and every position's block of
    [U,V] is the JAX shard of the same grid position."""
    c, r = pair
    a = np.random.default_rng(0).standard_normal((16, 24))
    J = jel.distribute(a, jel.MC, jel.MR, grid8) \
        .redistribute(jdist.Dist(c.value), jdist.Dist(r.value))
    A = tcore.distribute(a, tcore.MC, tcore.MR, tgrid8)
    B = A.redistribute(c, r)
    assert B.dist() == (c, r)
    assert_blocks_match(B, J, grid8)
    C = B.redistribute(tcore.MC, tcore.MR)
    assert torch.equal(tcore.as_array(C), torch.from_numpy(a))
    assert_blocks_match(from_reference(J, tgrid8), J, grid8)


def test_local_sharding_is_real(tgrid8):
    a = np.zeros((16, 16), np.float32)
    A = tcore.distribute(a, tcore.MC, tcore.MR, tgrid8)
    shapes = {tuple(A.local(i, j).shape) for i, j in tgrid8.positions()}
    assert shapes == {(8, 4)}  # 16/2 x 16/4
    starts = {A.ranges(i, j) for i, j in tgrid8.positions()}
    assert len(starts) == 8


def test_one_by_one_grid_copies_nothing():
    g = Grid(devices=[CPU])
    t = torch.randn(6, 5, dtype=torch.float64)
    A = tcore.distribute(t, tcore.MC, tcore.MR, g)
    assert A.local(0, 0) is t and tcore.as_array(A) is t


def test_replicated_blocks_share_storage(tgrid8):
    a = np.random.default_rng(1).standard_normal((8, 8))
    A = tcore.distribute(a, tcore.STAR, tcore.STAR, tgrid8)
    ptrs = {A.local(i, j).data_ptr() for i, j in tgrid8.positions()}
    assert len(ptrs) == 1


def test_root_is_carried(grid8, tgrid8):
    a = np.random.default_rng(2).standard_normal((8, 8))
    J = jel.distribute(a, jel.CIRC, jel.CIRC, grid8, root=3)
    T = from_reference(J, tgrid8)
    assert T.root == 3 and T.dist() == (tcore.CIRC, tcore.CIRC)
    assert T.redistribute(tcore.MC, tcore.MR).root == 3


def test_transpose_and_adjoint(grid8, tgrid8):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((8, 12)) + 1j * rng.standard_normal((8, 12))
    J = jel.distribute(a, jel.MC, jel.MR, grid8)
    A = tcore.distribute(a, tcore.MC, tcore.MR, tgrid8)
    At, Ah = A.T, A.H
    assert At.dist() == (tcore.MR, tcore.MC) == Ah.dist()
    assert_blocks_match(At, J.T, grid8)
    assert_blocks_match(Ah, J.H, grid8)
    np.testing.assert_array_equal(Ah.to_numpy(), a.conj().T)


def test_astype_and_like(tgrid8):
    a = np.random.default_rng(3).standard_normal((8, 8))
    A = tcore.distribute(a, tcore.VC, tcore.STAR, tgrid8)
    B = A.astype(np.float32)
    assert B.dtype == torch.float32 and B.dist() == A.dist()
    np.testing.assert_array_equal(B.to_numpy(), a.astype(np.float32))
    C = tcore.like(A, torch.ones(8, 8))
    assert C.dist() == (tcore.VC, tcore.STAR)
    assert tuple(C.local(0, 1).shape) == (1, 8)
    assert tcore.like(torch.zeros(1), torch.ones(2)).shape == (2,)
    assert tcore.grid_of(torch.ones(1), A) is tgrid8


def test_different_grids(grid8, grid4, tgrid8, tgrid4):
    """Cross-grid copy (reference ``tests/core/DifferentGrids.cpp:36-74``)."""
    a = np.random.default_rng(3).standard_normal((12, 12)).astype(np.float32)
    A = tcore.distribute(a, tcore.MC, tcore.MR, tgrid8)
    B = tred.translate_between_grids(A, tgrid4)
    J = jred.translate_between_grids(
        jel.distribute(a, jel.MC, jel.MR, grid8), grid4)
    assert B.grid is tgrid4
    assert_blocks_match(B, J, grid4)
    C = tred.translate_between_grids(B, tgrid8, tcore.VR, tcore.STAR)
    assert C.dist() == (tcore.VR, tcore.STAR)
    np.testing.assert_array_equal(C.to_numpy(), a)


def test_viewer_owner_subgrid(tgrid8):
    sub = tgrid8.subgrid(4, height=2)
    a = np.random.default_rng(0).standard_normal((32, 24)).astype(np.float32)
    A = tcore.distribute(a, tcore.MC, tcore.MR, sub)
    B = tred.translate_between_grids(A, tgrid8)
    assert B.grid is tgrid8
    np.testing.assert_array_equal(B.to_numpy(), a)
    np.testing.assert_array_equal(
        tred.translate_between_grids(B, sub).to_numpy(), a)


@pytest.mark.parametrize("pair", [(tcore.MC, tcore.MR), (tcore.VC, tcore.STAR),
                                  (tcore.STAR, tcore.VR)],
                         ids=["MC_MR", "VC_STAR", "STAR_VR"])
def test_nondivisible_dims_replicate_with_warning(grid8, tgrid8, pair):
    """A dimension the grid does not divide is replicated, with the JAX
    package's RuntimeWarning, and the blocks keep the JAX shards' shapes."""
    c, r = pair
    a = np.random.default_rng(4).standard_normal((13, 10))
    with pytest.warns(RuntimeWarning, match="not divisible"):
        J = jel.distribute(a, jdist.Dist(c.value), jdist.Dist(r.value),
                           grid8)
    with pytest.warns(RuntimeWarning, match="not divisible"):
        T = tcore.distribute(a, c, r, tgrid8)
    assert_blocks_match(T, J, grid8)
    with pytest.warns(RuntimeWarning, match="not divisible"):
        back = T.redistribute(tcore.MR, tcore.MC)
    np.testing.assert_array_equal(back.to_numpy(), a)


def test_divisible_shapes_do_not_warn(tgrid8):
    a = np.zeros((16, 8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for pair in tdist.DIST_PAIRS:
            tcore.distribute(a, *pair, grid=tgrid8)


def test_dense_queue_update_pull(tgrid8):
    """Remote updates (reference AbstractDistMatrix QueueUpdate/
    ProcessQueues/QueuePull, AbstractDistMatrix.hpp:162-171)."""
    A = tcore.distribute(np.zeros((8, 6), np.float32), tcore.MC, tcore.MR,
                         tgrid8)
    A.queue_update(1, 2, 3.5)
    A.queue_update(1, 2, 0.5)       # duplicates sum (COO semantics)
    A.queue_update(7, 5, -2.0)
    A2 = A.process_queues()
    out = A2.to_numpy()
    assert out[1, 2] == 4.0 and out[7, 5] == -2.0
    assert A.process_queues() is A      # the queue drained
    A2.queue_pull(1, 2)
    A2.queue_pull(7, 5)
    assert list(A2.process_pull_queue()) == [4.0, -2.0]
    with pytest.raises(IndexError):
        A2.queue_update(8, 0, 1.0)


@pytest.mark.parametrize("pair", [(tcore.MC, tcore.MR), (tcore.STAR, tcore.VC),
                                  (tcore.STAR, tcore.STAR)],
                         ids=["MC_MR", "STAR_VC", "STAR_STAR"])
def test_queue_updates_match_jax(grid8, tgrid8, pair):
    """Random updates with repeats, in every block, summed as the JAX
    package sums them (integer values: exact), then pulled back."""
    rng = np.random.default_rng(5)
    a = rng.integers(-4, 5, (16, 24)).astype(np.float64)
    c, r = pair
    J = jel.distribute(a, jdist.Dist(c.value), jdist.Dist(r.value), grid8)
    T = tcore.distribute(a, c, r, tgrid8)
    ii, jj = rng.integers(0, 16, 300), rng.integers(0, 24, 300)
    vv = rng.integers(-8, 9, 300).astype(np.float64)
    for i, j, v in zip(ii, jj, vv):
        J.queue_update(i, j, v)
        T.queue_update(i, j, v)
    J2, T2 = J.process_queues(), T.process_queues()
    assert T2.dist() == (c, r)
    assert_blocks_match(T2, J2, grid8)
    for i, j in zip(ii[:20], jj[:20]):
        J2.queue_pull(i, j)
        T2.queue_pull(i, j)
    np.testing.assert_array_equal(T2.process_pull_queue(),
                                  J2.process_pull_queue())


def test_redistribute_primitives_match_jax(grid8, tgrid8):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((16, 8))
    J = jel.distribute(a, jel.MC, jel.MR, grid8)
    T = tcore.distribute(a, tcore.MC, tcore.MR, tgrid8)
    np.testing.assert_array_equal(tred.all_gather(T).numpy(),
                                  np.asarray(jred.all_gather(J)))
    for t, j in ((tred.translate(T, tcore.VR, tcore.STAR),
                  jred.translate(J, jel.VR, jel.STAR)),
                 (tred.col_filter(T.redistribute(tcore.STAR, tcore.MR),
                                  tcore.MC),
                  jred.col_filter(J.redistribute(jel.STAR, jel.MR), jel.MC)),
                 (tred.row_filter(T.redistribute(tcore.MC, tcore.STAR),
                                  tcore.MR),
                  jred.row_filter(J.redistribute(jel.MC, jel.STAR), jel.MR)),
                 (tred.transpose_dist(T), jred.transpose_dist(J))):
        assert t.dist() == tuple(port_dist(d) for d in j.dist())
        assert_blocks_match(t, j, grid8)
    partial = rng.standard_normal((3, 16, 8))
    t = tred.contract(torch.from_numpy(partial), tgrid8, tcore.MC, tcore.MR)
    j = jred.contract(partial, grid8, jel.MC, jel.MR)
    np.testing.assert_allclose(t.to_numpy(), j.to_numpy(), rtol=1e-12)
    t = tred.axpy_contract(0.5, torch.from_numpy(partial), T)
    j = jred.axpy_contract(0.5, partial, J)
    assert t.dist() == (tcore.MC, tcore.MR)
    np.testing.assert_allclose(t.to_numpy(), j.to_numpy(), rtol=1e-12)


def test_proxies(tgrid8):
    from elemental_tpu_torch.core.proxy import ReadProxy, ReadWriteProxy
    a = np.random.default_rng(7).standard_normal((8, 8))
    A = tcore.distribute(a, tcore.MC, tcore.MR, tgrid8)
    assert ReadProxy(A, tcore.MC, tcore.MR).get() is A
    p = ReadWriteProxy(A, tcore.STAR, tcore.VC)
    assert p.value.dist() == (tcore.STAR, tcore.VC)
    back = p.restore(p.value)
    assert back.dist() == (tcore.MC, tcore.MR)
    np.testing.assert_array_equal(back.to_numpy(), a)


# -- block-cyclic ------------------------------------------------------------

def test_perm_matches_scalapack_ownership():
    n, nb, p = 96, 8, 4
    perm = tbc.block_cyclic_perm(n, nb, p)
    np.testing.assert_array_equal(perm, jbc.block_cyclic_perm(n, nb, p))
    per = n // p
    for k in range(n):
        assert (perm[k] // nb) % p == k // per


def test_blockcyclic_roundtrip_and_element_conversion(grid8, tgrid8):
    a = np.random.default_rng(0).standard_normal((70, 45))
    B = tbc.BlockCyclicMatrix.from_array(a, tgrid8, mb=8, nb=4)
    J = jbc.BlockCyclicMatrix.from_array(a, grid8, mb=8, nb=4)
    np.testing.assert_array_equal(B.to_array(), a)
    assert B.local_shape() == J.local_shape()
    assert B.owner(8, 0) == J.owner(8, 0) == (1, 0)
    assert B.owner(0, 4) == J.owner(0, 4) == (0, 1)
    E = B.to_element()
    np.testing.assert_array_equal(E.to_numpy(), a)
    B2 = tbc.BlockCyclicMatrix.from_element(E, mb=8, nb=4)
    np.testing.assert_array_equal(B2.to_array(), a)
    np.testing.assert_array_equal(B2.data.to_numpy(), np.asarray(J.data))


def test_blockcyclic_gemm_through_conversion(grid8, tgrid8):
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((48, 32)), rng.standard_normal((32, 40))
    A = tbc.BlockCyclicMatrix.from_array(a, tgrid8, mb=8, nb=8)
    B = tbc.BlockCyclicMatrix.from_array(b, tgrid8, mb=8, nb=8)
    C = tel.ops.gemm("N", "N", 1.0, A.to_element(), B.to_element())
    JA = jbc.BlockCyclicMatrix.from_array(a, grid8, mb=8, nb=8)
    JB = jbc.BlockCyclicMatrix.from_array(b, grid8, mb=8, nb=8)
    JC = jel.ops.gemm("N", "N", 1.0, JA.to_element(), JB.to_element())
    np.testing.assert_allclose(C.to_numpy(), JC.to_numpy(), rtol=1e-12)


# -- FLAME partitions --------------------------------------------------------

def test_flamepart_matches_jax():
    a = np.arange(42.0).reshape(7, 6)
    t = torch.from_numpy(a)

    def same(got, want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    for name, args in (("partition_down", (3,)), ("partition_right", (2,)),
                       ("partition_down_diagonal", (2,)),
                       ("repartition_down_diagonal", (2, 3))):
        same(getattr(tfp, name)(t, *args), getattr(jfp, name)(a, *args))
    same(tfp.repartition_down(t[:2], t[2:], 3),
         jfp.repartition_down(a[:2], a[2:], 3))
    same(tfp.repartition_right(t[:, :2], t[:, 2:], 3),
         jfp.repartition_right(a[:, :2], a[:, 2:], 3))
    same(tfp.slide_partition_down(t[:2], t[2:3], t[3:]),
         jfp.slide_partition_down(a[:2], a[2:3], a[3:]))
    same(tfp.slide_partition_right(t[:, :2], t[:, 2:3], t[:, 3:]),
         jfp.slide_partition_right(a[:, :2], a[:, 2:3], a[:, 3:]))
    np.testing.assert_array_equal(
        tfp.merge_2x2(*tfp.partition_down_diagonal(t, 4)).numpy(), a)


# -- environment, RNG, profiling ---------------------------------------------

def test_args_blocksize_timer(capsys):
    args = tenv.Args(["--n", "5", "--flag", "yes", "--name", "x",
                      "--unknown", "1"])
    args.input("n", "size", 3)
    args.input("flag", "a switch", False)
    args.input("name", "a name", "a")
    args.input("tol", "tolerance", 1e-8)
    args.process_input()
    assert (args["n"], args["--flag"], args["name"], args["tol"]) == (
        5, True, "x", 1e-8)
    args.print_report()
    assert "--n = 5" in capsys.readouterr().out
    assert tenv.blocksize() == 128
    tenv.push_blocksize_stack(64)
    assert tenv.blocksize() == 64
    tenv.set_local_blocksize("trsm", 32)
    assert tenv.blocksize("trsm") == 32 and tenv.blocksize("gemm") == 64
    assert tenv.pop_blocksize_stack() == 64
    with pytest.raises(RuntimeError):
        tenv.pop_blocksize_stack()
    tenv._local_blocksizes.clear()
    t = tenv.Timer("t")
    with pytest.raises(RuntimeError):
        t.stop()
    t.start()
    assert t.partial() >= 0 and t.stop() >= 0 and t.total >= 0


def test_initialize_finalize():
    tenv.finalize()
    tel.initialize()
    assert tenv.initialized()
    tel.finalize()
    assert not tenv.initialized()


def test_random_seed_determinism():
    trandom.seed(3)
    a = trandom.gaussian((64,), torch.float64, device=CPU)
    u = trandom.uniform((8,), torch.complex64, device=CPU)
    trandom.seed(3)
    assert torch.equal(a, trandom.gaussian((64,), torch.float64, device=CPU))
    assert torch.equal(u, trandom.uniform((8,), torch.complex64, device=CPU))
    trandom.seed(4)
    assert not torch.equal(a, trandom.gaussian((64,), torch.float64,
                                               device=CPU))


def test_random_moments():
    """Sample moments within 5 standard errors at n = 200,000."""
    trandom.seed(0)
    n = 200_000
    se = 5 / np.sqrt(n)
    g = trandom.gaussian((n,), torch.float64, 1.0, 2.0, device=CPU)
    assert abs(float(g.mean()) - 1.0) < 2 * se
    assert abs(float(g.var()) - 4.0) < 4 * 2 * se
    z = trandom.gaussian((n,), torch.complex128, device=CPU)
    assert abs(float((z.abs() ** 2).mean()) - 1.0) < 2 * se
    u = trandom.uniform((n,), torch.float32, 0.5, 2.0, device=CPU)
    assert float(u.min()) >= -1.5 and float(u.max()) <= 2.5
    assert abs(float(u.mean()) - 0.5) < 2 * se
    assert abs(float(u.var()) - 4 / 3) < 4 * se
    b = trandom.bernoulli((n,), 0.3, device=CPU)
    assert b.dtype == torch.bool and abs(float(b.double().mean()) - 0.3) < se
    r = trandom.rademacher((n,), torch.float64, device=CPU)
    assert set(r.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(r.mean())) < se


def test_profiling_regions(tmp_path):
    tprof.reset_stage_times()

    @tprof.profiled("double")
    def double(x):
        return 2 * x

    tprof.start_trace(str(tmp_path))
    with tprof.profile_region("outer"):
        assert double(3) == 6
    path = tprof.stop_trace()
    times = tprof.stage_times()
    assert set(times) == {"outer", "double"} and times["outer"] >= 0
    assert "outer" in open(path).read()
    tprof.enable_profiling(False)           # the default, left as found
    with tprof.profile_region("off"):
        pass
    assert "off" not in tprof.stage_times()
