"""The transfer count (``elemental_tpu_torch.utils.transfers``): the port's
counterparts of the JAX package's three HLO audits,
``tests/core/test_collectives_audit.py``,
``tests/ops/test_gemm.py::test_summa_no_full_operand_allgather`` and
``tests/sparse/test_sparse.py``'s ``test_dist_spmv_no_full_allgather`` and
``test_dist_spgemm_no_full_gather``.  Each asserts the bounds its HLO test
asserts, on the port's own records of the block copies between grid
positions (the grids repeat torch's CPU device, so positions, not devices,
are counted); nothing here reads or compares an HLO byte count."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from elemental_tpu_torch import sparse as tsp
from elemental_tpu_torch.core import MC, MR, STAR, VC, Grid, distribute
from elemental_tpu_torch.core import redistribute as rd
from elemental_tpu_torch.matrices import sparse_laplacian_2d
from elemental_tpu_torch.ops import gemm3d, summa
from elemental_tpu_torch.utils import KINDS, count_transfers, transfers

torch.set_num_threads(1)

CPU = torch.device("cpu")


def grid(n, height):
    return Grid(devices=[CPU] * n, height=height)


def full_gathers(log, shapes):
    return [r for r in log.of("all-gather") if r.shape in shapes]


# ------------------------------------- test_collectives_audit.py's three

def test_contraction_counts_and_bytes():
    """A contraction over 4 positions into a replicated result records an
    ``all-reduce`` with bytes (the psum audit); the total is the sum of the
    kinds."""
    g = grid(4, 2)
    partial = torch.ones((4, 8, 128), dtype=torch.float32)
    with count_transfers() as log:
        out = rd.contract(partial, g, STAR, STAR)
    audit = log.audit()
    assert audit["all-reduce"]["count"] >= 1
    assert audit["all-reduce"]["bytes"] > 0
    assert audit["total"]["count"] == sum(
        v["count"] for k, v in audit.items() if k != "total")
    assert set(audit) == set(KINDS) | {"total"}
    np.testing.assert_array_equal(out.to_numpy(), np.full((8, 128), 4.0))
    # cut over the grid it is a reduce-scatter, of a quarter of the bytes
    with count_transfers() as cut:
        rd.contract(partial, g, MC, MR)
    assert cut.audit()["reduce-scatter"]["count"] == 4
    assert cut.bytes() * 4 == log.bytes()


def test_all_gather_bytes_scale_with_size():
    g = grid(4, 2)

    def gathered(n):
        A = distribute(np.ones((n, 128), np.float32), VC, STAR, g)
        with count_transfers() as log:
            full = rd.all_gather(A)
        assert tuple(full.shape) == (n, 128)
        return log.audit()["all-gather"]["bytes"]

    small, big = gathered(8), gathered(32)
    assert small > 0 and big >= 4 * small * 0.9       # ~linear in size


def test_no_transfers_on_one_position():
    g = grid(1, 1)
    a = torch.randn(16, 24, dtype=torch.float64)
    b = torch.randn(24, 8, dtype=torch.float64)
    A = sparse_laplacian_2d(4, 4)
    with count_transfers() as log:
        for alg in ("stationary_c", "stationary_a", "stationary_b"):
            summa.gemm_summa(a, b, g, alg)
        distribute(a, MC, MR, g).redistribute(STAR, STAR)
        rd.contract(torch.ones(1, 4, 4), g, MC, MR)
        tsp.DistSparseMatrix.from_sparse(A, g).matvec(torch.ones(16))
        gemm3d.gemm_3d(a, b, gemm3d.make_3d_mesh([CPU], depth=1))
    assert log.audit()["total"] == {"count": 0, "bytes": 0}
    assert len(log) == 0


def test_recording_is_off_outside_the_context():
    g = grid(4, 2)
    assert not transfers.recording
    with count_transfers() as outer:
        with count_transfers() as inner:
            distribute(np.ones((8, 8)), MC, MR, g).redistribute(STAR, STAR)
        assert transfers.recording
        distribute(np.ones((8, 8)), MC, MR, g).redistribute(MR, MC)
    assert not transfers.recording
    assert len(inner) == 4 and len(outer) == 6
    assert {r.kind for r in outer.of("collective-permute")} == \
        {"collective-permute"}
    with pytest.raises(ValueError):
        transfers.record("broadcast", torch.ones(1), [], 0)


def test_redistributions_are_classed_as_the_hlo_would():
    g = grid(4, 2)
    A = distribute(np.arange(64.0).reshape(8, 8), MC, MR, g)
    kinds = {}
    for pair in ((STAR, STAR), (MR, MC), (VC, STAR), (MC, MR)):
        with count_transfers() as log:
            B = A.redistribute(*pair)
        np.testing.assert_array_equal(B.to_numpy(), A.to_numpy())
        kinds[pair] = {r.kind for r in log}
    assert kinds[(STAR, STAR)] == {"all-gather"}
    assert kinds[(MR, MC)] == {"collective-permute"}   # a swap on 2×2
    assert kinds[(VC, STAR)] == {"all-to-all"}
    assert kinds[(MC, MR)] == set()
    S = distribute(np.ones((8, 8)), STAR, STAR, g)
    with count_transfers() as log:
        S.redistribute(MC, MR)                         # a local filter
    assert len(log) == 0


# ------------------------- test_gemm.py::test_summa_no_full_operand_...

@pytest.mark.parametrize("alg", ["stationary_a", "stationary_b",
                                 "stationary_c", "pipelined"])
def test_summa_no_full_operand_allgather(alg):
    """No panel scheme replicates an operand over both grid axes: no
    all-gather record holds a whole m×k or k×n operand."""
    g = grid(8, 2)
    m, k, n = 64, 128, 96
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    with count_transfers() as log:
        c = summa.gemm_summa(torch.from_numpy(a), torch.from_numpy(b), g, alg)
    assert not full_gathers(log, {(m, k), (k, n)})
    assert log.of("all-gather")               # the panels are gathered
    if alg in ("stationary_a", "stationary_b", "pipelined"):
        assert log.of("collective-permute")   # and the ring moves blocks
    np.testing.assert_allclose(c.numpy(), a @ b, rtol=1e-4, atol=1e-4)


def test_gemm_3d_gathers_panels_and_sums_depth():
    a = torch.randn(32, 64, dtype=torch.float64)
    b = torch.randn(64, 16, dtype=torch.float64)
    mesh = gemm3d.make_3d_mesh([CPU] * 8, depth=2)
    with count_transfers() as log:
        c = gemm3d.gemm_3d(a, b, mesh)
    audit = log.audit()
    assert audit["all-gather"]["count"] > 0
    assert audit["all-reduce"]["count"] == 4          # one per (i, j)
    assert not full_gathers(log, {(32, 64), (64, 16)})
    torch.testing.assert_close(c, a @ b)


# ------------------------------------------- test_sparse.py's two audits

def test_dist_spmv_no_full_allgather():
    """The halo-compressed SpMV never replicates x: on DistMultiVec
    operands no all-gather is recorded, the all-to-all moves at most the
    JAX all_to_all's operand (p·p·H·k·itemsize), and the total stays well
    under a full gather of x to every position."""
    g = grid(8, 2)
    A = sparse_laplacian_2d(16, 16)      # n = 256; halo H = 16 a position
    dA = tsp.DistSparseMatrix.from_sparse(A, g)
    p, n, H = g.size, A.height, dA.halo
    rng = np.random.default_rng(1)
    for k in (1, 4):
        x = rng.standard_normal((n, k) if k > 1 else n)
        xv = tsp.DistMultiVec.from_array(x, g)
        for run in (dA.matvec, dA.matvec_transpose):
            with count_transfers() as log:
                y = run(xv)
            assert isinstance(y, tsp.DistMultiVec)
            assert not log.of("all-gather")
            a2a = log.audit()["all-to-all"]
            assert a2a["count"] == p and a2a["bytes"] > 0
            assert a2a["bytes"] <= p * p * H * k * 8
            assert log.bytes() < n * k * 8 * p / 2
            want = A.to_dense() if run == dA.matvec else A.to_dense().T
            np.testing.assert_allclose(y.to_numpy(), want @ x, rtol=1e-10)


def test_dist_spgemm_no_full_gather():
    """The distributed SpGEMM numeric ships only the entry-compressed halo
    of B's values: no all-gather, the all-to-all within p·p·H·itemsize and
    the total under a gather of B's values to every position."""
    g = grid(8, 2)
    Ra = sp.random(96, 96, density=0.06, format="csr", random_state=8)
    A = tsp.SparseMatrix.from_scipy(Ra)
    dA = tsp.DistSparseMatrix.from_sparse(A, g)
    plan = tsp.dist_spgemm_plan(dA, dA)
    p = g.size
    with count_transfers() as log:
        vals = plan.numeric(dA.lvals, dA.lvals)
    assert not log.of("all-gather")
    a2a = log.audit()["all-to-all"]
    assert a2a["count"] == p
    assert 0 < a2a["bytes"] <= p * p * plan.halo * 8
    assert log.bytes() < A.nnz * 8 * p
    got = plan.c_template.host.change_nonzero_values(
        torch.cat(vals).numpy()[plan.c_template.val_slot])
    np.testing.assert_allclose(got.to_dense(), (Ra @ Ra).toarray(),
                               rtol=1e-10, atol=1e-12)


def test_dist_multivec_recut_and_distmap_lookups_are_recorded():
    """Moving a multivector's rows to another block size is an all-to-all
    of the rows that change position; a DistMap lookup records the
    requests and the answers that cross positions."""
    g = grid(4, 2)
    x = np.arange(12.0)
    xv = tsp.DistMultiVec.from_array(x, g)             # blocks of 3 rows
    with count_transfers() as log:
        blocks = xv.row_blocks(4)
    assert [b.tolist() for b in blocks] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                            [8, 9, 10, 11], [0, 0, 0, 0]]
    assert {r.kind for r in log} == {"all-to-all"}
    assert log.bytes() == 6 * 8                         # rows 3, 6-8, 9, 10
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rv = tsp.DistMultiVec.from_array(np.arange(10.0), g)
    with count_transfers() as log:
        rv.row_blocks(3)                                # replicated: local
    assert len(log) == 0
    perm = np.random.default_rng(2).permutation(40)
    dm = tsp.DistMap(perm).to(g)
    idx = np.array([0, 5, 12, 39, 25])                  # owners 0,0,1,3,2
    with count_transfers() as log:
        out = dm.translate_device(idx)
    np.testing.assert_array_equal(out.numpy(), perm[idx])
    assert log.audit()["all-to-all"]["count"] == 6      # 3 owners × 2
    assert log.bytes() == 6 * 8
