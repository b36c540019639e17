"""Parity of the port's bridged SpMV tier (``plan_spmv(kind='bridged')``:
the stream gather and the bucketed combine K7, through their plain
versions) with the JAX package's bridged tier in Pallas interpret mode, as
``tests/sparse/test_bridged.py`` runs it, and with scipy, on the CPU.

Tolerances: y within 1e-5·max|y| of the JAX tier and of scipy, the bound of
``test_bridged.py:29`` (both sum in float32); the rebuilt slot layout
exactly.  The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elemental_tpu.kernels.extend_add import BLOCK_ROWS, ea_route_add
from elemental_tpu.kernels.unstructured import (
    gather_multiply as jax_gather_multiply,
    onehot_combine_bucketed as jax_combine,
    plan_bridged_spmv as jax_plan_bridged)
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix

from elemental_tpu_torch.kernels.unstructured import (
    BUCKET, BridgedPlan, onehot_combine_bucketed, plan_bridged_spmv,
    stream_gather, stream_gather_plain)
from elemental_tpu_torch.sparse import SparseMatrix, plan_spmv

torch.set_num_threads(1)
RTOL = 1e-5


def _matrix(n, m, rows, seed):
    rng = np.random.default_rng(seed)
    return SparseMatrix.from_coo(n, m, rows, rng.integers(0, m, rows.size),
                                 rng.standard_normal(rows.size))


# (matrix, bucket): at least two buckets and a ragged last one each
CASES = {
    # 3000 rows = 2·1024 + 952, 7 entries a row
    "square_1024": lambda: (_matrix(3000, 3000, np.repeat(np.arange(3000), 7),
                                    1), 1024),
    # rectangular, rows drawn at random: ragged row and bucket counts
    # (``test_bridged_rectangular_and_ragged`` at a third of its size)
    "rect_ragged": lambda: (_matrix(
        2500, 4000, np.random.default_rng(2).integers(0, 2500, 12000), 3),
        1024),
    # the default bucket of 8192 rows: 9000 = 8192 + 808
    "default_bucket": lambda: (_matrix(
        9000, 9000, np.repeat(np.arange(9000), 3), 4), BUCKET),
}


def _jax(A):
    return JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)


@functools.cache
def _case(name, dtype=np.float64):
    A, bucket = CASES[name]()
    A = SparseMatrix.from_arrays(A.height, A.width, A.rowptr, A.colind,
                                 A.vals.astype(dtype))
    ref = jax_plan_bridged(_jax(A), bucket=bucket)
    x = np.random.default_rng(5).standard_normal(A.width).astype(dtype)
    return A, bucket, ref, x


@functools.cache
def _jax_seg(name):
    """The reference's routed product stream P (its ``seg``) in float64."""
    _, _, ref, x = _case(name)
    p = jax_gather_multiply(ref.gather, jnp.asarray(x), interpret=True)
    pr = -(-p.shape[0] // 128)
    p128 = jnp.pad(p, (0, pr * 128 - p.shape[0])).reshape(pr, 128)
    seg = jnp.zeros((ref.nbuckets * ref.sub * 8 + BLOCK_ROWS, 128), p.dtype)
    for dstblk, wpair, idx in ref.rounds:
        seg = ea_route_add(seg, p128[wpair], idx, dstblk, interpret=True)
    return np.array(seg[:-BLOCK_ROWS]).reshape(ref.lr.shape)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bridged_matvec_matches_pallas(case, dtype):
    """``plan_spmv(kind='bridged')`` (bucket 8192) and the plan at the
    reference plan's bucket, against the reference tier and scipy."""
    A, bucket, ref, x = _case(case, dtype)
    plan = plan_spmv(A, kind="bridged")
    assert plan.kind == "bridged" and isinstance(plan.gather, BridgedPlan)
    yj = np.asarray(ref.matvec(jnp.asarray(x), interpret=True))
    expect = A.to_scipy().astype(np.float64) @ x.astype(np.float64)
    scale = np.abs(expect).max()
    for p in (plan, plan_bridged_spmv(A, bucket=bucket)):
        y = p.matvec(torch.from_numpy(x))
        assert y.dtype == torch.float32 and y.shape == (A.height,)
        assert np.abs(y.numpy() - yj).max() <= RTOL * scale
        assert np.abs(y.numpy() - expect).max() <= RTOL * scale


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_reference_reproduces_p_and_lr(case):
    """The rebuilt route puts every product in the reference's slot: P and
    LR equal its ``seg`` and ``lr`` entry for entry, in float64."""
    A, bucket, ref, x = _case(case)
    plan = BridgedPlan.from_reference(ref)
    assert (plan.n_rows, plan.n_cols, plan.nnz, plan.nbuckets, plan.sub,
            plan.bucket, plan.precision) == (
        ref.n_rows, ref.n_cols, ref.nnz, ref.nbuckets, ref.sub, ref.bucket,
        ref.precision)
    P = stream_gather(plan, torch.from_numpy(x)).view(plan.lr.shape)
    np.testing.assert_array_equal(P.numpy(), _jax_seg(case))
    np.testing.assert_array_equal(plan.lr.numpy(), np.asarray(ref.lr))
    # the port's own layout (by row within a bucket) gives the same y
    own = plan_bridged_spmv(A, bucket=bucket)
    assert (own.nbuckets, own.sub) == (plan.nbuckets, plan.sub)
    y_ref, y_own = plan.matvec(torch.from_numpy(x)), own.matvec(
        torch.from_numpy(x))
    assert float((y_ref - y_own).abs().max()) <= RTOL * float(
        y_ref.abs().max())


@pytest.mark.parametrize("precision", ["split2", "highest", "default"])
def test_combine_alone_matches_pallas(precision):
    """K7 on the reference plan's own (P, LR).  The port sums in float32
    for every ``precision``: within 1e-5·max|y| of the exact sums.  The
    reference's 'split2' and 'highest' agree with it to the same bound;
    its one-pass bf16 'default' rounds each product to bfloat16, so it
    lies within 2⁻⁸·Σ|P| of a row's exact sum."""
    _, bucket, ref, _ = _case("square_1024")
    P = _jax_seg("square_1024")
    LR = np.array(ref.lr)
    rows = (np.arange(ref.nbuckets)[:, None] * bucket
            + LR.reshape(ref.nbuckets, -1)).reshape(-1)
    exact = np.zeros(ref.nbuckets * bucket)
    np.add.at(exact, rows, P.reshape(-1))
    absum = np.zeros_like(exact)
    np.add.at(absum, rows, np.abs(P.reshape(-1)))
    y = onehot_combine_bucketed(torch.from_numpy(P), torch.from_numpy(LR),
                                bucket=bucket, precision=precision)
    assert y.dtype == torch.float32 and y.shape == exact.shape
    yj = np.asarray(jax_combine(jnp.asarray(P), ref.lr, bucket=bucket,
                                precision=precision, interpret=True))
    scale = np.abs(exact).max()
    assert np.abs(y.numpy() - exact).max() <= RTOL * scale
    if precision == "default":
        assert np.all(np.abs(yj - exact) <= 2.0**-8 * absum + 1e-30)
    else:
        assert np.abs(y.numpy() - yj).max() <= RTOL * scale


def test_padding_slots_stay_zero_with_inf_in_x():
    """A padding slot writes 0, not 0·x[c]: with x[0] = inf and no entry
    in column 0, y stays finite (padding slots read column 0 in the plain
    version's ``clamp``)."""
    n = 1500
    rng = np.random.default_rng(6)
    A = SparseMatrix.from_coo(n, n, np.repeat(np.arange(n), 4),
                              rng.integers(1, n, 4 * n),
                              rng.standard_normal(4 * n))
    plan = plan_bridged_spmv(A, bucket=1024)
    pad = plan.cols_b < 0
    assert int(pad.sum()) == plan.slots - A.nnz > 0
    x = rng.standard_normal(n)
    x[0] = np.inf
    P = stream_gather_plain(plan, torch.from_numpy(x))
    assert torch.all(P[pad] == 0) and torch.isfinite(P).all()
    y = plan.matvec(torch.from_numpy(x))
    assert torch.isfinite(y).all()
    expect = A.to_scipy() @ np.where(np.isinf(x), 0.0, x)
    assert np.abs(y.numpy() - expect).max() <= RTOL * np.abs(expect).max()


def test_bridged_plan_layout_to_and_stream_bytes():
    A, bucket, _, x = _case("rect_ragged")
    plan = plan_spmv(A, kind="bridged")
    g = plan.gather
    assert (g.bucket, g.precision, g.nbuckets) == (BUCKET, "split2", 1)
    assert g.cols_b.dtype == g.lr.dtype == torch.int32
    assert g.lr.shape == (g.nbuckets, g.sub, 8, 128)
    assert g.slots == g.cols_b.numel() == g.vals_b.numel() >= A.nnz
    assert g.col_max == int(A.colind.max())
    assert plan.stream_bytes == g.slots * (8 + 4 + 4) + 4 * BUCKET
    f32 = plan.to(dtype=torch.float32)
    assert f32.kind == "bridged" and f32.gather.vals_b.dtype == torch.float32
    assert f32.gather.cols_b is g.cols_b and f32.gather.lr is g.lr
    assert f32.stream_bytes == g.slots * (4 + 4 + 4) + 4 * BUCKET
    y = f32.matvec(torch.from_numpy(x))
    expect = A.to_scipy() @ x.astype(np.float32).astype(np.float64)
    assert np.abs(y.numpy() - expect).max() <= RTOL * np.abs(expect).max()


def test_bridged_refusals_on_the_cpu():
    A, _, _, x = _case("square_1024")
    with pytest.raises(ValueError, match="precision"):
        plan_bridged_spmv(A, precision="bf16")
    with pytest.raises(ValueError, match="bucket"):
        plan_bridged_spmv(A, bucket=0)
    plan = plan_bridged_spmv(A, bucket=1024)
    P = stream_gather(plan, torch.from_numpy(x)).view(plan.lr.shape)
    with pytest.raises(ValueError, match="precision"):
        onehot_combine_bucketed(P, plan.lr, 1024, precision="tf32")
    with pytest.raises(TypeError):
        onehot_combine_bucketed(P, plan.lr.long(), 1024)
    with pytest.raises(ValueError, match="SUB, 8, 128"):
        onehot_combine_bucketed(P.reshape(-1), plan.lr.reshape(-1), 1024)
