"""Parity of the port's bridged SpMV tier (``plan_spmv(kind='bridged')``:
the stream gather and the bucketed combine K7, through their plain
versions) with the JAX package's bridged tier in Pallas interpret mode, as
``tests/sparse/test_bridged.py`` runs it, and with scipy, on the CPU.

Tolerances: y within 1e-5·max|y| of the JAX tier and of scipy, the bound of
``test_bridged.py:29`` (both sum in float32); the rebuilt slot layout
exactly.  The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py``.
"""

import dataclasses
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
    BUCKET, TILE, BridgedPlan, _make_bridged, combine_in_plan_order,
    onehot_combine_bucketed, onehot_combine_bucketed_plain, plan_bridged_spmv,
    plan_combine, stream_gather, stream_gather_plain)
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


def _expected_plan(lr, keep, bucket):
    """K7's summation plan by numpy: per bucket, the summed slots stably
    sorted by local row, and each row's offsets into that list."""
    nb = lr.shape[0]
    lr, keep = lr.reshape(nb, -1), keep.reshape(nb, -1)
    key = np.where(keep & (lr >= 0) & (lr < bucket), lr, bucket)
    order = np.argsort(key, axis=1, kind="stable")
    offsets = np.stack([np.searchsorted(np.sort(k), np.arange(bucket + 1))
                        for k in key])
    return order, offsets, (key < bucket).sum(1)


def _shuffled(plan, seed):
    """``plan`` with its slots shuffled within each bucket (numpy)."""
    nb, per = plan.nbuckets, plan.sub * TILE
    rng = np.random.default_rng(seed)
    perm = (np.argsort(rng.random((nb, per)), axis=1)
            + per * np.arange(nb)[:, None]).reshape(-1)
    return _make_bridged(plan.n_rows, plan.n_cols, plan.nnz, plan.bucket,
                         plan.precision, plan.cols_b.numpy()[perm],
                         plan.vals_b.numpy()[perm],
                         plan.lr.numpy().reshape(-1)[perm].reshape(
                             plan.lr.shape))


def _layouts(case):
    """The three slot layouts of a case: the port's own (rows in order),
    the reference's route order, and the port's shuffled."""
    A, bucket, ref, _ = _case(case)
    own = plan_bridged_spmv(A, bucket=bucket)
    return {"own": own, "reference": BridgedPlan.from_reference(ref),
            "shuffled": _shuffled(own, 7)}


@pytest.mark.parametrize("layout", ["own", "reference", "shuffled"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_combine_plan_is_a_stable_sort_of_lr(case, layout):
    """The summation plan's offsets and order are a stable sort of LR
    within each bucket, padding left out; the port's own layout needs no
    order (the identity), the other two carry one."""
    plan = _layouts(case)[layout]
    cp = plan.combine
    assert (cp.nbuckets, cp.per_bucket, cp.bucket) == (
        plan.nbuckets, plan.sub * TILE, plan.bucket)
    assert cp.offsets.dtype == torch.int32
    assert cp.offsets.shape == (plan.nbuckets, plan.bucket + 1)
    keep = plan.cols_b.numpy() >= 0
    order, offsets, summed = _expected_plan(plan.lr.numpy(), keep,
                                            plan.bucket)
    np.testing.assert_array_equal(cp.offsets.numpy(), offsets)
    assert int(summed.sum()) == plan.nnz
    if layout == "own":
        assert cp.order is None
        for b, n in enumerate(summed):
            np.testing.assert_array_equal(order[b, :n], np.arange(n))
    else:
        assert cp.order is not None and cp.order.dtype == torch.int32
        for b, n in enumerate(summed):
            np.testing.assert_array_equal(cp.order.numpy()[b, :n],
                                          order[b, :n])


def test_combine_plan_of_plan_spmv_is_the_identity():
    A, _, _, _ = _case("default_bucket")
    g = plan_spmv(A, kind="bridged").gather
    assert g.combine.order is None and g.combine.bucket == BUCKET
    moved = g.to(dtype=torch.float32)
    assert moved.combine.offsets is g.combine.offsets


@pytest.mark.parametrize("layout", ["own", "reference", "shuffled"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_combine_in_plan_order_matches_pallas_highest(case, layout):
    """K7's sums in its fixed order (``combine_in_plan_order``, the
    kernel's bits) against the JAX ``onehot_combine_bucketed`` in interpret
    mode at precision 'highest' on the same (P, LR): within 1e-5·max|y|
    (both sum in float32, in different orders), and bit-equal to the order
    written out row by row (``_sums_in_order``).  The plan built from LR
    alone (padding included, as the wrapper builds it without one) gives
    the same bits on the port's own layout, where each bucket's padding
    (+0, local row 0) follows row 0's products; elsewhere it moves row 0's
    chunks, so it agrees to the tolerance."""
    _, _, _, x = _case(case)
    plan = _layouts(case)[layout]
    P = stream_gather(plan, torch.from_numpy(x)).view(plan.lr.shape)
    y = combine_in_plan_order(P, plan.combine)
    yj = np.asarray(jax_combine(jnp.asarray(P.numpy()),
                                jnp.asarray(plan.lr.numpy()),
                                bucket=plan.bucket, precision="highest",
                                interpret=True))
    assert y.dtype == torch.float32 and y.shape == yj.shape
    scale = np.abs(yj).max()
    assert np.abs(y.numpy() - yj).max() <= RTOL * scale
    assert np.array_equal(y.numpy().view(np.int32),
                          _sums_in_order(P.numpy(), plan.combine)
                          .view(np.int32))
    bare = combine_in_plan_order(P, plan_combine(plan.lr, plan.bucket))
    if layout == "own":
        assert torch.equal(bare.view(torch.int32), y.view(torch.int32))
    else:
        assert float((bare - y).abs().max()) <= RTOL * scale
    plain = onehot_combine_bucketed_plain(P, plan.lr, plan.bucket)
    assert float((plain - y).abs().max()) <= RTOL * scale


def _sums_in_order(P, cp):
    """K7's order written out row by row in numpy float32: a row's products
    in plan order, in chunks of 8 from its first, each chunk added left to
    right from +0, then the chunk sums pairwise (a lone last one passes
    up)."""
    nb, per = cp.nbuckets, cp.per_bucket
    p = P.reshape(nb, per).astype(np.float32)
    if cp.order is not None:
        p = np.take_along_axis(p, cp.order.numpy().astype(np.int64), 1)
    off = cp.offsets.numpy()
    y = np.zeros(nb * cp.bucket, np.float32)
    for b in range(nb):
        for r in np.nonzero(np.diff(off[b]))[0]:
            v = p[b, off[b, r]:off[b, r + 1]]
            sums = []
            for c in range(0, v.size, 8):
                acc = np.float32(0)
                for t in v[c:c + 8]:
                    acc = np.float32(acc + t)
                sums.append(acc)
            while len(sums) > 1:
                sums = [np.float32(sums[i] + sums[i + 1])
                        if i + 1 < len(sums) else sums[i]
                        for i in range(0, len(sums), 2)]
            y[b * cp.bucket + r] = sums[0]
    return y


@functools.cache
def _long_rows():
    """(P, LR) of two buckets of 1024 rows and 4·1024 slots with rows of
    every tier of K7: local row 5 of bucket 0 takes 2,500 slots (a block),
    row 9 takes 700 and row 1000 of bucket 1 takes 40 (a warp), the rest
    fall at random; 5 % of the products are zero."""
    rng = np.random.default_rng(12)
    lr = rng.integers(0, 1024, (2, 4 * TILE))
    lr[0, rng.permutation(4 * TILE)[:3200]] = np.repeat([5, 9], [2500, 700])
    lr[1, rng.permutation(4 * TILE)[:40]] = 1000
    P = rng.standard_normal((2, 4, 8, 128)).astype(np.float32)
    P.reshape(-1)[rng.random(P.size) < 0.05] = 0.0
    return P, lr.astype(np.int32).reshape(2, 4, 8, 128)


@pytest.mark.parametrize("sorted_slots", [False, True])
def test_combine_in_plan_order_long_rows(sorted_slots):
    """Rows long enough for K7's warp and block tiers: the plan lists them
    (``warp_rows``, ``block_rows``), and the plan-order sums are bit-equal
    to the order written out row by row and within 1e-5·max|y| of the JAX
    kernel at 'highest'; on slots already in row order the plan needs no
    permutation and gives the same bits."""
    P, lr = _long_rows()
    if sorted_slots:
        idx = np.argsort(lr.reshape(2, -1), axis=1, kind="stable")
        P = np.take_along_axis(P.reshape(2, -1), idx, 1).reshape(P.shape)
        lr = np.take_along_axis(lr.reshape(2, -1), idx, 1).reshape(lr.shape)
    LR = torch.from_numpy(lr)
    cp = plan_combine(LR, 1024)
    assert (cp.order is None) == sorted_slots
    assert cp.block_rows.tolist() == [5]
    assert 9 in cp.warp_rows.tolist() and 1024 + 1000 in cp.warp_rows.tolist()
    length = np.diff(cp.offsets.numpy(), axis=1).reshape(-1)
    np.testing.assert_array_equal(
        cp.warp_rows.numpy(), np.nonzero((length > 32) & (length <= 2048))[0])
    y = combine_in_plan_order(torch.from_numpy(P), cp)
    expect = _sums_in_order(P, cp)
    assert np.array_equal(y.numpy().view(np.int32), expect.view(np.int32))
    yj = np.asarray(jax_combine(jnp.asarray(P), jnp.asarray(lr), bucket=1024,
                                precision="highest", interpret=True))
    assert np.abs(y.numpy() - yj).max() <= RTOL * np.abs(yj).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_shuffled_layout_matvec_matches_scipy(case):
    A, _, _, x = _case(case)
    plan = _layouts(case)["shuffled"]
    expect = A.to_scipy().astype(np.float64) @ x
    y = plan.matvec(torch.from_numpy(x))
    assert np.abs(y.numpy() - expect).max() <= RTOL * np.abs(expect).max()


def test_combine_plan_skips_rows_outside_the_bucket():
    """Local rows outside [0, bucket) are left out of the plan; a row with
    no product is exactly +0."""
    LR = torch.zeros(2, 1, 8, 128, dtype=torch.int32)
    LR.view(2, -1)[0, :6] = torch.tensor([3, -1, 3, 1024, 0, 5])
    P = torch.zeros(2, 1, 8, 128)
    P.view(2, -1)[0, :6] = torch.tensor([1.0, 2.0, 4.0, 8.0, -0.0, 16.0])
    P.view(2, -1)[1, 0] = 32.0
    cp = plan_combine(LR, 1024)
    assert int(cp.offsets[0, -1]) == 1024 - 2 and int(cp.offsets[1, -1]) \
        == 1024
    y = combine_in_plan_order(P, cp)
    expect = torch.zeros(2048)
    expect[3], expect[5], expect[1024] = 5.0, 16.0, 32.0
    assert torch.equal(y.view(torch.int32), expect.view(torch.int32))


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
    with pytest.raises(ValueError, match="the plan is for"):
        onehot_combine_bucketed(P, plan.lr, 512, plan=plan.combine)
    with pytest.raises(TypeError, match="int32"):
        onehot_combine_bucketed(P, plan.lr, 1024, plan=dataclasses.replace(
            plan.combine, offsets=plan.combine.offsets.long()))
    # a plan is bound to the LR it was built from, and checked when built
    other = plan.lr.clone()
    with pytest.raises(ValueError, match="another LR"):
        onehot_combine_bucketed(P, other, 1024, plan=plan.combine)
    off = plan.combine.offsets.clone()
    off[0, -1] = plan.combine.per_bucket + 1
    with pytest.raises(ValueError, match="offsets must rise"):
        dataclasses.replace(plan.combine, offsets=off)
    off = plan.combine.offsets.clone()
    off[1, 1:3] = torch.tensor([5, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="offsets must rise"):
        dataclasses.replace(plan.combine, offsets=off)
    order = torch.zeros(plan.nbuckets, plan.combine.per_bucket,
                        dtype=torch.int32)
    order[0, 3] = plan.combine.per_bucket
    with pytest.raises(ValueError, match="order must name"):
        dataclasses.replace(plan.combine, order=order)
