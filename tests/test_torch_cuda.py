"""Tests of the port that need an NVIDIA card (and nvcc): K1-K7 and the
stream gather against their plain versions on the card, the wrappers'
refusals, and the factor, the LP, the SpMV planner (the bridged tier
included) and CG on the card against the same code on the CPU.  Every test
is marked ``cuda``
and skips without a card.  The file imports no JAX, so it also runs where
JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from elemental_tpu_torch.kernels import elementwise as ew
from elemental_tpu_torch.kernels.extend_add import (extend_add,
                                                    extend_add_plain)
from elemental_tpu_torch.kernels.matmul import (masked_rank_k_update,
                                                masked_rank_k_update_plain,
                                                matmul, matmul_plain)
from elemental_tpu_torch.kernels.spmv import (stencil_spmv,
                                              stencil_spmv_from_csr,
                                              stencil_spmv_plain)
from elemental_tpu_torch.kernels.unstructured import (
    gather_spmv, gather_spmv_plain, onehot_combine_bucketed,
    onehot_combine_bucketed_plain, plan_bridged_spmv, plan_gather_spmv,
    stream_gather, stream_gather_plain)
from elemental_tpu_torch.lapack import cg
from elemental_tpu_torch.matrices import (concat_fd_2d, sparse_laplacian_2d,
                                          sparse_laplacian_3d)
from elemental_tpu_torch.optimization import LPCtrl, lp_direct
from elemental_tpu_torch.sparse import SparseMatrix, plan_spmv
from elemental_tpu_torch.sparse_direct import (SparseLDLFactorization,
                                               analyze, build_ea_plan,
                                               nested_dissection)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(index_dtype):
    A = sparse_laplacian_3d(8, 8, 8, scaled=False)
    symb = analyze(A, perm=nested_dissection(A, cutoff=16))
    plan = build_ea_plan(symb)
    if index_dtype == torch.int64:
        plan.levels = {li: dataclasses.replace(
            lv, **{f: getattr(lv, f).astype(np.int64)
                   for f in ("udst", "offsets", "src", "dst")})
            for li, lv in plan.levels.items()}
    return symb, plan


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_kernel_matches_plain(cuda, dtype, rtol, index_dtype):
    symb, plan = _plan(index_dtype)
    plan = plan.to(cuda)
    assert next(iter(plan.levels.values())).udst.dtype == index_dtype
    g = torch.Generator(device=cuda).manual_seed(0)
    pool = torch.rand(symb.pool_size, generator=g, device=cuda, dtype=dtype)
    ref = pool.clone()
    before = extend_add.launches
    for li in sorted(plan.levels):
        extend_add(pool, plan.levels[li])
        extend_add_plain(ref, plan.levels[li])
    torch.cuda.synchronize()
    assert extend_add.launches - before == len(plan.levels)
    assert float((pool - ref).abs().max()) <= rtol * float(ref.abs().max())


def test_wrapper_refuses_bad_inputs(cuda):
    symb, plan = _plan(torch.int32)
    lv = next(iter(plan.levels.values()))
    lvc = lv.to(cuda)
    n = symb.pool_size
    with pytest.raises(TypeError):
        extend_add(torch.zeros(n, device=cuda, dtype=torch.float16), lvc)
    with pytest.raises(IndexError):
        extend_add(torch.zeros(lv.hi - 1, device=cuda), lvc)
    with pytest.raises(ValueError, match="contiguous"):
        extend_add(torch.zeros((n, 2), device=cuda)[:, 0], lvc)
    with pytest.raises(ValueError, match="different devices"):
        extend_add(torch.zeros(n, device=cuda), lv.to("cpu"))


@pytest.mark.parametrize("spd", [True, False])
def test_factor_on_card_matches_cpu(cuda, spd):
    """The facade on the card in float64 against the CPU, through K1; the
    TF32 switches are off inside the factor and restored after it."""
    A = sparse_laplacian_3d(10, 10, 10, scaled=False)
    perm = nested_dissection(A, cutoff=32)
    fc = SparseLDLFactorization(device="cpu", dtype=torch.float64, spd=spd)
    fc.initialize(A, perm=perm).factor()
    fg = SparseLDLFactorization(device=cuda, dtype=torch.float64, spd=spd)
    fg.initialize(A, perm=perm)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        before = extend_add.launches
        fg.factor()
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert extend_add.launches - before == len(fg.ea_plan.levels)
    pc, pg = fc.numeric.pool, fg.numeric.pool.cpu()
    assert float((pc - pg).abs().max()) <= 1e-12 * float(pc.abs().max())
    b = np.random.default_rng(0).standard_normal(A.height)
    x = fg.solve(b).cpu().numpy()
    r = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
    assert r < fg.residual_bound()


def test_factor_f32_has_no_tf32(cuda):
    """An f32 factor on the card solves to ~1e-7, not the ~1e-3 that TF32
    products would leave (the reference's 'highest' precision pin)."""
    A = sparse_laplacian_3d(16, 16, 16, scaled=False)
    f = SparseLDLFactorization(device=cuda, dtype=torch.float32)
    f.initialize(A, cutoff=64).factor()
    b = np.random.default_rng(1).standard_normal(A.height)
    x = f.solve(b).cpu().numpy().astype(np.float64)
    r = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
    assert r < 1e-5


def test_lp_direct_on_card_matches_cpu(cuda):
    A = concat_fd_2d(8, 8)
    rng = np.random.default_rng(0)
    b = A.to_scipy() @ (np.abs(rng.standard_normal(A.width)) + 0.1)
    c = np.abs(rng.standard_normal(A.width)) + 0.5
    ref = lp_direct(A, b, c, LPCtrl(tol=1e-9), device="cpu",
                    dtype=torch.float64)
    got = lp_direct(A, b, c, LPCtrl(tol=1e-9), device=cuda,
                    dtype=torch.float64)
    assert ref.converged and got.converged
    assert got.iterations == ref.iterations
    np.testing.assert_allclose(got.objective, ref.objective, rtol=1e-9)
    np.testing.assert_allclose(got.x, ref.x, atol=1e-7)


def _banded(n, width, offs, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offs:
        r = np.arange(max(0, -off), min(n, width - off))
        rows.append(r)
        cols.append(r + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return SparseMatrix.from_coo(n, width, rows, cols,
                                 rng.standard_normal(rows.shape[0]))


def _random_csr(n, nnzr, seed=0, width=None):
    rng = np.random.default_rng(seed)
    width = n if width is None else width
    return SparseMatrix.from_coo(n, width, np.repeat(np.arange(n), nnzr),
                                 rng.integers(0, width, n * nnzr),
                                 rng.standard_normal(n * nnzr))


TOL = [(torch.float32, 1e-5), (torch.float64, 1e-12)]


@pytest.mark.parametrize("dtype,rtol", TOL)
@pytest.mark.parametrize("case", ["laplacian_3d", "banded_rect"])
def test_stencil_kernel_matches_plain(cuda, dtype, rtol, case):
    A = (sparse_laplacian_3d(32, 32, 32, scaled=False)
         if case == "laplacian_3d" else
         _banded(3000, 3400, [-70, -1, 0, 3, 200, 2048]))
    plan = stencil_spmv_from_csr(A).to(cuda, dtype)
    x = torch.rand(A.width, generator=torch.Generator(device=cuda)
                   .manual_seed(0), device=cuda, dtype=dtype)
    before = stencil_spmv.launches
    y = stencil_spmv(plan, x)
    ref = stencil_spmv_plain(plan, x)
    torch.cuda.synchronize()
    assert stencil_spmv.launches - before == 1
    assert float((y - ref).abs().max()) <= rtol * float(ref.abs().max())
    expect = A.to_scipy() @ x.cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(y.cpu().numpy(), expect,
                               atol=10 * rtol * np.abs(expect).max())


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,rtol", TOL)
@pytest.mark.parametrize("nnzr", [1, 10, 40])
def test_gather_kernel_matches_plain(cuda, dtype, rtol, index_dtype, nnzr):
    A = _random_csr(5000, nnzr, seed=nnzr, width=6000)
    plan = plan_gather_spmv(A)
    plan = dataclasses.replace(plan, **{
        f: getattr(plan, f).to(index_dtype)
        for f in ("rowptr", "colind", "rows")}).to(cuda, dtype)
    x = torch.rand(A.width, generator=torch.Generator(device=cuda)
                   .manual_seed(0), device=cuda, dtype=dtype)
    before = gather_spmv.launches
    y = gather_spmv(plan, x)
    ref = gather_spmv_plain(plan, x)
    torch.cuda.synchronize()
    assert gather_spmv.launches - before == 1
    assert float((y - ref).abs().max()) <= rtol * float(ref.abs().max())
    y2 = gather_spmv(plan, x)
    assert torch.equal(y, y2)      # no atomics: the same bits every run


def test_spmv_wrappers_refuse_bad_inputs(cuda):
    A = sparse_laplacian_2d(16, 16, scaled=False)
    st = stencil_spmv_from_csr(A).to(cuda, torch.float32)
    x = torch.zeros(A.width, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        stencil_spmv(st.to("cpu"), x)
    with pytest.raises(TypeError):
        stencil_spmv(st, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        stencil_spmv(st, torch.zeros((A.width, 2), device=cuda)[:, 0])
    with pytest.raises(IndexError):
        stencil_spmv(st, x[:-1])

    g = plan_gather_spmv(A).to(cuda, torch.float32)
    with pytest.raises(ValueError, match="different devices"):
        gather_spmv(g.to("cpu"), x)
    with pytest.raises(TypeError):
        gather_spmv(g.to(dtype=torch.float16), x)
    with pytest.raises(ValueError, match="contiguous"):
        gather_spmv(g, torch.zeros((A.width, 2), device=cuda)[:, 0])
    with pytest.raises(IndexError):
        gather_spmv(g, x[:-1])
    with pytest.raises(IndexError):
        gather_spmv(dataclasses.replace(g, n_cols=g.col_max), x[:g.col_max])


def _scrambled_banded(n=2048, bw=6, seed=1):
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    offs = list(range(-bw, bw + 1))
    S = sp.diags([rng.standard_normal(n) for _ in offs], offs, shape=(n, n),
                 format="csr")
    S = S + S.T
    p = rng.permutation(n)
    return SparseMatrix.from_scipy(S[p][:, p].tocsr())


@pytest.mark.parametrize("case,kind", [
    ("laplacian", "stencil"), ("scrambled", "stencil_rcm"),
    ("random", "gather_csr"), ("random_plain", "csr")])
def test_plan_spmv_on_card_launches_kernels(cuda, case, kind):
    A = {"laplacian": lambda: sparse_laplacian_2d(40, 40, scaled=False),
         "scrambled": _scrambled_banded,
         "random": lambda: _random_csr(4096, 10),
         "random_plain": lambda: _random_csr(4096, 10)}[case]()
    host = plan_spmv(A, pallas_gather=case != "random_plain")
    assert host.kind == kind
    plan = host.to(cuda, torch.float64)
    x = np.random.default_rng(2).standard_normal(A.width)
    counts = (stencil_spmv.launches, gather_spmv.launches)
    y = plan.matvec(torch.from_numpy(plan.to_plan_space(x)).to(cuda))
    launched = (stencil_spmv.launches - counts[0],
                gather_spmv.launches - counts[1])
    assert launched == {"stencil": (1, 0), "stencil_rcm": (1, 0),
                        "gather_csr": (0, 1), "csr": (0, 0)}[kind]
    y = plan.from_plan_space(y.cpu().numpy())
    expect = plan.from_plan_space(host.matvec(
        torch.from_numpy(host.to_plan_space(x))).numpy())
    np.testing.assert_allclose(y, expect, rtol=1e-12, atol=1e-12)


def test_cg_on_card_matches_cpu(cuda):
    A = sparse_laplacian_2d(32, 32, scaled=False)
    host = plan_spmv(A)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.height))
    ref = cg(host.matvec, b, tol=1e-10, max_iters=5000)
    plan = host.to(cuda, torch.float64)
    before = stencil_spmv.launches
    got = cg(plan.matvec, b.to(cuda), tol=1e-10, max_iters=5000)
    assert stencil_spmv.launches - before == got.iterations + 1
    assert got.iterations == ref.iterations
    np.testing.assert_allclose(got.x.cpu().numpy(), ref.x.numpy(),
                               atol=1e-9)


# -- the bridged tier: the stream gather and K7 ------------------------------

def _bridged(A, bucket, index_dtype, device, dtype):
    plan = plan_bridged_spmv(A, bucket=bucket)
    plan = dataclasses.replace(plan, cols_b=plan.cols_b.to(index_dtype))
    return plan.to(device, dtype)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bucket", [1024, 8192, 16384])
def test_bridged_kernels_match_plain(cuda, dtype, index_dtype, bucket):
    """The stream gather equals its plain version exactly (one product a
    slot); K7 sums in float32 in no fixed order: within 1e-5·max|y| of
    ``index_add_`` (16384 rows take 64 KiB of dynamic shared memory)."""
    A = _random_csr(20000, 7, seed=3, width=23000)
    plan = _bridged(A, bucket, index_dtype, cuda, dtype)
    assert plan.cols_b.dtype == index_dtype and plan.nbuckets >= 2
    x = torch.rand(A.width, generator=torch.Generator(device=cuda)
                   .manual_seed(0), device=cuda, dtype=dtype)
    counts = (stream_gather.launches, onehot_combine_bucketed.launches)
    P = stream_gather(plan, x)
    assert torch.equal(P, stream_gather_plain(plan, x))
    P = P.view(plan.lr.shape)
    y = onehot_combine_bucketed(P, plan.lr, bucket=bucket)
    ref = onehot_combine_bucketed_plain(P, plan.lr, bucket)
    torch.cuda.synchronize()
    assert (stream_gather.launches - counts[0],
            onehot_combine_bucketed.launches - counts[1]) == (1, 1)
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    expect = A.to_scipy() @ x.cpu().numpy().astype(np.float64)
    got = plan.matvec(x).cpu().numpy()
    assert np.abs(got - expect).max() <= 1e-5 * np.abs(expect).max()


def test_bridged_padding_with_inf_in_x(cuda):
    rng = np.random.default_rng(6)
    n = 3000
    A = SparseMatrix.from_coo(n, n, np.repeat(np.arange(n), 4),
                              rng.integers(1, n, 4 * n),
                              rng.standard_normal(4 * n))
    plan = plan_bridged_spmv(A, bucket=1024).to(cuda, torch.float32)
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda, torch.float32)
    x[0] = float("inf")
    P = stream_gather(plan, x)
    assert torch.all(P[plan.cols_b < 0] == 0)
    assert torch.isfinite(plan.matvec(x)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_spmv_bridged_on_card(cuda, dtype):
    """One stream-gather and one K7 launch per matvec; y (float32 for
    either plan dtype) within 1e-5·max|y| of the host plan's."""
    A = _random_csr(20000, 10, seed=4)
    host = plan_spmv(A, kind="bridged")
    plan = host.to(cuda, dtype)
    x = np.random.default_rng(2).standard_normal(A.width)
    counts = (stream_gather.launches, onehot_combine_bucketed.launches,
              gather_spmv.launches)
    y = plan.matvec(torch.from_numpy(x).to(cuda))
    torch.cuda.synchronize()
    assert (stream_gather.launches - counts[0],
            onehot_combine_bucketed.launches - counts[1],
            gather_spmv.launches - counts[2]) == (1, 1, 0)
    assert y.dtype == torch.float32
    expect = host.matvec(torch.from_numpy(x)).numpy()
    assert np.abs(y.cpu().numpy() - expect).max() <= 1e-5 * np.abs(
        expect).max()


def test_bridged_wrappers_refuse_bad_inputs(cuda):
    A = _random_csr(3000, 5)
    plan = plan_bridged_spmv(A, bucket=1024).to(cuda, torch.float32)
    x = torch.zeros(A.width, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        stream_gather(plan.to("cpu"), x)
    with pytest.raises(TypeError):
        stream_gather(plan.to(dtype=torch.float16), x)
    with pytest.raises(ValueError, match="contiguous"):
        stream_gather(plan, torch.zeros((A.width, 2), device=cuda)[:, 0])
    with pytest.raises(IndexError):
        stream_gather(plan, x[:-1])
    with pytest.raises(IndexError):
        stream_gather(dataclasses.replace(plan, n_cols=plan.col_max),
                      x[:plan.col_max])
    P = stream_gather(plan, x).view(plan.lr.shape)
    with pytest.raises(ValueError, match="different devices"):
        onehot_combine_bucketed(P, plan.lr.cpu(), 1024)
    with pytest.raises(TypeError):
        onehot_combine_bucketed(P.half(), plan.lr, 1024)
    with pytest.raises(TypeError):
        onehot_combine_bucketed(P, plan.lr.long(), 1024)
    with pytest.raises(ValueError, match="contiguous"):
        onehot_combine_bucketed(P.transpose(2, 3).contiguous().transpose(
            2, 3), plan.lr, 1024)
    with pytest.raises(ValueError, match="bucket"):
        onehot_combine_bucketed(P, plan.lr, 10**6)


# -- K4 and K5 ---------------------------------------------------------------

def _bits(t):
    """``t``'s bits as integers, for bit-for-bit comparisons."""
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.fixture
def no_tf32():
    """The plain versions' cuBLAS products in full float32 (no TF32) and
    with float32 sums for bfloat16 (no reduced-precision reduction)."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = False
    yield
    m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


# against max|C|: float32 1e-5, float64 1e-12 (both sums in their own type,
# in another order); bfloat16 2⁻⁷, one bfloat16 rounding of the output on
# either side
MM_TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 2.0**-7}
MM_SHAPES = [(96, 40, 72), (1, 1, 1), (130, 257, 129), (256, 128, 384)]


@pytest.mark.parametrize("shape", MM_SHAPES)
@pytest.mark.parametrize("dtype", sorted(MM_TOL, key=str))
def test_matmul_kernel_matches_plain(cuda, no_tf32, dtype, shape):
    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    b = torch.randn(k, n, generator=g, device=cuda).to(dtype)
    before = matmul.launches
    c = matmul(a, b)
    ref = matmul_plain(a, b)
    torch.cuda.synchronize()
    assert matmul.launches - before == 1
    assert c.dtype == dtype and c.shape == (m, n)
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    assert float((c.double() - ref.double()).abs().max()) <= \
        MM_TOL[dtype] * scale
    assert float((c.double() - exact).abs().max()) <= \
        (2.0**-8 + 1e-5 if dtype == torch.bfloat16 else MM_TOL[dtype]) * scale


@pytest.mark.parametrize("shape", [(96, 40, 72), (300, 17, 200),
                                   (200, 64, 300)])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_rank_k_update_kernel_matches_plain(cuda, no_tf32, dtype,
                                                   lower, shape):
    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    c = torch.randn(m, n, generator=g, device=cuda, dtype=dtype)
    a = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    b = torch.randn(k, n, generator=g, device=cuda, dtype=dtype)
    before = masked_rank_k_update.launches
    out = masked_rank_k_update(c, a, b, alpha=-0.75, lower=lower)
    ref = masked_rank_k_update_plain(c, a, b, alpha=-0.75, lower=lower)
    torch.cuda.synchronize()
    assert masked_rank_k_update.launches - before == 1
    rows = torch.arange(m, device=cuda)[:, None]
    cols = torch.arange(n, device=cuda)[None, :]
    mask = rows >= cols if lower else rows <= cols
    assert torch.equal(_bits(out)[~mask], _bits(c)[~mask])
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


def test_dense_wrappers_refuse_bad_inputs(cuda):
    a = torch.zeros(8, 4, device=cuda)
    b = torch.zeros(4, 6, device=cuda)
    c = torch.zeros(8, 6, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        matmul(a, b.cpu())
    with pytest.raises(TypeError):
        matmul(a.half(), b.half())
    with pytest.raises(TypeError):
        matmul(a, b.double())
    with pytest.raises(ValueError, match="contiguous"):
        matmul(torch.zeros(4, 8, device=cuda).t(), b)
    with pytest.raises(ValueError, match="do not multiply"):
        matmul(a, c)
    with pytest.raises(ValueError, match="different devices"):
        masked_rank_k_update(c.cpu(), a, b)
    with pytest.raises(TypeError):
        masked_rank_k_update(c.bfloat16(), a.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        masked_rank_k_update(torch.zeros(6, 8, device=cuda).t(), a, b)
    with pytest.raises(ValueError, match="is not"):
        masked_rank_k_update(c[:4], a, b)


# -- K6 ----------------------------------------------------------------------

EW_DTYPES = [torch.float32, torch.float64, torch.bfloat16]


def _ew_case(op, x, y, dtype, plain):
    f = {"axpy": lambda: (ew.axpy_plain if plain else ew.axpy)(1.7, x, y),
         "scale": lambda: (ew.scale_plain if plain else ew.scale)(-0.3, x),
         "hadamard": lambda: (ew.hadamard_plain if plain else ew.hadamard)(
             x, y),
         "copy": lambda: (ew.copy_plain if plain else ew.copy)(x),
         "transpose": lambda: (ew.transpose_plain if plain
                               else ew.transpose)(x),
         "fill": lambda: (ew.fill_plain if plain else ew.fill)(
             tuple(x.shape), 1.1, dtype, device=x.device)}
    return f[op]()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", [(24, 200), (1, 1), (37, 5), (512, 1000)])
@pytest.mark.parametrize("dtype", EW_DTYPES)
@pytest.mark.parametrize("op", ["axpy", "scale", "hadamard", "copy", "fill",
                                "transpose"])
def test_elementwise_kernels_match_plain(cuda, op, dtype, shape, aligned):
    """copy, fill and transpose equal the plain version bit for bit; the
    arithmetic ops lie within one rounding of the largest term in the
    dtype, eps·(|y| + |α·x|) (axpy fuses its multiply-add, the plain
    version may not).  ``aligned=False`` offsets every pointer by one
    element, off the 16-byte packs."""
    m, n = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    off = 0 if aligned else 1

    def operand():
        flat = torch.randn(m * n + off, generator=g, device=cuda).to(dtype)
        return flat[off:].view(m, n)

    x, y = operand(), operand()
    counter = getattr(ew, op)
    before = counter.launches
    got = _ew_case(op, x, y, dtype, plain=False)
    ref = _ew_case(op, x, y, dtype, plain=True)
    torch.cuda.synchronize()
    assert counter.launches - before == 1
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.is_contiguous()
    if op in ("copy", "fill", "transpose"):
        assert torch.equal(_bits(got), _bits(ref))
        return
    xd, yd = x.double(), y.double()
    size = {"axpy": yd.abs() + (1.7 * xd).abs(), "scale": (0.3 * xd).abs(),
            "hadamard": (xd * yd).abs()}[op]
    eps = torch.finfo(dtype).eps
    assert bool(((got.double() - ref.double()).abs() <= eps * size).all())


def test_elementwise_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros(8, 6, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        ew.axpy(1.0, x, x.cpu())
    with pytest.raises(TypeError):
        ew.hadamard(x, x.double())
    with pytest.raises(TypeError):
        ew.copy(x.half())
    with pytest.raises(TypeError):
        ew.fill((8, 6), 1.0, torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ew.scale(2.0, torch.zeros(6, 8, device=cuda).t())
    with pytest.raises(ValueError, match="contiguous"):
        ew.transpose(torch.zeros(8, 6, 2, device=cuda)[..., 0])
    with pytest.raises(ValueError, match="differ"):
        ew.axpy(1.0, x, x[:4])
    with pytest.raises(ValueError, match="2-D"):
        ew.fill((8,), 1.0, device=cuda)
