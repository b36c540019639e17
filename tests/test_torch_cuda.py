"""Tests of the port that need an NVIDIA card (and nvcc): K1-K7 and the
stream gather against their plain versions on the card, the wrappers'
refusals, and the factor, the LP, the SpMV planner (the bridged tier
included), CG, the dense core, the sparse products, a distributed matvec
and a conic driver on the card against the same code on the CPU or the
library call.  Every test
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
from elemental_tpu_torch.kernels.extend_add import (RUN_BLOCK, extend_add,
                                                    extend_add_plain)
from elemental_tpu_torch.kernels.matmul import (_matmul_path, _rank_k_path,
                                                _run_matmul, _run_rank_k,
                                                masked_rank_k_update,
                                                masked_rank_k_update_plain,
                                                matmul, matmul_plain)
from elemental_tpu_torch.kernels.spmv import (stencil_spmv,
                                              stencil_spmv_from_csr,
                                              stencil_spmv_plain)
from elemental_tpu_torch.kernels.unstructured import (
    _make_bridged, combine_in_plan_order, gather_spmv, gather_spmv_plain,
    onehot_combine_bucketed, onehot_combine_bucketed_plain, plan_bridged_spmv,
    plan_combine, plan_gather_spmv, stream_gather, stream_gather_plain)
from elemental_tpu_torch.lapack import cg
from elemental_tpu_torch.matrices import (concat_fd_2d, sparse_laplacian_2d,
                                          sparse_laplacian_3d)
from elemental_tpu_torch.optimization import LPCtrl, lp_direct
from elemental_tpu_torch.optimization.lp import _build_lp_kkt, sparse_ruiz
from elemental_tpu_torch.sparse import SparseMatrix, plan_spmv
from elemental_tpu_torch.sparse_direct import (EAPlan,
                                               SparseLDLFactorization,
                                               analyze, build_ea_plan,
                                               nested_dissection)
from elemental_tpu_torch.sparse_direct.ea_plan import (INDEX_FIELDS,
                                                       build_ea_level)

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
            lv, **{f: getattr(lv, f).astype(np.int64) for f in INDEX_FIELDS})
            for li, lv in plan.levels.items()}
    return symb, plan


# K1's dtypes and its tolerance against index_add_ (summation order only)
K1_TOL = [(torch.float32, 1e-5), (torch.float64, 1e-12),
          (torch.complex64, 1e-5), (torch.complex128, 1e-12)]


def _ea_case(case, cuda):
    """(pool size, plan on the card) of a K1 test plan."""
    if case == "laplacian_8":
        symb, plan = _plan(torch.int32)
        return symb.pool_size, plan.to(cuda)
    if case == "kkt_fd_8":
        kkt, _ = _build_lp_kkt(sparse_ruiz(concat_fd_2d(8, 8))[0], 1e-2,
                               1e-2, None, device=cuda, dtype=torch.float64)
        return kkt.symb.pool_size, kkt.ea_plan
    rng = np.random.default_rng(7)
    n = 3 * RUN_BLOCK + 17
    if case == "single_pair_runs":     # no two pairs continue each other
        dst, src = n + rng.permutation(n), rng.permutation(n)
    else:                              # long runs cut by multi-source pairs
        dst = np.concatenate([n + np.arange(n), n + np.arange(0, n, 7)])
        src = np.concatenate([np.arange(n), rng.integers(0, n, -(-n // 7))])
    lv = build_ea_level(dst, src, n, 2 * n, 2 * n)
    assert case != "single_pair_runs" or lv.n_runs == n
    return 2 * n, EAPlan({0: lv}, 2 * n).to(cuda)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,rtol", K1_TOL)
@pytest.mark.parametrize("case", ["laplacian_8", "kkt_fd_8",
                                  "single_pair_runs", "runs_and_multi"])
def test_kernel_run_plan_is_bit_stable(cuda, case, dtype, rtol,
                                       index_dtype):
    """K1 over every level of the plan against ``index_add_``, and two
    runs from the same pool bit-equal (no atomics)."""
    pool_size, plan = _ea_case(case, cuda)
    levels = [dataclasses.replace(lv, **{
        f: getattr(lv, f).to(index_dtype) for f in INDEX_FIELDS})
        for _, lv in sorted(plan.levels.items())]
    g = torch.Generator(device=cuda).manual_seed(1)
    pool0 = torch.rand(pool_size, generator=g, device=cuda, dtype=dtype)
    runs = []
    for _ in range(2):
        pool = pool0.clone()
        before = extend_add.launches
        for lv in levels:
            extend_add(pool, lv)
        assert extend_add.launches - before == len(levels)
        runs.append(pool)
    ref = pool0.clone()
    for lv in levels:
        extend_add_plain(ref, lv)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert float((runs[0] - ref).abs().max()) <= rtol * float(
        ref.abs().max())


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,rtol", K1_TOL)
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
    products would leave (the reference's 'highest' precision pin); so does
    a complex64 one (cgemm is subject to the same math mode)."""
    A = sparse_laplacian_3d(16, 16, 16, scaled=False)
    Ac = dataclasses.replace(A, vals=A.vals * (1 + 0.5j))
    for M, dtype in ((A, torch.float32), (Ac, torch.complex64)):
        f = SparseLDLFactorization(device=cuda, dtype=dtype)
        f.initialize(M, cutoff=64).factor()
        b = np.random.default_rng(1).standard_normal(M.height)
        x = f.solve(b).cpu().numpy().astype(np.complex128)
        r = np.linalg.norm(M.to_scipy() @ x - b) / np.linalg.norm(b)
        assert r < 1e-5, (dtype, r)


def _magnetic(n1, n2, sigma):
    """The unscaled grid Laplacian in the Landau gauge (flux 1/8 a
    plaquette), minus sigma on the diagonal: Hermitian."""
    A = sparse_laplacian_2d(n1, n2, scaled=False)
    r, c = A.row_ids(), A.colind
    phase = np.exp(2j * np.pi / 8 * (r % n2))
    v = A.vals.astype(np.complex128)
    v = np.where(c - r == n2, v * phase, v)
    v = np.where(r - c == n2, v * phase.conj(), v)
    return dataclasses.replace(A, vals=np.where(r == c, v - sigma, v))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", ["helmholtz", "hermitian", "hpd"])
def test_complex_factor_on_card_matches_cpu(cuda, case, dtype):
    """Complex-symmetric LDLᵀ, Hermitian LDLᴴ and HPD Cholesky on the card
    through K1's complex instantiations, against the same factor on the
    CPU: in complex128 to 1e-12 of max|pool|; in complex64 the card's pool
    is held to the CPU's complex128 pool within four times the CPU complex64
    pool's own distance from it (plus 1e-6 of max|pool|): the indefinite
    Hermitian factor already loses most of complex64's digits on the CPU,
    and the card's rounding differs.  Then the solve, the solve through
    the panel inverses (conj(L⁻ᵀ) backward) and the refined solve against
    the matrix."""
    from elemental_tpu_torch.matrices import sparse_helmholtz_2d
    from elemental_tpu_torch.sparse_direct import natural_nested_dissection
    if case == "helmholtz":
        A = sparse_helmholtz_2d(24, 20, 900.0 * (1 + 0.05j))
    else:
        A = _magnetic(24, 20, 1.3 if case == "hermitian" else 0.0)
    herm, spd = case != "helmholtz", case == "hpd"
    perm = natural_nested_dissection((24, 20))
    fc = SparseLDLFactorization(device="cpu", dtype=dtype, spd=spd)
    fc.initialize(A, hermitian=herm, perm=perm).factor()
    fg = SparseLDLFactorization(device=cuda, dtype=dtype, spd=spd)
    fg.initialize(A, hermitian=herm, perm=perm)
    before = extend_add.launches
    fg.factor()
    assert extend_add.launches - before == len(fg.ea_plan.levels) > 0
    pc, pg = fc.numeric.pool, fg.numeric.pool.cpu()
    assert pg.dtype == dtype
    if dtype == torch.complex128:
        assert float((pc - pg).abs().max()) <= 1e-12 * float(
            pc.abs().max())
    else:
        f128 = SparseLDLFactorization(device="cpu", dtype=torch.complex128,
                                      spd=spd)
        ref = f128.initialize(A, hermitian=herm, perm=perm).factor()\
            .numeric.pool
        cpu_err = float((pc.to(ref.dtype) - ref).abs().max())
        card_err = float((pg.to(ref.dtype) - ref).abs().max())
        assert card_err <= 4 * cpu_err + 1e-6 * float(ref.abs().max())
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.height) + 1j * rng.standard_normal(A.height)
    S = A.to_scipy()
    num = fg.numeric
    for x in (num.solve(b), num.solve(b, num.solve_context()),
              fg.solve_with_iterative_refinement(b, iters=2)):
        x = x.cpu().numpy().astype(np.complex128)
        r = np.linalg.norm(S @ x - b) / np.linalg.norm(b)
        assert r < fg.residual_bound(), (case, dtype, r)


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
        for f in ("rowptr", "colind", "rows", "split", "fix")}).to(cuda,
                                                                  dtype)
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


def _csr_of_lengths(lengths, width=3000, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    rows = np.repeat(np.arange(lengths.size), lengths)
    return SparseMatrix.from_coo(lengths.size, width, rows,
                                 rng.integers(0, width, rows.size),
                                 rng.standard_normal(rows.size))


GATHER_SHAPES = {
    "empty_rows": lambda rng: np.where(rng.random(4000) < 0.4, 0,
                                       rng.integers(1, 30, 4000)),
    "empty_ends": lambda rng: [0] * 700 + [5] * 2000 + [0] * 900,
    "long_row": lambda rng: [3] * 200 + [100_000] + [0, 2] * 150,
    "straddling": lambda rng: [255, 257, 513, 1, 767, 256, 2, 1023] * 20,
    "one_row": lambda rng: [37],
    "one_entry": lambda rng: [0, 0, 1, 0],
    "no_entries": lambda rng: [0] * 300,
}


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,rtol", TOL)
@pytest.mark.parametrize("case", sorted(GATHER_SHAPES))
def test_gather_kernel_row_shapes(cuda, case, dtype, rtol, index_dtype):
    """K2 on rows that stress the nnz-balanced shares (empty rows, rows
    longer than many shares, rows across share boundaries, a single row or
    entry, no entries): against the plain version, exactly 0 on empty
    rows, and two runs bit-equal."""
    A = _csr_of_lengths(GATHER_SHAPES[case](np.random.default_rng(3)))
    plan = plan_gather_spmv(A)
    plan = dataclasses.replace(plan, **{
        f: getattr(plan, f).to(index_dtype)
        for f in ("rowptr", "colind", "rows", "split", "fix")}).to(cuda,
                                                                  dtype)
    x = torch.rand(A.width, generator=torch.Generator(device=cuda)
                   .manual_seed(0), device=cuda, dtype=dtype)
    before = gather_spmv.launches
    y = gather_spmv(plan, x)
    y2 = gather_spmv(plan, x)
    ref = gather_spmv_plain(plan, x)
    torch.cuda.synchronize()
    assert gather_spmv.launches - before == 2
    assert torch.equal(y, y2)
    empty = torch.from_numpy(np.diff(A.rowptr) == 0).to(cuda)
    assert torch.equal(y[empty], torch.zeros_like(y[empty]))
    scale = max(float(ref.abs().max()), 1.0)
    assert float((y - ref).abs().max()) <= rtol * scale


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
    with pytest.raises(ValueError, match="aligned"):
        gather_spmv(dataclasses.replace(
            g, vals=torch.zeros(g.nnz + 1, device=cuda)[1:]), x)
    with pytest.raises(ValueError, match="shape"):
        gather_spmv(dataclasses.replace(g, split=g.split[:-1]), x)


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
    slot); K7 sums each row in its fixed order: bit-equal to
    ``combine_in_plan_order``, and within 1e-5·max|y| of ``index_add_``."""
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
    assert torch.equal(_bits(y), _bits(combine_in_plan_order(
        P, plan.combine)))
    expect = A.to_scipy() @ x.cpu().numpy().astype(np.float64)
    got = plan.matvec(x).cpu().numpy()
    assert np.abs(got - expect).max() <= 1e-5 * np.abs(expect).max()


def _shuffled(plan, seed):
    """``plan`` (on the host) with its slots shuffled within each bucket."""
    nb, per = plan.nbuckets, plan.combine.per_bucket
    rng = np.random.default_rng(seed)
    perm = (np.argsort(rng.random((nb, per)), axis=1)
            + per * np.arange(nb)[:, None]).reshape(-1)
    return _make_bridged(plan.n_rows, plan.n_cols, plan.nnz, plan.bucket,
                         plan.precision, plan.cols_b.numpy()[perm],
                         plan.vals_b.numpy()[perm],
                         plan.lr.numpy().reshape(-1)[perm].reshape(
                             plan.lr.shape))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bucket", [1024, 8192])
def test_bridged_bits_are_stable(cuda, bucket, dtype, shuffle):
    """K7 and ``BridgedPlan.matvec`` give the same bits (as int32) on 10
    calls, on the port's row-ordered slots and on slots shuffled within
    each bucket; K7 without a plan (built from LR on each call, padding
    included) gives the bits of the same plan prebuilt, and on the
    row-ordered slots (padding after row 0) those of the matvec's plan;
    ``combine_in_plan_order`` on the card gives the plan's bits."""
    A = _random_csr(30000, 9, seed=5, width=26000)
    host = plan_bridged_spmv(A, bucket=bucket)
    if shuffle:
        host = _shuffled(host, 11)
    assert (host.combine.order is not None) == shuffle
    plan = host.to(cuda, dtype)
    x = torch.randn(A.width, generator=torch.Generator(device=cuda)
                    .manual_seed(1), device=cuda, dtype=dtype)
    P = stream_gather(plan, x).view(plan.lr.shape)
    y0 = _bits(onehot_combine_bucketed(P, plan.lr, bucket=bucket,
                                       plan=plan.combine))
    m0 = _bits(plan.matvec(x))
    for _ in range(9):
        assert torch.equal(_bits(onehot_combine_bucketed(
            P, plan.lr, bucket=bucket, plan=plan.combine)), y0)
        assert torch.equal(_bits(plan.matvec(x)), m0)
    bare = _bits(onehot_combine_bucketed(P, plan.lr, bucket=bucket))
    assert torch.equal(bare, _bits(onehot_combine_bucketed(
        P, plan.lr, bucket=bucket, plan=plan_combine(plan.lr, bucket))))
    if not shuffle:
        assert torch.equal(bare, y0)
    assert torch.equal(_bits(combine_in_plan_order(P, plan.combine)), y0)
    assert torch.equal(m0, y0[:A.height])
    expect = A.to_scipy() @ x.cpu().numpy().astype(np.float64)
    got = plan.matvec(x).cpu().numpy()
    assert np.abs(got - expect).max() <= 1e-5 * np.abs(expect).max()


@pytest.mark.parametrize("sorted_slots", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_rows_of_every_tier(cuda, dtype, sorted_slots):
    """Rows for K7's thread, warp and block tiers (1 to 70,000 products in
    one bucket of 4,096 rows, empty rows and rows outside the bucket
    among them): bit-equal to ``combine_in_plan_order``, the same bits on
    10 calls, within 1e-5·max|y| of the exact sums."""
    rng = np.random.default_rng(8)
    nb, sub, bucket = 3, 96, 4096
    per = sub * 1024
    # bucket 0: even rows of ~48 products, odd rows empty; bucket 1: rows
    # 0, 7, ..., 49 of the lengths below, the other slots on rows >= 64;
    # bucket 2: ~24 products a row, 2 % of the slots outside the bucket
    lr = np.stack([2 * rng.integers(0, bucket // 2, per),
                   rng.integers(64, bucket, per),
                   rng.integers(0, bucket, per)])
    lengths = [70000, 9000, 2049, 2048, 2047, 700, 33, 32]
    pick = rng.permutation(per)[:sum(lengths)]
    lr[1, pick] = np.repeat(np.arange(len(lengths)) * 7, lengths)
    lr[2, rng.random(per) < 0.01] = -1
    lr[2, rng.random(per) < 0.01] = bucket
    if sorted_slots:                        # row order, the rest last
        key = np.where((lr >= 0) & (lr < bucket), lr, bucket)
        lr = np.take_along_axis(lr, np.argsort(key, axis=1, kind="stable"),
                                1)
    LR = torch.from_numpy(lr.astype(np.int32).reshape(nb, sub, 8, 128)).to(
        cuda)
    P = torch.from_numpy(rng.standard_normal((nb, sub, 8, 128))).to(
        cuda, dtype)
    cp = plan_combine(LR, bucket)
    assert (cp.order is None) == sorted_slots
    assert cp.block_rows.tolist() == [4096, 4096 + 7, 4096 + 14]
    assert {4096 + 21, 4096 + 28, 4096 + 35, 4096 + 42} <= set(
        cp.warp_rows.tolist())
    y = onehot_combine_bucketed(P, LR, bucket=bucket, plan=cp)
    assert torch.equal(_bits(y), _bits(combine_in_plan_order(P, cp)))
    for _ in range(9):
        assert torch.equal(_bits(onehot_combine_bucketed(
            P, LR, bucket=bucket, plan=cp)), _bits(y))
    # the exact sums, in float64 (a float32 index_add_ over 70,000 terms is
    # itself off by ~1e-5·max|y|)
    keep = ((LR >= 0) & (LR < bucket)).reshape(nb, -1)
    rows = (LR.reshape(nb, -1).long()
            + bucket * torch.arange(nb, device=cuda)[:, None])[keep]
    ref = torch.zeros(nb * bucket, dtype=torch.float64, device=cuda)
    ref.index_add_(0, rows, P.reshape(nb, -1).to(torch.float32)[keep]
                   .double())
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


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
        onehot_combine_bucketed(P, plan.lr, 2**31)
    with pytest.raises(ValueError, match="different devices"):
        onehot_combine_bucketed(P, plan.lr, 1024, plan=plan.combine.to("cpu"))
    with pytest.raises(ValueError, match="the plan is for"):
        onehot_combine_bucketed(P, plan.lr, 2048, plan=plan.combine)
    with pytest.raises(ValueError, match="another LR"):
        onehot_combine_bucketed(P, plan.lr.clone(), 1024, plan=plan.combine)
    with pytest.raises(ValueError, match="16-byte"):
        stream_gather(dataclasses.replace(
            plan, cols_b=torch.empty(plan.slots + 1, dtype=torch.int32,
                                     device=cuda)[1:],
            vals_b=torch.empty(plan.slots + 1, device=cuda)[1:]), x)


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


# K4's Hopper paths.  Shapes (m, k, n) for each: one whole block tile
# (wgmma 128 x 256 with k = 64, dmma and ffma 128 x 128 with k = 16); m, k
# and n ragged against every tile; k under one k-step; k one 16-byte vector
# (8, 2 or 4 elements); a long k for the accumulation.
MM_PATHS = {"wgmma": (torch.bfloat16, 8, (128, 64, 256)),
            "dmma": (torch.float64, 2, (128, 16, 128)),
            "ffma": (torch.float32, 4, (128, 16, 128))}
MM_PATH_CASES = ["full_tile", "ragged", "k_under_step", "k_one_vector",
                 "long_k"]


def _path_shape(path, case):
    _, vec, full = MM_PATHS[path]
    return {"full_tile": full, "ragged": (197, 1000, 264),
            "k_under_step": (130, 8, 136), "k_one_vector": (70, vec, 72),
            "long_k": (128, 4096, 256)}[case]


def _gate(dtype):
    """max|C − A·B| over max|C| against the float64 product: f32 sums
    (1e-5), one bfloat16 rounding of the output (2⁻⁸ + 1e-5), f64 sums
    (1e-12)."""
    return {torch.float32: 1e-5, torch.bfloat16: 2.0**-8 + 1e-5,
            torch.float64: 1e-12}[dtype]


@pytest.mark.parametrize("case", MM_PATH_CASES)
@pytest.mark.parametrize("path", sorted(MM_PATHS))
def test_matmul_paths_match_float64(cuda, no_tf32, path, case):
    dtype = MM_PATHS[path][0]
    m, k, n = _path_shape(path, case)
    g = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    b = torch.randn(k, n, generator=g, device=cuda).to(dtype)
    assert _matmul_path(a, b) == path
    before = dict(matmul.launches_by_path)
    c = matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.launches_by_path[path] - before[path] == 1
    assert sum(matmul.launches_by_path.values()) - sum(before.values()) == 1
    assert c.dtype == dtype and c.shape == (m, n)
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    assert float((c.double() - exact).abs().max()) <= _gate(dtype) * scale
    ref = matmul_plain(a, b)
    assert float((c.double() - ref.double()).abs().max()) <= \
        MM_TOL[dtype] * scale


@pytest.mark.parametrize("path", sorted(MM_PATHS))
def test_matmul_paths_identity_shows_layout(cuda, path):
    """I·B = B and A·I = A exactly (one product a sum): a wrong shared-
    memory layout or descriptor moves or mixes entries."""
    dtype = MM_PATHS[path][0]
    n = 256
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(n, n, generator=g, device=cuda).to(dtype)
    eye = torch.eye(n, device=cuda, dtype=dtype)
    for a, b, want in ((eye, x, x), (x, eye, x)):
        assert _matmul_path(a, b) == path
        assert torch.equal(_run_matmul(a, b, path), want)
    # a permutation on the left reorders B's rows exactly
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(6))
    p = eye[perm.to(cuda)]
    assert torch.equal(_run_matmul(p, x, path), x[perm.to(cuda)])


@pytest.mark.parametrize("dtype", sorted(MM_TOL, key=str))
def test_matmul_simt_route_by_rule(cuda, no_tf32, dtype):
    """Shapes off the 16-byte vectors and misaligned data take the SIMT
    kernel, by the rule and its counter, and stay within the gates."""
    g = torch.Generator(device=cuda).manual_seed(7)
    flat = torch.randn(40 * 33 + 1, generator=g, device=cuda).to(dtype)
    cases = [(torch.randn(33, 31, generator=g, device=cuda).to(dtype),
              torch.randn(31, 70, generator=g, device=cuda).to(dtype)),
             (torch.randn(9, 1, generator=g, device=cuda).to(dtype),
              torch.randn(1, 16, generator=g, device=cuda).to(dtype)),
             (flat[1:].view(33, 40),              # base off 16 bytes
              torch.randn(40, 64, generator=g, device=cuda).to(dtype))]
    for a, b in cases:
        assert _matmul_path(a, b) == "simt"
        before = matmul.launches_by_path["simt"]
        c = matmul(a, b)
        torch.cuda.synchronize()
        assert matmul.launches_by_path["simt"] - before == 1
        exact = a.double() @ b.double()
        scale = float(exact.abs().max())
        assert float((c.double() - exact).abs().max()) <= \
            _gate(dtype) * scale


def test_matmul_paths_refuse_what_they_cannot_take(cuda):
    a = torch.randn(64, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        matmul(a.t(), a)
    with pytest.raises(ValueError, match="contiguous"):
        matmul(a, a[:, ::2])
    for path, (dtype, vec, _) in MM_PATHS.items():
        flat = torch.zeros(64 * 64 + 1, device=cuda, dtype=dtype)
        mis = flat[1:].view(64, 64)               # base off 16 bytes
        ok = torch.zeros(64, 64, device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="cannot take"):
            _run_matmul(mis, ok, path)
        with pytest.raises(ValueError, match="cannot take"):
            _run_matmul(torch.zeros(8, vec + 1, device=cuda, dtype=dtype),
                        torch.zeros(vec + 1, 64, device=cuda, dtype=dtype),
                        path)


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


# K5's Hopper paths.  Shapes (m, k, n), each on its dtype's path in both
# dtypes: the 4096² trailing update at rank 128; m != n both ways; k one
# float32 vector and k off the DMMA ring's 16; n a multiple of both vectors
# but not of 128.
RK_SHAPES = [(4096, 128, 4096), (520, 128, 300), (300, 64, 1028),
             (260, 4, 260), (260, 132, 260), (384, 64, 388)]
RK_PATHS = {torch.float32: "ffma", torch.float64: "dmma"}


def _plant(c, mask):
    """c with a NaN (a payload of its own) in every 7th entry outside the
    mask and −0 in every 11th."""
    c = c.clone()
    bits = _bits(c).view(-1)
    idx = (~mask).flatten().nonzero().flatten()
    one = 1 << (8 * c.element_size() - 1)
    bits[idx[::7]] = (0x7FC01234 if c.dtype == torch.float32
                      else 0x7FF8000000001234)
    bits[idx[3::11]] = -one                                   # −0
    return c


def _rank_k_operands(cuda, dtype, lower, m, k, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rows = torch.arange(m, device=cuda)[:, None]
    cols = torch.arange(n, device=cuda)[None, :]
    mask = rows >= cols if lower else rows <= cols
    c = _plant(torch.randn(m, n, generator=g, device=cuda, dtype=dtype), mask)
    a = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    b = torch.randn(k, n, generator=g, device=cuda, dtype=dtype)
    return mask, c, a, b


def _check_rank_k(out, ref, c, mask):
    """The other triangle bit-equal to c; the triangle within 1e-5 (float32,
    which TF32's ~1e-3 would miss) or 1e-12 (float64) of max|out| against
    the plain version."""
    assert out.dtype == c.dtype and out.shape == c.shape
    assert torch.equal(_bits(out)[~mask], _bits(c)[~mask])
    tol = 1e-5 if c.dtype == torch.float32 else 1e-12
    assert float((out - ref)[mask].abs().max()) <= \
        tol * float(ref[mask].abs().max())


@pytest.mark.parametrize("shape", RK_SHAPES)
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rank_k_paths_match_plain(cuda, no_tf32, dtype, lower, shape):
    """Each shape on its dtype's Hopper path, by the rule and its counter,
    for α = −1, 0.5 and 0, with NaN and −0 planted in the other triangle;
    the same bits over 3 more calls."""
    path = RK_PATHS[dtype]
    mask, c, a, b = _rank_k_operands(cuda, dtype, lower, *shape, seed=8)
    assert _rank_k_path(c, a, b) == path
    for alpha in (-1.0, 0.5, 0.0):
        before = dict(masked_rank_k_update.launches_by_path)
        out = masked_rank_k_update(c, a, b, alpha=alpha, lower=lower)
        ref = masked_rank_k_update_plain(c, a, b, alpha=alpha, lower=lower)
        torch.cuda.synchronize()
        after = masked_rank_k_update.launches_by_path
        assert after[path] - before[path] == 1
        assert sum(after.values()) - sum(before.values()) == 1
        _check_rank_k(out, ref, c, mask)
    for _ in range(3):
        again = masked_rank_k_update(c, a, b, alpha=0.0, lower=lower)
        assert torch.equal(_bits(again), _bits(out))


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rank_k_simt_route_by_rule(cuda, no_tf32, dtype, lower):
    """k or n off the 16-byte vectors, k = 0, and c, a or b off 16-byte
    alignment take the SIMT kernel, by the rule and its counter, and pass
    the same checks."""
    g = torch.Generator(device=cuda).manual_seed(9)
    cases = [(300, 17, 200), (130, 64, 67), (64, 0, 64)]
    for m, k, n in cases:
        mask, c, a, b = _rank_k_operands(cuda, dtype, lower, m, k, n, seed=9)
        cases_ops = [(c, a, b)]
        if k:
            # each operand in turn off 16 bytes, the others aligned
            for i, t in enumerate((c, a, b)):
                flat = torch.randn(t.numel() + 1, generator=g, device=cuda,
                                   dtype=dtype)
                flat[1:] = t.flatten()
                ops = [c, a, b]
                ops[i] = flat[1:].view(t.shape)
                cases_ops.append(tuple(ops))
        for cc, aa, bb in cases_ops:
            assert _rank_k_path(cc, aa, bb) == "simt"
            before = masked_rank_k_update.launches_by_path["simt"]
            out = masked_rank_k_update(cc, aa, bb, alpha=-0.75, lower=lower)
            ref = masked_rank_k_update_plain(cc, aa, bb, alpha=-0.75,
                                             lower=lower)
            torch.cuda.synchronize()
            assert masked_rank_k_update.launches_by_path["simt"] - before \
                == 1
            _check_rank_k(out, ref, cc, mask)


def test_rank_k_paths_refuse_what_they_cannot_take(cuda):
    for dtype, path in RK_PATHS.items():
        c = torch.zeros(64, 64, device=cuda, dtype=dtype)
        a = torch.zeros(64, 8, device=cuda, dtype=dtype)
        b = torch.zeros(8, 64, device=cuda, dtype=dtype)
        other = "dmma" if path == "ffma" else "ffma"
        with pytest.raises(ValueError, match="cannot take"):
            _run_rank_k(c, a, b, 1.0, True, other)
        mis = torch.zeros(64 * 64 + 1, device=cuda, dtype=dtype)[1:]
        with pytest.raises(ValueError, match="cannot take"):
            _run_rank_k(mis.view(64, 64), a, b, 1.0, True, path)
        with pytest.raises(ValueError, match="cannot take"):
            _run_rank_k(c, torch.zeros(64, 5, device=cuda, dtype=dtype),
                        torch.zeros(5, 64, device=cuda, dtype=dtype), 1.0,
                        False, path)


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
# (3, 1367) and (1025, 9): many blocks of 128 packs in every dtype, ending
# in a part-block and a tail under one pack
@pytest.mark.parametrize("shape", [(24, 200), (1, 1), (37, 5), (512, 1000),
                                   (3, 1367), (1025, 9)])
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


# --------------------------------------------------------------------------
# The rest of the IPM tier: QP, affine LP, SOCP, MPS, sparse least squares
# --------------------------------------------------------------------------

def _qp_case(n1=6, seed=0):
    """A small qp_direct instance: Q = blockdiag(L, L) of the n1² grid
    Laplacian, A = concat_fd_2d(n1, n1), b = A·x0 with x0 > 0."""
    from elemental_tpu_torch.matrices import sparse_laplacian_2d
    A = concat_fd_2d(n1, n1)
    L = sparse_laplacian_2d(n1, n1, scaled=False)
    h = L.height
    Q = SparseMatrix.from_coo(2 * h, 2 * h,
                              np.concatenate([L.row_ids(), L.row_ids() + h]),
                              np.concatenate([L.colind, L.colind + h]),
                              np.concatenate([L.vals, L.vals]))
    rng = np.random.default_rng(seed)
    b = A.to_scipy() @ (np.abs(rng.standard_normal(A.width)) + 0.1)
    return Q, A, b, rng.standard_normal(A.width)


def _affine_case(seed=53):
    """test_ipm.py:67's lp_affine instance."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((5, 8))
    x0 = rng.standard_normal(8)
    G = rng.standard_normal((12, 8))
    h = G @ x0 + np.abs(rng.standard_normal(12)) + 0.1
    return A, A @ x0, G, h, rng.standard_normal(8)


def _socp_case(seed=4):
    """Cones of orders 3, 1, 5, 2, with a strictly feasible primal and
    dual."""
    from elemental_tpu_torch.optimization import Cones
    rng = np.random.default_rng(seed)
    cones = Cones([3, 1, 5, 2, 1])
    inner = np.zeros(cones.dim)
    for f, o in zip(cones.first, cones.orders):
        v = rng.standard_normal(o) * 0.3
        v[0] = np.linalg.norm(v[1:]) + 1.0
        inner[f:f + o] = v
    G = rng.standard_normal((cones.dim, 6))
    A = rng.standard_normal((2, 6))
    x0 = rng.standard_normal(6)
    c = -A.T @ rng.standard_normal(2) - G.T @ (0.7 * inner + 0.2)
    return A, A @ x0, G, G @ x0 + inner, c, cones


def _engine_runs(name, device, dtype=torch.float64):
    """(result, x) of one engine of the tier on a small instance."""
    from elemental_tpu_torch.optimization import (lp_affine, qp_affine,
                                                  socp_affine)
    from elemental_tpu_torch.optimization import qp_direct
    kw = dict(device=device, dtype=dtype)
    if name == "qp_direct":
        r = qp_direct(*_qp_case(), LPCtrl(tol=1e-9), **kw)
    elif name == "lp_affine":
        r = lp_affine(*_affine_case(), LPCtrl(tol=1e-9), **kw)
    elif name == "qp_affine":
        rng = np.random.default_rng(5)
        M = rng.standard_normal((8, 8))
        A = rng.standard_normal((2, 8))
        r = qp_affine(M @ M.T + 8 * np.eye(8), A,
                      A @ rng.uniform(-0.4, 0.4, 8),
                      np.concatenate([np.eye(8), -np.eye(8)]), np.ones(16),
                      rng.standard_normal(8), LPCtrl(tol=1e-8), **kw)
    else:
        A, b, G, h, c, cones = _socp_case()
        r = socp_affine(A, b, G, h, c, cones, LPCtrl(tol=1e-9,
                                                     max_iters=200), **kw)
    return r, r.x


@pytest.mark.parametrize("name", ["qp_direct", "lp_affine", "qp_affine",
                                  "socp_affine"])
def test_ipm_engines_on_card_match_cpu(cuda, name):
    """Each engine in float64 on the card: the CPU's iterations, objective
    and x within 1e-8, with K1 launched in every factor."""
    ref, xr = _engine_runs(name, "cpu")
    before = extend_add.launches
    got, xg = _engine_runs(name, cuda)
    assert extend_add.launches - before >= got.iterations
    assert ref.converged and got.converged
    assert got.iterations == ref.iterations
    np.testing.assert_allclose(got.objective, ref.objective, rtol=1e-8)
    np.testing.assert_allclose(xg, xr, atol=1e-8)


def test_solve_mps_on_card_matches_cpu(cuda, tmp_path):
    """A general-form MPS file (every bound kind, RANGES, an objective
    constant) through read_mps and solve_mps in float64, card against CPU."""
    from elemental_tpu_torch.optimization import solve_mps
    from elemental_tpu_torch.sparse import read_mps
    path = tmp_path / "lp.mps"
    path.write_text("""NAME T
ROWS
 N  OBJ
 E  R1
 L  R2
 G  R3
COLUMNS
    X1  OBJ  1.0  R1  1.0
    X1  R2  2.0  R3  1.0
    X2  OBJ  -1.0  R1  1.0
    X2  R3  1.0
    X3  OBJ  0.5  R2  1.0
    X4  OBJ  2.0  R1  -1.0
    X5  OBJ  -0.5  R3  -1.0
    X5  R1  0.5
RHS
    RHS  OBJ  -3.0  R1  1.0
    RHS  R2  4.0  R3  -2.0
RANGES
    RNG  R2  6.0
BOUNDS
 UP BND  X1  3.0
 LO BND  X2  -1.0
 UP BND  X2  2.0
 FR BND  X3
 FX BND  X4  0.5
 MI BND  X5
 UP BND  X5  1.0
ENDATA
""")
    lp = read_mps(str(path))
    assert lp.c0 == 3.0
    ref, xr = solve_mps(lp, LPCtrl(tol=1e-9), device="cpu",
                        dtype=torch.float64)
    before = extend_add.launches
    got, xg = solve_mps(lp, LPCtrl(tol=1e-9), device=cuda,
                        dtype=torch.float64)
    assert extend_add.launches - before >= got.iterations + 1
    assert ref.converged and got.converged
    assert got.iterations == ref.iterations
    np.testing.assert_allclose(got.objective, ref.objective, rtol=1e-8)
    np.testing.assert_allclose(xg, xr, atol=1e-8)


@pytest.mark.parametrize("which", ["ls", "lse"])
def test_sparse_min_on_card_matches_cpu(cuda, which):
    """sparse_least_squares (a 12×12 extended Laplacian) and sparse_lse (a
    10×10 FD2D with its dense column) in float64: card against CPU within
    1e-8 relative, K1 launched."""
    from elemental_tpu_torch.lapack import sparse_least_squares, sparse_lse
    rng = np.random.default_rng(4)
    if which == "ls":
        A = sparse_laplacian_2d(12, 12, scaled=False)
        A = SparseMatrix.from_coo(
            2 * A.height, A.width,
            np.concatenate([A.row_ids(), np.arange(A.width) + A.height]),
            np.concatenate([A.colind, np.arange(A.width)]),
            np.concatenate([A.vals, np.full(A.width, 8.0)]))
        b = rng.standard_normal(A.height)

        def run(dev):
            return sparse_least_squares(A, b, device=dev,
                                        dtype=torch.float64)
    else:
        A = sparse_laplacian_2d(10, 10, scaled=False)
        B = SparseMatrix.from_dense(rng.uniform(0, 1, (5, A.width)))
        c, d = rng.standard_normal(A.width), rng.standard_normal(5)

        def run(dev):
            return sparse_lse(A, B, c, d, device=dev,
                              dtype=torch.float64)[0]
    ref = run("cpu").numpy()
    before = extend_add.launches
    got = run(cuda)
    assert got.device.type == "cuda" and extend_add.launches > before
    got = got.cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-8 * np.abs(ref).max()


def test_qp_direct_first_factor_f32_has_no_tf32(cuda):
    """qp_direct's first KKT factor (Θ = I) in float32 on the card, with
    the TF32 switches on outside it, against the same factor in float64:
    within 1e-4 of max|pool| (6e-7 on the CPU), where TF32's 10-bit
    products would leave errors of 1e-4 and more."""
    from elemental_tpu_torch.optimization.lp import _build_lp_kkt
    Q, A, _, _ = _qp_case(n1=32)
    pools = {}
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        perm = None
        for dt in (torch.float64, torch.float32):
            kkt, _ = _build_lp_kkt(A, 1e-2, 1e-2, perm, device=cuda,
                                   dtype=dt, Q=Q)
            perm = kkt.symb.perm.cpu().numpy()
            pools[dt] = kkt.prepare(kkt.assemble(
                [torch.ones(A.width, dtype=dt, device=cuda)])).pool
            assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    p64 = pools[torch.float64]
    err = (pools[torch.float32].double() - p64).abs().max()
    assert float(err) <= 1e-4 * float(p64.abs().max())


def test_ipm_on_card_in_float32(cuda):
    """qp_direct and socp_affine in float32 on the card: finite iterates,
    the objective within 1e-3 of the float64 answer."""
    for name in ("qp_direct", "socp_affine"):
        ref, _ = _engine_runs(name, "cpu")
        got, xg = _engine_runs(name, cuda, torch.float32)
        assert np.all(np.isfinite(xg))
        assert abs(got.objective - ref.objective) <= 1e-3 * (
            1 + abs(ref.objective))


def test_native_library_built_from_port_source(cuda):
    """On the machine with the card, the ordering library is compiled from
    the port's own csrc/symbolic.cpp and orders a graph."""
    import os
    from elemental_tpu_torch.sparse_direct import native
    assert native.SOURCE.endswith(os.path.join("elemental_tpu_torch", "csrc",
                                               "symbolic.cpp"))
    lib = native._lib()
    assert os.path.basename(lib._name).startswith("libelemental_native-")
    perm = native.rcm(np.array([0, 1, 3, 4]), np.array([1, 0, 2, 1]))
    assert sorted(perm.tolist()) == [0, 1, 2]


# -- the dense core and the BLAS tier ------------------------------------------

def _dense(shape, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    real = torch.randn(shape, generator=g, dtype=torch.float64)
    if dtype.is_complex:
        real = torch.complex(real, torch.randn(shape, generator=g,
                                               dtype=torch.float64))
    return real.to(device, dtype)


def test_default_grid_is_the_card(cuda):
    """``Grid()`` and ``distribute`` with no grid place every block on the
    card."""
    from elemental_tpu_torch.core import MC, MR, Grid, distribute
    Grid.set_default(None)
    g = Grid()
    assert g.size == torch.cuda.device_count()
    assert all(d.type == "cuda" for d in g.devices.ravel())
    A = distribute(np.ones((64, 48)), MC, MR)
    assert A.grid == g
    assert all(A.local(i, j).is_cuda for i, j in g.positions())


def test_redistribution_on_card_is_bit_exact(cuda):
    from elemental_tpu_torch.core import (DIST_PAIRS, MC, MR, Grid,
                                          as_array, distribute)
    g = Grid(devices=[cuda] * 4, height=2)
    a = _dense((256, 192), torch.float64, cuda)
    A = distribute(a, MC, MR, g)
    for pair in DIST_PAIRS:
        B = A.redistribute(*pair)
        assert all(B.local(i, j).is_cuda for i, j in g.positions())
        assert torch.equal(as_array(B.redistribute(MC, MR)), a), pair


def test_gemm_f32_has_no_tf32(cuda):
    """ops.gemm in float32 is true float32 on the card even when the caller
    allows TF32 (TF32 would read about 1e-3), and the caller's flag is
    restored."""
    from elemental_tpu_torch import ops
    from elemental_tpu_torch.core import MC, MR, Grid, distribute
    g = Grid(devices=[cuda])
    a = _dense((1024, 1024), torch.float32, cuda, 1)
    b = _dense((1024, 1024), torch.float32, cuda, 2)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        C = ops.gemm("N", "N", 1.0, distribute(a, MC, MR, g),
                     distribute(b, MC, MR, g))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ref = a.double() @ b.double()
    c = C.local(0, 0)
    assert c.is_cuda
    assert float(torch.linalg.norm(c.double() - ref)
                 / torch.linalg.norm(ref)) <= 1e-5


@pytest.mark.parametrize("alg", ["stationary_c", "stationary_a",
                                 "stationary_b", "pipelined"])
def test_summa_2x2_on_card_matches_1x1(cuda, alg):
    """Each SUMMA variant on a 2×2 grid over the card equals the 1×1 grid's
    product to 1e-5 in float32, on a shape the grid does not divide."""
    import warnings
    from elemental_tpu_torch import ops
    from elemental_tpu_torch.core import MC, MR, Grid, distribute
    g1, g4 = Grid(devices=[cuda]), Grid(devices=[cuda] * 4, height=2)
    a = _dense((515, 300), torch.float32, cuda, 3)
    b = _dense((300, 257), torch.float32, cuda, 4)
    c1 = ops.gemm("N", "N", 1.0, distribute(a, MC, MR, g1),
                  distribute(b, MC, MR, g1)).local(0, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        C4 = ops.gemm("N", "N", 1.0, distribute(a, MC, MR, g4),
                      distribute(b, MC, MR, g4), alg=alg)
    c4 = C4.to_numpy()
    ref = c1.cpu().numpy()
    assert np.abs(c4 - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64])
def test_trsm_residual_on_card(cuda, dtype):
    """The recursive trsm (n = 1024 > 256) on the card: ‖op(T)X − αB‖ /
    (‖T‖‖X‖) under residual_bound."""
    from elemental_tpu_torch import ops
    from elemental_tpu_torch.core import residual_bound
    n = 1024
    T = torch.tril(_dense((n, n), dtype, cuda, 5)) + n * torch.eye(
        n, dtype=dtype, device=cuda)
    B = _dense((n, 256), dtype, cuda, 6)
    for side, uplo, orient in (("L", "L", "N"), ("R", "U", "C")):
        tt = T if uplo == "L" else T.T.contiguous()
        b = B if side == "L" else B.T.contiguous()
        X = ops.trsm(side, uplo, orient, "N", 2.0, tt, b)
        op = {"N": tt, "C": tt.conj().T}[orient]
        r = (op @ X if side == "L" else X @ op) - 2.0 * b
        rel = float(torch.linalg.norm(r) / (torch.linalg.norm(tt)
                                            * torch.linalg.norm(X)))
        assert rel < residual_bound(dtype, n), (side, rel)


def test_gemm_3d_on_card(cuda):
    from elemental_tpu_torch import ops
    mesh = ops.make_3d_mesh([cuda] * 8, depth=2)
    a = _dense((256, 512), torch.float64, cuda, 7)
    b = _dense((512, 384), torch.float64, cuda, 8)
    c = ops.gemm_3d(a, b, mesh)
    assert c.is_cuda
    assert float((c - a @ b).abs().max()) <= 1e-12 * float((a @ b).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spgemm_on_card_matches_torch_sparse_mm(cuda, dtype):
    """SpGEMM's plan on the card against cuSPARSE (``torch.sparse.mm``) on
    the same CSR operands: C's structure equal to scipy's, values within
    the dtype's tolerance (``index_add_`` sums with atomics), and the
    Galerkin plan against A·diag(d)·Aᵀ."""
    import scipy.sparse as sps
    from elemental_tpu_torch.sparse import (galerkin_plan, spgemm,
                                            spgemm_plan, syrk_sparse)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    A = sparse_laplacian_2d(24, 24, scaled=False)
    plan = spgemm_plan(A, A).to(cuda)
    vals = torch.from_numpy(A.vals).to(cuda, dtype)
    c = plan.numeric(vals, vals)
    assert c.is_cuda and c.dtype == dtype
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    ref.sort_indices()
    assert np.array_equal(plan.c_struct.rowptr, ref.indptr)
    assert np.array_equal(plan.c_struct.colind, ref.indices)
    S = torch.sparse_csr_tensor(torch.from_numpy(A.rowptr),
                                torch.from_numpy(A.colind), vals.cpu(),
                                A.shape).to(cuda)
    lib = torch.sparse.mm(S, S).to_dense()
    mine = torch.from_numpy(
        plan.c_struct.change_nonzero_values(c.cpu().numpy()).to_dense()
    ).to(cuda)
    assert float((mine - lib).norm() / lib.norm()) <= tol
    C = spgemm(A, A, device=cuda, dtype=dtype)
    np.testing.assert_allclose(C.vals, ref.data, rtol=tol)
    d = np.linspace(0.5, 2.0, A.width)
    G = syrk_sparse(A, d, device=cuda, dtype=dtype).to_scipy()
    want = A.to_scipy() @ sps.diags(d) @ A.to_scipy().T
    assert sps.linalg.norm(G - want) <= tol * sps.linalg.norm(want)
    assert galerkin_plan(A).to(cuda).a_idx.is_cuda


def test_dist_matvec_2x2_on_card_matches_csr_device(cuda):
    """A distributed matvec on a 2×2 grid over the card against the 1×1
    ``CSRDevice`` product, with the transfers of a ``DistMultiVec``
    product within the halo's bound."""
    from elemental_tpu_torch.core import Grid
    from elemental_tpu_torch.sparse import DistMultiVec, DistSparseMatrix
    from elemental_tpu_torch.utils import count_transfers
    A = sparse_laplacian_2d(64, 64, scaled=False)
    g = Grid(devices=[cuda] * 4, height=2)
    dA = DistSparseMatrix.from_sparse(A, g, dtype=torch.float64)
    assert all(t.is_cuda for t in dA.lvals)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(A.width)) \
        .to(cuda)
    want = A.device_csr(device=cuda, dtype=torch.float64).matvec(x)
    got = dA.matvec(x)
    assert got.is_cuda
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    xv = DistMultiVec.from_array(x, g)
    with count_transfers() as log:
        yv = dA.matvec_transpose(xv)
    assert not log.of("all-gather")
    assert log.bytes() <= 4 * 4 * dA.halo * 8
    assert float((yv.assemble() - want).abs().max()) <= \
        1e-12 * float(want.abs().max())


def test_ipm_driver_on_card(cuda, monkeypatch):
    """One driver of the conic tier end to end on the card (its own
    checks), with K1 launched by its factors."""
    import importlib
    import sys
    from elemental_tpu_torch.kernels import extend_add as ea
    monkeypatch.setattr(sys, "argv", ["lp_affine", "--device", "cuda"])
    before = ea.extend_add.launches
    res = importlib.import_module(
        "elemental_tpu_torch.examples.lp_affine").main()
    assert res.converged
    assert ea.extend_add.launches > before
