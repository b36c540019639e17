"""Tests of the port that need an NVIDIA card (and nvcc): K1, K2 and K3
against their plain versions on the card, the wrappers' refusals, and the
factor, the LP, the SpMV planner and CG on the card against the same code on
the CPU.  Every test is marked ``cuda``
and skips without a card.  The file imports no JAX, so it also runs where
JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from elemental_tpu_torch.kernels.extend_add import (extend_add,
                                                    extend_add_plain)
from elemental_tpu_torch.kernels.spmv import (stencil_spmv,
                                              stencil_spmv_from_csr,
                                              stencil_spmv_plain)
from elemental_tpu_torch.kernels.unstructured import (gather_spmv,
                                                      gather_spmv_plain,
                                                      plan_gather_spmv)
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
