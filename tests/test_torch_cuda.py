"""Tests of the port that need an NVIDIA card (and nvcc): K1 against its
plain version on the card, the wrapper's refusals, and the factor and the LP
on the card against the same code on the CPU.  Every test is marked ``cuda``
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
from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_3d
from elemental_tpu_torch.optimization import LPCtrl, lp_direct
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
