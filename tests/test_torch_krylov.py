"""Parity of the port's Krylov solvers with the JAX package's, on the CPU:
the dense operators of ``tests/lapack/test_spectral_solve.py`` in float64
(equal iteration counts, x to 1e-10), and the slice as a whole, ``plan_spmv``
+ ``cg`` on the 32² Laplacian, against the JAX ``cg`` over the JAX stencil
kernel (Pallas interpret mode).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from elemental_tpu import lapack as jla
from elemental_tpu.kernels.spmv import (plan_stencil_spmv as
                                        jax_plan_stencil,
                                        stencil_spmv as jax_stencil_spmv)
from elemental_tpu.sparse import to_dia as jax_to_dia

from elemental_tpu_torch import lapack as la
from elemental_tpu_torch.matrices import sparse_laplacian_2d
from elemental_tpu_torch.sparse import SparseMatrix, plan_spmv

torch.set_num_threads(1)


def _problem(kind):
    rng = np.random.default_rng(5)
    if kind == "cg":
        n = 100
        a = rng.standard_normal((n, n))
        a = a @ a.T + n * np.eye(n)
    else:
        n = {"refined_solve": 50}.get(kind, 80)
        a = rng.standard_normal((n, n)) + n * np.eye(n)
    return a, rng.standard_normal(n)


def _solve(pkg, kind, a, b):
    """Run solver ``kind`` of ``pkg`` (the JAX ``lapack`` or the port's) on
    the dense operator a."""
    if pkg is la:
        A, v = torch.from_numpy(a), torch.from_numpy

        def approx(r):
            return (inv32 @ r.to(torch.float32)).to(torch.float64)
    else:
        A, v = jnp.asarray(a), jnp.asarray

        def approx(r):
            return (inv32 @ r.astype(jnp.float32)).astype(jnp.float64)
    dinv = v(1.0 / np.diag(a))
    inv32 = v(np.linalg.inv(a.astype(np.float32)))
    op = lambda x: A @ x  # noqa: E731
    b = v(b)
    if kind == "cg":
        return pkg.cg(op, b, tol=1e-12)
    if kind == "gmres":
        return pkg.gmres(op, b, restart=40, tol=1e-10)
    if kind == "gmres_short_restart":
        return pkg.gmres(op, b, restart=5, tol=1e-10)
    if kind == "fgmres":
        return pkg.fgmres(op, b, precond=lambda r: dinv * r, tol=1e-10)
    if kind == "lgmres":
        return pkg.lgmres(op, b, tol=1e-10)
    return pkg.refined_solve(op, approx, b, tol=1e-13)


@pytest.mark.parametrize("kind", ["cg", "gmres", "gmres_short_restart",
                                  "fgmres", "lgmres", "refined_solve"])
def test_solver_matches_reference(kind):
    a, b = _problem(kind)
    got = _solve(la, kind, a, b)
    ref = _solve(jla, kind, a, b)
    assert got.iterations == int(ref.iterations) > 0
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-10)
    np.testing.assert_allclose(got.residual, float(ref.residual),
                               rtol=1e-3, atol=1e-12)
    x = got.x.numpy()
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-8


def test_cg_respects_max_iters_and_zero_rhs():
    a, b = _problem("cg")
    A = torch.from_numpy(a)
    res = la.cg(lambda x: A @ x, torch.from_numpy(b), max_iters=3, tol=1e-14)
    assert res.iterations == 3
    zero = la.cg(lambda x: A @ x, torch.zeros(100, dtype=torch.float64))
    assert zero.iterations == 0 and zero.residual == 0.0


def _jax_cg_laplacian(A, b, tol, dtype):
    dia = jax_to_dia(A)
    jplan = jax_plan_stencil(dia.offsets, np.asarray(dia.diags).astype(dtype),
                             A.height, cols=128)
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(lambda b: jla.cg(
            lambda v: jax_stencil_spmv(jplan, v, tile_rows=8), b, tol=tol,
            max_iters=5000))(jnp.asarray(b))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cg_on_the_stencil_plan(dtype):
    """The slice end to end: plan_spmv + cg on the 32² Laplacian against
    the JAX cg over the JAX stencil kernel.  float64: equal iterations,
    x to 1e-9.  float32: iterations within ±2, and the residual, checked
    on the host in float64, under 1e-4·‖b‖ (the recurrence reaches tol =
    1e-6; the true residual of an f32 solve lags it by the rounding of the
    updates, κ ≈ 440 here)."""
    A = sparse_laplacian_2d(32, 32, scaled=False)
    b = np.random.default_rng(0).standard_normal(A.height).astype(dtype)
    tol = 1e-10 if dtype == "float64" else 1e-6
    plan = plan_spmv(SparseMatrix.from_scipy(A.to_scipy().astype(dtype)))
    assert plan.kind == "stencil"
    got = la.cg(plan.matvec, torch.from_numpy(b), tol=tol, max_iters=5000)
    ref = _jax_cg_laplacian(A, b, tol, dtype)
    x = got.x.numpy()
    assert x.dtype == np.dtype(dtype)
    res = np.linalg.norm(A.to_scipy() @ x.astype(np.float64) - b) / \
        np.linalg.norm(b)
    if dtype == "float64":
        assert got.iterations == int(ref.iterations)
        np.testing.assert_allclose(x, np.asarray(ref.x), atol=1e-9)
        assert res < 1e-9
    else:
        assert abs(got.iterations - int(ref.iterations)) <= 2
        assert res < 1e-4
