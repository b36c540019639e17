"""Parity of the port's application solvers (``optimization/solvers.py``, all
14) and sparse Euclidean minimizations (``lapack/sparse_min.py``) with the
JAX package, on the CPU in float64, from the same NumPy inputs: the
instances of ``tests/optimization/test_ipm.py:130-241`` and of the example
drivers.  Solutions agree to atol 1e-6 (the IPM solvers) and 1e-10 relative
(the direct sparse solvers); the reference tests' own gates are then held on
the port's answers.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from elemental_tpu import lapack as jlapack
from elemental_tpu.optimization import LPCtrl as JaxLPCtrl
from elemental_tpu.optimization import solvers as jsol

from elemental_tpu_torch import lapack as tlapack
from elemental_tpu_torch.optimization import LPCtrl
from elemental_tpu_torch.optimization import solvers as tsol
from elemental_tpu_torch.sparse import SparseMatrix

torch.set_num_threads(1)
CPU = dict(device="cpu", dtype=torch.float64)
EXDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples")


def _both(name, *args, ctrl=None, **kw):
    """(port, JAX) answers of solver ``name`` on the same arguments."""
    jctrl = None if ctrl is None else JaxLPCtrl(**ctrl)
    tctrl = None if ctrl is None else LPCtrl(**ctrl)
    ref = getattr(jsol, name)(*args, ctrl=jctrl, **kw)
    got = getattr(tsol, name)(*args, ctrl=tctrl, **kw, **CPU)
    return got, ref


def _check(got, ref, atol=1e-6):
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, atol=atol)


def test_basis_pursuit():
    rng = np.random.default_rng(130)
    m, n, k = 20, 50, 3
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x0 = np.zeros(n)
    x0[rng.choice(n, k, replace=False)] = rng.standard_normal(k) * 3
    got, ref = _both("basis_pursuit", A, A @ x0, ctrl=dict(tol=1e-10))
    _check(got, ref)
    np.testing.assert_allclose(got, x0, atol=1e-5)


def test_lav_and_chebyshev_point():
    """test_ipm.py:142's instance and HiGHS gates.  On it the JAX lp_affine
    meets an exactly-zero KKT pivot at iteration 8 and returns the iterate
    before it; the port factors that KKT again with the static
    regularization as pivot floors and converges in 9 (ROADMAP queue 3),
    within 1e-6 of that iterate."""
    import scipy.optimize as so
    rng = np.random.default_rng(142)
    m, n = 25, 6
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    got, ref = _both("lav", A, b, ctrl=dict(tol=1e-9))
    _check(got, ref)
    c = np.concatenate([np.zeros(2 * n), np.ones(2 * m)])
    blocks = np.concatenate([A, -A, -np.eye(m), np.eye(m)], axis=1)
    lp = so.linprog(c, A_eq=blocks, b_eq=b, bounds=(0, None),
                    method="highs")
    np.testing.assert_allclose(np.abs(A @ got - b).sum(), lp.fun, rtol=1e-8)
    got, ref = _both("chebyshev_point", A, b, ctrl=dict(tol=1e-9))
    _check(got, ref)
    lp = so.linprog(np.concatenate([np.zeros(n), [1.0]]),
                    A_ub=np.block([[A, -np.ones((m, 1))],
                                   [-A, -np.ones((m, 1))]]),
                    b_ub=np.concatenate([b, -b]), bounds=(None, None),
                    method="highs")
    np.testing.assert_allclose(np.abs(A @ got - b).max(), lp.fun, rtol=1e-4)


def test_nnls():
    import scipy.optimize as so
    rng = np.random.default_rng(165)
    A = rng.standard_normal((15, 8))
    b = rng.standard_normal(15)
    got, ref = _both("nnls", A, b, ctrl=dict(tol=1e-10))
    _check(got, ref)
    x_ref, _ = so.nnls(A, b)
    np.testing.assert_allclose(np.linalg.norm(A @ got - b),
                               np.linalg.norm(A @ x_ref - b), rtol=1e-6)
    assert got.min() > -1e-8


@pytest.mark.parametrize("name", ["bpdn", "lasso"])
def test_bpdn_and_lasso_soft_threshold(name):
    """Orthogonal A: the answer is soft thresholding (test_ipm.py:176)."""
    rng = np.random.default_rng(176)
    n = 12
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    b = rng.standard_normal(n)
    got, ref = _both(name, q, b, 0.3, ctrl=dict(tol=1e-10))
    _check(got, ref)
    qtb = q.T @ b
    np.testing.assert_allclose(got, np.sign(qtb) * np.maximum(
        np.abs(qtb) - 0.3, 0), atol=1e-6)


def test_elastic_net():
    """examples/en.py's model: λ₁ = 0.3, λ₂ = 0.1."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((30, 10))
    b = rng.standard_normal(30)
    got, ref = _both("elastic_net", A, b, 0.3, 0.1, ctrl=dict(tol=1e-9))
    _check(got, ref)


def test_svm_separable():
    rng = np.random.default_rng(189)
    m = 40
    X = rng.standard_normal((m, 2))
    y = np.sign(X @ np.array([1.0, -2.0]) + 0.1)
    got, ref = _both("svm", X, y, lam=1e-3,
                     ctrl=dict(tol=1e-9, max_iters=200))
    _check(got, ref)
    assert (np.sign(X @ got[:2] + got[2]) == y).all()


def test_total_variation():
    """test_ipm.py:200's instance and gates.  At iteration 7 a KKT pivot
    cancels to noise (the JAX package's rounds to −1.2e-8, the port's to
    exactly 0, and the port factors again with the static regularization
    as pivot floors): both converge in 9 iterations."""
    rng = np.random.default_rng(200)
    n = 30
    x_true = np.concatenate([np.zeros(15), np.ones(15)])
    b = x_true + 0.05 * rng.standard_normal(n)
    got, ref = _both("total_variation", b, lam=0.4,
                     ctrl=dict(tol=1e-9, max_iters=200))
    _check(got, ref)
    assert np.abs(np.diff(got)).sum() < np.abs(np.diff(b)).sum() * 0.5
    assert np.linalg.norm(got - x_true) < np.linalg.norm(b - x_true)


def test_dantzig_selector():
    rng = np.random.default_rng(211)
    m, n = 25, 10
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x0 = np.zeros(n)
    x0[:2] = [3.0, -2.0]
    got, ref = _both("dantzig_selector", A, A @ x0, lam=1e-4,
                     ctrl=dict(tol=1e-9))
    _check(got, ref)
    np.testing.assert_allclose(got, x0, atol=1e-2)


def test_portfolio():
    rng = np.random.default_rng(222)
    n = 8
    L = rng.standard_normal((n, n))
    Sigma = L @ L.T + np.eye(n)
    got, ref = _both("portfolio", Sigma, rng.standard_normal(n), gamma=1.0,
                     ctrl=dict(tol=1e-9))
    _check(got, ref)
    np.testing.assert_allclose(got.sum(), 1.0, atol=1e-6)
    assert got.min() > -1e-8


def test_robust_least_squares():
    rng = np.random.default_rng(232)
    A = rng.standard_normal((10, 4))
    b = rng.standard_normal(10)
    got, ref = _both("robust_least_squares", A, b, rho=0.1,
                     ctrl=dict(tol=1e-9, max_iters=300))
    _check(got, ref)


def test_rnnls():
    """examples/rnnls_ex.py's Rectang stencil (40×20), ρ = 2: twenty
    order-1 cones, whose exit the port's ConeOps.max_step takes exactly
    (see its docstring); both converge in 16 iterations."""
    m, n = 40, 20
    s = np.arange(m)
    A = SparseMatrix.from_coo(
        m, n, np.concatenate([s] * 5),
        np.concatenate([s % n, (s - 1) % n, (s + 1) % n, (s - m) % n,
                        (s + m) % n]),
        np.concatenate([np.full(m, v) for v in (11.0, -1.0, 2.0, -3.0,
                                                4.0)]))
    b = np.random.default_rng(3).standard_normal(m)
    Ad = A.to_dense()
    got, ref = _both("rnnls", Ad, b, 2.0, ctrl=dict(tol=1e-9))
    _check(got, ref)
    assert got.min() > -1e-5


def test_basis_pursuit_complex():
    """examples/bp_complex.py's instance, realified into order-3 cones."""
    rng = np.random.default_rng(11)
    m, n, k = 12, 30, 3
    A = (rng.standard_normal((m, n))
         + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    x_true = np.zeros(n, complex)
    x_true[rng.choice(n, k, replace=False)] = (rng.standard_normal(k)
                                               + 1j * rng.standard_normal(k))
    b = A @ x_true
    got, ref = _both("basis_pursuit_complex", A, b)
    assert np.iscomplexobj(got)
    _check(got, ref)
    assert np.linalg.norm(A @ got - b) / (1 + np.linalg.norm(b)) < 1e-3
    assert np.abs(got).sum() <= np.abs(x_true).sum() * (1 + 1e-2)


def _example(name, monkeypatch):
    monkeypatch.syspath_prepend(EXDIR)
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXDIR, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_matrix(A):
    return SparseMatrix.from_arrays(A.height, A.width, A.rowptr, A.colind,
                                    A.vals)


def _close(got, ref, tol=1e-10):
    got, ref = got.numpy(), np.asarray(ref)
    assert float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max())


def test_sparse_least_squares(monkeypatch):
    """examples/sequential_least_squares.py at its default 12×12 grid, with
    its gate ‖Aᵀ(b − Ax)‖∞ < residual_bound·max|A|·‖b‖."""
    from elemental_tpu_torch.core.policy import residual_bound
    jA = _example("sequential_least_squares", monkeypatch
                  ).extended_laplacian(12, 12)
    A = _port_matrix(jA)
    b = np.random.default_rng(4).standard_normal(A.height)
    ref = jlapack.sparse_least_squares(jA, b)
    got = tlapack.sparse_least_squares(A, b, **CPU)
    _close(got, ref)
    As = A.to_scipy()
    x = got.numpy()
    g = np.abs(As.T @ (b - As @ x)).max()
    assert g < residual_bound(torch.float64, A.width) * np.abs(
        As.data).max() * np.linalg.norm(b)


def test_sparse_linear_solve(monkeypatch):
    """examples/sequential_linear_solve.py at n = 300 (the dense last
    column): relative residual under the dtype's bound."""
    from elemental_tpu_torch.core.policy import residual_bound
    jA = _example("sequential_linear_solve", monkeypatch).rectang_square(300)
    A = _port_matrix(jA)
    b = np.random.default_rng(5).standard_normal(A.height)
    ref = jlapack.sparse_linear_solve(jA, b)
    got = tlapack.sparse_linear_solve(A, b, **CPU)
    _close(got, ref)
    r = np.linalg.norm(A.to_scipy() @ got.numpy() - b) / np.linalg.norm(b)
    assert r < residual_bound(torch.float64, A.height)
    with pytest.raises(ValueError, match="square"):
        tlapack.sparse_linear_solve(
            SparseMatrix.from_dense(np.ones((3, 2))), np.ones(3), **CPU)


def test_sparse_lse(monkeypatch):
    """examples/sequential_lse.py at its default 10×10 grid and p = 5, with
    its constraint and projected-gradient gates."""
    from elemental_tpu_torch.core.policy import residual_bound
    jA = _example("sequential_lse", monkeypatch).fd2d(10, 10)
    A = _port_matrix(jA)
    n, p = A.width, 5
    rng = np.random.default_rng(6)
    Bd = rng.uniform(0, 1, (p, n))
    c, d = rng.standard_normal(n), rng.standard_normal(p)
    from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix
    jx, jres = jlapack.sparse_lse(jA, JaxSparseMatrix.from_dense(Bd), c, d)
    x, res = tlapack.sparse_lse(A, SparseMatrix.from_dense(Bd), c, d, **CPU)
    _close(x, jx)
    assert abs(float(res) - float(jres)) <= 1e-10 * float(jres)
    x = x.numpy()
    bound = residual_bound(torch.float64, n)
    assert np.abs(Bd @ x - d).max() < bound * (1 + np.abs(d).max())
    As = A.to_scipy()
    g = As.T @ (c - As @ x)
    perp = np.abs(g - Bd.T @ np.linalg.lstsq(Bd.T, g, rcond=None)[0]).max()
    assert perp < bound * (np.abs(As.data).max() * np.linalg.norm(c) + 1)


def test_sparse_least_squares_float32_delta(monkeypatch):
    """float32 at a 60×60 grid of the same driver: the port's δ =
    √eps·‖A‖²_max meets the driver's gate, where the JAX package's
    √eps·‖A‖_max leaves a refinement that does not (sparse_min.py's
    docstring)."""
    from elemental_tpu_torch.core.policy import residual_bound
    A = _port_matrix(_example("sequential_least_squares", monkeypatch
                              ).extended_laplacian(60, 60))
    b = np.random.default_rng(4).standard_normal(A.height)
    As = A.to_scipy()
    bound = residual_bound(torch.float32, A.width) * np.abs(
        As.data).max() * np.linalg.norm(b)

    def gate(delta):
        x = tlapack.sparse_least_squares(
            A, b, delta, device="cpu", dtype=torch.float32).numpy()
        g = np.abs(As.T @ (b - As @ x.astype(np.float64))).max()
        return bool(g < bound)          # False for NaN too

    assert gate(None)
    eps = float(torch.finfo(torch.float32).eps)
    assert not gate(np.sqrt(eps) * np.abs(As.data).max())
