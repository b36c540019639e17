"""Application solvers (counterpart of
``elemental_tpu/optimization/solvers.py``; spec'd by the reference's Python
drivers in ``examples/interface``: BP.py, BPDN.py, LAV.py, CP.py, DS.py,
SVM.py, NNLS.py, TV.py, ...).  Each reduces to the canonical LP/QP/SOCP
solvers of this package and runs them on ``device`` in ``dtype``; the
models are built on the host in NumPy, as in the JAX package."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..sparse.csr import SparseMatrix
from .lp import LPCtrl, lp_affine, lp_direct
from .qp import qp_direct
from .socp import Cones, socp_affine


def _dense(A):
    return A.to_dense() if isinstance(A, SparseMatrix) else np.asarray(A)


def basis_pursuit(A, b: np.ndarray, ctrl: Optional[LPCtrl] = None, *,
                  device, dtype) -> np.ndarray:
    """min ‖x‖₁ s.t. Ax = b (reference ``BP.py``): split x = u − v, u,v ≥ 0."""
    Ad = _dense(A)
    m, n = Ad.shape
    A_std = SparseMatrix.from_dense(np.concatenate([Ad, -Ad], axis=1))
    c = np.ones(2 * n)
    res = lp_direct(A_std, b, c, ctrl, device=device, dtype=dtype)
    return res.x[:n] - res.x[n:]


def lav(A, b: np.ndarray, ctrl: Optional[LPCtrl] = None, *,
        device, dtype) -> np.ndarray:
    """Least absolute value regression: min ‖Ax − b‖₁ (reference ``LAV.py``,
    which routes through ``El.LPAffine``): min Σtᵢ s.t. |aᵢᵀx − bᵢ| ≤ tᵢ
    with x free — the affine form avoids the degenerate sign-splitting."""
    Ad = _dense(A)
    m, n = Ad.shape
    G = np.block([[Ad, -np.eye(m)], [-Ad, -np.eye(m)]])
    h = np.concatenate([b, -b])
    c = np.concatenate([np.zeros(n), np.ones(m)])
    res = lp_affine(SparseMatrix.from_dense(np.zeros((0, n + m))),
                    np.zeros(0), SparseMatrix.from_dense(G), h, c, ctrl,
                    device=device, dtype=dtype)
    return res.x[:n]


def chebyshev_point(A, b: np.ndarray, ctrl: Optional[LPCtrl] = None, *,
                    device, dtype) -> np.ndarray:
    """min ‖Ax − b‖∞ (reference ``CP.py``, routed through ``El.LPAffine``):
    min t s.t. ±(Ax − b) ≤ t·1 with x, t free."""
    Ad = _dense(A)
    m, n = Ad.shape
    G = np.block([[Ad, -np.ones((m, 1))], [-Ad, -np.ones((m, 1))]])
    h = np.concatenate([b, -b])
    c = np.concatenate([np.zeros(n), [1.0]])
    res = lp_affine(SparseMatrix.from_dense(np.zeros((0, n + 1))),
                    np.zeros(0), SparseMatrix.from_dense(G), h, c, ctrl,
                    device=device, dtype=dtype)
    return res.x[:n]


def dantzig_selector(A, b: np.ndarray, lam: float,
                     ctrl: Optional[LPCtrl] = None, *,
                     device, dtype) -> np.ndarray:
    """min ‖x‖₁ s.t. ‖Aᵀ(Ax − b)‖∞ ≤ λ (reference ``DS.py``)."""
    Ad = _dense(A)
    m, n = Ad.shape
    AtA = Ad.T @ Ad
    Atb = Ad.T @ b
    # vars [x⁺, x⁻, s₁, s₂ ≥ 0]: AᵀA(x⁺−x⁻) + s₁ = Atb + λ;
    #                            −AᵀA(x⁺−x⁻) + s₂ = −Atb + λ
    top = np.concatenate([AtA, -AtA, np.eye(n), np.zeros((n, n))], axis=1)
    bot = np.concatenate([-AtA, AtA, np.zeros((n, n)), np.eye(n)], axis=1)
    A_std = SparseMatrix.from_dense(np.concatenate([top, bot], axis=0))
    b_std = np.concatenate([Atb + lam, -Atb + lam])
    c = np.concatenate([np.ones(2 * n), np.zeros(2 * n)])
    res = lp_direct(A_std, b_std, c, ctrl, device=device, dtype=dtype)
    return res.x[:n] - res.x[n:2 * n]


def bpdn(A, b: np.ndarray, lam: float, ctrl: Optional[LPCtrl] = None, *,
         device, dtype) -> np.ndarray:
    """Basis-pursuit denoising / LASSO: min ½‖Ax − b‖² + λ‖x‖₁ (reference
    ``BPDN.py``) as a QP over x = u − v, u,v ≥ 0."""
    Ad = _dense(A)
    m, n = Ad.shape
    AtA = Ad.T @ Ad
    Q = np.block([[AtA, -AtA], [-AtA, AtA]])
    c = lam * np.ones(2 * n) - np.concatenate([Ad.T @ b, -Ad.T @ b])
    res = qp_direct(Q + 1e-10 * np.eye(2 * n), np.zeros((0, 2 * n)),
                    np.zeros(0), c, ctrl, device=device, dtype=dtype)
    return res.x[:n] - res.x[n:]


def lasso(A, b: np.ndarray, lam: float, **kw) -> np.ndarray:
    """Alias (reference ``EN.py`` family)."""
    return bpdn(A, b, lam, **kw)


def elastic_net(A, b: np.ndarray, lam1: float, lam2: float,
                ctrl: Optional[LPCtrl] = None, *,
                device, dtype) -> np.ndarray:
    """min ½‖Ax−b‖² + λ₁‖x‖₁ + ½λ₂‖x‖² (reference ``EN.py``)."""
    Ad = _dense(A)
    m, n = Ad.shape
    AtA = Ad.T @ Ad + lam2 * np.eye(n)
    Q = np.block([[AtA, -AtA], [-AtA, AtA]])
    c = lam1 * np.ones(2 * n) - np.concatenate([Ad.T @ b, -Ad.T @ b])
    res = qp_direct(Q + 1e-10 * np.eye(2 * n), np.zeros((0, 2 * n)),
                    np.zeros(0), c, ctrl, device=device, dtype=dtype)
    return res.x[:n] - res.x[n:]


def nnls(A, b: np.ndarray, ctrl: Optional[LPCtrl] = None, *,
         device, dtype) -> np.ndarray:
    """Nonnegative least squares: min ‖Ax − b‖² s.t. x ≥ 0 (reference
    ``NNLS.py``)."""
    Ad = _dense(A)
    n = Ad.shape[1]
    Q = Ad.T @ Ad + 1e-12 * np.eye(n)
    c = -Ad.T @ b
    res = qp_direct(Q, np.zeros((0, n)), np.zeros(0), c, ctrl,
                    device=device, dtype=dtype)
    return res.x


def svm(X, labels: np.ndarray, lam: float = 1.0,
        ctrl: Optional[LPCtrl] = None, *,
        device, dtype) -> np.ndarray:
    """Soft-margin linear SVM (reference ``SVM.py``): dual QP
    max Σα − ½αᵀ(Y XXᵀ Y)α, 0 ≤ α ≤ 1/(2λm); returns (w, b)."""
    Xd = _dense(X)
    m, n = Xd.shape
    y = np.asarray(labels, float)
    K = (Xd * y[:, None]) @ (Xd * y[:, None]).T
    C = 1.0 / (2 * lam * m)
    # box QP via slack: α + s = C
    Q = np.block([[K, np.zeros((m, m))], [np.zeros((m, 2 * m))]])
    Q = Q + 1e-10 * np.eye(2 * m)
    c = np.concatenate([-np.ones(m), np.zeros(m)])
    A_eq = np.concatenate([np.eye(m), np.eye(m)], axis=1)
    res = qp_direct(Q, A_eq, np.full(m, C), c, ctrl, device=device,
                    dtype=dtype)
    alpha = res.x[:m]
    w = Xd.T @ (alpha * y)
    sv = (alpha > 1e-6 * C) & (alpha < C * (1 - 1e-6))
    if sv.any():
        b = np.mean(y[sv] - Xd[sv] @ w)
    else:
        b = 0.0
    return np.concatenate([w, [b]])


def total_variation(b: np.ndarray, lam: float,
                    ctrl: Optional[LPCtrl] = None, *,
                    device, dtype) -> np.ndarray:
    """1-D TV denoising: min ½‖x − b‖² + λ‖Dx‖₁ (reference ``TV.py``) as a
    QP over (x free split, |Dx| split)."""
    n = b.shape[0]
    D = (np.eye(n - 1, n, 1) - np.eye(n - 1, n))
    # vars [x⁺, x⁻, u, v ≥ 0]: D(x⁺−x⁻) − u + v = 0
    m = n - 1
    A_eq = np.concatenate([D, -D, -np.eye(m), np.eye(m)], axis=1)
    nvar = 2 * n + 2 * m
    Q = np.zeros((nvar, nvar))
    I = np.eye(n)
    Q[:n, :n] = I
    Q[:n, n:2 * n] = -I
    Q[n:2 * n, :n] = -I
    Q[n:2 * n, n:2 * n] = I
    Q += 1e-10 * np.eye(nvar)
    c = np.concatenate([-b, b, lam * np.ones(2 * m)])
    res = qp_direct(Q, A_eq, np.zeros(m), c, ctrl, device=device,
                    dtype=dtype)
    return res.x[:n] - res.x[n:2 * n]


def portfolio(Sigma, mu: np.ndarray, gamma: float = 1.0,
              ctrl: Optional[LPCtrl] = None, *,
              device, dtype) -> np.ndarray:
    """Long-only Markowitz: min γ·xᵀΣx − μᵀx s.t. Σx = 1, x ≥ 0."""
    Sd = _dense(Sigma)
    n = Sd.shape[0]
    res = qp_direct(2 * gamma * Sd, np.ones((1, n)), np.array([1.0]), -mu,
                    ctrl, device=device, dtype=dtype)
    return res.x


def robust_least_squares(A, b: np.ndarray, rho: float,
                         ctrl: Optional[LPCtrl] = None, *,
                         device, dtype) -> np.ndarray:
    """min ‖Ax − b‖₂ + ρ‖x‖₂ (reference ``RLS.py``) as an SOCP."""
    Ad = _dense(A)
    m, n = Ad.shape
    # vars: (x, t1, t2); min t1 + ρ t2
    # cones: (t1, Ax−b) ∈ SOC_{m+1}, (t2, x) ∈ SOC_{n+1}
    nv = n + 2
    G = np.zeros((m + 1 + n + 1, nv))
    h = np.zeros(m + 1 + n + 1)
    G[0, n] = -1.0
    G[1:m + 1, :n] = -Ad
    h[1:m + 1] = -b
    G[m + 1, n + 1] = -1.0
    G[m + 2:, :n] = -np.eye(n)
    c = np.zeros(nv)
    c[n] = 1.0
    c[n + 1] = rho
    res = socp_affine(np.zeros((0, nv)), np.zeros(0), G, h, c,
                      Cones([m + 1, n + 1]), ctrl, device=device,
                      dtype=dtype)
    return res.x[:n]


def rnnls(A, b: np.ndarray, rho: float,
          ctrl: Optional[LPCtrl] = None, *,
          device, dtype) -> np.ndarray:
    """Robust non-negative least squares (reference ``RNNLS.py``, which
    routes through the affine SOCP solver):

        min_{x ≥ 0}  ‖Ax − b‖₂ + ρ‖x‖₂

    — :func:`robust_least_squares` plus the nonnegative orthant (n
    order-1 cones appended to the two Lorentz cones)."""
    Ad = _dense(A)
    m, n = Ad.shape
    # vars (x, t1, t2); min t1 + ρ·t2
    nv = n + 2
    rows = m + 1 + n + 1 + n
    G = np.zeros((rows, nv))
    h = np.zeros(rows)
    G[0, n] = -1.0                       # (t1, Ax−b) ∈ SOC_{m+1}
    G[1:m + 1, :n] = -Ad
    h[1:m + 1] = -b
    G[m + 1, n + 1] = -1.0               # (t2, x) ∈ SOC_{n+1}
    G[m + 2:m + 2 + n, :n] = -np.eye(n)
    G[m + 2 + n:, :n] = -np.eye(n)       # x ≥ 0 (order-1 cones)
    c = np.zeros(nv)
    c[n] = 1.0
    c[n + 1] = rho
    res = socp_affine(np.zeros((0, nv)), np.zeros(0), G, h, c,
                      Cones([m + 1, n + 1] + [1] * n), ctrl, device=device,
                      dtype=dtype)
    return res.x[:n]


def basis_pursuit_complex(A: np.ndarray, b: np.ndarray,
                          ctrl: Optional[LPCtrl] = None, *,
                          device, dtype) -> np.ndarray:
    """Complex basis pursuit (reference ``BPComplex.py``):

        min ‖x‖₁  s.t.  Ax = b,   A ∈ ℂ^{m×n}, x ∈ ℂⁿ

    with ‖x‖₁ = Σ|xᵢ| = Σ‖(Re xᵢ, Im xᵢ)‖₂ — realified into an SOCP:
    variables (t, Re x, Im x), n order-3 Lorentz cones tᵢ ≥ ‖(Reᵢ, Imᵢ)‖,
    and the realified equality [Re A, −Im A; Im A, Re A]·(Re x; Im x) =
    (Re b; Im b)."""
    A = np.asarray(A, complex)
    b = np.asarray(b, complex)
    m, n = A.shape
    nv = n + 2 * n                        # (t, Re x, Im x)
    Ar, Ai = A.real, A.imag
    Aeq = np.zeros((2 * m, nv))
    Aeq[:m, n:2 * n] = Ar
    Aeq[:m, 2 * n:] = -Ai
    Aeq[m:, n:2 * n] = Ai
    Aeq[m:, 2 * n:] = Ar
    beq = np.concatenate([b.real, b.imag])
    G = np.zeros((3 * n, nv))
    h = np.zeros(3 * n)
    for i in range(n):
        G[3 * i, i] = -1.0               # tᵢ
        G[3 * i + 1, n + i] = -1.0       # Re xᵢ
        G[3 * i + 2, 2 * n + i] = -1.0   # Im xᵢ
    c = np.concatenate([np.ones(n), np.zeros(2 * n)])
    res = socp_affine(Aeq, beq, G, h, c, Cones([3] * n), ctrl,
                      device=device, dtype=dtype)
    return res.x[n:2 * n] + 1j * res.x[2 * n:]
