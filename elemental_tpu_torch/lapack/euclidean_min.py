"""Euclidean minimization (counterpart of
``elemental_tpu/lapack/euclidean_min.py``; reference
``src/lapack_like/euclidean_min``: LeastSquares, Ridge, Tikhonov, GLM,
LSE)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision
from .cholesky import _adj, cholesky
from .cholesky import solve_after as chol_solve
from .qr import qr

Arr = Union[torch.Tensor, DistMatrix]


def _op(a: torch.Tensor, orient: str) -> torch.Tensor:
    o = orient.upper()[0]
    if o == "N":
        return a
    return _adj(a) if o in ("C", "A") else a.T


@with_precision
def least_squares(orient: str, A: Arr, B: Arr) -> Arr:
    """min ‖op(A)·X − B‖_F (reference ``LeastSquares``) via QR for m ≥ n,
    the minimum-norm solution via the QR of op(A)ᴴ for m < n."""
    a = _op(as_array(A), orient)
    b = as_array(B)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    m, n = a.shape
    if m >= n:
        q, r = qr(a)
        x = as_array(trsm("L", "U", "N", "N", 1, r, q.mH @ b))
    else:
        # minimum-norm: x = Aᴴ (A Aᴴ)⁻¹ b via QR of Aᴴ
        q, r = qr(_adj(a))
        y = as_array(trsm("L", "U", "C", "N", 1, r, b))
        x = q @ y
    if squeeze:
        x = x[:, 0]
    return like(B, x)


def _normal_solve(a: torch.Tensor, B: Arr, lhs: torch.Tensor) -> Arr:
    """Solve lhs·X = Aᴴ·B by Cholesky (B a vector or a matrix)."""
    b = as_array(B)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    L = cholesky("L", lhs)
    x = as_array(chol_solve("L", "N", L, a.mH @ b))
    if squeeze:
        x = x[:, 0]
    return like(B, x)


@with_precision
def ridge(orient: str, A: Arr, B: Arr, gamma: float) -> Arr:
    """min ‖A·X − B‖² + γ²‖X‖² (reference ``Ridge``) via the normal
    equations (AᴴA + γ²I) X = AᴴB and a Cholesky solve."""
    a = as_array(A)
    if not orient.upper().startswith("N"):
        a = _adj(a)
    n = a.shape[1]
    g = torch.matmul(a.mH, a) + (gamma ** 2) * torch.eye(
        n, dtype=a.dtype, device=a.device)
    return _normal_solve(a, B, g)


@with_precision
def tikhonov(orient: str, A: Arr, B: Arr, G: Arr) -> Arr:
    """min ‖A·X − B‖² + ‖G·X‖² with a general regularizer G (reference
    ``Tikhonov``): normal equations (AᴴA + GᴴG) X = AᴴB."""
    a = as_array(A)
    if not orient.upper().startswith("N"):
        a = _adj(a)
    g = as_array(G)
    return _normal_solve(a, B, a.mH @ a + g.mH @ g)


@with_precision
def lse(A: Arr, B: Arr, c, d) -> torch.Tensor:
    """Equality-constrained least squares: min ‖A·x − c‖ s.t. B·x = d
    (reference ``LSE``), by the nullspace method on the complete QR of
    Bᴴ."""
    a, b = as_array(A), as_array(B)
    c = as_array(c).reshape(-1)
    d = as_array(d).reshape(-1)
    p, n = b.shape
    q_full, r_full = torch.linalg.qr(_adj(b), mode="complete")
    r = r_full[:p, :]
    # B x = d  ⇒  rᴴ (q1ᴴ x) = d
    y1 = torch.linalg.solve_triangular(r.mH, d[:, None], upper=False)[:, 0]
    q1, q2 = q_full[:, :p], q_full[:, p:]
    resid_rhs = c - a @ (q1 @ y1)
    y2 = as_array(least_squares("N", a @ q2, resid_rhs))
    return q1 @ y1 + q2 @ y2


@with_precision
def glm(A: Arr, B: Arr, d) -> Tuple[torch.Tensor, torch.Tensor]:
    """General (Gauss-Markov) linear model: min ‖y‖ s.t. d = A·x + B·y
    (reference ``GLM``), through the KKT system
    [[0,0,Aᴴ],[0,I,Bᴴ],[A,B,0]] [x;y;λ] = [0;0;d]."""
    a, b = as_array(A), as_array(B)
    d = as_array(d).reshape(-1)
    m, n, p = a.shape[0], a.shape[1], b.shape[1]
    dt, dev = a.dtype, a.device
    kkt = torch.zeros((n + p + m, n + p + m), dtype=dt, device=dev)
    kkt[:n, n + p:] = a.mH
    kkt[n:n + p, n:n + p] = torch.eye(p, dtype=dt, device=dev)
    kkt[n:n + p, n + p:] = b.mH
    kkt[n + p:, :n] = a
    kkt[n + p:, n:n + p] = b
    rhs = torch.cat([torch.zeros(n + p, dtype=dt, device=dev), d.to(dt)])
    sol = torch.linalg.solve(kkt, rhs)
    return sol[:n], sol[n:n + p]
