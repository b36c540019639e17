"""Solvers (counterpart of ``elemental_tpu/lapack/solve.py``; reference
``src/lapack_like/solve``: Linear, HPD, Symmetric/Hermitian, SQSD,
MultiShiftHess; headers ``include/El/lapack_like/solve/
{GMRES,LGMRES,FGMRES,Refined}.hpp``).

The dense solvers factor with the port's dense LAPACK (``ldl``, and the
re-exported ``hpd_solve`` and ``linear_solve``); ``multishift_hess_solve``
is one batched ``torch.linalg.solve`` over the shifts.

The Krylov operator is any callable on tensors (a dense product,
``SpMVPlan.matvec``).  The reference's ``while_loop``/``fori_loop`` bodies
become Python loops on tensors: the vectors stay on their device, and each
loop test is one host-side comparison per iteration (one device
synchronisation).  The arithmetic is the reference's, step for step, so in
float64 the iteration counts are its counts.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..core.distmatrix import DistMatrix, as_array, like
from .cholesky import hpd_solve  # noqa: F401  (re-exported)
from .ldl import ldl
from .ldl import solve_after as ldl_solve_after
from .lu import linear_solve  # noqa: F401  (re-exported)

Arr = Union[torch.Tensor, DistMatrix]


def symmetric_solve(A: Arr, B: Arr, conjugate: bool = False) -> Arr:
    """Solve with symmetric (or Hermitian when conjugate) A via dense LDL
    (reference ``SymmetricSolve``/``HermitianSolve``)."""
    fact = ldl(A, conjugate=conjugate)
    return ldl_solve_after(fact, B, conjugate=conjugate)


def hermitian_solve(A: Arr, B: Arr) -> Arr:
    return symmetric_solve(A, B, conjugate=True)


def sqsd_solve(A: Arr, B: Arr) -> Arr:
    """Symmetric quasi-semidefinite solve (reference ``SQSDSolve``): LDL
    without pivoting is stable for SQSD operands."""
    return symmetric_solve(A, B, conjugate=False)


def multishift_hess_solve(H: Arr, shifts, B: Arr) -> Arr:
    """Solve (H − σ_j I) x_j = b_j with upper-Hessenberg H (reference
    ``MultiShiftHessSolve``): one batched solve over the shifts."""
    h = as_array(H)
    b = as_array(B)
    shifts = torch.as_tensor(shifts, device=h.device)
    eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    dt = torch.promote_types(torch.promote_types(h.dtype, shifts.dtype),
                             b.dtype)
    lhs = (h[None] - shifts[:, None, None] * eye).to(dt)
    x = torch.linalg.solve(lhs, b.T.to(dt)[:, :, None])[:, :, 0].T
    return like(B, x)


class KrylovResult(NamedTuple):
    x: torch.Tensor
    residual: float
    iterations: int


def _vec(b) -> torch.Tensor:
    return torch.as_tensor(b).reshape(-1)


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    """v, with 0 replaced by 1 (the reference's ``where(v == 0, 1, v)``)."""
    return torch.where(v == 0, 1.0, v)


def _target(b: torch.Tensor, tol: float) -> torch.Tensor:
    """``tol·‖b‖`` (``tol`` when b = 0), in b's dtype, on b's device."""
    return tol * _nonzero(torch.linalg.vector_norm(b))


def _gmres_cycle(apply_a: Callable, precond: Callable, b, x0, m: int):
    """One restart cycle of right-preconditioned GMRES(m) with modified
    Gram-Schmidt Arnoldi, fixed m (a breakdown leaves zero columns).

    The small least-squares problem min ‖βe₁ − H·y‖ is solved on the host
    in float64 (complex128 for a complex H) by NumPy's SVD-based ``lstsq``
    (rank-revealing, so a happy breakdown, where H loses rank, gives the
    minimum-norm solution, as the reference's ``jnp.linalg.lstsq`` does)."""
    n = b.shape[0]
    r0 = b - apply_a(x0)
    beta = torch.linalg.vector_norm(r0)
    V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
    V[0] = r0 / _nonzero(beta)
    H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
    Z = torch.zeros((m, n), dtype=b.dtype, device=b.device)
    for j in range(m):
        z = precond(V[j])
        w = apply_a(z)
        # rows past j + 1 of V are zero, so the reference's masked loop
        # over all m + 1 rows does the same arithmetic as this one
        for i in range(j + 1):
            hij = torch.vdot(V[i], w)
            H[i, j] = hij
            w = w - hij * V[i]
        hnorm = torch.linalg.vector_norm(w)
        H[j + 1, j] = hnorm
        V[j + 1] = w / _nonzero(hnorm)
        Z[j] = z
    host = np.complex128 if H.is_complex() else np.float64
    e1 = np.zeros(m + 1, host)
    e1[0] = float(beta)
    y, *_ = np.linalg.lstsq(H.cpu().numpy().astype(host), e1, rcond=None)
    x = x0 + Z.T @ torch.as_tensor(y, dtype=b.dtype, device=b.device)
    return x, torch.linalg.vector_norm(b - apply_a(x))


def gmres(apply_a: Callable, b, x0=None, restart: int = 30,
          max_cycles: int = 20, tol: float = 1e-8,
          precond: Optional[Callable] = None) -> KrylovResult:
    """Restarted GMRES (reference ``solve/GMRES.hpp``).  ``apply_a`` is any
    linear operator; supply ``precond`` for right preconditioning (making
    this FGMRES when the preconditioner varies).  ``iterations`` counts
    restart cycles."""
    b = _vec(b)
    x = torch.zeros_like(b) if x0 is None else _vec(x0)
    precond = precond if precond is not None else (lambda v: v)
    target = _target(b, tol)
    res = torch.linalg.vector_norm(b - apply_a(x))
    it = 0
    while it < max_cycles and bool(res > target):
        x, res = _gmres_cycle(apply_a, precond, b, x, restart)
        it += 1
    return KrylovResult(x, float(res), it)


def fgmres(apply_a: Callable, b, precond: Callable, **kw) -> KrylovResult:
    """Flexible GMRES (reference ``solve/FGMRES.hpp``): the Arnoldi basis
    stores preconditioned vectors, so the preconditioner may change per
    iteration (e.g. an inner iterative solve)."""
    return gmres(apply_a, b, precond=precond, **kw)


def lgmres(apply_a: Callable, b, **kw) -> KrylovResult:
    """LGMRES (reference ``solve/LGMRES.hpp``) as the reference implements
    it: plain restarts with a longer default window (40)."""
    kw.setdefault("restart", 40)
    return gmres(apply_a, b, **kw)


def refined_solve(apply_a: Callable, apply_inv: Callable, b,
                  max_iters: int = 10, tol: float = 1e-12) -> KrylovResult:
    """Iterative refinement x ← x + Ã⁻¹(b − A·x) (reference
    ``solve/Refined.hpp``), to recover full precision from an approximate
    (e.g. regularized or low-precision) inverse ``apply_inv``."""
    b = torch.as_tensor(b)
    x = apply_inv(b)
    target = _target(b, tol)
    res = torch.linalg.vector_norm(b - apply_a(x))
    it = 0
    while it < max_iters and bool(res > target):
        x = x + apply_inv(b - apply_a(x))
        res = torch.linalg.vector_norm(b - apply_a(x))
        it += 1
    return KrylovResult(x, float(res), it)


def cg(apply_a: Callable, b, x0=None, max_iters: int = 1000,
       tol: float = 1e-8, precond: Optional[Callable] = None
       ) -> KrylovResult:
    """Preconditioned conjugate gradients for HPD operators.  ``residual``
    is the recurrence residual ‖r‖; ``apply_a`` runs once before the loop
    and once per iteration."""
    b = _vec(b)
    x = torch.zeros_like(b) if x0 is None else _vec(x0)
    M = precond if precond is not None else (lambda v: v)
    r = b - apply_a(x)
    z = M(r)
    p = z
    rz = torch.vdot(r, z)
    target = _target(b, tol)
    it = 0
    while it < max_iters and bool(torch.linalg.vector_norm(r) > target):
        ap = apply_a(p)
        alpha = rz / _nonzero(torch.vdot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = torch.vdot(r, z)
        p = z + rz_new / _nonzero(rz) * p
        rz = rz_new
        it += 1
    return KrylovResult(x, float(torch.linalg.vector_norm(r)), it)
