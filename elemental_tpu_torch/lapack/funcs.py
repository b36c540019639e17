"""Matrix functions (counterpart of ``elemental_tpu/lapack/funcs.py``;
reference ``src/lapack_like/funcs``: HermitianFunction, Sign (Newton),
SquareRoot, Pseudoinverse, Inverse incl. triangular/HPD/symmetric).

``sign`` and ``square_root`` are the JAX package's ``while_loop``s: they
stop when the relative change falls to ``tol`` or after ``iters`` steps.
The port reads the change on the host once an iteration (compared in its
own dtype, as the JAX loop compares it), so both stop on the same
iteration; with the default tol = 1e-12, a float32 iteration never gets
there and runs all ``iters``.
"""

from __future__ import annotations

from typing import Union

import torch

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision
from .cholesky import cholesky
from .lu import lu, solve_after as lu_solve
from .spectral import hermitian_eig, svd

Arr = Union[torch.Tensor, DistMatrix]


def _adj(x: torch.Tensor) -> torch.Tensor:
    return x.mH.resolve_conj()


def _eye(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(a.shape[0], dtype=a.dtype, device=a.device)


@with_precision
def inverse(A: Arr) -> Arr:
    """General inverse via LU (reference ``funcs/Inverse``)."""
    a = as_array(A)
    return like(A, as_array(lu_solve(lu(a), _eye(a))))


def triangular_inverse(uplo: str, diag: str, A: Arr) -> Arr:
    """Triangular inverse (reference ``TriangularInverse``), a trsm against
    I with the other triangle zeroed."""
    a = as_array(A)
    out = as_array(trsm("L", uplo, "N", diag, 1, a, _eye(a)))
    lower = uplo.upper().startswith("L")
    return like(A, torch.tril(out) if lower else torch.triu(out))


@with_precision
def hpd_inverse(uplo: str, A: Arr) -> Arr:
    """HPD inverse via Cholesky (reference ``HPDInverse``): L⁻ᴴ·L⁻¹."""
    a = as_array(A)
    L = as_array(cholesky("L", a if uplo.upper().startswith("L")
                          else _adj(a)))
    Linv = as_array(triangular_inverse("L", "N", L))
    return like(A, _adj(Linv) @ Linv)


def symmetric_inverse(A: Arr, conjugate: bool = False) -> Arr:
    """Symmetric/Hermitian inverse via LDL (reference
    ``SymmetricInverse``)."""
    from .ldl import ldl, solve_after
    a = as_array(A)
    fact = ldl(a, conjugate=conjugate)
    return like(A, as_array(solve_after(fact, _eye(a), conjugate=conjugate)))


@with_precision
def pseudoinverse(A: Arr, tol: float = None) -> Arr:
    """Moore-Penrose pseudoinverse via the SVD (:func:`.spectral.svd`;
    reference ``Pseudoinverse``), singular values under tol·σ_max dropped
    (tol = max(m, n)·eps by default)."""
    a = as_array(A)
    u, s, vh = svd(a)
    eps = torch.finfo(s.dtype).eps
    cutoff = (tol if tol is not None else max(a.shape) * eps) * torch.max(s)
    sinv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s)).to(a.dtype)
    return like(A, _adj(vh) @ (sinv[:, None] * _adj(u)))


@with_precision
def sign(A: Arr, iters: int = 100, tol: float = 1e-12) -> Arr:
    """Matrix sign function by the scaled Newton iteration
    X ← (cX + (cX)⁻¹)/2, c = |det X|^(−1/n) (reference ``funcs/Sign``, the
    Sylvester/Lyapunov/Riccati engine)."""
    a = as_array(A)
    n = a.shape[0]
    x = a
    for _ in range(iters):
        xinv = torch.linalg.inv(x)
        logdet = torch.linalg.slogdet(x).logabsdet
        c = torch.exp(-logdet / n).to(a.dtype)
        xnew = (c * x + xinv / c) / 2
        diff = torch.linalg.norm(xnew - x) / torch.clamp(
            torch.linalg.norm(xnew), min=1e-30)
        x = xnew
        if not bool(diff > tol):
            break
    return like(A, x)


@with_precision
def square_root(A: Arr, iters: int = 64, tol: float = 1e-12) -> Arr:
    """Principal matrix square root by the Denman–Beavers iteration
    (reference ``funcs/SquareRoot``)."""
    a = as_array(A)
    y, z = a, _eye(a)
    anorm = torch.clamp(torch.linalg.norm(a), min=1e-30)
    for _ in range(iters):
        yinv = torch.linalg.inv(y)
        zinv = torch.linalg.inv(z)
        y, z = (y + zinv) / 2, (z + yinv) / 2
        diff = torch.linalg.norm(y @ y - a) / anorm
        if not bool(diff > tol):
            break
    return like(A, y)


def hpd_square_root(uplo: str, A: Arr) -> Arr:
    """Square root of an HPD matrix by its eigendecomposition (reference
    ``HPDSquareRoot``)."""
    return hermitian_function(uplo, A, torch.sqrt)


@with_precision
def hermitian_function(uplo: str, A: Arr, fn) -> Arr:
    """f(A) for Hermitian A by its eigendecomposition (reference
    ``HermitianFunction``)."""
    pair = hermitian_eig(uplo, A, vectors=True)
    w = fn(pair.w)
    a = as_array(A)
    return like(A, (pair.q * w[None, :].to(a.dtype)) @ _adj(pair.q))
