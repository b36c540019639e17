"""Cholesky factorization (counterpart of ``elemental_tpu/lapack/cholesky.py``;
reference ``src/lapack_like/factor/Cholesky*``: blocked Variant3 L/U,
reverse, pivoted, LowerMod rank-update, SolveAfter).

The JAX package's recursive blocked Cholesky: a midpoint recursion whose
trailing update ``A22 − L21·L21ᴴ`` is one ``torch.matmul`` per level (TF32
off), with ``torch.linalg.cholesky_ex`` on blocks of at most 256.  The
blocks are written into one output tensor in place.

Two differences of the libraries are bridged so that both packages give
the same factor: ``jax.lax.linalg.cholesky`` symmetrizes its input
(``(A + Aᴴ)/2``) where ``torch.linalg.cholesky`` reads one triangle, so the
base block is symmetrized here; and where JAX writes NaN over a block that
is not positive definite, ``cholesky_ex`` reports it in ``info`` (read on
the device, no host check), and the block is set to NaN.

``pivoted_cholesky`` is a loop over the columns with one host read per
column (the largest live diagonal entry and its index); the matrix stays on
its device.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision
from .perm import _swap_symmetric

Arr = Union[torch.Tensor, DistMatrix]

_BASE = 256


def _adj(x: torch.Tensor) -> torch.Tensor:
    return x.mH.resolve_conj()


def _chol_base(a: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex((a + a.mH) / 2)
    return torch.where(info == 0, L, torch.full((), float("nan"),
                                                dtype=a.dtype,
                                                device=a.device))


def _chol_into(a: torch.Tensor, out: torch.Tensor) -> None:
    """Write the lower Cholesky factor of ``a`` into ``out`` (its strict
    upper triangle is left as it was)."""
    n = a.shape[0]
    if n <= _BASE:
        out.copy_(_chol_base(a))
        return
    m = n // 2
    _chol_into(a[:m, :m], out[:m, :m])
    # L21 = A21 · L11⁻ᴴ
    L21 = torch.linalg.solve_triangular(out[:m, :m].mH, a[m:, :m],
                                        upper=True, left=False)
    out[m:, :m] = L21
    _chol_into(a[m:, m:] - torch.matmul(L21, L21.mH), out[m:, m:])


def _chol_lower_rec(a: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(a)
    _chol_into(a, out)
    return out


@with_precision
def cholesky(uplo: str, A: Arr) -> Arr:
    """Return the Cholesky factor of Hermitian positive-definite A: lower L
    with A = L·Lᴴ, or upper U with A = Uᴴ·U (reference ``Cholesky``)."""
    a = as_array(A)
    if uplo.upper().startswith("L"):
        out = torch.tril(_chol_lower_rec(a))
    else:
        # U = (chol_lower(Aᴴ))ᴴ
        out = _adj(torch.tril(_chol_lower_rec(_adj(a))))
    return like(A, out)


def reverse_cholesky(uplo: str, A: Arr) -> Arr:
    """Reverse Cholesky (reference ``Cholesky/ReverseLowerVariant3.hpp``):
    A = Lᴴ·L (LOWER) or A = U·Uᴴ (UPPER), by flipping both axes, factoring,
    and flipping back."""
    a = as_array(A)
    flipped = a.flip(0, 1)
    if uplo.upper().startswith("L"):
        u = as_array(cholesky("U", flipped))
        return like(A, u.flip(0, 1))
    low = as_array(cholesky("L", flipped))
    return like(A, low.flip(0, 1))


class PivotedCholesky(NamedTuple):
    factor: torch.Tensor
    perm: torch.Tensor   # permutation vector p: A[p][:,p] = L·Lᴴ
    rank: torch.Tensor   # numerical rank detected


def pivoted_cholesky(uplo: str, A: Arr, tol: float = 0.0) -> PivotedCholesky:
    """Diagonally-pivoted Cholesky (reference
    ``Cholesky/PivotedLowerVariant3``): at step k pivot the largest remaining
    diagonal entry (the first of equal ones) to position k; a pivot counts
    toward the rank when it exceeds ``tol``."""
    a = as_array(A).clone()
    if not uplo.upper().startswith("L"):
        a = _adj(a).clone()
    n = a.shape[0]
    p = torch.arange(n, device=a.device)
    rank = 0
    for k in range(n):
        best, j = torch.max(torch.diagonal(a)[k:].real, 0)
        pivot, j = torch.stack([best, j.to(best.dtype)]).tolist()
        j = k + int(j)
        _swap_symmetric(a, p, k, j)
        ok = pivot > tol
        rank += int(ok)
        root = torch.sqrt(a[k, k].real if ok else
                          torch.ones((), dtype=best.dtype,
                                     device=a.device)).to(a.dtype)
        col = a[k + 1:, k] / root
        a[k + 1:, k] = col
        a[k, k] = root
        a[k + 1:, k + 1:] -= torch.outer(col, col.conj())
    return PivotedCholesky(torch.tril(a), p,
                           torch.tensor(rank, dtype=torch.int32))


def cholesky_mod(uplo: str, L: Arr, alpha, V: Arr) -> Arr:
    """Update the factor after a rank-k perturbation: given A = L·Lᴴ, return
    the factor of A + α·V·Vᴴ (reference ``Cholesky/LowerMod.hpp``), by
    dense re-formation."""
    lo = as_array(L)
    v = as_array(V)
    lower = uplo.upper().startswith("L")
    base = lo @ lo.mH if lower else lo.mH @ lo
    newA = base + alpha * (v @ v.mH)
    return like(L, as_array(cholesky(uplo, newA)))


def solve_after(uplo: str, orient: str, L: Arr, B: Arr) -> Arr:
    """Solve A·X = B given the Cholesky factor (reference
    ``factor/Cholesky/SolveAfter.hpp``): two triangular solves."""
    if uplo.upper().startswith("L"):
        y = trsm("L", "L", "N", "N", 1, L, B)
        x = trsm("L", "L", "C", "N", 1, L, y)
    else:
        y = trsm("L", "U", "C", "N", 1, L, B)
        x = trsm("L", "U", "N", "N", 1, L, y)
    return like(B, as_array(x))


def hpd_solve(uplo: str, A: Arr, B: Arr) -> Arr:
    """Factor + solve (reference ``HPDSolve``)."""
    L = cholesky(uplo, A)
    return solve_after(uplo, "N", L, B)
