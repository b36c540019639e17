"""LU factorization (counterpart of ``elemental_tpu/lapack/lu.py``; reference
``src/lapack_like/factor/LU/``: partial and full pivoting, Mod, SolveAfter).

Partial pivoting is ``torch.linalg.lu_factor`` (LAPACK's ``getrf`` on the
host, cuSOLVER or MAGMA on the card).  Its pivots are 1-based LAPACK swaps;
:class:`LU` holds the JAX package's convention: 0-based sequential pivot
rows ``pivots`` and the row permutation ``perm`` with A[perm] = L·U (made
from the pivots on the host: n integers; the matrix stays on its device).

Full pivoting is a loop over the columns with one host read per step (the
row and column of the live block's largest |a_ij|, the first in row-major
order as ``jnp.argmax`` takes it) and in-place swaps.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision
from .perm import _swap_cols, _swap_rows

Arr = Union[torch.Tensor, DistMatrix]


class LU(NamedTuple):
    lu: torch.Tensor        # packed unit-lower L and U
    perm: torch.Tensor      # row permutation p: A[p] = L·U
    pivots: torch.Tensor    # LAPACK-style sequential pivot rows (0-based)


class LUFull(NamedTuple):
    lu: torch.Tensor
    rowperm: torch.Tensor
    colperm: torch.Tensor


def _permutation(pivots: np.ndarray, m: int) -> np.ndarray:
    """The row permutation of sequential swaps k ↔ pivots[k]."""
    perm = np.arange(m)
    for k, j in enumerate(pivots):
        perm[k], perm[j] = perm[j], perm[k]
    return perm


@with_precision
def lu(A: Arr) -> LU:
    """Partial-pivoted LU: P·A = L·U (reference ``LU``)."""
    a = as_array(A)
    packed, piv = torch.linalg.lu_factor(a)
    pivots = piv.to(torch.int64) - 1
    perm = _permutation(pivots.cpu().numpy(), a.shape[0])
    return LU(packed, torch.as_tensor(perm, device=a.device), pivots)


@with_precision
def lu_full(A: Arr) -> LUFull:
    """Fully-pivoted LU (reference ``LU/Full.hpp``): P·A·Q = L·U."""
    a = as_array(A).clone()
    m, n = a.shape
    rp = torch.arange(m, device=a.device)
    cp = torch.arange(n, device=a.device)
    for k in range(min(m, n)):
        flat = int(torch.argmax(a[k:, k:].abs().reshape(-1)))
        i, j = k + flat // (n - k), k + flat % (n - k)
        _swap_rows(a, k, i)
        _swap_rows(rp, k, i)
        _swap_cols(a, k, j)
        _swap_rows(cp, k, j)
        col = a[k + 1:, k] / a[k, k]
        a[k + 1:, k + 1:] -= torch.outer(col, a[k, k + 1:])
        a[k + 1:, k] = col
    return LUFull(a, rp, cp)


def solve_after(fact: LU, B: Arr, orient: str = "N") -> Arr:
    """Solve op(A)·X = B from a partial-pivoted factorization (reference
    ``LU/SolveAfter.hpp``)."""
    b = as_array(B)
    if orient.upper().startswith("N"):
        pb = b[fact.perm.to(b.device)]
        y = trsm("L", "L", "N", "U", 1, fact.lu, pb)
        x = trsm("L", "U", "N", "N", 1, fact.lu, as_array(y))
        return like(B, as_array(x))
    # op(A) X = B with A = Pᵀ L U: solve op(U) y = B, op(L) z = y, X = Pᵀ z
    o = orient.upper()[0]
    y = trsm("L", "U", o, "N", 1, fact.lu, b)
    z = trsm("L", "L", o, "U", 1, fact.lu, as_array(y))
    inv = torch.argsort(fact.perm).to(b.device)
    return like(B, as_array(z)[inv])


def solve_after_full(fact: LUFull, B: Arr) -> Arr:
    b = as_array(B)
    pb = b[fact.rowperm.to(b.device)]
    y = trsm("L", "L", "N", "U", 1, fact.lu, pb)
    x = as_array(trsm("L", "U", "N", "N", 1, fact.lu, as_array(y)))
    inv = torch.argsort(fact.colperm).to(b.device)
    return like(B, x[inv])


def lu_mod(fact: LU, u: Arr, v: Arr) -> LU:
    """Rank-one update of an LU factorization: factor A + u·vᴴ (reference
    ``LU/Mod.hpp``), by dense re-factorization."""
    a = fact.lu
    L = torch.tril(a, -1) + torch.eye(a.shape[0], dtype=a.dtype,
                                      device=a.device)
    U = torch.triu(a)
    inv = torch.argsort(fact.perm)
    A = (L @ U)[inv]
    newA = A + torch.outer(as_array(u).reshape(-1),
                           as_array(v).reshape(-1).conj())
    return lu(newA)


def linear_solve(A: Arr, B: Arr) -> Arr:
    """General solve via partial-pivoted LU (reference ``LinearSolve``)."""
    return solve_after(lu(A), B)


def determinant(A: Arr):
    """det(A) via LU (reference ``props/Determinant``)."""
    fact = lu(A)
    d = torch.diagonal(fact.lu)
    # each sequential pivot row differing from its index is one swap
    swaps = (fact.pivots != torch.arange(fact.pivots.shape[0],
                                         device=fact.pivots.device)).sum()
    sign = (1 - 2 * (swaps % 2)).to(d.dtype)
    return sign * torch.prod(d)
