"""BLAS-like level 1 (counterpart of ``elemental_tpu/ops/level1.py``;
reference ``include/El/blas_like/level1/*.hpp``, ``src/blas_like/level1``).

Entrywise / vector ops over local (``torch.Tensor``) or distributed
(:class:`DistMatrix`) operands.  A distributed operand is assembled on its
grid's first device and a distributed result cut again by the template's
distribution (:mod:`..core.distmatrix`); reductions return a tensor on that
device.  Every function returns a new tensor: none writes into its input.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..core.distmatrix import DistMatrix, as_array, like
from .level3 import _common

Arr = Union[torch.Tensor, DistMatrix]

__all__ = [
    "copy", "zero", "fill", "entrywise_fill", "entrywise_map",
    "index_dependent_map", "scale", "axpy", "axpby", "safe_scale", "shift",
    "shift_diagonal", "dot", "dotu", "nrm2", "hadamard", "max_abs_loc",
    "min_abs_loc", "column_norms", "row_norms", "column_max_norms",
    "row_max_norms", "transpose", "adjoint", "conjugate", "get_diagonal",
    "set_diagonal", "update_diagonal", "get_submatrix", "set_submatrix",
    "update_submatrix", "kronecker", "concatenate", "reshape", "swap_rows",
    "round_", "real", "imag", "make_symmetric", "make_hermitian",
    "make_trapezoidal", "diagonal_scale", "diagonal_solve",
    "symmetric_diagonal_equil"]


def _on(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``ref``'s device."""
    return as_array(x).to(ref.device)


# -- copies / fills ---------------------------------------------------------

def copy(A: Arr) -> Arr:
    return like(A, as_array(A).clone())


def zero(A: Arr) -> Arr:
    return like(A, torch.zeros_like(as_array(A)))


def fill(A: Arr, value) -> Arr:
    return like(A, torch.full_like(as_array(A), value))


def entrywise_fill(A: Arr, fn) -> Arr:
    """Fill with fn() draws — fn must return an array of A's shape."""
    a = as_array(A)
    return like(A, torch.as_tensor(np.asarray(fn(tuple(a.shape))))
                .to(a.device))


def entrywise_map(A: Arr, fn) -> Arr:
    return like(A, fn(as_array(A)))


def index_dependent_map(A: Arr, fn) -> Arr:
    """A[i,j] = fn(i, j, A[i,j]) (reference ``IndexDependentMap``), with
    broadcast int32 index grids."""
    a = as_array(A)
    m, n = a.shape
    i = torch.arange(m, dtype=torch.int32, device=a.device)[:, None] \
        .expand(m, n)
    j = torch.arange(n, dtype=torch.int32, device=a.device)[None, :] \
        .expand(m, n)
    return like(A, fn(i, j, a))


# -- scaling / axpy ---------------------------------------------------------

def scale(alpha, A: Arr) -> Arr:
    return like(A, alpha * as_array(A))


def axpy(alpha, X: Arr, Y: Arr) -> Arr:
    y = as_array(Y)
    return like(Y, y + alpha * _on(X, y))


def axpby(alpha, X: Arr, beta, Y: Arr) -> Arr:
    y = as_array(Y)
    return like(Y, beta * y + alpha * _on(X, y))


def safe_scale(numerator, denominator, A: Arr) -> Arr:
    """Scale by numerator/denominator (reference ``SafeScale``)."""
    a = as_array(A)
    ratio = torch.as_tensor(numerator / denominator, dtype=a.dtype,
                            device=a.device)
    return like(A, a * ratio)


def shift(A: Arr, alpha) -> Arr:
    return like(A, as_array(A) + alpha)


def shift_diagonal(A: Arr, alpha, offset: int = 0) -> Arr:
    d = torch.diagonal(as_array(A), offset)
    return update_diagonal(A, d + alpha, offset)


# -- products / reductions --------------------------------------------------

def dot(A: Arr, B: Arr) -> torch.Tensor:
    """⟨A,B⟩ = Σ conj(A)∘B (reference ``Dot``)."""
    a = as_array(A)
    a, b = _common(a.reshape(-1), _on(B, a).reshape(-1))
    return torch.vdot(a, b)


def dotu(A: Arr, B: Arr) -> torch.Tensor:
    a = as_array(A)
    return torch.sum(a * _on(B, a))


def nrm2(A: Arr) -> torch.Tensor:
    return torch.linalg.vector_norm(as_array(A).reshape(-1))


def hadamard(A: Arr, B: Arr) -> Arr:
    a = as_array(A)
    return like(A, a * _on(B, a))


def _abs_loc(A: Arr, pick):
    a = as_array(A)
    flat = torch.abs(a).reshape(-1)
    idx = pick(flat)
    if a.ndim == 2:
        return flat[idx], (idx // a.shape[1], idx % a.shape[1])
    return flat[idx], (idx,)


def max_abs_loc(A: Arr):
    """(value, (i,j)) of the entry with max |a_ij| (reference ``MaxAbsLoc``);
    the first such entry in row-major order."""
    return _abs_loc(A, torch.argmax)


def min_abs_loc(A: Arr):
    return _abs_loc(A, torch.argmin)


def column_norms(A: Arr) -> torch.Tensor:
    return torch.linalg.vector_norm(as_array(A), dim=0)


def row_norms(A: Arr) -> torch.Tensor:
    return torch.linalg.vector_norm(as_array(A), dim=1)


def column_max_norms(A: Arr) -> torch.Tensor:
    return torch.amax(torch.abs(as_array(A)), dim=0)


def row_max_norms(A: Arr) -> torch.Tensor:
    return torch.amax(torch.abs(as_array(A)), dim=1)


# -- structure --------------------------------------------------------------

def transpose(A: Arr) -> Arr:
    if isinstance(A, DistMatrix):
        return A.transpose()
    return as_array(A).transpose(-1, -2)


def adjoint(A: Arr) -> Arr:
    if isinstance(A, DistMatrix):
        return A.adjoint()
    return as_array(A).transpose(-1, -2).conj()


def conjugate(A: Arr) -> Arr:
    return like(A, as_array(A).conj())


def get_diagonal(A: Arr, offset: int = 0) -> torch.Tensor:
    return torch.diagonal(as_array(A), offset).clone()


def set_diagonal(A: Arr, d, offset: int = 0) -> Arr:
    return update_diagonal(A, as_array(d), offset)


def update_diagonal(A: Arr, d, offset: int = 0) -> Arr:
    """A with its ``offset`` diagonal set to d (the name is the JAX
    package's: it sets, as ``.at[].set``)."""
    a = as_array(A)
    d = _on(d, a).to(a.dtype)
    k = d.shape[0]
    i = torch.arange(k, device=a.device) + max(0, -offset)
    j = torch.arange(k, device=a.device) + max(0, offset)
    out = a.clone()
    out[i, j] = d
    return like(A, out)


def _ix(rows, cols, device):
    r = torch.as_tensor(np.asarray(rows)).to(device)
    c = torch.as_tensor(np.asarray(cols)).to(device)
    return r[:, None], c[None, :]


def get_submatrix(A: Arr, rows, cols) -> torch.Tensor:
    a = as_array(A)
    return a[_ix(rows, cols, a.device)]


def set_submatrix(A: Arr, rows, cols, B) -> Arr:
    a = as_array(A)
    out = a.clone()
    out[_ix(rows, cols, a.device)] = _on(B, a).to(a.dtype)
    return like(A, out)


def update_submatrix(A: Arr, rows, cols, alpha, B) -> Arr:
    """A[rows, cols] += α·B, repeated indices summed (``.at[].add``)."""
    a = as_array(A)
    r, c = _ix(rows, cols, a.device)
    upd = (alpha * _on(B, a)).to(a.dtype)
    r, c, upd = torch.broadcast_tensors(r, c, upd)
    return like(A, a.clone().index_put_((r, c), upd, accumulate=True))


def kronecker(A: Arr, B: Arr) -> torch.Tensor:
    a = as_array(A)
    a, b = _common(a, _on(B, a))
    return torch.kron(a, b)


def concatenate(mats: Sequence[Arr], axis: int = 0) -> torch.Tensor:
    parts = [as_array(m) for m in mats]
    return torch.cat([p.to(parts[0].device) for p in parts], dim=axis)


def reshape(A: Arr, m: int, n: int) -> Arr:
    return like(A, as_array(A).reshape(m, n))


def swap_rows(A: Arr, i: int, j: int) -> Arr:
    out = as_array(A).clone()
    out[[i, j]] = out[[j, i]]
    return like(A, out)


def round_(A: Arr) -> Arr:
    """Round half to even (a complex entry part by part)."""
    a = as_array(A)
    if a.is_complex():
        return like(A, torch.complex(torch.round(a.real),
                                     torch.round(a.imag)))
    return like(A, torch.round(a))


def real(A: Arr) -> Arr:
    return like(A, torch.real(as_array(A)).clone())


def imag(A: Arr) -> Arr:
    a = as_array(A)
    return like(A, torch.imag(a).clone() if a.is_complex()
                else torch.zeros_like(a))


def make_symmetric(A: Arr, uplo: str = "L", conjugate_: bool = False) -> Arr:
    a = as_array(A)
    tri = torch.tril(a) if uplo.upper().startswith("L") else torch.triu(a)
    opp = tri.conj().T if conjugate_ else tri.T
    d = torch.diagonal(tri)
    if conjugate_:
        d = torch.real(d).to(a.dtype)
    return like(A, tri + opp - torch.diag(d))


def make_hermitian(A: Arr, uplo: str = "L") -> Arr:
    return make_symmetric(A, uplo, conjugate_=True)


def make_trapezoidal(A: Arr, uplo: str = "L", offset: int = 0) -> Arr:
    a = as_array(A)
    if uplo.upper().startswith("L"):
        return like(A, torch.tril(a, offset))
    return like(A, torch.triu(a, offset))


# -- diagonal scaling -------------------------------------------------------

def diagonal_scale(side: str, d, A: Arr) -> Arr:
    """A ← diag(d)·A (LEFT) or A·diag(d) (RIGHT) (reference ``DiagonalScale``)."""
    a = as_array(A)
    d = _on(d, a)
    if side.upper().startswith("L"):
        return like(A, d[:, None] * a)
    return like(A, a * d[None, :])


def diagonal_solve(side: str, d, A: Arr) -> Arr:
    a = as_array(A)
    d = _on(d, a)
    if side.upper().startswith("L"):
        return like(A, a / d[:, None])
    return like(A, a / d[None, :])


def symmetric_diagonal_equil(A: Arr, d) -> Arr:
    """A ← diag(d)⁻¹ A diag(d)⁻¹ (used by equilibration)."""
    a = as_array(A)
    d = _on(d, a)
    return like(A, a / (d[:, None] * d[None, :]))
