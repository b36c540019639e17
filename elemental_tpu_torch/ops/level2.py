"""BLAS-like level 2 (counterpart of ``elemental_tpu/ops/level2.py``;
reference ``src/blas_like/level2``): Gemv, Ger, Geru, Hemv, Symv, Her, Her2,
Syr, Syr2, Trmv, Trsv, ApplyGivensSequence.

The JAX package lets GSPMD partition each contraction; the port assembles
the operands on the grid's first device, computes there and cuts a
distributed result again (:mod:`..core.distmatrix`).
"""

from __future__ import annotations

from typing import Union

import torch

from ..core.distmatrix import DistMatrix, as_array, like
from .level3 import _common, _mask_tri, _mm, _orient, _unit_diag, trsm

Arr = Union[torch.Tensor, DistMatrix]


def _vec(x: Arr) -> torch.Tensor:
    return as_array(x).reshape(-1)


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x, y = _common(x, y)
    return torch.outer(x, y)


def gemv(orient: str, alpha, A: Arr, x: Arr, beta=0, y: Arr = None) -> Arr:
    a = _orient(as_array(A), orient)
    out = alpha * _mm(a, _vec(x))
    if y is not None:
        out = out + beta * _vec(y)
        return like(y, out)
    return out


def ger(alpha, x: Arr, y: Arr, A: Arr) -> Arr:
    """A += α·x·yᴴ (reference ``Ger``)."""
    return like(A, as_array(A) + alpha * _outer(_vec(x), _vec(y).conj()))


def geru(alpha, x: Arr, y: Arr, A: Arr) -> Arr:
    return like(A, as_array(A) + alpha * _outer(_vec(x), _vec(y)))


def _sym_full(a, uplo, conjugate):
    tri = _mask_tri(a, uplo)
    opp = tri.conj().T if conjugate else tri.T
    d = torch.real(torch.diagonal(tri)) if conjugate else torch.diagonal(tri)
    return tri + opp - torch.diag(d.to(a.dtype))


def symv(uplo: str, alpha, A: Arr, x: Arr, beta=0, y: Arr = None) -> Arr:
    out = alpha * _mm(_sym_full(as_array(A), uplo, False), _vec(x))
    if y is not None:
        out = out + beta * _vec(y)
        return like(y, out)
    return out


def hemv(uplo: str, alpha, A: Arr, x: Arr, beta=0, y: Arr = None) -> Arr:
    out = alpha * _mm(_sym_full(as_array(A), uplo, True), _vec(x))
    if y is not None:
        out = out + beta * _vec(y)
        return like(y, out)
    return out


def _tri_update(A, upd, uplo):
    return like(A, as_array(A) + _mask_tri(upd, uplo))


def syr(uplo: str, alpha, x: Arr, A: Arr) -> Arr:
    xv = _vec(x)
    return _tri_update(A, alpha * _outer(xv, xv), uplo)


def her(uplo: str, alpha, x: Arr, A: Arr) -> Arr:
    xv = _vec(x)
    return _tri_update(A, alpha * _outer(xv, xv.conj()), uplo)


def syr2(uplo: str, alpha, x: Arr, y: Arr, A: Arr) -> Arr:
    xv, yv = _vec(x), _vec(y)
    return _tri_update(A, alpha * (_outer(xv, yv) + _outer(yv, xv)), uplo)


def her2(uplo: str, alpha, x: Arr, y: Arr, A: Arr) -> Arr:
    xv, yv = _vec(x), _vec(y)
    calpha = (alpha.conj() if isinstance(alpha, torch.Tensor)
              else alpha.conjugate())
    upd = (alpha * _outer(xv, yv.conj())
           + calpha * _outer(yv, xv.conj()))
    return _tri_update(A, upd, uplo)


def trmv(uplo: str, orient: str, diag: str, A: Arr, x: Arr) -> Arr:
    tri = _mask_tri(as_array(A), uplo)
    if diag.upper().startswith("U"):
        tri = _unit_diag(tri)
    return like(x, _mm(_orient(tri, orient), _vec(x)))


def trsv(uplo: str, orient: str, diag: str, A: Arr, x: Arr) -> Arr:
    sol = trsm("L", uplo, orient, diag, 1, A, as_array(x).reshape(-1, 1))
    return like(x, as_array(sol).reshape(-1))


def apply_givens_sequence(side: str, c, s, A: Arr) -> Arr:
    """Apply a sequence of Givens rotations G_i acting on rows (columns for
    RIGHT) (i, i+1) (reference ``ApplyGivensSequence``), in order."""
    a = as_array(A)
    c = torch.as_tensor(c).to(a.device)
    s = torch.as_tensor(s).to(a.device)
    acc = a.clone()
    view = acc if side.upper().startswith("L") else acc.T
    for i in range(c.shape[0]):
        r0, r1 = view[i].clone(), view[i + 1].clone()
        view[i] = c[i] * r0 + s[i] * r1
        view[i + 1] = -s[i].conj() * r0 + c[i] * r1
    return like(A, acc)
