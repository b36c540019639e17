"""BLAS-like level 2 (counterpart of ``elemental_tpu/ops/level2.py``;
reference ``src/blas_like/level2``): Gemv, Ger, Geru, Hemv, Symv, Her, Her2,
Syr, Syr2, Trmv, Trsv, ApplyGivensSequence.

A distributed operand is computed on where its blocks lie, as the JAX
package's GSPMD computes on the shards: ``gemv``, ``symv``, ``hemv`` and
``trmv`` as each block's product with its chunk of x, summed over the
contracted dimension at the grid's first position (laid out as a
distributed y or x where one is given); the rank-1 and rank-2 updates
block by block with the chunks of x and y each block's ranges need, the
triangle masked by global indices; ``apply_givens_sequence`` on the column
(row) panel its rotations sweep, gathered as the JAX HLO gathers it.
``trsv`` assembles A at the first position, as the JAX HLO gathers it
whole; the assembly is recorded.
"""

from __future__ import annotations

import functools
from typing import Union

import torch

from ..core.distmatrix import (DistMatrix, as_array, like, map_blocks,
                               vector_piece)
from ._blocks import chunks, diag_offset, each, reduce, tri, vec
from .level3 import (_common, _conj_scalar, _lower, _mm, _op, _triangle,
                     trsm)

Arr = Union[torch.Tensor, DistMatrix]


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x, y = _common(x, y)
    return torch.outer(x, y)


def _rows(A: Arr, parts, template):
    """The row partials ((at, (lo, hi), tensor) each) summed into a vector
    of A's height: at the grid's first position, or laid out with the
    dist of the DistMatrix ``template``."""
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for *_, t in parts))
    return reduce(A, [(at, (r,), t) for at, r, t in parts], (A.shape[0],),
                  dtype, into=template if isinstance(template, DistMatrix)
                  else None)


def _matvec(A: Arr, x: Arr, template=None):
    """A·x from each distinct block's product with its chunk of x."""
    x = vec(x)
    return _rows(A, [(at, at.rows, _mm(a, vector_piece(x, *at.cols, at)))
                     for at, a in chunks(A)], template)


def _finish(alpha, out, beta, y):
    """α·out + β·y (α·out without y)."""
    if y is None:
        return alpha * out
    if isinstance(out, DistMatrix):
        return each(lambda at, o: alpha * o
                    + beta * vector_piece(y, *at.rows, at), out)
    return alpha * out + beta * as_array(y).reshape(-1).to(out.device)


def gemv(orient: str, alpha, A: Arr, x: Arr, beta=0, y: Arr = None) -> Arr:
    return _finish(alpha, _matvec(_op(A, orient), x, y), beta, y)


def ger(alpha, x: Arr, y: Arr, A: Arr) -> Arr:
    """A += α·x·yᴴ (reference ``Ger``)."""
    x, y = vec(x), vec(y)
    return each(lambda at, a: a + alpha * _outer(
        vector_piece(x, *at.rows, at), vector_piece(y, *at.cols, at).conj()),
        A)


def geru(alpha, x: Arr, y: Arr, A: Arr) -> Arr:
    x, y = vec(x), vec(y)
    return each(lambda at, a: a + alpha * _outer(
        vector_piece(x, *at.rows, at), vector_piece(y, *at.cols, at)), A)


def _symv(uplo: str, alpha, A: Arr, x: Arr, beta, y, conjugate: bool):
    """(tri + oppᵀ − diag)·x from the stored triangle, block by block: each
    block's triangle times x's column chunk, its mirror times the row
    chunk, less the diagonal's share."""
    x, lower = vec(x), _lower(uplo)
    parts = []
    for at, a in chunks(A):
        t = tri(a, at, lower)
        parts.append((at, at.rows, _mm(t, vector_piece(x, *at.cols, at))))
        mirror = t.conj().T if conjugate else t.T
        parts.append((at, at.cols, _mm(mirror, vector_piece(x, *at.rows,
                                                             at))))
        loc, t0 = diag_offset(at)
        d = torch.diagonal(t, loc)
        if d.shape[0]:
            d = (torch.real(d) if conjugate else d).to(t.dtype)
            parts.append((at, (t0, t0 + d.shape[0]),
                          -d * vector_piece(x, t0, t0 + d.shape[0], at)))
    return _finish(alpha, _rows(A, parts, y), beta, y)


def symv(uplo: str, alpha, A: Arr, x: Arr, beta=0, y: Arr = None) -> Arr:
    return _symv(uplo, alpha, A, x, beta, y, False)


def hemv(uplo: str, alpha, A: Arr, x: Arr, beta=0, y: Arr = None) -> Arr:
    return _symv(uplo, alpha, A, x, beta, y, True)


def _tri_update(A: Arr, uplo: str, upd) -> Arr:
    """A + tri(upd(at)) block by block."""
    lower = _lower(uplo)
    return each(lambda at, a: a + tri(upd(at), at, lower), A)


def syr(uplo: str, alpha, x: Arr, A: Arr) -> Arr:
    x = vec(x)
    return _tri_update(A, uplo, lambda at: alpha * _outer(
        vector_piece(x, *at.rows, at), vector_piece(x, *at.cols, at)))


def her(uplo: str, alpha, x: Arr, A: Arr) -> Arr:
    x = vec(x)
    return _tri_update(A, uplo, lambda at: alpha * _outer(
        vector_piece(x, *at.rows, at),
        vector_piece(x, *at.cols, at).conj()))


def syr2(uplo: str, alpha, x: Arr, y: Arr, A: Arr) -> Arr:
    x, y = vec(x), vec(y)

    def upd(at):
        xr, xc = vector_piece(x, *at.rows, at), vector_piece(x, *at.cols, at)
        yr, yc = vector_piece(y, *at.rows, at), vector_piece(y, *at.cols, at)
        return alpha * (_outer(xr, yc) + _outer(yr, xc))
    return _tri_update(A, uplo, upd)


def her2(uplo: str, alpha, x: Arr, y: Arr, A: Arr) -> Arr:
    x, y = vec(x), vec(y)
    calpha = _conj_scalar(alpha)

    def upd(at):
        xr, xc = vector_piece(x, *at.rows, at), vector_piece(x, *at.cols, at)
        yr, yc = vector_piece(y, *at.rows, at), vector_piece(y, *at.cols, at)
        return (alpha * _outer(xr, yc.conj())
                + calpha * _outer(yr, xc.conj()))
    return _tri_update(A, uplo, upd)


def trmv(uplo: str, orient: str, diag: str, A: Arr, x: Arr) -> Arr:
    T = _triangle(A, uplo, diag.upper().startswith("U"))
    return _matvec(_op(T, orient), x, x)


def trsv(uplo: str, orient: str, diag: str, A: Arr, x: Arr) -> Arr:
    sol = trsm("L", uplo, orient, diag, 1, A, as_array(x).reshape(-1, 1))
    return like(x, as_array(sol).reshape(-1))


def _rotate(acc: torch.Tensor, c, s, left: bool) -> torch.Tensor:
    """The rotations applied in order to the rows (columns) of ``acc``, in
    place."""
    c, s = c.to(acc.device), s.to(acc.device)
    view = acc if left else acc.T
    for i in range(c.shape[0]):
        r0, r1 = view[i].clone(), view[i + 1].clone()
        view[i] = c[i] * r0 + s[i] * r1
        view[i + 1] = -s[i].conj() * r0 + c[i] * r1
    return acc


def apply_givens_sequence(side: str, c, s, A: Arr) -> Arr:
    """Apply a sequence of Givens rotations G_i acting on rows (columns for
    RIGHT) (i, i+1) (reference ``ApplyGivensSequence``), in order.  Each
    block of a distributed A rotates the column (row) panel it lies in,
    gathered at its position."""
    c, s = torch.as_tensor(c), torch.as_tensor(s)
    left = side.upper().startswith("L")
    if not isinstance(A, DistMatrix):
        return _rotate(as_array(A).clone(), c, s, left)
    m, n = A.shape

    def block(at, _):
        panel = A.fetch(((0, m), at.cols) if left else (at.rows, (0, n)),
                        at.pos, at.device)
        out = _rotate(panel.clone(), c, s, left)
        return out[slice(*at.rows)] if left else out[:, slice(*at.cols)]
    return map_blocks(block, A)
