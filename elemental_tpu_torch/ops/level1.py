"""BLAS-like level 1 (counterpart of ``elemental_tpu/ops/level1.py``;
reference ``include/El/blas_like/level1/*.hpp``, ``src/blas_like/level1``).

Entrywise / vector ops over local (``torch.Tensor``) or distributed
(:class:`DistMatrix`) operands.  A distributed operand is computed on where
its blocks lie, as GSPMD computes on the shards: entrywise ops block by
block (:func:`~..core.distmatrix.map_blocks`, other operands brought to the
first one's layout), reductions as partials of each distinct block summed
at the grid's first position (:func:`~..core.distmatrix.reduce_parts`),
index-dependent ops with each block's global indices.  A reduction returns
a tensor on the grid's first device.  ``make_symmetric``/``make_hermitian``
assemble the matrix on the first position, as the JAX package's HLO
gathers it whole there; the assembly is recorded.  Every function returns
a new tensor: none writes into its input.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..core.distmatrix import (At, DistMatrix, as_array, from_blocks, like,
                               map_blocks, vector_piece)
from ..utils import transfers
from ._blocks import chunks, diag_offset, each, first_device, on, reduce, \
    tri, vec
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


def _index_grids(at: At):
    (r0, r1), (c0, c1) = at.rows, at.cols
    i = torch.arange(r0, r1, dtype=torch.int32, device=at.device)[:, None] \
        .expand(r1 - r0, c1 - c0)
    j = torch.arange(c0, c1, dtype=torch.int32, device=at.device)[None, :] \
        .expand(r1 - r0, c1 - c0)
    return i, j


# -- copies / fills ---------------------------------------------------------

def copy(A: Arr) -> Arr:
    return each(lambda _, a: a.clone(), A)


def zero(A: Arr) -> Arr:
    return each(lambda _, a: torch.zeros_like(a), A)


def fill(A: Arr, value) -> Arr:
    return each(lambda _, a: torch.full_like(a, value), A)


def entrywise_fill(A: Arr, fn) -> Arr:
    """Fill with fn() draws — fn must return an array of A's shape (drawn
    whole on the host and placed as :func:`distribute` places it)."""
    vals = torch.as_tensor(np.asarray(fn(tuple(A.shape))))
    if isinstance(A, DistMatrix):
        return DistMatrix._from_whole(vals, A.coldist, A.rowdist, A.grid,
                                      A.root, warn=False)
    return vals.to(as_array(A).device)


def entrywise_map(A: Arr, fn) -> Arr:
    return each(lambda _, a: fn(a), A)


def index_dependent_map(A: Arr, fn) -> Arr:
    """A[i,j] = fn(i, j, A[i,j]) (reference ``IndexDependentMap``), with
    broadcast int32 grids of each block's global indices."""
    return each(lambda at, a: fn(*_index_grids(at), a), A)


# -- scaling / axpy ---------------------------------------------------------

def scale(alpha, A: Arr) -> Arr:
    return each(lambda _, a: alpha * a, A)


def axpy(alpha, X: Arr, Y: Arr) -> Arr:
    return each(lambda _, y, x: y + alpha * x, Y, X)


def axpby(alpha, X: Arr, beta, Y: Arr) -> Arr:
    return each(lambda _, y, x: beta * y + alpha * x, Y, X)


def safe_scale(numerator, denominator, A: Arr) -> Arr:
    """Scale by numerator/denominator (reference ``SafeScale``)."""
    return each(lambda _, a: a * torch.as_tensor(
        numerator / denominator, dtype=a.dtype, device=a.device), A)


def shift(A: Arr, alpha) -> Arr:
    return each(lambda _, a: a + alpha, A)


def _diag_len(shape, offset: int) -> int:
    m, n = shape
    return max(0, min(m, n - offset) if offset >= 0 else min(m + offset, n))


def _on_diagonal(A: Arr, offset: int, k: int, values) -> Arr:
    """A with entries t = 0..k-1 of its ``offset`` diagonal set to
    ``values(at, lo, hi, old)`` (entries lo:hi, ``old`` their values) in
    each block the diagonal crosses."""
    def block(at, a):
        loc, t0 = diag_offset(at, offset)
        out = a.clone()
        diag = torch.diagonal(out, loc)
        lo, hi = max(t0, 0), min(t0 + diag.shape[0], k)
        if lo < hi:
            seg = diag[lo - t0:hi - t0]
            seg.copy_(values(at, lo, hi, seg.clone()).to(a.dtype))
        return out
    return each(block, A)


def shift_diagonal(A: Arr, alpha, offset: int = 0) -> Arr:
    return _on_diagonal(A, offset, _diag_len(A.shape, offset),
                        lambda at, lo, hi, old: old + alpha)


# -- products / reductions --------------------------------------------------

def _scalar(A: Arr, B: Arr, fn):
    """Σ over the distinct blocks of fn(a, b), at the first position."""
    parts = [(at, (), fn(a, b)) for at, a, b in chunks(A, B)]
    return reduce(A, parts, (), parts[0][2].dtype)


def dot(A: Arr, B: Arr) -> torch.Tensor:
    """⟨A,B⟩ = Σ conj(A)∘B (reference ``Dot``)."""
    return _scalar(A, B, lambda a, b: torch.vdot(
        *_common(a.reshape(-1), b.reshape(-1))))


def dotu(A: Arr, B: Arr) -> torch.Tensor:
    return _scalar(A, B, lambda a, b: torch.sum(a * b))


def _abs2(a: torch.Tensor) -> torch.Tensor:
    return (a * a.conj()).real


def nrm2(A: Arr) -> torch.Tensor:
    parts = [(at, (), torch.vdot(a.reshape(-1), a.reshape(-1)).real)
             for at, a in chunks(A)]
    return torch.sqrt(reduce(A, parts, (), parts[0][2].dtype))


def hadamard(A: Arr, B: Arr) -> Arr:
    return each(lambda _, a, b: a * b, A, B)


def _abs_loc(A: Arr, largest: bool):
    """The first entry (row-major) of largest or smallest |a_ij|: each
    distinct block's candidate and its global flat index, compared at the
    first position."""
    n = A.shape[1] if len(A.shape) == 2 else 1
    vals, flat = [], []
    for at, a in chunks(A):
        if a.numel() == 0:
            continue
        mag = torch.abs(a).reshape(-1)
        idx = torch.argmax(mag) if largest else torch.argmin(mag)
        if a.ndim == 2:
            w = a.shape[1]
            g = (at.rows[0] + idx // w) * n + at.cols[0] + idx % w
        else:
            g = at.rows[0] + idx
        vals.append((at, mag[idx]))
        flat.append((at, g))
    v = reduce(A, [(at, ((k, k + 1),), t.reshape(1))
                   for k, (at, t) in enumerate(vals)],
               (len(vals),), vals[0][1].dtype)
    g = reduce(A, [(at, ((k, k + 1),), t.reshape(1))
                   for k, (at, t) in enumerate(flat)],
               (len(flat),), torch.int64)
    best = torch.max(v) if largest else torch.min(v)
    g = torch.min(torch.where(v == best, g, torch.iinfo(torch.int64).max))
    if len(A.shape) == 2:
        return best, (g // n, g % n)
    return best, (g,)


def max_abs_loc(A: Arr):
    """(value, (i,j)) of the entry with max |a_ij| (reference ``MaxAbsLoc``);
    the first such entry in row-major order."""
    return _abs_loc(A, True)


def min_abs_loc(A: Arr):
    return _abs_loc(A, False)


def _along(A: Arr, dim: int, fn, op: str) -> torch.Tensor:
    """fn(block, dim) of each distinct block, combined over the blocks of
    each column (dim 0) or row (dim 1) chunk."""
    parts = [(at, (at.ranges[1 - dim],), fn(a, dim)) for at, a in chunks(A)]
    return reduce(A, parts, (A.shape[1 - dim],), parts[0][2].dtype, op)


def column_norms(A: Arr) -> torch.Tensor:
    return torch.sqrt(_along(A, 0, lambda a, d: torch.sum(_abs2(a), dim=d),
                             "sum"))


def row_norms(A: Arr) -> torch.Tensor:
    return torch.sqrt(_along(A, 1, lambda a, d: torch.sum(_abs2(a), dim=d),
                             "sum"))


def column_max_norms(A: Arr) -> torch.Tensor:
    return _along(A, 0, lambda a, d: torch.amax(torch.abs(a), dim=d), "amax")


def row_max_norms(A: Arr) -> torch.Tensor:
    return _along(A, 1, lambda a, d: torch.amax(torch.abs(a), dim=d), "amax")


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
    return each(lambda _, a: a.conj(), A)


def get_diagonal(A: Arr, offset: int = 0) -> torch.Tensor:
    """The ``offset`` diagonal: each distinct block's piece, placed at the
    first position."""
    parts = []
    for at, a in chunks(A):
        loc, t0 = diag_offset(at, offset)
        d = torch.diagonal(a, loc)
        if d.shape[0]:
            parts.append((at, ((t0, t0 + d.shape[0]),), d))
    k = _diag_len(A.shape, offset)
    return reduce(A, parts, (k,), A.dtype)


def set_diagonal(A: Arr, d, offset: int = 0) -> Arr:
    return update_diagonal(A, d, offset)


def update_diagonal(A: Arr, d, offset: int = 0) -> Arr:
    """A with its ``offset`` diagonal set to d (the name is the JAX
    package's: it sets, as ``.at[].set``)."""
    d = vec(d)
    return _on_diagonal(A, offset, d.shape[0] if d.ndim == 1 else
                        max(d.shape),
                        lambda at, lo, hi, old: vector_piece(d, lo, hi, at))


def _hits(idx: torch.Tensor, lo: int, hi: int):
    """Positions p of ``idx`` with lo <= idx[p] < hi, and idx[p] − lo."""
    sel = torch.nonzero((idx >= lo) & (idx < hi)).reshape(-1)
    return sel, idx[sel] - lo


def _index(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


def get_submatrix(A: Arr, rows, cols) -> torch.Tensor:
    """A[rows][:, cols]: each distinct block's entries, placed at the
    first position."""
    rows, cols = _index(rows), _index(cols)
    dev = first_device(A)
    out = torch.zeros((rows.shape[0], cols.shape[0]), dtype=A.dtype,
                      device=dev)
    pieces = []
    for at, a in chunks(A):
        rs, rl = _hits(rows, *at.rows)
        cs, cl = _hits(cols, *at.cols)
        if rs.numel() and cs.numel():
            sub = a[rl.to(a.device)[:, None], cl.to(a.device)[None, :]]
            out[rs.to(dev)[:, None], cs.to(dev)[None, :]] = sub.to(dev)
            pieces.append((sub, at.pos))
    if transfers.recording:
        transfers.record("all-reduce", out, pieces, (0, 0))
    return out


def _submatrix(A: Arr, rows, cols, B, write):
    """A with ``write(out, (r, c), b)`` applied in each block to the
    entries of rows × cols that it holds (b: B's matching entries)."""
    rows, cols = _index(rows), _index(cols)
    b_all = torch.broadcast_to(as_array(B), (rows.shape[0], cols.shape[0]))

    def block(at, a):
        out = a.clone()
        rs, rl = _hits(rows, *at.rows)
        cs, cl = _hits(cols, *at.cols)
        if rs.numel() and cs.numel():
            sub = b_all[rs.to(b_all.device)[:, None],
                        cs.to(b_all.device)[None, :]]
            write(out, (rl.to(a.device)[:, None], cl.to(a.device)[None, :]),
                  sub.to(a.device))
        return out
    return each(block, A)


def set_submatrix(A: Arr, rows, cols, B) -> Arr:
    def write(out, rc, b):
        out[rc] = b.to(out.dtype)
    return _submatrix(A, rows, cols, B, write)


def update_submatrix(A: Arr, rows, cols, alpha, B) -> Arr:
    """A[rows, cols] += α·B, repeated indices summed (``.at[].add``)."""
    def write(out, rc, b):
        r, c, upd = torch.broadcast_tensors(*rc, (alpha * b).to(out.dtype))
        out.index_put_((r, c), upd, accumulate=True)
    return _submatrix(A, rows, cols, B, write)


def _template(*mats):
    return next((m for m in mats if isinstance(m, DistMatrix)), None)


def _range_of(X, ranges, at: At) -> torch.Tensor:
    """The global sub-block ``ranges`` of X at ``at``'s position: fetched
    from a DistMatrix (recorded), sliced from a local array."""
    if isinstance(X, DistMatrix):
        return X.fetch(ranges, at.pos, at.device)
    return as_array(X)[tuple(slice(lo, hi) for lo, hi in ranges)] \
        .to(at.device)


def kronecker(A: Arr, B: Arr) -> Arr:
    """A ⊗ B; on a distributed operand a DistMatrix with the first
    distributed operand's dist, each block from the rows and columns of A
    it spans and all of B, which reaches each position as the JAX HLO's
    ``all-to-all`` brings it."""
    T = _template(A, B)
    if T is None:
        a = as_array(A)
        a, b = _common(a, on(B, a))
        return torch.kron(a, b)
    (m1, n1), (m2, n2) = A.shape, B.shape

    def block(at):
        (r0, r1), (c0, c1) = at.rows, at.cols
        ia, ja = r0 // m2, c0 // n2
        a = _range_of(A, ((ia, (r1 - 1) // m2 + 1), (ja, (c1 - 1) // n2 + 1)),
                      at)
        b = (B.fetch(((0, m2), (0, n2)), at.pos, at.device,
                     kind="all-to-all") if isinstance(B, DistMatrix)
             else as_array(B).to(at.device))
        full = torch.kron(*_common(a, b))
        return full[r0 - ia * m2:r1 - ia * m2, c0 - ja * n2:c1 - ja * n2]
    return from_blocks(block, (m1 * m2, n1 * n2), T.coldist, T.rowdist,
                       T.grid, T.root)


def concatenate(mats: Sequence[Arr], axis: int = 0) -> Arr:
    """The matrices joined along ``axis``; on a distributed operand a
    DistMatrix with the first distributed operand's dist, each block
    cut from the operands' pieces it spans."""
    T = _template(*mats)
    if T is None:
        parts = [as_array(m) for m in mats]
        return torch.cat([p.to(parts[0].device) for p in parts], dim=axis)
    sizes = [m.shape[axis] for m in mats]
    offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    shape = list(mats[0].shape)
    shape[axis] = offs[-1]

    def block(at):
        lo, hi = at.ranges[axis]
        pieces = []
        for M, o0, o1 in zip(mats, offs[:-1], offs[1:]):
            a, b = max(lo, o0), min(hi, o1)
            if a < b:
                ranges = list(at.ranges)
                ranges[axis] = (a - o0, b - o0)
                pieces.append(_range_of(M, tuple(ranges), at))
        return torch.cat(pieces, dim=axis)
    return from_blocks(block, shape, T.coldist, T.rowdist, T.grid, T.root)


def reshape(A: Arr, m: int, n: int) -> Arr:
    """A's entries in row-major order as m×n; each block of a distributed
    result from the panel of A's rows that holds its entries."""
    if not isinstance(A, DistMatrix):
        return as_array(A).reshape(m, n)
    width = A.shape[1] if A.ndim == 2 else 1

    def block(at):
        (r0, r1), (c0, c1) = at.rows, at.cols
        flat = (torch.arange(r0, r1, device=at.device)[:, None] * n
                + torch.arange(c0, c1, device=at.device)[None, :])
        if flat.numel() == 0:
            return torch.empty(flat.shape, dtype=A.dtype, device=at.device)
        lo = int(flat.min()) // width
        hi = int(flat.max()) // width + 1
        ranges = ((lo, hi), (0, width)) if A.ndim == 2 else \
            ((lo, hi),)
        panel = A.fetch(ranges, at.pos, at.device)
        return panel.reshape(-1)[flat - lo * width]
    return from_blocks(block, (m, n), A.coldist, A.rowdist, A.grid, A.root)


def swap_rows(A: Arr, i: int, j: int) -> Arr:
    """Rows i and j exchanged; a block holding one of them fetches the
    other's piece from its owner."""
    if not isinstance(A, DistMatrix):
        out = as_array(A).clone()
        out[[i, j]] = out[[j, i]]
        return out

    i, j = i % A.shape[0], j % A.shape[0]

    def block(at, a):
        out = a.clone()
        (r0, r1), cols = at.rows, at.cols
        for dst, src in ((i, j), (j, i)):
            if r0 <= dst < r1 and dst != src:
                out[dst - r0] = A.fetch(((src, src + 1), cols), at.pos,
                                        at.device)[0]
        return out
    return map_blocks(block, A)


def round_(A: Arr) -> Arr:
    """Round half to even (a complex entry part by part)."""
    def block(_, a):
        if a.is_complex():
            return torch.complex(torch.round(a.real), torch.round(a.imag))
        return torch.round(a)
    return each(block, A)


def real(A: Arr) -> Arr:
    return each(lambda _, a: torch.real(a).clone(), A)


def imag(A: Arr) -> Arr:
    return each(lambda _, a: torch.imag(a).clone() if a.is_complex()
                 else torch.zeros_like(a), A)


def make_symmetric(A: Arr, uplo: str = "L", conjugate_: bool = False) -> Arr:
    """The stored triangle mirrored (assembled whole at the first
    position, as the JAX HLO gathers it)."""
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
    lower = uplo.upper().startswith("L")
    return each(lambda at, a: tri(a, at, lower, offset), A)


# -- diagonal scaling -------------------------------------------------------

def diagonal_scale(side: str, d, A: Arr) -> Arr:
    """A ← diag(d)·A (LEFT) or A·diag(d) (RIGHT) (reference ``DiagonalScale``)."""
    d = vec(d)
    if side.upper().startswith("L"):
        return each(lambda at, a: vector_piece(d, *at.rows, at)[:, None] * a,
                     A)
    return each(lambda at, a: a * vector_piece(d, *at.cols, at)[None, :], A)


def diagonal_solve(side: str, d, A: Arr) -> Arr:
    d = vec(d)
    if side.upper().startswith("L"):
        return each(lambda at, a: a / vector_piece(d, *at.rows, at)[:, None],
                     A)
    return each(lambda at, a: a / vector_piece(d, *at.cols, at)[None, :], A)


def symmetric_diagonal_equil(A: Arr, d) -> Arr:
    """A ← diag(d)⁻¹ A diag(d)⁻¹ (used by equilibration)."""
    d = vec(d)
    return each(lambda at, a: a / (vector_piece(d, *at.rows, at)[:, None]
                                    * vector_piece(d, *at.cols, at)[None, :]),
                 A)
