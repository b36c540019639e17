"""The BLAS tier's block plumbing: one function written once runs on the
blocks of a :class:`~..core.distmatrix.DistMatrix` or on the whole of a
local tensor (one block spanning it)."""

from __future__ import annotations

import torch

from ..core.distmatrix import (At, DistMatrix, aligned, as_array,
                               map_blocks, reduce_parts)


def on(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``ref``'s device (a DistMatrix assembled)."""
    return as_array(x).to(ref.device)


def vec(v):
    """A vector operand as :func:`~..core.distmatrix.vector_piece` takes
    it: a DistMatrix as it is, anything else as a tensor."""
    return v if isinstance(v, DistMatrix) else as_array(v)


def whole(a: torch.Tensor) -> At:
    """The one block of a local tensor."""
    return At((0, 0), a.device, tuple((0, n) for n in a.shape))


def each(fn, A, *others):
    """``fn(at, a, *o)`` on each block of A (the others brought to A's
    layout), or once on the whole of a local A."""
    if isinstance(A, DistMatrix):
        return map_blocks(fn, A, *others)
    a = as_array(A)
    return fn(whole(a), a, *(on(o, a) for o in others))


def chunks(A, *others):
    """(at, a, *o) for each distinct block of A (the others brought to A's
    layout; a block replicated over positions counts once), or the whole
    of a local A."""
    if not isinstance(A, DistMatrix):
        a = as_array(A)
        return [(whole(a), a, *(on(o, a) for o in others))]
    others = [aligned(o, A) for o in others]
    out = []
    for pos, ranges in A.distinct():
        at = At(pos, A.grid.device(*pos), ranges)
        out.append((at, A.local(*pos), *(
            o.local(*pos) if isinstance(o, DistMatrix) else
            o[tuple(slice(lo, hi) for lo, hi in ranges)].to(at.device)
            for o in others)))
    return out


def first_device(A) -> torch.device:
    """The device of A's grid's first position, or of a local A."""
    return (A.grid.device(0, 0) if isinstance(A, DistMatrix)
            else as_array(A).device)


def reduce(A, parts, shape, dtype, op: str = "sum", into=None):
    """The partials ``parts`` ((at, ranges, tensor) each) combined at the
    first position of A's grid (on a local A's device), or laid out as the
    DistMatrix ``into``."""
    return reduce_parts([(at.pos, r, t) for at, r, t in parts], shape, dtype,
                        first_device(A), into, op)


def tri(a: torch.Tensor, at: At, lower: bool, offset: int = 0):
    """The block at ``at`` of tril/triu(A, offset), by global indices."""
    k = at.rows[0] - at.cols[0] + offset
    return torch.tril(a, k) if lower else torch.triu(a, k)


def diag_offset(at: At, offset: int = 0):
    """The block-local offset of A's ``offset`` diagonal in the block at
    ``at``, and the index along that diagonal of its first entry there."""
    loc = at.rows[0] - at.cols[0] + offset
    return loc, at.rows[0] + max(0, -loc) - max(0, -offset)
