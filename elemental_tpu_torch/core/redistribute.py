"""Redistribution primitives (counterpart of
``elemental_tpu/core/redistribute.py``, layer L4 of the reference).

The reference implements its named redistribution kernels under
``include/El/blas_like/level1/Copy/`` (Translate, AllGather, ColFilter,
RowFilter, Contract, AxpyContract, ...), dispatched per distribution pair
from ``DistMatrix::operator=``.  In the port each is a copy of blocks
between grid positions (:meth:`DistMatrix.redistribute`), with
``.to(device)`` where the positions' devices differ and a view where the
target block lies inside one source block on the same device.

``contract``/``axpy_contract`` sum partial contributions stacked along an
explicit axis of a tensor, as in the JAX package.

Every copy between positions is recorded in an open
:func:`~..utils.transfers.count_transfers` log: the block copies of a
redistribution as :meth:`DistMatrix._relayout` classes them (``all_gather``
as ``all-gather``), and a contraction as the reduction of its partials, the
k-th held by the k-th position in the flat (VC) order: ``all-reduce`` where
the result is replicated, ``reduce-scatter`` where it is cut.
"""

from __future__ import annotations

from typing import Optional

import torch

from .dist import Dist
from .distmatrix import DistMatrix, as_array
from .grid import Grid
from ..utils import transfers


def translate(A: DistMatrix, coldist: Dist, rowdist: Dist) -> DistMatrix:
    """Any pairwise redistribution (reference ``copy::Translate``,
    generalised)."""
    return A.redistribute(coldist, rowdist)


def all_gather(A: DistMatrix) -> torch.Tensor:
    """→ fully replicated (reference ``copy::AllGather``: [U,V]→[*,*]); the
    first position's copy of the whole matrix."""
    return A.replicate()


def col_filter(A: DistMatrix, coldist: Dist) -> DistMatrix:
    """Subsample rows into a col distribution (reference ``copy::ColFilter``,
    e.g. [*,MR]→[MC,MR]): views of the replicated blocks, no copy."""
    return A.redistribute(coldist, A.rowdist)


def row_filter(A: DistMatrix, rowdist: Dist) -> DistMatrix:
    return A.redistribute(A.coldist, rowdist)


def transpose_dist(A: DistMatrix) -> DistMatrix:
    """[MC,MR] → [MR,MC] on the same data (reference ``copy::TransposeDist``)."""
    return A.redistribute(A.rowdist, A.coldist)


def _record_reduction(out: DistMatrix, parts: int) -> None:
    """Each position's block of ``out`` as the sum of ``parts`` partials,
    the k-th held by flat position k mod p."""
    grid = out.grid
    p, w = grid.size, grid.width
    whole = all(hi - lo == n for (lo, hi), n in zip(out.ranges(0, 0),
                                                     out.shape))
    kind = "all-reduce" if whole else "reduce-scatter"
    for i, j in grid.positions():
        blk = out.local(i, j)
        transfers.record(kind, blk, [(blk, k % p) for k in range(parts)],
                         i * w + j)


def contract(partial: torch.Tensor, grid: Grid, coldist: Dist, rowdist: Dist,
             axis: int = 0) -> DistMatrix:
    """Sum partial contributions stacked along ``axis`` and lay the result out
    as [coldist,rowdist] (reference ``Contract.hpp:75-101``)."""
    partial = torch.as_tensor(partial)
    data = torch.sum(partial, dim=axis)
    out = DistMatrix._from_whole(data, coldist, rowdist, grid, 0, warn=True)
    if transfers.recording:
        _record_reduction(out, partial.shape[axis])
    return out


def axpy_contract(alpha, partial: torch.Tensor, C: DistMatrix,
                  axis: int = 0) -> DistMatrix:
    """C += α·Σ_partial (reference ``AxpyContract.hpp``: the SUMMA reduction
    step)."""
    partial = torch.as_tensor(partial)
    c = as_array(C)
    data = c + alpha * torch.sum(partial.to(c.device), dim=axis)
    out = DistMatrix._from_whole(data, C.coldist, C.rowdist, C.grid, C.root,
                                 warn=True)
    if transfers.recording:
        _record_reduction(out, partial.shape[axis])
    return out


def translate_between_grids(A: DistMatrix, grid: Grid,
                            coldist: Optional[Dist] = None,
                            rowdist: Optional[Dist] = None) -> DistMatrix:
    """Copy a matrix onto a *different* grid (reference
    ``TranslateBetweenGrids.hpp:21-417``, used by multi-grid ensembles and
    tested by ``tests/core/DifferentGrids.cpp``): each target block copied
    from the source blocks that hold it."""
    coldist = coldist if coldist is not None else A.coldist
    rowdist = rowdist if rowdist is not None else A.rowdist
    out = A._relayout(grid, coldist, rowdist, warn=True)
    out.root = 0
    return out
