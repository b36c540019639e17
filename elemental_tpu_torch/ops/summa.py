"""SUMMA distributed GEMM over the grid's ('mc','mr') positions
(counterpart of ``elemental_tpu/ops/summa.py``; reference
``src/blas_like/level3/Gemm.cpp:274-345``, ``Gemm/NN.hpp``).

The variants are the JAX package's:

  * ``xla``          — one ``torch.matmul`` on a 1×1 grid; on more
                       positions the ``stationary_c`` blocks, whose panel
                       gathers are the ones GSPMD inserts for the JAX
                       package's ``xla`` product.
  * ``stationary_c`` — each position gathers its row of A blocks along
                       'mr' and its column of B blocks along 'mc' and does
                       one local matmul (SUMMA-Dot).
  * ``stationary_a``/``pipelined`` — A's blocks ring along 'mr', one panel
                       a step, against B gathered along 'mc'.
  * ``stationary_b`` — B's blocks ring along 'mc' against A gathered along
                       'mr'.

Each ``shard_map`` body of the JAX package becomes a loop over grid
positions on that position's blocks: ``all_gather(…, tiled=True)`` is a
``torch.cat`` of the blocks along that axis, ``ppermute`` over the ring
reads the block the ring has brought (``src = (my + t) % w``), and the
accumulation order is the JAX package's (``acc = acc + a_cur @ b_slice``),
so float64 results agree with it to rounding.  Blocks move with
``.to(device)`` where two positions' devices differ.

:func:`summa_dist` runs them on two DistMatrix operands' own [MC,MR]
blocks; :func:`gemm_summa` takes whole tensors, pads them to the grid and
returns the whole product.  Every copy between positions is recorded in an
open :func:`~..utils.transfers.count_transfers` log: the panel gathers as
``all-gather``, the ring's reads as ``collective-permute``.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix, _cut, from_blocks
from ..core.grid import Grid
from ..utils import transfers

Blocks = List[List[torch.Tensor]]


def _pad_to(x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    pm, pn = m - x.shape[0], n - x.shape[1]
    if pm == 0 and pn == 0:
        return x
    return torch.nn.functional.pad(x, (0, pn, 0, pm))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gemm_xla(A: torch.Tensor, B: torch.Tensor, grid: Grid) -> torch.Tensor:
    """One ``torch.matmul`` of the whole operands (the caller cuts the
    product as [MC,MR])."""
    return torch.matmul(A, B)


def _gather_mr(blocks: Blocks, i: int, j: int, dev) -> torch.Tensor:
    """Grid row i's blocks side by side at position (i, j): that
    position's share of the JAX package's ``all_gather`` along 'mr' (tiled,
    axis 1).  The transfer log records one ``all-gather`` of the (m/h, k)
    panel, with the bytes of the row's other w − 1 blocks."""
    out = torch.cat([b.to(dev) for b in blocks[i]], dim=1)
    if transfers.recording:
        transfers.record("all-gather", out,
                         [(b, (i, jj)) for jj, b in enumerate(blocks[i])],
                         (i, j))
    return out


def _gather_mc(blocks: Blocks, i: int, j: int, dev) -> torch.Tensor:
    """Grid column j's blocks stacked at position (i, j): that position's
    share of the ``all_gather`` along 'mc' (tiled, axis 0).  The transfer
    log records one ``all-gather`` of the (k, n/w) panel, with the bytes of
    the column's other h − 1 blocks."""
    out = torch.cat([row[j].to(dev) for row in blocks], dim=0)
    if transfers.recording:
        transfers.record("all-gather", out,
                         [(row[j], (ii, j)) for ii, row in enumerate(blocks)],
                         (i, j))
    return out


def _ring_read(blocks: Blocks, src, dst, dev) -> torch.Tensor:
    """The block of position ``src`` at position ``dst``, brought by the
    ring's ``ppermute``: a ``collective-permute`` in the transfer log
    unless ``src`` is ``dst``."""
    blk = blocks[src[0]][src[1]]
    out = blk.to(dev)
    if transfers.recording:
        transfers.record("collective-permute", out, [(blk, src)], dst)
    return out


def _stationary_c_local(a: Blocks, b: Blocks, i: int, j: int, dev):
    a_row = _gather_mr(a, i, j, dev)       # (m/h, k)
    b_col = _gather_mc(b, i, j, dev)       # (k, n/w)
    return torch.matmul(a_row, b_col)


def _ring_over_a(a: Blocks, b: Blocks, i: int, j: int, dev):
    """``stationary_a`` and ``pipelined`` (the reference's SUMMA-A role,
    ``Gemm/NN.hpp:108``, and the ring collective-matmul): A is never
    gathered, its (m/h, k/w) blocks ring along 'mr' (step t holds the block
    of position (i, (j + t) % w)) against B gathered along 'mc'."""
    w = len(a[0])
    b_col = _gather_mc(b, i, j, dev)       # (k, n/w)
    k_w = a[i][j].shape[1]
    acc = torch.zeros((a[i][j].shape[0], b_col.shape[1]),
                      dtype=a[i][j].dtype, device=dev)
    for t in range(w):
        src = (j + t) % w
        a_cur = _ring_read(a, (i, src), (i, j), dev)
        b_slice = b_col[src * k_w:(src + 1) * k_w]
        acc = acc + torch.matmul(a_cur, b_slice)
    return acc


def _stationary_b_local(a: Blocks, b: Blocks, i: int, j: int, dev):
    """Big-B panel scheme (reference SUMMA-B role, ``Gemm/NN.hpp:227``): B
    is never gathered, its (k/h, n/w) blocks ring along 'mc' (step t holds
    the block of position ((i + t) % h, j)) against A gathered along
    'mr'."""
    h = len(a)
    a_row = _gather_mr(a, i, j, dev)       # (m/h, k)
    k_h = b[i][j].shape[0]
    acc = torch.zeros((a[i][j].shape[0], b[i][j].shape[1]),
                      dtype=a[i][j].dtype, device=dev)
    for t in range(h):
        src = (i + t) % h
        b_cur = _ring_read(b, (src, j), (i, j), dev)
        a_slice = a_row[:, src * k_h:(src + 1) * k_h]
        acc = acc + torch.matmul(a_slice, b_cur)
    return acc


_LOCAL = {"stationary_c": _stationary_c_local,
          "stationary_a": _ring_over_a,
          "stationary_b": _stationary_b_local,
          "pipelined": _ring_over_a}


def summa_blocks(a: Blocks, b: Blocks, grid: Grid, alg: str) -> Blocks:
    """C's [MC,MR] blocks from A's and B's [MC,MR] blocks (shapes divisible:
    A's columns and B's rows over h·w), one local product per position."""
    if alg not in _LOCAL:
        raise ValueError(f"unknown SUMMA algorithm {alg!r}")
    local = _LOCAL[alg]
    return [[local(a, b, i, j, grid.device(i, j))
             for j in range(grid.width)] for i in range(grid.height)]


def summa_dist(A: DistMatrix, B: DistMatrix, alg: str) -> DistMatrix:
    """C = A·B as an [MC,MR] DistMatrix on A's grid, computed on the
    operands' blocks: each brought to [MC,MR] first (a recorded
    redistribution where its layout differs).  Where the grid divides
    every dimension, the ``alg`` variant runs on the blocks as they are
    (``xla`` as ``stationary_c``); otherwise each position multiplies the
    rows of A and the columns of B its block of C needs (a dimension the
    grid does not divide is replicated, so those rows or columns are
    mostly its own already).  One ``torch.matmul`` on a 1×1 grid."""
    grid = A.grid
    A, B = (X if X.grid is grid and X.dist() == (MC, MR)
            else X._relayout(grid, MC, MR, warn=False) for X in (A, B))
    (m, k), n = A.shape, B.shape[1]
    if k != B.shape[0]:
        raise ValueError(f"inner dimensions differ: {A.shape} @ {B.shape}")
    if grid.size == 1:
        return DistMatrix([[torch.matmul(A.local(0, 0), B.local(0, 0))]],
                          (m, n), MC, MR, grid)
    if A.spec == B.spec == ("mc", "mr"):
        blocks = summa_blocks(A._blocks, B._blocks, grid,
                              "stationary_c" if alg == "xla" else alg)
        return DistMatrix(blocks, (m, n), MC, MR, grid)
    return from_blocks(lambda at: torch.matmul(
        A.fetch((at.rows, (0, k)), at.pos, at.device),
        B.fetch(((0, k), at.cols), at.pos, at.device)), (m, n), MC, MR, grid)


def gemm_summa(A: torch.Tensor, B: torch.Tensor, grid: Grid,
               alg: str = "stationary_c") -> torch.Tensor:
    """Explicit SUMMA.  A: (m,k), B: (k,n), whole tensors; the blocks are cut
    [MC,MR] on the grid after padding to grid-divisible shapes, and C (m,n)
    comes back whole on the grid's first device."""
    h, w = grid.height, grid.width
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {tuple(A.shape)} @ "
                         f"{tuple(B.shape)}")
    # SUMMA needs k divisible by both axes (A splits k over 'mr', B over 'mc').
    mp, kp, np_ = _round_up(m, h), _round_up(k, h * w), _round_up(n, w)
    # [MC,MR] blocks
    a = _cut(_pad_to(A, mp, kp), ("mc", "mr"), grid)
    b = _cut(_pad_to(B, kp, np_), ("mc", "mr"), grid)
    c = summa_blocks(a, b, grid, alg)
    first = grid.device(0, 0)
    Cp = torch.cat([torch.cat([blk.to(first) for blk in row], dim=1)
                    for row in c], dim=0)
    return Cp[:m, :n]


def choose_algorithm(m: int, n: int, k: int, grid: Grid,
                     itemsize: int = 4,
                     pipeline_bytes: int = 64 << 20) -> str:
    """Size heuristic in the spirit of ``Gemm/NN.hpp:582-599``: keep the
    largest operand stationary; switch the stationary-C gather to the
    ring-pipelined product when the per-position gathered panels exceed
    ``pipeline_bytes``."""
    p = grid.size
    if p == 1:
        return "xla"
    h, w = grid.height, grid.width
    weight_a, weight_b, weight_c = m * k, k * n, m * n
    if weight_c >= weight_a and weight_c >= weight_b:
        if (m // max(h, 1)) * k * itemsize > pipeline_bytes:
            return "pipelined"
        return "stationary_c"
    if weight_b >= weight_a:
        return "stationary_b"
    return "stationary_a"
