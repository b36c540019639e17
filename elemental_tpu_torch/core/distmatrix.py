"""DistMatrix: a distributed matrix as one local block per grid position
(counterpart of ``elemental_tpu/core/distmatrix.py``).

The reference's ``DistMatrix<T,U,V>`` hierarchy (``include/El/core/
DistMatrix/``) becomes one class, as in the JAX package.  There the global
matrix is one ``jax.Array`` whose ``NamedSharding`` realises the
``[coldist, rowdist]`` distribution; here each grid position (i, j) holds
its block, on that position's device, cut as the ``NamedSharding`` cuts:
contiguous chunks, mesh-major for a tuple of axes.  A dimension that the
grid does not divide is replicated, with the JAX package's
``RuntimeWarning``.

Redistribution copies blocks between positions (``.to(device)`` where the
devices differ); a block that lies inside one source block on the same
device is a view of it.  Replicated blocks of positions that share a device
share storage.  An open :func:`~..utils.transfers.count_transfers` log
records each target position's copies from other positions (see
:meth:`DistMatrix._relayout`).

Operations that the JAX package leaves to GSPMD (level 1 and 2, most of
level 3) assemble the global tensor on the grid's first device
(:func:`as_array`), compute there and cut the result again (:func:`like`).
On a 1×1 grid the one block is the whole matrix and nothing is copied.

A *local* matrix (reference ``Matrix<T,D>``) is a ``torch.Tensor``; every
operation accepts either.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .dist import (MC, MR, Dist, Spec, partition_spec, transpose_pair)
from .grid import Grid
from .policy import effective_dtype
from ..utils import transfers

Range = Tuple[int, int]


def _feasible_spec(shape, spec: Spec, grid: Grid, warn: bool) -> Spec:
    """``spec`` with every dimension the grid does not divide replicated
    (the JAX package's ``_feasible_sharding``); only 2-D arrays are cut."""
    if len(shape) != 2:
        return (None,) * len(shape)
    out = tuple(None if axes is not None and n % grid.axis_size(axes)
                else axes for n, axes in zip(shape, spec))
    if warn and out != tuple(spec):
        warnings.warn(
            f"shape {tuple(shape)} is not divisible by the grid along "
            f"{tuple(spec)}; degrading those dimensions to REPLICATED. "
            "Pad to a grid-aligned shape to keep the distribution.",
            RuntimeWarning, stacklevel=3)
    return out


def _chunk(n: int, axes, grid: Grid) -> int:
    return n // grid.axis_size(axes)


def _block_ranges(shape, spec: Spec, grid: Grid, i: int,
                  j: int) -> Tuple[Range, ...]:
    """Global (lo, hi) of each dimension of position (i, j)'s block."""
    out = []
    for n, axes in zip(shape, spec):
        c = _chunk(n, axes, grid)
        k = grid.chunk_index(axes, i, j)
        out.append((k * c, (k + 1) * c))
    return tuple(out)


def _slice(t: torch.Tensor, ranges: Tuple[Range, ...]) -> torch.Tensor:
    if all(lo == 0 and hi == n for (lo, hi), n in zip(ranges, t.shape)):
        return t
    return t[tuple(slice(lo, hi) for lo, hi in ranges)]


def _cut(t: torch.Tensor, spec: Spec, grid: Grid) -> List[List[torch.Tensor]]:
    """Blocks of the whole tensor ``t`` laid out by ``spec``: views of one
    copy of ``t`` per distinct device."""
    on: Dict[torch.device, torch.Tensor] = {}
    memo: Dict[tuple, torch.Tensor] = {}
    blocks = [[None] * grid.width for _ in range(grid.height)]
    for i, j in grid.positions():
        dev = grid.device(i, j)
        ranges = _block_ranges(t.shape, spec, grid, i, j)
        key = (dev, ranges)
        if key not in memo:
            if dev not in on:
                on[dev] = t.to(dev)
            memo[key] = _slice(on[dev], ranges)
        blocks[i][j] = memo[key]
    return blocks


def _map_blocks(blocks, fn):
    """``fn`` of every block, once per distinct block object (shared
    replicated blocks stay shared)."""
    memo: Dict[int, torch.Tensor] = {}
    return [[memo[id(b)] if id(b) in memo else memo.setdefault(id(b), fn(b))
             for b in row] for row in blocks]


class DistMatrix:
    """A matrix distributed ``[coldist, rowdist]`` over a :class:`Grid`:
    ``local(i, j)`` is grid position (i, j)'s block, on its device.  Row
    indices are cut by ``coldist`` and column indices by ``rowdist``
    (Elemental's convention).  Build one with :func:`distribute`.

    ``blocks[i][j]`` must have the shape that the (feasible) spec of
    ``shape`` gives position (i, j)."""

    def __init__(self, blocks, shape, coldist: Dist = MC, rowdist: Dist = MR,
                 grid: Optional[Grid] = None, root: int = 0):
        if grid is None:
            grid = Grid.default()
        self.grid = grid
        self.coldist = coldist
        self.rowdist = rowdist
        self.root = root  # only meaningful for CIRC
        self.shape = tuple(int(n) for n in shape)
        self.spec = _feasible_spec(self.shape,
                                   partition_spec(coldist, rowdist), grid,
                                   warn=False)
        self._blocks = [list(row) for row in blocks]
        for i, j in grid.positions():
            want = tuple(hi - lo for lo, hi in self.ranges(i, j))
            got = tuple(self._blocks[i][j].shape)
            if got != want:
                raise ValueError(f"block ({i}, {j}) has shape {got}, the "
                                 f"layout gives {want}")
        self._queue: list = []
        self._pull_queue: list = []

    @classmethod
    def _from_whole(cls, t: torch.Tensor, coldist: Dist, rowdist: Dist,
                    grid: Grid, root: int, warn: bool) -> "DistMatrix":
        spec = _feasible_spec(t.shape, partition_spec(coldist, rowdist),
                              grid, warn)
        return cls(_cut(t, spec, grid), t.shape, coldist, rowdist, grid, root)

    # -- basic queries -----------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self._blocks[0][0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def height(self) -> int:
        return self.shape[0]

    @property
    def width(self) -> int:
        return self.shape[1] if len(self.shape) > 1 else 1

    def dist(self) -> Tuple[Dist, Dist]:
        return (self.coldist, self.rowdist)

    def local(self, i: int, j: int) -> torch.Tensor:
        """Grid position (i, j)'s block, on ``grid.device(i, j)``."""
        return self._blocks[i][j]

    def ranges(self, i: int, j: int) -> Tuple[Range, ...]:
        """Global (lo, hi) of each dimension of position (i, j)'s block."""
        return _block_ranges(self.shape, self.spec, self.grid, i, j)

    def _with_blocks(self, blocks, shape=None, coldist=None, rowdist=None
                     ) -> "DistMatrix":
        return DistMatrix(blocks, self.shape if shape is None else shape,
                          self.coldist if coldist is None else coldist,
                          self.rowdist if rowdist is None else rowdist,
                          self.grid, self.root)

    # -- block gathering ---------------------------------------------------
    def _owners(self) -> Dict[tuple, List[Tuple[int, int]]]:
        """Chunk index tuple → the positions that hold that block."""
        owners: Dict[tuple, List[Tuple[int, int]]] = {}
        for i, j in self.grid.positions():
            key = tuple(self.grid.chunk_index(ax, i, j) for ax in self.spec)
            owners.setdefault(key, []).append((i, j))
        return owners

    def _gather(self, ranges: Tuple[Range, ...], device: torch.device,
                owners=None, dst=None, sources=None) -> torch.Tensor:
        """The global sub-block ``ranges`` on ``device``, copied from the
        blocks that hold it (from position ``dst`` itself where it holds
        one, else from a position on ``device`` where one does); a view
        where one block on ``device`` holds it all.  Each piece and its
        source position are appended to the list ``sources`` if given."""
        if any(lo == hi for lo, hi in ranges):
            return torch.empty(tuple(hi - lo for lo, hi in ranges),
                               dtype=self.dtype, device=device)
        owners = owners if owners is not None else self._owners()
        chunks = [max(_chunk(n, ax, self.grid), 1)
                  for n, ax in zip(self.shape, self.spec)]
        per_dim = [range(lo // c, (hi - 1) // c + 1)
                   for (lo, hi), c in zip(ranges, chunks)]

        def piece(key):
            held = owners[key]
            i, j = (dst if dst in held else
                    next((p for p in held if self.grid.device(*p) == device),
                         held[0]))
            local = tuple((max(lo, k * c) - k * c, min(hi, (k + 1) * c) - k * c)
                          for (lo, hi), c, k in zip(ranges, chunks, key))
            src = _slice(self._blocks[i][j], local)
            if sources is not None:
                sources.append((src, (i, j)))
            return src.to(device)

        if len(ranges) != 2:
            return piece(tuple(0 for _ in ranges))
        rows = [torch.cat([piece((r, c)) for c in per_dim[1]], dim=1)
                if len(per_dim[1]) > 1 else piece((r, per_dim[1][0]))
                for r in per_dim[0]]
        return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]

    def _relayout(self, grid: Grid, coldist: Dist, rowdist: Dist,
                  warn: bool) -> "DistMatrix":
        """This matrix's blocks copied into the ``[coldist, rowdist]``
        layout of ``grid``.

        The transfer log gets one record a target position that copies
        from other positions: an ``all-gather`` where its block is larger
        than a source block, a ``collective-permute`` where it is one other
        position's block, an ``all-to-all`` otherwise.  Between two grids
        positions are told apart by their grid's identity as well."""
        spec = _feasible_spec(self.shape, partition_spec(coldist, rowdist),
                              grid, warn)
        owners = self._owners()
        memo: Dict[tuple, torch.Tensor] = {}
        blocks = [[None] * grid.width for _ in range(grid.height)]
        here = (lambda p: p) if grid is self.grid else \
            (lambda p: (id(grid), p))
        src_numel = int(np.prod([hi - lo for lo, hi in self.ranges(0, 0)]))
        for i, j in grid.positions():
            dev = grid.device(i, j)
            ranges = _block_ranges(self.shape, spec, grid, i, j)
            key = (dev, ranges)
            sources = [] if transfers.recording else None
            if key not in memo or sources is not None:
                memo[key] = self._gather(ranges, dev, owners, here((i, j)),
                                         sources)
            blocks[i][j] = memo[key]
            if sources:
                out = blocks[i][j]
                kind = ("all-gather" if out.numel() > src_numel else
                        "collective-permute" if len(sources) == 1 else
                        "all-to-all")
                transfers.record(kind, out, sources, here((i, j)))
        return DistMatrix(blocks, self.shape, coldist, rowdist, grid,
                          self.root)

    def assemble(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole matrix on ``device`` (the grid's first by default)."""
        device = self.grid.device(0, 0) if device is None else device
        return self._gather(tuple((0, n) for n in self.shape),
                            torch.device(device))

    # -- redistribution ----------------------------------------------------
    def redistribute(self, coldist: Dist, rowdist: Dist) -> "DistMatrix":
        """Equivalent of the reference's cross-distribution ``operator=``:
        block copies between positions."""
        return self._relayout(self.grid, coldist, rowdist, warn=True)

    def replicate(self) -> torch.Tensor:
        """→ [STAR,STAR]: every position holds the whole matrix; returns the
        first position's copy."""
        from .dist import STAR
        return self.redistribute(STAR, STAR).local(0, 0)

    def transpose(self) -> "DistMatrix":
        cd, rd = transpose_pair(self.coldist, self.rowdist)
        if self.ndim != 2:
            return self._with_blocks(self._blocks, coldist=cd, rowdist=rd)
        return self._with_blocks(_map_blocks(self._blocks, lambda b: b.T),
                                 self.shape[::-1], cd, rd)

    @property
    def T(self) -> "DistMatrix":
        return self.transpose()

    def adjoint(self) -> "DistMatrix":
        if not self.dtype.is_complex:
            return self.transpose()
        t = self.transpose()
        return t._with_blocks(_map_blocks(t._blocks,
                                          lambda b: b.conj_physical()))

    @property
    def H(self) -> "DistMatrix":
        return self.adjoint()

    def astype(self, dtype) -> "DistMatrix":
        dtype = effective_dtype(dtype)
        return self._with_blocks(_map_blocks(self._blocks,
                                             lambda b: b.to(dtype)))

    def like(self, data: torch.Tensor) -> "DistMatrix":
        """New DistMatrix with the same distribution holding ``data`` (the
        whole matrix), cut by this matrix's layout."""
        data = torch.as_tensor(data)
        return DistMatrix._from_whole(data, self.coldist, self.rowdist,
                                      self.grid, self.root, warn=False)

    # -- remote entrywise updates (reference AbstractDistMatrix
    #    QueueUpdate/ProcessQueues/QueuePull, AbstractDistMatrix.hpp:162-171)
    def _index(self, i: int, j: int) -> Tuple[int, int]:
        m, n = self.shape
        i, j = int(i), int(j)
        i, j = (i + m if i < 0 else i), (j + n if j < 0 else j)
        if not (0 <= i < m and 0 <= j < n):
            raise IndexError(f"entry ({i}, {j}) outside {self.shape}")
        return i, j

    def queue_update(self, i: int, j: int, value) -> None:
        """Queue a remote entry update; applied (summed, COO semantics) by
        :meth:`process_queues`."""
        self._queue.append((*self._index(i, j), value))

    def queue_pull(self, i: int, j: int) -> None:
        """Queue a remote entry READ (reference QueuePull); drained by
        :meth:`process_pull_queue`."""
        self._pull_queue.append(self._index(i, j))

    def process_queues(self) -> "DistMatrix":
        """Drain queued updates into a NEW DistMatrix: each block takes the
        updates that fall in it as one ``index_put_`` with accumulation
        (duplicates summed); the queue empties."""
        q = self._queue
        if not q:
            return self
        ii = torch.tensor([e[0] for e in q], dtype=torch.int64)
        jj = torch.tensor([e[1] for e in q], dtype=torch.int64)
        vv = torch.as_tensor(np.asarray([e[2] for e in q])).to(self.dtype)
        self._queue = []
        ranges = {}
        for i, j in self.grid.positions():
            ranges.setdefault(id(self._blocks[i][j]), self.ranges(i, j))

        def update(b):
            (r0, r1), (c0, c1) = ranges[id(b)]
            sel = (ii >= r0) & (ii < r1) & (jj >= c0) & (jj < c1)
            out = b.clone()
            idx = ((ii[sel] - r0).to(b.device), (jj[sel] - c0).to(b.device))
            return out.index_put_(idx, vv[sel].to(b.device), accumulate=True)

        return self._with_blocks(_map_blocks(self._blocks, update))

    def process_pull_queue(self) -> np.ndarray:
        """Drain queued reads; returns values in queue order (host)."""
        q = self._pull_queue
        if not q:
            return np.empty((0,))
        ii = torch.tensor([e[0] for e in q], dtype=torch.int64)
        jj = torch.tensor([e[1] for e in q], dtype=torch.int64)
        out = torch.empty(len(q), dtype=self.dtype)
        for held in self._owners().values():
            (r0, r1), (c0, c1) = self.ranges(*held[0])
            sel = (ii >= r0) & (ii < r1) & (jj >= c0) & (jj < c1)
            if bool(sel.any()):
                b = self._blocks[held[0][0]][held[0][1]]
                idx = ((ii[sel] - r0).to(b.device),
                       (jj[sel] - c0).to(b.device))
                out[sel] = b[idx].cpu()
        self._pull_queue = []
        return out.resolve_conj().numpy()

    # -- numpy interop -----------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return as_numpy(self)

    def __repr__(self) -> str:
        return (f"DistMatrix(shape={self.shape}, dtype={self.dtype}, "
                f"dist=[{self.coldist.value},{self.rowdist.value}], "
                f"grid={self.grid.height}x{self.grid.width})")


def _as_tensor(array) -> torch.Tensor:
    """A tensor of ``array``: a tensor as it is, anything else as a fresh
    host copy (NumPy's dtype kept)."""
    if isinstance(array, torch.Tensor):
        return array
    return torch.from_numpy(np.array(array))


def distribute(array, coldist: Dist = MC, rowdist: Dist = MR,
               grid: Optional[Grid] = None, root: int = 0) -> DistMatrix:
    """Place an array (NumPy, or a tensor) onto a grid with the given
    distribution: one copy per distinct device of the grid, cut into the
    positions' blocks (the default grid is every CUDA device)."""
    if grid is None:
        grid = Grid.default()
    return DistMatrix._from_whole(_as_tensor(array), coldist, rowdist, grid,
                                  root, warn=True)


def as_array(A) -> torch.Tensor:
    """The whole matrix of a DistMatrix on its grid's first device (the
    block itself on a 1×1 grid), or the array itself as a tensor."""
    if isinstance(A, DistMatrix):
        return A.assemble()
    if isinstance(A, torch.Tensor):
        return A
    return torch.as_tensor(np.ascontiguousarray(A))


def as_numpy(A) -> np.ndarray:
    """The whole matrix (:func:`as_array`) as a host NumPy array, from any
    device."""
    return as_array(A).detach().cpu().resolve_conj().resolve_neg().numpy()


def like(A, data) -> "DistMatrix | torch.Tensor":
    """Cut ``data`` by A's distribution if A is distributed."""
    if isinstance(A, DistMatrix):
        return A.like(data)
    return data


def grid_of(*mats) -> Optional[Grid]:
    for m in mats:
        if isinstance(m, DistMatrix):
            return m.grid
    return None


__all__ = ["DistMatrix", "as_array", "as_numpy", "distribute", "grid_of",
           "like"]
