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

Each block owns storage of its own size: :func:`distribute` copies each
position's slice to its device (the counterpart of ``jax.device_put``),
and a redistribution copies the pieces a target block needs from the
blocks that hold them.  A replicated block is one copy per distinct
device, shared by the positions on that device.

The BLAS tier computes on the blocks (:func:`map_blocks`,
:func:`reduce_parts`, :meth:`DistMatrix.fetch`), where the JAX package's
GSPMD computes on the shards.  Assembling the whole matrix on the grid's
first position (:func:`as_array`) and cutting a whole result again
(:func:`like`) remain for the calls whose JAX HLO gathers a whole operand
and for the tiers not yet moved onto blocks.  An open
:func:`~..utils.transfers.count_transfers` log records every copy between
positions: a redistribution's (see :meth:`DistMatrix._relayout`), an
assembly as an ``all-gather`` at the first position, a cut of a whole
result as a ``collective-permute`` at each other position.  Reading a
matrix to the host (:func:`as_numpy`) is not recorded.  On a 1×1 grid the
one block is the whole matrix and nothing is copied.

A *local* matrix (reference ``Matrix<T,D>``) is a ``torch.Tensor``; every
operation accepts either.
"""

from __future__ import annotations

import dataclasses
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


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it spans its whole storage, else a contiguous copy: a block
    never keeps a larger tensor alive."""
    if t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _cut(t: torch.Tensor, spec: Spec, grid: Grid,
         record: bool = False) -> List[List[torch.Tensor]]:
    """Blocks of the whole tensor ``t`` laid out by ``spec``: each
    position's slice copied to its device, once per distinct (device,
    ranges).  With ``record``, ``t`` is a result held at the first position
    and each other position's block is recorded as a
    ``collective-permute``."""
    memo: Dict[tuple, torch.Tensor] = {}
    blocks = [[None] * grid.width for _ in range(grid.height)]
    for i, j in grid.positions():
        dev = grid.device(i, j)
        ranges = _block_ranges(t.shape, spec, grid, i, j)
        key = (dev, ranges)
        if key not in memo:
            memo[key] = _own(_slice(t, ranges).to(dev))
        blocks[i][j] = memo[key]
        if record and transfers.recording:
            transfers.record("collective-permute", memo[key],
                             [(memo[key], (0, 0))], (i, j))
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
                    grid: Grid, root: int, warn: bool,
                    record: bool = False) -> "DistMatrix":
        spec = _feasible_spec(t.shape, partition_spec(coldist, rowdist),
                              grid, warn)
        return cls(_cut(t, spec, grid, record), t.shape, coldist, rowdist,
                   grid, root)

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
        one, else from a position on ``device`` where one does); the block
        itself where it is one whole block on ``device``, else storage of
        its own.  Each piece and its source position are appended to the
        list ``sources`` if given."""
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
            return _own(piece(tuple(0 for _ in ranges)))
        rows = [torch.cat([piece((r, c)) for c in per_dim[1]], dim=1)
                if len(per_dim[1]) > 1 else piece((r, per_dim[1][0]))
                for r in per_dim[0]]
        return _own(torch.cat(rows, dim=0) if len(rows) > 1 else rows[0])

    def fetch(self, ranges: Tuple[Range, ...], pos, device=None,
              owners=None, kind: Optional[str] = None) -> torch.Tensor:
        """The global sub-block ``ranges`` at grid position ``pos`` (on
        ``device``, that position's by default), recorded in an open
        transfer log as the pieces that come from other positions: an
        ``all-gather`` where it is larger than one block, a
        ``collective-permute`` where it is one other position's piece, an
        ``all-to-all`` otherwise (or as ``kind``)."""
        device = self.grid.device(*pos) if device is None else device
        sources = [] if transfers.recording else None
        out = self._gather(ranges, device, owners, pos, sources)
        if sources:
            block = int(np.prod([hi - lo for lo, hi in self.ranges(0, 0)]))
            kind = kind or ("all-gather" if out.numel() > block else
                            "collective-permute" if len(sources) == 1 else
                            "all-to-all")
            transfers.record(kind, out, sources, pos)
        return out

    def distinct(self) -> List[Tuple[Tuple[int, int], Tuple[Range, ...]]]:
        """One (position, ranges) a distinct block: the first position
        that holds it (a replicated block counts once)."""
        return [(held[0], self.ranges(*held[0]))
                for held in self._owners().values()]

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
        for i, j in grid.positions():
            dev = grid.device(i, j)
            ranges = _block_ranges(self.shape, spec, grid, i, j)
            key = (dev, ranges)
            if key not in memo or transfers.recording:
                memo[key] = self.fetch(ranges, here((i, j)), dev, owners)
            blocks[i][j] = memo[key]
        return DistMatrix(blocks, self.shape, coldist, rowdist, grid,
                          self.root)

    def assemble(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole matrix at the grid's first position (on ``device``,
        that position's by default), recorded as an ``all-gather`` of the
        pieces other positions hold."""
        device = self.grid.device(0, 0) if device is None else device
        return self.fetch(tuple((0, n) for n in self.shape), (0, 0),
                          torch.device(device), kind="all-gather")

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
        whole matrix, held at the first position), cut by this matrix's
        layout; each other position's block is recorded as a
        ``collective-permute``."""
        data = torch.as_tensor(data)
        return DistMatrix._from_whole(data, self.coldist, self.rowdist,
                                      self.grid, self.root, warn=False,
                                      record=True)

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


@dataclasses.dataclass(frozen=True)
class At:
    """Where a block lies: its grid position, its device and the global
    (lo, hi) of each of its dimensions."""

    pos: Tuple[int, int]
    device: torch.device
    ranges: Tuple[Range, ...]

    @property
    def rows(self) -> Range:
        return self.ranges[0]

    @property
    def cols(self) -> Range:
        return self.ranges[1]


def aligned(X, A: DistMatrix):
    """``X`` in ``A``'s layout: a DistMatrix relaid out where its layout
    differs (recorded, as GSPMD reshards), anything else as a tensor."""
    if not isinstance(X, DistMatrix):
        return _as_tensor(X)
    if X.shape != A.shape:
        raise ValueError(f"shape {X.shape} against {A.shape}")
    if X.grid is A.grid and X.dist() == A.dist():
        return X
    return X._relayout(A.grid, A.coldist, A.rowdist, warn=False)


def from_blocks(fn, shape, coldist: Dist, rowdist: Dist, grid: Grid,
                root: int = 0) -> DistMatrix:
    """The DistMatrix of ``shape`` laid out ``[coldist, rowdist]`` on
    ``grid`` whose block at each position is ``fn(at)`` (``at`` the
    block's :class:`At`).  ``fn`` runs once per distinct (device, ranges),
    and once per position while a transfer log is open, so that each
    position records what it fetches."""
    shape = tuple(int(n) for n in shape)
    spec = _feasible_spec(shape, partition_spec(coldist, rowdist), grid,
                          warn=False)
    memo: Dict[tuple, torch.Tensor] = {}
    blocks = [[None] * grid.width for _ in range(grid.height)]
    for i, j in grid.positions():
        dev = grid.device(i, j)
        ranges = _block_ranges(shape, spec, grid, i, j)
        key = (dev, ranges)
        if key not in memo or transfers.recording:
            memo[key] = _own(fn(At((i, j), dev, ranges)))
        blocks[i][j] = memo[key]
    return DistMatrix(blocks, shape, coldist, rowdist, grid, root)


def map_blocks(fn, A: DistMatrix, *others) -> DistMatrix:
    """A DistMatrix in ``A``'s layout whose block at each position is
    ``fn(at, a, *o)``: ``at`` the block's :class:`At`, ``a`` A's block and
    ``o`` the others' (a DistMatrix brought to A's layout by
    :func:`aligned`; a local array of A's shape sliced by the block's
    ranges and moved to its device, unrecorded, as :func:`distribute` cuts
    it)."""
    others = [aligned(o, A) for o in others]

    def block(at):
        args = [o.local(*at.pos) if isinstance(o, DistMatrix)
                else _slice(o, at.ranges).to(at.device) for o in others]
        return fn(at, A.local(*at.pos), *args)

    return from_blocks(block, A.shape, A.coldist, A.rowdist, A.grid, A.root)


def vector_piece(v, lo: int, hi: int, at: At) -> torch.Tensor:
    """Entries ``lo:hi`` of the vector ``v`` at ``at``'s position: a slice
    of a local tensor moved to its device (unrecorded), or fetched from a
    DistMatrix of shape (n,), (n, 1) or (1, n) (recorded)."""
    if not isinstance(v, DistMatrix):
        return v.reshape(-1)[lo:hi].to(at.device)
    if v.ndim == 1:
        ranges = ((lo, hi),)
    elif v.shape[1] == 1:
        ranges = ((lo, hi), (0, 1))
    else:
        ranges = ((0, 1), (lo, hi))
    return v.fetch(ranges, at.pos, at.device).reshape(-1)


def reduce_parts(parts, shape, dtype, device=None,
                 into: Optional[DistMatrix] = None, op: str = "sum"):
    """Partials summed (``op="sum"``) or maxed (``"amax"``) into a result
    of ``shape``: each part is (position, global (lo, hi) of each dimension
    of the result it covers, tensor).

    Without ``into`` the result is a tensor on ``device``, the grid's first
    position's, recorded as that position's share of an ``all-reduce``.
    With ``into`` the result is a DistMatrix with ``into``'s dist: each
    position's block combines the parts that overlap it, recorded as an
    ``all-reduce`` where the block is whole and a ``reduce-scatter`` where
    it is cut."""
    combine = {"sum": torch.add, "amax": torch.maximum}[op]
    shape = tuple(int(n) for n in shape)

    def block(ranges, dev, dst):
        out = torch.zeros(tuple(hi - lo for lo, hi in ranges), dtype=dtype,
                          device=dev)
        pieces = []
        for pos, rng, t in parts:
            cut = [(max(lo, a), min(hi, b))
                   for (lo, hi), (a, b) in zip(rng, ranges)]
            if any(lo >= hi for lo, hi in cut):
                continue
            sub = t[tuple(slice(lo - p, hi - p)
                          for (lo, hi), (p, _) in zip(cut, rng))]
            at = tuple(slice(lo - a, hi - a)
                       for (lo, hi), (a, _) in zip(cut, ranges))
            out[at] = combine(out[at], sub.to(dev))
            pieces.append((sub, pos))
        if transfers.recording:
            whole = all(hi - lo == n for (lo, hi), n in zip(ranges, shape))
            transfers.record("all-reduce" if whole else "reduce-scatter",
                             out, pieces, dst)
        return out

    if into is None:
        return block(tuple((0, n) for n in shape), device, (0, 0))
    return from_blocks(lambda at: block(at.ranges, at.device, at.pos), shape,
                       into.coldist, into.rowdist, into.grid, into.root)


def _as_tensor(array) -> torch.Tensor:
    """A tensor of ``array``: a tensor as it is, anything else as a fresh
    host copy (NumPy's dtype kept)."""
    if isinstance(array, torch.Tensor):
        return array
    return torch.from_numpy(np.array(array))


def distribute(array, coldist: Dist = MC, rowdist: Dist = MR,
               grid: Optional[Grid] = None, root: int = 0) -> DistMatrix:
    """Place an array (NumPy, or a tensor) onto a grid with the given
    distribution: each position's block copied to its device (the default
    grid is every CUDA device); not recorded, as ``jax.device_put`` is in
    no HLO."""
    if grid is None:
        grid = Grid.default()
    return DistMatrix._from_whole(_as_tensor(array), coldist, rowdist, grid,
                                  root, warn=True)


def as_array(A) -> torch.Tensor:
    """The whole matrix of a DistMatrix at its grid's first position (the
    block itself on a 1×1 grid; an ``all-gather`` in an open transfer log
    otherwise), or the array itself as a tensor."""
    if isinstance(A, DistMatrix):
        return A.assemble()
    if isinstance(A, torch.Tensor):
        return A
    return torch.as_tensor(np.ascontiguousarray(A))


def as_numpy(A) -> np.ndarray:
    """The whole matrix as a host NumPy array, from any device: a host
    read, not recorded (reading a global ``jax.Array`` is in no HLO)."""
    if isinstance(A, DistMatrix):
        t = A._gather(tuple((0, n) for n in A.shape), torch.device("cpu"))
    else:
        t = as_array(A)
    return t.detach().cpu().resolve_conj().resolve_neg().numpy()


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


__all__ = ["At", "DistMatrix", "aligned", "as_array", "as_numpy",
           "distribute", "from_blocks", "grid_of", "like", "map_blocks",
           "reduce_parts", "vector_piece"]
