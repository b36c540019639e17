"""Distributed sparse containers: ``DistSparseMatrix``, ``DistMultiVec``,
``DistGraph`` and ``DistMap`` (counterpart of
``elemental_tpu/sparse/distsparse.py``; the reference's tier-3 containers,
spec'd by e.g. ``tests/lapack_like/SparseLDL.cpp:50-210`` and
``examples/interface/BP.py``).

The JAX package cuts the rows in one block per device of the flattened mesh
axis ('mc','mr') — the reference's [VC,*] sparse distribution — and runs
its local functions under ``shard_map``.  The port keeps its
single-controller model (``core/grid.py``): one row block per grid
position, in the flat (VC) order (position q is grid position
(q // w, q % w)), each position's arrays on that position's device, and
the ``shard_map`` body a loop over positions.

The host plan is the JAX package's, built by the same NumPy code: each
position's column footprint is split by owner, and a product exchanges ONLY
the off-position entries it references, through one padded all-to-all
(the reference's ``SparseAllToAll``, ``Process.hpp:150-275``); a position
reads its own x block in place.  The transpose product runs the exchange in
reverse: local partials are summed into the compressed halo workspace and
sent back to the owning positions.  Each all-to-all is recorded in an open
:func:`~..utils.transfers.count_transfers` log, one record a receiving
position.

The local numerics are a gather, a product and ``index_add_``, as the JAX
package's were an XLA gather and ``segment_sum``.  Index arrays are int32,
values in the matrix's dtype.  Plans are not pytrees: there is no jit.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.grid import Grid
from ..core.policy import effective_dtype
from ..utils import transfers
from .csr import Graph, SparseMatrix

Blocks = List[torch.Tensor]


def _flat_devices(grid: Grid) -> List[torch.device]:
    """The device of each flat (VC-order) position."""
    return [grid.device(i, j) for i, j in grid.positions()]


def _cut_rows(x: torch.Tensor, size: int, devices) -> Blocks:
    """``x`` padded with zero rows to p·size and cut into p row blocks, the
    q-th on ``devices[q]`` (one copy of x per distinct device)."""
    p = len(devices)
    pad = p * size - x.shape[0]
    if pad > 0:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    on = {}
    out = []
    for q, dev in enumerate(devices):
        if dev not in on:
            on[dev] = x.to(dev)
        out.append(on[dev][q * size:(q + 1) * size])
    return out


def _all_to_all(send: Blocks, devices) -> Blocks:
    """``recv[i][j] = send[j][i]``: each position's (p, ...) send buffer
    exchanged with every other (``jax.lax.all_to_all`` over the flat axis,
    ``tiled=False``); one ``all-to-all`` record a receiving position."""
    p = len(devices)
    recv = []
    for i, dev in enumerate(devices):
        parts = [send[j][i] for j in range(p)]
        out = torch.stack([t.to(dev) for t in parts])
        if transfers.recording:
            transfers.record("all-to-all", out,
                             [(t, j) for j, t in enumerate(parts)], i)
        recv.append(out)
    return recv


@dataclasses.dataclass
class DistSparseMatrix:
    """Row-block-partitioned sparse matrix on a grid with a precomputed
    halo-exchange plan.

    Per position q (lists indexed by the flat position, each tensor on that
    position's device):
      * ``lrows[q]``/``lcols[q]``/``lvals[q]`` (E,): flat local CSR
        triplets, row ids local to the position, column ids addressing the
        local workspace ``w = [own x block (cs) | halo (p·H)]``; padded
        slots carry row id ``rs`` and value 0.
      * ``send_idx[q]`` (p, H): ``send_idx[j][i, t]`` = index into position
        j's x block of the t-th entry position i needs from j (the plan of
        the padded all-to-all; H = the largest off-position footprint).
    """

    height: int
    width: int
    grid: Grid
    lrows: Blocks           # p × (E,) int32
    lcols: Blocks           # p × (E,) int32 — workspace-local
    lvals: Blocks           # p × (E,)
    send_idx: Blocks        # p × (p, H) int32
    cs: int                 # x-block size per position (width partition)
    rs: int                 # rows per position
    halo: int               # H
    nnz: int
    val_slot: np.ndarray    # host: padded slot of each original CSR value
    host: Optional[SparseMatrix] = None  # host CSR (symbolic reuse, IO)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_sparse(cls, A: SparseMatrix, grid: Optional[Grid] = None, *,
                    dtype=None) -> "DistSparseMatrix":
        """Plan and place A on ``grid`` (default: ``Grid.default()``, every
        CUDA device), values in ``dtype`` (default: A's)."""
        if grid is None:
            grid = Grid.default()
        p = grid.size
        rs = -(-A.height // p)
        cs = -(-A.width // p)
        rows = np.repeat(np.arange(A.height), A.row_nnz())
        cols = np.asarray(A.colind)
        shard = (rows // rs).astype(np.int64)
        owner = (cols // cs).astype(np.int64)

        # footprints: for each (reader i, owner j≠i) the sorted unique
        # off-position columns; H = max block (padded all-to-all width)
        off = shard != owner
        fkey = shard[off] * (p * A.width) + owner[off] * A.width + cols[off]
        funiq = np.unique(fkey)
        f_i = funiq // (p * A.width)
        f_j = (funiq // A.width) % p
        f_c = funiq % A.width
        counts = np.zeros((p, p), np.int64)
        np.add.at(counts, (f_i, f_j), 1)
        H = max(1, int(counts.max()) if counts.size else 1)
        send_idx = np.zeros((p, p, H), np.int32)
        # position of each footprint entry within its (i,j) block
        blk_key = f_i * p + f_j
        blk_start = np.searchsorted(blk_key, np.arange(p * p))
        pos_in_blk = np.arange(funiq.size) - blk_start[blk_key]
        send_idx[f_j, f_i, pos_in_blk] = (f_c - f_j * cs).astype(np.int32)

        # localized column index per entry
        lcol = np.where(off, 0, cols - owner * cs).astype(np.int64)
        if off.any():
            pos = np.searchsorted(funiq, fkey)
            lcol[off] = cs + f_j[pos] * H + pos_in_blk[pos]

        # pack per-position flat triplets, padded to common E; padding
        # slots carry row id rs, which the sum drops
        per = np.zeros(p, np.int64)
        np.add.at(per, shard, 1)
        E = max(1, int(per.max()))
        lrows = np.full((p, E), rs, np.int32)
        lcolsa = np.zeros((p, E), np.int32)
        lvalsa = np.zeros((p, E), A.vals.dtype)
        # entries are in CSR order → within each position already row-sorted
        starts = np.concatenate([[0], np.cumsum(per)])
        slot_of = np.arange(rows.size) - starts[shard]
        lrows[shard, slot_of] = (rows - shard * rs).astype(np.int32)
        lcolsa[shard, slot_of] = lcol.astype(np.int32)
        lvalsa[shard, slot_of] = A.vals
        val_slot = shard * E + slot_of      # original CSR entry → padded slot

        devs = _flat_devices(grid)
        vdtype = effective_dtype(A.vals.dtype if dtype is None else dtype)

        def put(arr, dt=None):
            return [torch.from_numpy(np.ascontiguousarray(arr[q]))
                    .to(devs[q], dt) for q in range(p)]

        return cls(A.height, A.width, grid, put(lrows), put(lcolsa),
                   put(lvalsa, vdtype), put(send_idx), cs, rs, H, A.nnz,
                   val_slot, host=A)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def rows_per_shard(self) -> int:
        return self.rs

    @property
    def slots(self) -> int:
        """E: the padded entries of each position (the JAX package's
        ``lvals.shape[1]``)."""
        return int(self.lvals[0].shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.lvals[0].dtype

    def change_nonzero_values(self, new_host_vals) -> "DistSparseMatrix":
        """Reference ``ChangeNonzeroValues``: same structure and plan, new
        numbers — only the padded values are shipped again."""
        v = np.asarray(new_host_vals)
        p, E = self.grid.size, self.slots
        flat = np.zeros(p * E, v.dtype)
        flat[self.val_slot] = v
        flat = flat.reshape(p, E)
        dtype = (torch.promote_types(self.dtype, effective_dtype(v.dtype))
                 if v.dtype.kind == "c" else self.dtype)
        lvals = [torch.from_numpy(np.ascontiguousarray(flat[q]))
                 .to(t.device, dtype) for q, t in enumerate(self.lvals)]
        newA = (self.host.change_nonzero_values(v)
                if self.host is not None else None)
        return dataclasses.replace(self, lvals=lvals, host=newA)

    # -- distributed products -------------------------------------------------
    def matvec(self, x):
        """y = A·x — the halo all-to-all, then each position's gather,
        product and sum."""
        return self._apply(x, transpose=False)

    def matvec_transpose(self, x):
        """y = Aᵀ·x — local partials into the compressed workspace, then
        the REVERSED halo exchange sends them to the owning positions."""
        return self._apply(x, transpose=True)

    def matmat(self, X):
        return self._apply(X, transpose=False)

    def matmat_transpose(self, X):
        return self._apply(X, transpose=True)

    def _apply(self, x, transpose: bool):
        """x: a tensor (or array), cut into the positions' blocks here and
        assembled on the grid's first device at the end, as a global
        ``jax.Array`` presents itself; or a :class:`DistMultiVec`, whose
        blocks go in and come out as they are."""
        p = self.grid.size
        rs, cs, H = self.rs, self.cs, self.halo
        devs = _flat_devices(self.grid)
        size = rs if transpose else cs
        dist = isinstance(x, DistMultiVec)
        if dist:
            squeeze = x.ndim == 1
            xb = x.row_blocks(size)
        else:
            x = torch.as_tensor(x)
            squeeze = x.ndim == 1
            xb = _cut_rows(x, size, devs)
        if squeeze:
            xb = [b[:, None] for b in xb]
        k = xb[0].shape[1]
        if not transpose:
            send = [xb[j].index_select(0, self.send_idx[j].reshape(-1))
                    .reshape(p, H, k) for j in range(p)]
            recv = _all_to_all(send, devs)
            y = []
            for q in range(p):
                w = torch.cat([xb[q], recv[q].reshape(p * H, k)])
                prod = self.lvals[q][:, None] * w.index_select(0,
                                                               self.lcols[q])
                out = prod.new_zeros((rs + 1, k))   # row rs: the padding
                y.append(out.index_add_(0, self.lrows[q], prod)[:rs])
            n = self.height
        else:
            nseg = cs + p * H
            w = []
            for q in range(p):
                # one zero row for the padding slots' row id rs
                xe = torch.cat([xb[q], xb[q].new_zeros((1, k))])
                prod = self.lvals[q][:, None] * xe.index_select(0,
                                                                self.lrows[q])
                w.append(prod.new_zeros((nseg, k))
                         .index_add_(0, self.lcols[q], prod))
            recv = _all_to_all([wq[cs:].reshape(p, H, k) for wq in w], devs)
            y = [w[q][:cs].index_add_(0, self.send_idx[q].reshape(-1),
                                      recv[q].reshape(p * H, k))
                 for q in range(p)]
            n = self.width
        if squeeze:
            y = [b[:, 0] for b in y]
        if dist:
            return DistMultiVec(y, self.grid, n)
        first = devs[0]
        return torch.cat([b.to(first) for b in y])[:n]


@dataclasses.dataclass
class DistMultiVec:
    """Row-partitioned dense multivector (reference ``DistMultiVec``: the
    [VC,*] right-hand-side container of the sparse solvers): ``blocks[q]``
    is flat position q's row block, on that position's device.  Blocks may
    carry zero rows past ``height`` (a product's output keeps its padded
    blocks); a replicated multivector holds the whole of it at every
    position."""

    blocks: Blocks
    grid: Grid
    height: int
    replicated: bool = False

    @classmethod
    def from_array(cls, x, grid: Optional[Grid] = None) -> "DistMultiVec":
        """Cut ``x`` (a tensor or array) into [VC,*] row blocks; a height
        the grid does not divide is stored replicated, with the JAX
        package's warning."""
        if grid is None:
            grid = Grid.default()
        x = torch.as_tensor(x)
        devs = _flat_devices(grid)
        if x.shape[0] % grid.size == 0:
            return cls(_cut_rows(x, x.shape[0] // grid.size, devs), grid,
                       x.shape[0])
        warnings.warn(
            f"DistMultiVec height {x.shape[0]} is not divisible by the "
            f"{grid.size}-position grid; storing REPLICATED. Pad the "
            "height to keep the [VC,*] row partition.",
            RuntimeWarning, stacklevel=2)
        on = {}
        blocks = [on.setdefault(d, x.to(d)) for d in devs]
        return cls(blocks, grid, x.shape[0], replicated=True)

    @property
    def ndim(self) -> int:
        return self.blocks[0].ndim

    @property
    def width(self) -> int:
        return self.blocks[0].shape[1] if self.ndim > 1 else 1

    def row_blocks(self, size: int) -> Blocks:
        """The rows cut into p blocks of ``size`` rows (zero rows past the
        height): the blocks themselves where they already have that size,
        else rows copied between positions, one ``all-to-all`` record a
        receiving position (none from a replicated multivector)."""
        p = len(self.blocks)
        devs = _flat_devices(self.grid)
        if self.replicated:
            return _cut_rows(self.blocks[0][:self.height], size, devs)
        have = self.blocks[0].shape[0]
        if have == size:
            return list(self.blocks)
        out = []
        for q in range(p):
            lo, hi = q * size, min((q + 1) * size, self.height)
            pieces = []
            for s in range(lo // have, -(-hi // have) if hi > lo else 0):
                a, b = max(lo, s * have), min(hi, (s + 1) * have)
                pieces.append((self.blocks[s][a - s * have:b - s * have], s))
            parts = [t.to(devs[q]) for t, _ in pieces]
            rows = sum(t.shape[0] for t in parts)
            tail = (size - rows,) + tuple(self.blocks[0].shape[1:])
            parts.append(self.blocks[0].new_zeros(tail, device=devs[q]))
            blk = torch.cat(parts)
            if transfers.recording:
                transfers.record("all-to-all", blk, pieces, q)
            out.append(blk)
        return out

    def assemble(self) -> torch.Tensor:
        """The whole multivector on the grid's first device."""
        if self.replicated:
            return self.blocks[0]
        first = self.blocks[0].device
        return torch.cat([b.to(first) for b in self.blocks])[:self.height]

    def to_numpy(self) -> np.ndarray:
        return self.assemble().detach().cpu().resolve_conj().numpy()


class DistGraph(Graph):
    """Distributed graph: the pattern stays on the host (the symbolic
    layers are host-side), the partition comes from the grid."""

    def __init__(self, num_sources, num_targets, rowptr, colind,
                 grid: Optional[Grid] = None):
        super().__init__(num_sources, num_targets, rowptr, colind)
        self.grid = grid if grid is not None else Grid.default()

    @classmethod
    def from_graph(cls, g: Graph, grid: Optional[Grid] = None) -> "DistGraph":
        return cls(g.num_sources, g.num_targets, g.rowptr, g.colind, grid)


@dataclasses.dataclass
class DistMap:
    """1-D distributed index map (reference ``DistMap``,
    ``include/El/core/DistMap/decl.hpp:28-40``: the reordering permutations
    of the sparse solvers); ``translate`` is the batched host lookup
    (``DistMap::Translate(localInds)``).

    :meth:`to` cuts the map into one block per grid position (the
    reference's [STAR,VC] map entries; the JAX package's ``device``);
    ``translate_device`` then looks each index up in the block that owns
    it, as the reference's owner exchange does."""

    map_: np.ndarray
    _blocks: Optional[Blocks] = dataclasses.field(default=None, repr=False)
    _grid: Optional[Grid] = dataclasses.field(default=None, repr=False)

    def translate(self, indices) -> np.ndarray:
        return self.map_[np.asarray(indices)]

    def to(self, grid: Optional[Grid] = None) -> "DistMap":
        """The map cut over the grid's flat positions (default grid: every
        CUDA device), int64 on each position's device."""
        g = grid if grid is not None else Grid.default()
        n, p = self.map_.shape[0], g.size
        c = max(1, -(-n // p))
        blocks = _cut_rows(torch.from_numpy(np.asarray(self.map_, np.int64)),
                           c, _flat_devices(g))
        return DistMap(self.map_, blocks, g)

    def translate_device(self, indices) -> torch.Tensor:
        """map[indices] as an int64 tensor.  On a map cut by :meth:`to`,
        the indices (a tensor, or an array) are asked of the first
        position and each is answered by the position whose block holds
        it: the requests and the answers that cross positions are
        ``all-to-all`` records.  Without :meth:`to`, one gather from the
        whole map on the indices' device."""
        idx = torch.as_tensor(indices)
        if self._blocks is None:
            src = torch.from_numpy(np.asarray(self.map_, np.int64))
            return src.to(idx.device)[idx.long()]
        devs = _flat_devices(self._grid)
        c = self._blocks[0].shape[0]
        idx = idx.to(devs[0]).long()
        owner = torch.div(idx, c, rounding_mode="floor")
        out = torch.empty_like(idx)
        for q, blk in enumerate(self._blocks):
            sel = owner == q
            req = idx[sel] - q * c
            if req.numel() == 0:
                continue
            there = req.to(devs[q])
            ans = blk.index_select(0, there)
            if transfers.recording:
                transfers.record("all-to-all", there, [(req, 0)], q)
                transfers.record("all-to-all", ans.to(devs[0]),
                                 [(ans, q)], 0)
            out[sel] = ans.to(devs[0])
        return out

    def inverse(self) -> "DistMap":
        inv = np.empty_like(self.map_)
        inv[self.map_] = np.arange(self.map_.shape[0])
        return DistMap(inv)

    def __len__(self) -> int:
        return int(self.map_.shape[0])


__all__ = ["DistGraph", "DistMap", "DistMultiVec", "DistSparseMatrix"]
