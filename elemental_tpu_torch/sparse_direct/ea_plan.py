"""Extend-add plan for the Hopper kernel K1 (``kernels/extend_add.py``).

Built once per symbolic analysis.  Each level with child Schur complements
has the symbolic plan's ``(child_dst, child_src)`` pairs (the reference's
``childRelInds``, ``NodeInfo.hpp:27-110``), one per child Schur element, in
the symbolic plan's order: child by child, each Schur triangle row by row.
Most destinations have one source, and along a Schur row both the source
and, where the row's parent rows are contiguous, the destination step by
one.  So the plan splits the pairs in two:

* **runs**: every destination with exactly one source joins a maximal run
  ``(run_dst[j], run_src[j], run_off[j+1] - run_off[j])`` in which source
  and destination both step by 1.  ``run_off`` holds CSR-style offsets over
  the run pairs, and ``run_blk[b]`` the run that holds run pair
  ``RUN_BLOCK·b`` (``np.searchsorted(run_off, RUN_BLOCK·b, 'right') - 1``;
  ``n_runs`` past the end), so each block of the kernel finds its runs
  without a search.
* **multi-source destinations**, in the destination-sorted form: ``udst``
  (ascending), CSR-style ``offsets``, and their sources in stable
  destination order at the head of ``src``, summed in that order.

``src``/``dst`` hold every pair (the multi-source part, then the run part in
run order) for the plain version ``pool.index_add_(0, dst, pool[src])``.

The plan checks the geometry that makes the kernel's update in place safe:
every destination lies in the level's own pool segment, and no source does
(sources are child fronts, eliminated in earlier levels); the run
destinations and the multi-source destinations are disjoint.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core.profiling import profiled
from ..kernels.extend_add import RUN_BLOCK
from .symbolic import SymbolicFactorization, index_dtype

INDEX_FIELDS = ("udst", "offsets", "src", "dst", "run_dst", "run_src",
                "run_off", "run_blk")


@dataclasses.dataclass
class EALevel:
    """One level's extend-add: ``pool[run_dst[j] + t] += pool[run_src[j] +
    t]`` for ``t < run_off[j+1] - run_off[j]`` over the runs, and
    ``pool[udst[i]] += Σ pool[src[offsets[i]:offsets[i+1]]]`` over the
    multi-source destinations.  ``lo``/``hi`` bound the level's pool segment
    (every destination is in it, no source is); ``src_max`` is the largest
    source index.  Index arrays are NumPy on the host, tensors after
    :meth:`to`, all of one index type."""
    udst: object
    offsets: object
    src: object
    dst: object
    run_dst: object
    run_src: object
    run_off: object
    run_blk: object
    n_run_pairs: int
    lo: int
    hi: int
    src_max: int

    @property
    def n_multi(self) -> int:
        """Destinations with two or more sources."""
        return int(self.udst.shape[0])

    @property
    def n_runs(self) -> int:
        return int(self.run_dst.shape[0])

    @property
    def n_dest(self) -> int:
        """Unique destinations."""
        return self.n_multi + self.n_run_pairs

    @property
    def n_pairs(self) -> int:
        return int(self.src.shape[0])

    def to(self, device) -> "EALevel":
        """A copy on ``device``.  What depends only on the plan (one index
        type, contiguity, the arrays' lengths, the segment) is checked once
        here; the kernel's wrapper checks only what depends on the pool."""
        arrays = {f: torch.as_tensor(getattr(self, f)) for f in INDEX_FIELDS}
        if len({t.dtype for t in arrays.values()}) != 1 or \
                arrays["src"].dtype not in (torch.int32, torch.int64):
            raise TypeError(f"EALevel: index arrays must share one index "
                            f"type, int32 or int64, got "
                            f"{[t.dtype for t in arrays.values()]}")
        if not all(t.dim() == 1 and t.is_contiguous()
                   for t in arrays.values()):
            raise ValueError("EALevel: index arrays must be contiguous 1-D")
        n_blocks = -(-self.n_run_pairs // RUN_BLOCK)
        if arrays["offsets"].numel() != self.n_multi + 1 or \
                arrays["run_off"].numel() != self.n_runs + 1 or \
                arrays["run_src"].numel() != self.n_runs or \
                arrays["run_blk"].numel() != n_blocks + 1 or \
                arrays["dst"].numel() != self.n_pairs or \
                int(arrays["run_off"][-1]) != self.n_run_pairs or \
                int(arrays["offsets"][-1]) + self.n_run_pairs != self.n_pairs:
            raise ValueError("EALevel: offsets must have one more entry than "
                             "udst, run_off one more than the runs, run_blk "
                             "one more than the run blocks, and the pairs "
                             "must be the multi-source and the run pairs")
        if not 0 <= self.lo <= self.hi:
            raise IndexError(f"EALevel: segment [{self.lo}, {self.hi})")
        return dataclasses.replace(
            self, **{f: t.to(device) for f, t in arrays.items()})


@dataclasses.dataclass
class EAPlan:
    levels: Dict[int, EALevel]      # level index → plan (levels with pairs)
    pool_size: int

    def to(self, device) -> "EAPlan":
        return EAPlan({li: lv.to(device) for li, lv in self.levels.items()},
                      self.pool_size)

    @property
    def n_pairs(self) -> int:
        return sum(lv.n_pairs for lv in self.levels.values())


def build_ea_level(dst: np.ndarray, src: np.ndarray, lo: int, hi: int,
                   pool_size: int, idt=None) -> EALevel:
    """One level's plan from its pairs in the symbolic plan's order
    (host NumPy, index type ``idt``, by default the index-width rule's for
    ``pool_size``).  Raises ``ValueError`` on a geometry that would make the
    update in place unsafe."""
    dst = np.asarray(dst, np.int64)
    src = np.asarray(src, np.int64)
    idt = index_dtype(pool_size) if idt is None else idt
    if dst.min() < lo or dst.max() >= hi:
        raise ValueError(f"extend-add destination outside the level's pool "
                         f"segment [{lo}, {hi})")
    if src.min() < 0 or src.max() >= pool_size:
        raise ValueError(f"extend-add source outside the pool "
                         f"[0, {pool_size})")
    if np.any((src >= lo) & (src < hi)):
        raise ValueError("extend-add source inside the level's own "
                         "segment; the update in place would not be safe")
    order = np.argsort(dst, kind="stable")
    d, s = dst[order], src[order]
    new = np.ones(d.size, bool)
    new[1:] = d[1:] != d[:-1]
    starts = np.flatnonzero(new)
    fan_in = np.diff(np.append(starts, d.size))
    many = np.repeat(fan_in > 1, fan_in)          # in destination order
    md, ms = d[many], s[many]
    single = np.empty(d.size, bool)
    single[order] = ~many                         # in the symbolic order
    sd, ss = dst[single], src[single]
    brk = np.ones(sd.size, bool)
    brk[1:] = (sd[1:] != sd[:-1] + 1) | (ss[1:] != ss[:-1] + 1)
    rstart = np.flatnonzero(brk)
    run_off = np.append(rstart, sd.size)
    # disjoint parts: no destination has pairs on both sides
    if np.any(~new[1:] & (many[1:] != many[:-1])):
        raise ValueError("extend-add run destinations and multi-source "
                         "destinations overlap")
    mstart = np.flatnonzero(new[many])
    n_blocks = -(-sd.size // RUN_BLOCK)
    run_blk = np.searchsorted(run_off, RUN_BLOCK * np.arange(n_blocks + 1),
                              side="right") - 1
    return EALevel(
        udst=md[mstart].astype(idt),
        offsets=np.append(mstart, md.size).astype(idt),
        src=np.concatenate([ms, ss]).astype(idt),
        dst=np.concatenate([md, sd]).astype(idt),
        run_dst=sd[rstart].astype(idt), run_src=ss[rstart].astype(idt),
        run_off=run_off.astype(idt), run_blk=run_blk.astype(idt),
        n_run_pairs=int(sd.size), lo=lo, hi=hi, src_max=int(src.max()))


@profiled("el.ea_plan.build")
def build_ea_plan(symb: SymbolicFactorization) -> EAPlan:
    """The extend-add plan of every level of ``symb`` that has child Schur
    elements (host NumPy; move it with :meth:`EAPlan.to`)."""
    levels: Dict[int, EALevel] = {}
    for li, lev in enumerate(symb.levels):
        if np.asarray(lev.child_dst).size == 0:
            continue
        nf = np.asarray(lev.sn_ids).shape[0]
        lo = int(lev.offset)
        hi = lo + nf * lev.front_size * lev.front_size
        try:
            levels[li] = build_ea_level(lev.child_dst, lev.child_src, lo, hi,
                                        symb.pool_size)
        except ValueError as e:
            raise ValueError(f"level {li}: {e}") from None
    return EAPlan(levels, symb.pool_size)
