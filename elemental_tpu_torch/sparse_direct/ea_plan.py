"""Extend-add plan for the Hopper kernel K1 (``kernels/extend_add.py``).

Built once per symbolic analysis.  For each level with child Schur
complements, the symbolic plan's ``(child_dst, child_src)`` pairs (the
reference's ``childRelInds``, ``NodeInfo.hpp:27-110``) are sorted stably by
destination, giving

* ``udst``: the unique destinations, ascending;
* ``offsets``: CSR-style offsets, so destination ``udst[i]`` is fed by
  ``src[offsets[i]:offsets[i+1]]``;
* ``src``: the sources in destination order (``dst`` beside it, for the
  plain version ``pool.index_add_(0, dst, pool[src])``).

The plan checks the geometry that makes the kernel's update in place safe:
every destination lies in the level's own pool segment, and no source does
(sources are child fronts, eliminated in earlier levels).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .symbolic import SymbolicFactorization, index_dtype


@dataclasses.dataclass
class EALevel:
    """One level's extend-add: ``pool[udst[i]] += Σ pool[src[offsets[i]:
    offsets[i+1]]]``.  ``lo``/``hi`` bound the level's pool segment (every
    destination is in it, no source is); ``src_max`` is the largest source
    index.  Index arrays are NumPy on the host, tensors after :meth:`to`."""
    udst: object
    offsets: object
    src: object
    dst: object
    lo: int
    hi: int
    src_max: int

    @property
    def n_udst(self) -> int:
        return int(self.udst.shape[0])

    @property
    def n_pairs(self) -> int:
        return int(self.src.shape[0])

    def to(self, device) -> "EALevel":
        conv = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
        return dataclasses.replace(self, udst=conv(self.udst),
                                   offsets=conv(self.offsets),
                                   src=conv(self.src), dst=conv(self.dst))


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


def build_ea_plan(symb: SymbolicFactorization) -> EAPlan:
    """The extend-add plan of every level of ``symb`` that has child Schur
    elements (host NumPy; move it with :meth:`EAPlan.to`)."""
    idt = index_dtype(symb.pool_size)
    levels: Dict[int, EALevel] = {}
    for li, lev in enumerate(symb.levels):
        dst = np.asarray(lev.child_dst, np.int64)
        src = np.asarray(lev.child_src, np.int64)
        if dst.size == 0:
            continue
        nf = np.asarray(lev.sn_ids).shape[0]
        lo = int(lev.offset)
        hi = lo + nf * lev.front_size * lev.front_size
        if dst.min() < lo or dst.max() >= hi:
            raise ValueError(f"level {li}: extend-add destination outside "
                             f"the level's pool segment [{lo}, {hi})")
        if src.min() < 0 or src.max() >= symb.pool_size:
            raise ValueError(f"level {li}: extend-add source outside the "
                             f"pool [0, {symb.pool_size})")
        if np.any((src >= lo) & (src < hi)):
            raise ValueError(f"level {li}: extend-add source inside the "
                             f"level's own segment; the update in place "
                             f"would not be safe")
        order = np.argsort(dst, kind="stable")
        d, s = dst[order], src[order]
        new = np.ones(d.size, bool)
        new[1:] = d[1:] != d[:-1]
        starts = np.flatnonzero(new)
        levels[li] = EALevel(
            udst=d[starts].astype(idt),
            offsets=np.append(starts, d.size).astype(idt),
            src=s.astype(idt), dst=d.astype(idt),
            lo=lo, hi=hi, src_max=int(s.max()))
    return EAPlan(levels, symb.pool_size)
