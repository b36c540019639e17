"""Scatter plan of the tree solve's level step, for the kernel K9
(``kernels/level_scatter.py``).

Built once per symbolic analysis, where the plan moves to its device
(:meth:`SymbolicFactorization.to`), and reused by every solve and every
``multiply_with_l`` against every factor of the pattern.  A level step ends
with ``xe[front_rows] += w - xf`` over the level's nf·S front slots.  The
symbolic plan pads every front of a level to the level's largest size and
points each padded slot at the dummy row n of ``xe``, so most of a level's
slots (77 % of the LP's KKT plan, 68 % of the 48³ Laplacian's) add zeros into
one address.  The plan keeps only the real slots, as CSR segments by
destination row:

* ``rows``: the distinct destination rows, ascending;
* ``offsets``: CSR-style offsets over ``slots``, one segment a row;
* ``slots``: the slot ids (flat indices into the level's nf·S slots), stably
  sorted by destination, so that within a row they stay in ascending slot
  order, the order in which ``index_add_`` adds them;
* ``dst``: the destination of each entry of ``slots``, for the plain version
  ``xe.index_add_(0, dst, (w - xf).reshape(-1, k)[slots])``.

No padded slot appears in the plan, so row n is never written.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.policy import index_dtype
from ..core.profiling import profiled

INDEX_FIELDS = ("rows", "offsets", "slots", "dst")


@dataclasses.dataclass
class ScatterLevel:
    """One level's scatter: ``xe[rows[i]] += Σ (w - xf)[slots[offsets[i]:
    offsets[i+1]]]``, added in that order.  ``n``: the real rows (``xe``
    has n + 1); ``n_level_slots``: the level's nf·S slots.  Index arrays are
    NumPy on the host, tensors after :meth:`to`, all of one index type."""
    rows: object
    offsets: object
    slots: object
    dst: object
    n: int
    n_level_slots: int

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_slots(self) -> int:
        return int(self.slots.shape[0])

    def to(self, device) -> "ScatterLevel":
        return dataclasses.replace(
            self, **{f: torch.as_tensor(getattr(self, f)).to(device)
                     for f in INDEX_FIELDS})


@dataclasses.dataclass
class SolvePlan:
    levels: List[ScatterLevel]      # one a level of the symbolic plan

    def to(self, device) -> "SolvePlan":
        return SolvePlan([lv.to(device) for lv in self.levels])


def build_scatter_level(front_rows, n: int) -> ScatterLevel:
    """One level's plan from its (nf, S) ``front_rows`` (padded slots hold
    n); host NumPy, int32 where the level's slots and ``xe``'s rows fit,
    int64 otherwise."""
    fr = np.asarray(front_rows).reshape(-1)
    if fr.size and (fr.min() < 0 or fr.max() > n):
        raise ValueError(f"front rows outside [0, {n}]")
    real = np.flatnonzero(fr != n)
    order = np.argsort(fr[real], kind="stable")
    slots = real[order]
    dst = fr[slots]
    new = np.ones(dst.size, bool)
    new[1:] = dst[1:] != dst[:-1]
    starts = np.flatnonzero(new)
    idt = index_dtype(max(fr.size, n + 1))
    return ScatterLevel(rows=dst[starts].astype(idt),
                        offsets=np.append(starts, dst.size).astype(idt),
                        slots=slots.astype(idt), dst=dst.astype(idt),
                        n=n, n_level_slots=int(fr.size))


@profiled("el.solve_plan.build")
def build_solve_plan(symb) -> SolvePlan:
    """The scatter plan of every level of the host plan ``symb`` (NumPy;
    move it with :meth:`SolvePlan.to`)."""
    return SolvePlan([build_scatter_level(lev.front_rows, symb.n)
                      for lev in symb.levels])
