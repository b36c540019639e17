"""Plans of the tree solve's level step, for the kernels K9
(``kernels/level_scatter.py``) and K10 (``kernels/level_solve.py``).

Built once per symbolic analysis, where the plan moves to its device
(:meth:`SymbolicFactorization.to`), and reused by every solve and every
``multiply_with_l`` against every factor of the pattern.

K9.  A level step with the panel inverses (the solve context) ends with
``xe[front_rows] += w - xf`` over the level's nf·S front slots.  The
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

K10.  The plain solve's level step (:class:`SubstitutionLevel`) needs each
front's pivot count ``ns`` and real row count ``sz`` on the device, and,
for the forward direction, K9's plan of the update slots alone (a front's
real slots from its ``ns``-th on): K10 writes a front's solved pivot rows
in place and leaves ``-L21·w1`` at its update slots, which K9 adds into
their rows.  The plan also fixes each level's launch shape (warps a block,
and whether the L21 products take launches of their own).
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


# csrc/level_solve.cu's rows a diagonal block, most warps a block and
# pivots a panel
K10_NB = 32
K10_MAX_WARPS = 8
K10_PANEL = 256
# a level of fewer fronts than this whose largest L21 panel holds at least
# SPLIT_MIN_PANEL entries takes launches of its own for the L21 products
SPLIT_MAX_FRONTS = 64
SPLIT_MIN_PANEL = 16384


@dataclasses.dataclass
class SubstitutionLevel:
    """K10's plan of one level: ``ns``, ``sz`` (nf,) the pivots and real
    rows of each front (NumPy on the host, tensors after :meth:`to`, in the
    symbolic plan's index type); ``update``: K9's plan of the update slots;
    ``max_ns``: the largest ``ns``; ``warps``: warps a block of the front
    kernels; ``split``: the level's triangles go a panel of
    :data:`K10_PANEL` pivots a launch, their products with the rest of each
    front over many blocks in launches of their own (a front of more than
    a panel's pivots, or few fronts with large L21 panels); else one launch
    a direction; ``update_warps``: warps a block of the forward products."""
    ns: object
    sz: object
    update: ScatterLevel
    max_ns: int
    warps: int
    split: bool
    update_warps: int

    @property
    def panels(self) -> int:
        return -(-self.max_ns // K10_PANEL)

    @property
    def launches(self) -> int:
        """K10 launches of one direction: two a panel when split."""
        return 2 * self.panels if self.split else 1

    def to(self, device) -> "SubstitutionLevel":
        return dataclasses.replace(
            self, ns=torch.as_tensor(self.ns).to(device),
            sz=torch.as_tensor(self.sz).to(device),
            update=self.update.to(device))


@dataclasses.dataclass
class SolvePlan:
    levels: List[ScatterLevel]      # one a level of the symbolic plan
    substitution: List[SubstitutionLevel]   # the same levels, for K10

    @property
    def max_level_slots(self) -> int:
        """The most front slots of one level: K10's forward buffer."""
        return max((lv.n_level_slots for lv in self.levels), default=0)

    def to(self, device) -> "SolvePlan":
        return SolvePlan([lv.to(device) for lv in self.levels],
                         [sub.to(device) for sub in self.substitution])


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def build_substitution_level(front_rows, ns, n: int,
                             index_type) -> SubstitutionLevel:
    """K10's plan of one level from its (nf, S) ``front_rows`` (padded
    slots hold n) and its (nf,) pivot counts ``ns``; ``index_type``: the
    symbolic plan's (the type of ``front_rows`` on the device)."""
    fr = np.asarray(front_rows)
    ns = np.asarray(ns, np.int64)
    nf, S = fr.shape
    sz = (fr != n).sum(axis=1)
    if np.any(ns < 1) or np.any(ns > sz) or np.any(
            fr[np.arange(S)[None, :] >= sz[:, None]] != n):
        raise ValueError("a front needs 1 <= ns <= its real rows, and its "
                         "padded slots after its real ones")
    pivot = np.arange(S)[None, :] < ns[:, None]
    update = build_scatter_level(np.where(pivot, n, fr), n)
    max_ns = int(ns.max()) if nf else 0
    row_blocks = int((-(-(sz - ns) // K10_NB)).max()) if nf else 0
    diag_blocks = -(-min(max_ns, K10_PANEL) // K10_NB)
    split = max_ns > K10_PANEL or (
        0 < nf < SPLIT_MAX_FRONTS
        and int((ns * (sz - ns)).max()) >= SPLIT_MIN_PANEL)
    return SubstitutionLevel(
        ns=ns.astype(index_type), sz=sz.astype(index_type), update=update,
        max_ns=max_ns, split=split,
        warps=min(K10_MAX_WARPS, _pow2_at_least(
            diag_blocks if split else max(diag_blocks, row_blocks))),
        update_warps=min(K10_MAX_WARPS, _pow2_at_least(diag_blocks)))


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
    """K9's and K10's plans of every level of the host plan ``symb``
    (NumPy; move it with :meth:`SolvePlan.to`)."""
    idt = index_dtype(symb.pool_size)
    return SolvePlan([build_scatter_level(lev.front_rows, symb.n)
                      for lev in symb.levels],
                     [build_substitution_level(lev.front_rows, lev.ns,
                                               symb.n, idt)
                      for lev in symb.levels])
