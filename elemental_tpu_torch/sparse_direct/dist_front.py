"""Distributed dense-front factorization (counterpart of
``elemental_tpu/sparse_direct/dist_front.py``; reference L2D fronts:
``numeric.hpp:29-38`` front types, ``ProcessFront.hpp:29-60`` blocked
LDL + Trsm + rank-k on a per-node ``[MC,MR]`` grid).

The few flop-dominant top-separator fronts are too big for one position's
share of a level batch and too few to split the batch.  So one front is
cut into row blocks over every position of the grid (``core/grid.py``),
in the flat order of the JAX ``_flat_index`` (row-major over the grid),
and factored panel by panel:

* each position's device receives that position's row block alone (a
  position on the front's own device works on a view of it);
* every device that holds a row at or below the panel's first pivot
  gathers the panel's columns of those rows (recorded as the JAX
  schedule's ``all-gather`` of the whole panel in the transfer log,
  ``utils/transfers.py``; the bytes that leave a device go to
  ``transfers.peer_bytes``) and eliminates its pivots with K8
  (``kernels.front_panel.ldl_panel``, sub-panels of 32; its plain column
  loop on the CPU), once per distinct device: the JAX package repeats
  this on every device;
* each position applies the rank-nb trailing update to its OWN row block
  with ``torch.matmul``, TF32 off, and writes the factored panel back;
* the row blocks held on other devices go back into the front.

The host never waits inside a front: every copy between cards is ordered
on the two cards' streams.  The masked-elimination semantics (``ns``-column
partial factorization, signed pivot floors) are those of the single-device
kernels in ``numeric.py``, so the pool layout and the extend-add are
unchanged.  The panel loop stops at ``ns``, and the last panel is as wide
as the pivots left: the JAX loop's steps past ``ns`` change nothing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.policy import tf32
from ..core.profiling import profile_region
from ..kernels.front_panel import ldl_panel
from ..utils import transfers

PANEL = 128     # the panel width nb (the JAX default)


def padded_size(S: int, nb: int, positions: int) -> int:
    """The front's padded order: a multiple of lcm(nb, 8·positions), so the
    rows split evenly into 8-aligned blocks and the panels tile it."""
    step = math.lcm(nb, 8 * positions)
    return -(-S // step) * step


def dist_partial_ldl(F: torch.Tensor, ns, grid, nb: int = PANEL,
                     conjugate: bool = False,
                     pf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Right-looking panel LDL of ONE front ``F`` (S×S, lower), row-block
    cut over every position of ``grid``, in place: the first ``ns``
    columns are eliminated, unit L and D in the panel and the Schur
    complement in the trailing block, as the one-device kernel
    ``numeric._masked_partial_ldl_blocked`` leaves them.  ``pf``: optional
    (S,) signed pivot floors (see ``kernels.front_panel._clamp_pivot``).
    Returns F."""
    devs = [grid.device(i, j) for i, j in grid.positions()]
    P = len(devs)
    S = F.shape[0]
    ns = int(ns)
    Sp = padded_size(S, nb, P)
    rl = Sp // P
    home = F.device
    Fp = F if Sp == S else torch.nn.functional.pad(F, (0, Sp - S, 0, Sp - S))
    blocks = [transfers.peer_copy(Fp[q * rl:(q + 1) * rl], dev)
              for q, dev in enumerate(devs)]
    on = list(dict.fromkeys(devs))          # the distinct devices, in order
    # K8's block-order counters, one front: zeroed, and left zeroed
    arrivals = {dev: torch.zeros(1, dtype=torch.int32, device=dev)
                for dev in on}
    pfs = {}
    if pf is not None:
        pfp = pf if Sp == S else torch.nn.functional.pad(pf, (0, Sp - S))
        pfs = {dev: transfers.peer_copy(pfp, dev) for dev in on}
    with tf32(False):
        for j0 in range(0, ns, nb):
            if transfers.recording:
                pieces = [b[:, j0:j0 + nb] for b in blocks]
                for q in range(P):
                    transfers.record("all-gather", ((Sp, nb), F.dtype),
                                     [(t, r) for r, t in enumerate(pieces)],
                                     q)
            w = min(nb, ns - j0)
            j1 = j0 + w
            # the positions holding a row ≥ j0, and their part of the panel
            active = range(j0 // rl, P)
            need = list(dict.fromkeys(devs[q] for q in active))
            with profile_region("el.ldl.dist.gather"):
                rows = [blocks[q][max(j0 - q * rl, 0):, j0:j1]
                        for q in active]
                if len(need) > 1:
                    rows = [t.contiguous() for t in rows]
                panels = {dev: torch.cat([transfers.peer_copy(t, dev)
                                          for t in rows]) for dev in need}
            for dev, Pp in panels.items():
                # rows ≥ j0 of the panel: its pivot k on row k − j0
                lp = Pp.new_empty((1,) + Pp.shape)
                ld = torch.empty_like(lp)
                nsd = torch.full((1,), ns - j0, dtype=torch.int64,
                                 device=dev)
                ldl_panel(Pp[None], nsd, 0, w, conjugate,
                          pfs[dev][None, j0:] if pfs else None, lp, ld,
                          arrivals[dev])
                panels[dev] = (Pp, lp[0], ld[0])
            for q in active:
                Pp, lp, ld = panels[devs[q]]
                r0 = q * rl
                blk = blocks[q]
                a = max(j0 - r0, 0)
                blk[a:, j0:j1] = Pp[r0 + a - j0:r0 + rl - j0]
                # rows ≤ j0 of the trailing update are zero
                lo = max(j0 + 1 - r0, 0)
                if j1 < Sp and lo < rl:
                    Lt = lp[j1 - j0:]
                    blk[lo:, j1:] -= torch.matmul(
                        ld[r0 + lo - j0:r0 + rl - j0],
                        Lt.mH if conjugate else Lt.mT)
    with profile_region("el.ldl.dist.return"):
        for q, dev in enumerate(devs):
            if dev != home:
                transfers.peer_copy_(Fp[q * rl:(q + 1) * rl], blocks[q])
    if Sp != S:
        F.copy_(Fp[:S, :S])
    return F


def dist_partial_spd(F: torch.Tensor, ns, grid, nb: int = PANEL,
                     conjugate: bool = False) -> torch.Tensor:
    """SPD wrapper: the LDL elimination on an HPD front gives the pool
    layout of the SPD kernel (unit-L panel, D = d on the diagonal, Schur
    trailing block)."""
    return dist_partial_ldl(F, ns, grid, nb=nb, conjugate=conjugate)
