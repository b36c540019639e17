"""Distributed dense-front factorization (counterpart of
``elemental_tpu/sparse_direct/dist_front.py``; reference L2D fronts:
``numeric.hpp:29-38`` front types, ``ProcessFront.hpp:29-60`` blocked
LDL + Trsm + rank-k on a per-node ``[MC,MR]`` grid).

The few flop-dominant top-separator fronts are too big for one position's
share of a level batch and too few to split the batch.  So one front is
cut into row blocks over every position of the grid (``core/grid.py``),
in the flat order of the JAX ``_flat_index`` (row-major over the grid),
and factored panel by panel:

* every position gathers the panel's Sp×nb columns (one ``all-gather`` in
  the transfer log, ``utils/transfers.py``);
* the ≤ nb pivots inside the panel are eliminated once per distinct device
  (the JAX package repeats this on every device; positions that share a
  device would repeat the same arithmetic);
* each position applies the rank-nb trailing update to its OWN row block
  with ``torch.matmul``, TF32 off, and writes the factored panel back.

The masked-elimination semantics (``ns``-column partial factorization,
signed pivot floors) are those of the single-device kernels in
``numeric.py``, so the pool layout and the extend-add are unchanged.  The
column loop stops at ``ns``: the JAX loop's steps past it change nothing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils import transfers
from .numeric import _clamp_pivot, full_fp32_matmul

PANEL = 128     # the panel width nb (the JAX default)


def padded_size(S: int, nb: int, positions: int) -> int:
    """The front's padded order: a multiple of lcm(nb, 8·positions), so the
    rows split evenly into 8-aligned blocks and the panels tile it."""
    step = math.lcm(nb, 8 * positions)
    return -(-S // step) * step


def _eliminate_panel(Pp, j0: int, ncols: int, conjugate: bool, pf) -> None:
    """Eliminate the panel's first ``ncols`` columns (pivots j0 + kk), in
    place on the gathered Sp×nb panel ``Pp``: unit L below each pivot, the
    pivot on the diagonal, the rank-1 updates inside the panel."""
    for kk in range(ncols):
        k = j0 + kk
        dk = Pp[k, kk]
        if pf is not None:
            dk = _clamp_pivot(dk, pf[k])
        safe = torch.where(dk == 0, torch.ones_like(dk), dk)
        col = Pp[k + 1:, kk] / safe
        rest = Pp.shape[1] - kk - 1
        if rest:
            row = col[:rest]
            if conjugate:
                row = row.conj()
            Pp[k + 1:, kk + 1:] -= col[:, None] * row[None, :] * dk
        Pp[k + 1:, kk] = col
        if pf is not None:
            Pp[k, kk] = dk


def dist_partial_ldl(F: torch.Tensor, ns, grid, nb: int = PANEL,
                     conjugate: bool = False,
                     pf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Right-looking panel LDL of ONE front ``F`` (S×S, lower), row-block
    cut over every position of ``grid``, in place: the first ``ns``
    columns are eliminated, unit L and D in the panel and the Schur
    complement in the trailing block, as ``numeric._masked_partial_ldl``
    leaves them.  ``pf``: optional (S,) signed pivot floors (see
    ``numeric._clamp_pivot``).  Returns F."""
    devs = [grid.device(i, j) for i, j in grid.positions()]
    P = len(devs)
    S = F.shape[0]
    ns = int(ns)
    Sp = padded_size(S, nb, P)
    rl = Sp // P
    Fp = F if Sp == S else torch.nn.functional.pad(F, (0, Sp - S, 0, Sp - S))
    on = {F.device: Fp}
    # one copy of the front per distinct device; each position's block is a
    # view of its device's copy (cutting at entry: not a transfer)
    blocks = []
    for q, dev in enumerate(devs):
        if dev not in on:
            on[dev] = Fp.to(dev)
        blocks.append(on[dev][q * rl:(q + 1) * rl])
    pfs = {}
    if pf is not None:
        pfp = pf if Sp == S else torch.nn.functional.pad(pf, (0, Sp - S))
        pfs = {dev: pfp.to(dev) for dev in on}
    rows = torch.arange(Sp, device=F.device)
    with full_fp32_matmul():
        for j0 in range(0, ns, nb):
            j1 = j0 + nb
            pieces = [b[:, j0:j1] for b in blocks]
            panels = {}
            for dev in on:
                Pp = torch.cat([t.to(dev) for t in pieces])     # (Sp, nb)
                _eliminate_panel(Pp, j0, min(nb, ns - j0), conjugate,
                                 pfs.get(dev))
                # the panel's L columns (pivots < ns), and its D
                prow = torch.arange(j0, j1, device=dev)
                keep = ((rows.to(dev)[:, None] > prow[None, :])
                        & (prow[None, :] < ns))
                Lp = torch.where(keep, Pp, torch.zeros((), dtype=Pp.dtype,
                                                       device=dev))
                d = Pp[j0:j1].diagonal()
                LpT = Lp[j1:].mH if conjugate else Lp[j1:].mT
                panels[dev] = (Pp, Lp, d, LpT)
            for q, dev in enumerate(devs):
                if transfers.recording:
                    transfers.record("all-gather", ((Sp, nb), F.dtype),
                                     [(t, r) for r, t in enumerate(pieces)],
                                     q)
                Pp, Lp, d, LpT = panels[dev]
                r0 = q * rl
                blk = blocks[q]
                # rows ≤ j0 of the trailing update are zero
                lo = min(max(j0 + 1 - r0, 0), rl)
                if j1 < Sp and lo < rl:
                    blk[lo:, j1:] -= torch.matmul(
                        Lp[r0 + lo:r0 + rl] * d[None, :], LpT)
                blk[:, j0:j1] = Pp[r0:r0 + rl]
    # the row blocks held on another device than F's go back into it
    for q, dev in enumerate(devs):
        if dev != F.device:
            Fp[q * rl:(q + 1) * rl] = blocks[q].to(F.device)
    if Sp != S:
        F.copy_(Fp[:S, :S])
    return F


def dist_partial_spd(F: torch.Tensor, ns, grid, nb: int = PANEL,
                     conjugate: bool = False) -> torch.Tensor:
    """SPD wrapper: the LDL elimination on an HPD front gives the pool
    layout of the SPD kernel (unit-L panel, D = d on the diagonal, Schur
    trailing block)."""
    return dist_partial_ldl(F, ns, grid, nb=nb, conjugate=conjugate)
