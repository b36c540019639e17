"""A count of the block copies between grid positions (the port's
counterpart of ``elemental_tpu/utils/collectives.py``).

The JAX package audits communication by compiling a function and counting
the collectives in XLA's optimized HLO.  The port has no HLO: its
collectives are block copies between grid positions, made in Python by the
single controller (``core/grid.py``).  So they are counted where they are
made::

    with count_transfers() as log:
        y = dA.matvec(x)
    log.audit()   # {"all-to-all": {"count": 8, "bytes": ...}, ..., "total": ...}

Each record is one collective's share at one destination position: its
kind, under the HLO's names (``all-gather``, ``all-to-all``,
``all-reduce``, ``collective-permute``, ``reduce-scatter``), the shape and
dtype of what that position ends up holding, and the bytes that reached it
from *other* positions.  A copy whose source and destination are the same
position costs nothing and is not recorded.  Positions are counted, not
devices: on one card, or on the CPU, several positions share a device and
their copies never leave it.

What the count is not: it is the bytes that cross positions in the port's
own schedule, logically.  It does not measure a link's traffic, and on one
card no byte leaves the device.  Placing host data on a grid
(``distribute``, the counterpart of ``jax.device_put``) and reading a
matrix to the host (``to_numpy``, ``as_numpy``, the ``assemble`` of a
``DistMultiVec`` or a distributed sparse matrix: the counterparts of
reading a global ``jax.Array``) are not recorded, as no HLO audit sees
them.  Inside the library they are: assembling a ``DistMatrix`` at the
grid's first position (``as_array``) is an ``all-gather`` there, and
cutting a whole result held there into blocks (``like``) a
``collective-permute`` at each other position, copies that GSPMD does
not make where it computes on the shards.

Outside :func:`count_transfers`, a hook costs one check of the module-level
flag :data:`recording`.

What the log does not say is what left a device.  The grid tiers of the
sparse-direct factor (``sparse_direct/dist_front.py``, ``numeric.
_shard_level``) move their blocks with :func:`peer_copy` and
:func:`peer_copy_`, which add the bytes of every copy between two distinct
devices to :data:`peer_bytes`, whether or not a log is open: on four
cards that is the traffic over the links; on a grid that repeats one
device it stays 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "collective-permute",
         "all-to-all")

# True while at least one ``count_transfers`` context is open; the hooks in
# the port test it before they build anything
recording = False
_logs: List["TransferLog"] = []
# bytes :func:`peer_copy` and :func:`peer_copy_` copied between two
# distinct devices since the process started
peer_bytes = 0


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One collective's share at one destination position."""

    kind: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    bytes: int


class TransferLog:
    """The records made while its :func:`count_transfers` context was
    open."""

    def __init__(self):
        self.records: List[Transfer] = []

    def __iter__(self) -> Iterator[Transfer]:
        return iter(self.records)

    def __len__(self) -> int:
        return len(self.records)

    def of(self, kind: str) -> List[Transfer]:
        return [r for r in self.records if r.kind == kind]

    def bytes(self, kind: Optional[str] = None) -> int:
        return sum(r.bytes for r in self.records
                   if kind is None or r.kind == kind)

    def audit(self) -> Dict[str, Dict[str, int]]:
        """Per kind ``{"count", "bytes"}``, and their ``total``: the form
        of the JAX package's ``collective_audit``."""
        out = {k: {"count": 0, "bytes": 0} for k in KINDS}
        for r in self.records:
            out[r.kind]["count"] += 1
            out[r.kind]["bytes"] += r.bytes
        out["total"] = {"count": len(self.records),
                        "bytes": self.bytes()}
        return out


@contextlib.contextmanager
def count_transfers() -> Iterator[TransferLog]:
    """Record every transfer between grid positions made inside the
    ``with`` block (contexts may nest; each log sees what was made while it
    was open)."""
    global recording
    log = TransferLog()
    _logs.append(log)
    recording = True
    try:
        yield log
    finally:
        _logs.remove(log)
        recording = bool(_logs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def record(kind: str, out, pieces: Iterable[Tuple[torch.Tensor, object]],
           dst) -> None:
    """Record that position ``dst`` now holds ``out`` (a tensor, or a
    ``(shape, dtype)`` pair), made of ``pieces``: (tensor, source
    position) pairs.  The bytes of the pieces from other positions are the
    transfer's; a transfer of no such bytes is not recorded."""
    if kind not in KINDS:
        raise ValueError(f"unknown transfer kind {kind!r}")
    nbytes = sum(_nbytes(t) for t, src in pieces if src != dst)
    if nbytes == 0:
        return
    shape, dtype = ((tuple(out.shape), out.dtype)
                    if isinstance(out, torch.Tensor) else
                    (tuple(out[0]), out[1]))
    rec = Transfer(kind, shape, dtype, nbytes)
    for log in _logs:
        log.records.append(rec)


def peer_copy(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: ``t`` itself where it is there already, else a
    copy, whose bytes are added to :data:`peer_bytes`.  A copy between two
    cards is ordered on both cards' current streams; the host does not
    wait for it."""
    global peer_bytes
    if t.device == device:
        return t
    peer_bytes += _nbytes(t)
    return t.to(device)


def peer_copy_(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, its bytes added to :data:`peer_bytes` where the
    two lie on distinct devices."""
    global peer_bytes
    if dst.device != src.device:
        peer_bytes += _nbytes(src)
    dst.copy_(src)
