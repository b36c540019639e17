"""Distribution calculus (counterpart of ``elemental_tpu/core/dist.py``).

The reference encodes its matrix distributions as pairs drawn from
``Dist {MC, MD, MR, VC, VR, STAR, CIRC}`` (``include/El/core/types.hpp:
208-217``) and derives, by a small algebra (``types.hpp:240-330``), where a
diagonal, a partial reduction or a gathered variant lives.  The JAX package
maps each pair onto a ``PartitionSpec`` over a 2-D mesh with axes
``('mc', 'mr')``; the port keeps that mapping as a plain tuple, one entry a
dimension:

  * ``MC`` → ``'mc'``, ``MR`` → ``'mr'``;
  * ``VC`` and ``MD`` → ``('mc', 'mr')``, ``VR`` → ``('mr', 'mc')`` (the
    flattened grid, mesh-major);
  * ``STAR`` and ``CIRC`` → ``None`` (replicated; ``CIRC`` carries a root).

Blocks are contiguous chunks, as ``NamedSharding`` cuts them: element-cyclic
layouts exist in the reference for the load balance of panel algorithms,
which both packages replace with recursive blocked ones.  ``MD`` is laid out
exactly as ``VC``, as in the JAX package.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple, Union

#: One dimension's entry of a spec: a mesh axis, a tuple of axes (the
#: flattened grid, major axis first), or None (replicated).
Axes = Optional[Union[str, Tuple[str, ...]]]
#: The port's partition spec: one :data:`Axes` entry per dimension.
Spec = Tuple[Axes, ...]


class Dist(enum.Enum):
    """Mirror of the reference's ``Dist`` enum (``types.hpp:208-217``)."""

    MC = "MC"      # column of a 2D process grid
    MD = "MD"      # diagonal of a 2D process grid
    MR = "MR"      # row of a 2D process grid
    VC = "VC"      # full grid, column-major order
    VR = "VR"      # full grid, row-major order
    STAR = "STAR"  # replicated
    CIRC = "CIRC"  # stored on a single root process


MC = Dist.MC
MD = Dist.MD
MR = Dist.MR
VC = Dist.VC
VR = Dist.VR
STAR = Dist.STAR
CIRC = Dist.CIRC

#: All distribution pairs the reference instantiates
#: (``src/core/DistMatrix/ElementMatrix/*.cpp``).
DIST_PAIRS: Tuple[Tuple[Dist, Dist], ...] = (
    (CIRC, CIRC),
    (MC, MR),
    (MC, STAR),
    (MD, STAR),
    (MR, MC),
    (MR, STAR),
    (STAR, MC),
    (STAR, MD),
    (STAR, MR),
    (STAR, STAR),
    (STAR, VC),
    (STAR, VR),
    (VC, STAR),
    (VR, STAR),
)


def _axis_of(d: Dist) -> Axes:
    """Mesh axis (or axis tuple) that a single Dist shards over."""
    if d is Dist.MC:
        return "mc"
    if d is Dist.MR:
        return "mr"
    if d in (Dist.VC, Dist.MD):
        return ("mc", "mr")
    if d is Dist.VR:
        return ("mr", "mc")
    # STAR and CIRC: replicated over the grid (CIRC carries root metadata).
    return None


def partition_spec(coldist: Dist, rowdist: Dist) -> Spec:
    """Spec of a matrix with rows distributed as ``coldist`` and columns as
    ``rowdist`` (Elemental's [U,V] convention: A[MC,MR] cuts rows over MC
    and columns over MR)."""
    return (_axis_of(coldist), _axis_of(rowdist))


def vector_spec(dist: Dist) -> Spec:
    """Spec of a 1-D array distributed as ``dist``."""
    return (_axis_of(dist),)


# ---------------------------------------------------------------------------
# Distribution algebra — mirrors ``types.hpp:240-330``.
# ---------------------------------------------------------------------------

def diag_col(coldist: Dist, rowdist: Dist) -> Dist:
    """Distribution of a diagonal extracted from an [coldist,rowdist] matrix
    (reference ``DiagCol``, ``types.hpp:240``)."""
    pair = (coldist, rowdist)
    if pair == (MC, MR) or pair == (MR, MC):
        return MD
    if coldist is STAR and rowdist is STAR:
        return STAR
    if coldist is CIRC:
        return CIRC
    return VC


def gathered_dist(d: Dist) -> Dist:
    """Collect a distribution onto every process (reference ``Collect``)."""
    return STAR if d is not CIRC else CIRC


def partial_dist(d: Dist) -> Dist:
    """Partial (pre-reduction) distribution (reference ``Partial``): the dist a
    sum-contribution lives in before ``Contract`` reduce-scatters it."""
    if d is VC:
        return MC
    if d is VR:
        return MR
    return d


def partial_union_dist(u: Dist, v: Dist) -> Dist:
    """Reference ``PartialUnionRow/Col`` helper: the axis over which a partial
    distribution must be reduced."""
    if u is VC and v is STAR:
        return MR
    if u is VR and v is STAR:
        return MC
    return STAR


def is_replicated(coldist: Dist, rowdist: Dist) -> bool:
    return coldist in (STAR, CIRC) and rowdist in (STAR, CIRC)


def transpose_pair(coldist: Dist, rowdist: Dist) -> Tuple[Dist, Dist]:
    """Distribution of the transpose living on the same grid:
    [MC,MR]ᵀ → [MR,MC] etc."""
    return (rowdist, coldist)
