"""Block-cyclic (BLOCK wrap) distributed matrices (counterpart of
``elemental_tpu/core/blockcyclic.py``).

Reference parity: the ``DistWrap BLOCK`` tier (``include/El/core/types.hpp
:228``, ``src/core/DistMatrix/Block/*``) — ScaLAPACK-compatible block-cyclic
layouts beside the element-cyclic default.

As in the JAX package, BLOCK wrap is an index map over the same layouts: a
:class:`BlockCyclicMatrix` stores the matrix with its rows/columns permuted
into owner-major block order, so the plain [MC,MR] blocks of the permuted
matrix are exactly the ScaLAPACK ``(mb, nb)`` block-cyclic ownership;
``to_element``/``from_element`` convert to the element-cyclic
:class:`~.distmatrix.DistMatrix` world: one permutation of the whole
matrix, assembled at the grid's first position and cut again (both
recorded in an open transfer log; the permutation moves rows and columns
between every pair of positions).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .dist import MC, MR
from .distmatrix import DistMatrix, as_array, distribute
from .grid import Grid


def block_cyclic_perm(n: int, nb: int, p: int) -> np.ndarray:
    """Permutation putting indices into owner-major block-cyclic order:
    position k of the permuted axis holds global index ``perm[k]``; owner
    of global index i is ``(i // nb) % p`` (the ScaLAPACK formula)."""
    idx = np.arange(n)
    blocks = idx // nb
    owner = blocks % p
    # sort by (owner, block, offset) — stable keeps in-block order
    return np.lexsort((idx, blocks, owner))


def _cut_whole(t: torch.Tensor, grid: Grid) -> DistMatrix:
    """The whole tensor ``t``, held at the grid's first position after an
    assembly, cut [MC,MR] (recorded, as :meth:`DistMatrix.like` cuts)."""
    return DistMatrix._from_whole(t, MC, MR, grid, 0, warn=True,
                                  record=True)


def _padded(m: int, n: int, mb: int, nb: int, grid: Grid) -> Tuple[int, int]:
    """Shape padded so every owner gets the same number of full blocks."""
    h, w = grid.height, grid.width
    return -(-m // (mb * h)) * (mb * h), -(-n // (nb * w)) * (nb * w)


@dataclasses.dataclass
class BlockCyclicMatrix:
    """A matrix in (mb, nb) block-cyclic layout over the grid: rows cycle
    over the 'mc' axis in mb-blocks, columns over 'mr' in nb-blocks."""

    data: DistMatrix           # permuted (owner-major) storage, [MC,MR]
    grid: Grid
    height: int
    width: int
    mb: int
    nb: int
    rperm: np.ndarray          # storage position -> global row
    cperm: np.ndarray          # storage position -> global col

    @classmethod
    def from_array(cls, a, grid: Optional[Grid] = None, mb: int = 32,
                   nb: int = 32) -> "BlockCyclicMatrix":
        if grid is None:
            grid = Grid.default()
        a = np.asarray(a)
        m, n = a.shape
        mp, npad = _padded(m, n, mb, nb, grid)
        ap = np.zeros((mp, npad), a.dtype)
        ap[:m, :n] = a
        rperm = block_cyclic_perm(mp, mb, grid.height)
        cperm = block_cyclic_perm(npad, nb, grid.width)
        stored = ap[np.ix_(rperm, cperm)]
        return cls(distribute(stored, MC, MR, grid), grid, m, n, mb, nb,
                   rperm, cperm)

    # -- ownership (ScaLAPACK semantics) ---------------------------------
    def owner(self, i: int, j: int) -> Tuple[int, int]:
        """(grid row, grid col) owning global entry (i, j)."""
        return ((i // self.mb) % self.grid.height,
                (j // self.nb) % self.grid.width)

    def local_shape(self) -> Tuple[int, int]:
        return tuple(self.data.local(0, 0).shape)

    # -- conversions ------------------------------------------------------
    def to_array(self) -> np.ndarray:
        inv_r = np.argsort(self.rperm)
        inv_c = np.argsort(self.cperm)
        full = self.data.to_numpy()[np.ix_(inv_r, inv_c)]
        return full[:self.height, :self.width]

    def to_element(self) -> DistMatrix:
        """Convert to the element-cyclic [MC,MR] DistMatrix (reference
        BLOCK→ELEMENT redistribution) — one permutation on the device."""
        stored = as_array(self.data)
        dev = stored.device
        inv_r = torch.from_numpy(np.argsort(self.rperm)).to(dev)
        inv_c = torch.from_numpy(np.argsort(self.cperm)).to(dev)
        full = stored.index_select(0, inv_r).index_select(1, inv_c)
        return _cut_whole(full[:self.height, :self.width], self.grid)

    @classmethod
    def from_element(cls, A: DistMatrix, mb: int = 32, nb: int = 32
                     ) -> "BlockCyclicMatrix":
        """ELEMENT→BLOCK redistribution as the permutation on the device
        inverse to :meth:`to_element` (no host round trip)."""
        grid = A.grid
        a = as_array(A)
        m, n = a.shape
        mp, npad = _padded(m, n, mb, nb, grid)
        ap = torch.nn.functional.pad(a, (0, npad - n, 0, mp - m))
        rperm = block_cyclic_perm(mp, mb, grid.height)
        cperm = block_cyclic_perm(npad, nb, grid.width)
        stored = ap.index_select(0, torch.from_numpy(rperm).to(a.device)) \
            .index_select(1, torch.from_numpy(cperm).to(a.device))
        return cls(_cut_whole(stored, grid), grid, m, n, mb, nb, rperm,
                   cperm)
