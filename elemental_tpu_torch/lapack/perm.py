"""Permutations (counterpart of ``elemental_tpu/lapack/perm.py``; reference
``src/lapack_like/perm``: Permutation, pivot↔permutation conversions).

A permutation is an index vector; applying it is a gather on the operand's
device.  Pivots are 0-based LAPACK sequential swaps, as in the JAX package.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core.distmatrix import DistMatrix, as_array, like

Arr = Union[torch.Tensor, DistMatrix]


class Permutation:
    """Composable permutation (reference ``Permutation``)."""

    def __init__(self, perm):
        self.perm = torch.as_tensor(perm)

    @classmethod
    def identity(cls, n: int) -> "Permutation":
        return cls(torch.arange(n))

    def inverse(self) -> "Permutation":
        return Permutation(torch.argsort(self.perm))

    def compose(self, other: "Permutation") -> "Permutation":
        return Permutation(self.perm[other.perm.to(self.perm.device)])

    def _index(self, a: torch.Tensor, inverse: bool) -> torch.Tensor:
        p = torch.argsort(self.perm) if inverse else self.perm
        return p.to(a.device)

    def permute_rows(self, A: Arr, inverse: bool = False) -> Arr:
        a = as_array(A)
        return like(A, a[self._index(a, inverse)])

    def permute_cols(self, A: Arr, inverse: bool = False) -> Arr:
        a = as_array(A)
        return like(A, a[:, self._index(a, inverse)])

    def permute_symmetric(self, A: Arr) -> Arr:
        a = as_array(A)
        p = self._index(a, False)
        return like(A, a[p][:, p])

    def __len__(self) -> int:
        return int(self.perm.shape[0])


def _swap_rows(t: torch.Tensor, i: int, j: int) -> None:
    """Swap entries (rows) i and j of ``t`` in place, by copies on its
    device (an index list would be copied from the host each time)."""
    if i != j:
        ti = t[i].clone()
        t[i] = t[j]
        t[j] = ti


def _swap_cols(t: torch.Tensor, i: int, j: int) -> None:
    """Swap columns i and j of ``t`` in place (see :func:`_swap_rows`)."""
    _swap_rows(t.T, i, j)


def _swap_symmetric(a: torch.Tensor, p: torch.Tensor, i: int,
                    j: int) -> None:
    """Symmetric swap of rows and columns i, j of ``a``, and of ``p``."""
    _swap_rows(a, i, j)
    _swap_cols(a, i, j)
    _swap_rows(p, i, j)


def pivots_to_permutation(pivots) -> Permutation:
    """LAPACK sequential pivot rows → explicit permutation vector (reference
    ``PivotsToPermutation``)."""
    piv = np.asarray(torch.as_tensor(pivots).cpu())
    n = piv.shape[0]
    perm = np.arange(max(n, int(piv.max()) + 1 if n else 0))
    for k in range(n):
        j = int(piv[k])
        perm[k], perm[j] = perm[j], perm[k]
    return Permutation(perm)


def permutation_to_pivots(perm: Permutation):
    """Inverse conversion (reference ``PermutationToPivots``)."""
    p = np.asarray(perm.perm.cpu()).copy()
    n = p.shape[0]
    piv = np.zeros(n, dtype=np.int64)
    work = np.arange(n)
    for k in range(n):
        j = int(np.where(work == p[k])[0][0])
        piv[k] = j
        work[k], work[j] = work[j], work[k]
    return torch.as_tensor(piv)
