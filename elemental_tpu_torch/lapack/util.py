"""LAPACK-like utilities (counterpart of ``elemental_tpu/lapack/util.py``;
reference ``src/lapack_like/util``: Median, Sort, TaggedSort, PivotParity).
"""

from __future__ import annotations

from typing import Union

import torch

from ..core.distmatrix import DistMatrix, as_array

Arr = Union[torch.Tensor, DistMatrix]


def median(x: Arr):
    """The median of every entry; an even count averages the two middle
    values, as ``jnp.median`` does (``torch.median`` returns the lower)."""
    s = torch.sort(as_array(x).reshape(-1)).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return 0.5 * s[n // 2 - 1] + 0.5 * s[n // 2]


def sort(x: Arr, descending: bool = False):
    s = torch.sort(as_array(x).reshape(-1)).values
    return s.flip(0) if descending else s


def tagged_sort(x: Arr, descending: bool = False):
    """Sort returning (values, original indices) (reference ``TaggedSort``):
    the stable ascending order, reversed when ``descending`` (so ties come
    out in the JAX package's order)."""
    v = as_array(x).reshape(-1)
    idx = torch.argsort(v, stable=True)
    if descending:
        idx = idx.flip(0)
    return v[idx], idx


def pivot_parity(pivots):
    """Parity of a LAPACK pivot sequence (reference ``PivotParity``)."""
    p = torch.as_tensor(pivots)
    swaps = (p != torch.arange(p.shape[0], device=p.device)).sum()
    return swaps % 2
