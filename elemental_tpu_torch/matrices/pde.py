"""Sparse PDE operators used by the port's main path (counterpart of part of
``elemental_tpu/matrices/pde.py``, plus ``concat_fd_2d`` from
``examples/lp_direct_large.py``).  Host NumPy, returning
:class:`~..sparse.csr.SparseMatrix`."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..sparse.csr import SparseMatrix


def _sparse_stencil(dims: Tuple[int, ...], diag_val, off_val) -> SparseMatrix:
    n = int(np.prod(dims))
    idx = np.arange(n).reshape(dims)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, diag_val)]
    for axis in range(len(dims)):
        sl_lo = [slice(None)] * len(dims)
        sl_hi = [slice(None)] * len(dims)
        sl_lo[axis] = slice(0, -1)
        sl_hi[axis] = slice(1, None)
        a = idx[tuple(sl_lo)].ravel()
        b = idx[tuple(sl_hi)].ravel()
        rows.extend([a, b])
        cols.extend([b, a])
        vals.extend([np.full(a.shape[0], off_val)] * 2)
    return SparseMatrix.from_coo(n, n, np.concatenate(rows),
                                 np.concatenate(cols), np.concatenate(vals),
                                 sum_duplicates=True)


def sparse_laplacian_3d(n1: int, n2: int, n3: int,
                        scaled: bool = True) -> SparseMatrix:
    """Negative 3-D Laplacian, 7-point stencil on an n1×n2×n3 grid over
    (0,1)³ with Dirichlet boundaries, scaled by 1/h² when ``scaled``
    (positive definite)."""
    h2inv = float((n1 + 1) ** 2) if scaled else 1.0
    return _sparse_stencil((n1, n2, n3), 6.0 * h2inv, -1.0 * h2inv)


def concat_fd_2d(n0: int, n1: int) -> SparseMatrix:
    """Two 2-D finite-difference blocks side by side, [FD₁ FD₂]
    (m = n0·n1 rows, 2m columns; the reference BP.py's ConcatFD2D
    stencil)."""
    m = n0 * n1
    s = np.arange(m)
    x0, x1 = s % n0, s // n0
    rows, cols, vals = [], [], []

    def add(mask, col, val):
        rows.append(s[mask])
        cols.append(col[mask])
        vals.append(np.full(int(mask.sum()), float(val)))

    t = np.ones(m, bool)
    add(t, s, 11.0)
    add(t, s + m, -20.0)
    add(x0 > 0, s - 1, -1.0)
    add(x0 > 0, s + m - 1, -17.0)
    add(x0 + 1 < n0, s + 1, 2.0)
    add(x0 + 1 < n0, s + m + 1, -20.0)
    add(x1 > 0, s - n0, -30.0)
    add(x1 > 0, s + m - n0, -3.0)
    add(x1 + 1 < n1, s + n0, 4.0)
    add(x1 + 1 < n1, s + m + n0, 3.0)
    return SparseMatrix.from_coo(m, 2 * m, np.concatenate(rows),
                                 np.concatenate(cols),
                                 np.concatenate(vals))
