"""Sparse PDE operators (counterpart of the sparse overloads of
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


def _laplacian_sparse(dims: Tuple[int, ...], shift: float = 0.0,
                      scaled: bool = True) -> SparseMatrix:
    """Negative Laplacian on a ``dims`` grid over (0,1)^d with Dirichlet
    boundaries, scaled by 1/h² (h from ``dims[0]``) when ``scaled``, minus
    ``shift`` on the diagonal (Helmholtz −Δ − ω²)."""
    d = len(dims)
    h2inv = float((dims[0] + 1) ** 2) if scaled else 1.0
    return _sparse_stencil(dims, 2.0 * d * h2inv - shift, -1.0 * h2inv)


def sparse_laplacian_1d(n1: int, scaled: bool = True) -> SparseMatrix:
    return _laplacian_sparse((n1,), scaled=scaled)


def sparse_laplacian_2d(n1: int, n2: int, scaled: bool = True) -> SparseMatrix:
    return _laplacian_sparse((n1, n2), scaled=scaled)


def sparse_laplacian_3d(n1: int, n2: int, n3: int,
                        scaled: bool = True) -> SparseMatrix:
    """Negative 3-D Laplacian, 7-point stencil on an n1×n2×n3 grid
    (positive definite)."""
    return _laplacian_sparse((n1, n2, n3), scaled=scaled)


def sparse_helmholtz_2d(n1: int, n2: int, shift: float) -> SparseMatrix:
    return _laplacian_sparse((n1, n2), shift=shift)


def sparse_helmholtz_3d(n1: int, n2: int, n3: int,
                        shift: float) -> SparseMatrix:
    return _laplacian_sparse((n1, n2, n3), shift=shift)


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
