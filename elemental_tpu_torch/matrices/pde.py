"""PDE operators (counterpart of ``elemental_tpu/matrices/pde.py``, plus
``concat_fd_2d`` from ``examples/lp_direct_large.py``).  The sparse
overloads are host NumPy, returning :class:`~..sparse.csr.SparseMatrix`;
the dense overloads return tensors on a keyword-only ``device``.

Convention as in the reference: the negative Laplacian on a uniform grid
over (0,1)^d with Dirichlet boundaries, scaled by 1/h²; Helmholtz subtracts
the shift ω², which may be complex (a damped wave number)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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


# ---- dense overloads ----

def _dense(A: SparseMatrix, device) -> torch.Tensor:
    return torch.as_tensor(A.to_dense()).to(device)


def laplacian_1d(n1: int, scaled: bool = True, *, device) -> torch.Tensor:
    return _dense(sparse_laplacian_1d(n1, scaled), device)


def laplacian_2d(n1: int, n2: int, scaled: bool = True, *,
                 device) -> torch.Tensor:
    return _dense(sparse_laplacian_2d(n1, n2, scaled), device)


def laplacian_3d(n1: int, n2: int, n3: int, scaled: bool = True, *,
                 device) -> torch.Tensor:
    return _dense(sparse_laplacian_3d(n1, n2, n3, scaled), device)


def helmholtz_1d(n1: int, shift, *, device) -> torch.Tensor:
    return _dense(_laplacian_sparse((n1,), shift), device)


def helmholtz_2d(n1: int, n2: int, shift, *, device) -> torch.Tensor:
    return _dense(sparse_helmholtz_2d(n1, n2, shift), device)


def helmholtz_3d(n1: int, n2: int, n3: int, shift, *,
                 device) -> torch.Tensor:
    return _dense(sparse_helmholtz_3d(n1, n2, n3, shift), device)


def helmholtz_pml_2d(n1: int, n2: int, omega: float, pml_width: int = 5,
                     sigma: float = 1.5) -> SparseMatrix:
    """2-D Helmholtz with a simple PML absorbing layer (reference
    ``HelmholtzPML``): each axis' second difference divided by that axis'
    complex stretch s = 1 + iσ·depth² at the row's grid point, minus ω².

    Entry for entry the JAX package's matrix.  The stencil scales a row by
    its own point's stretch, so inside the band A ≠ Aᵀ (max|A − Aᵀ| = 21.6
    at 8×8, ω = 20): an LDLᵀ, which reads the permuted lower triangle, does
    not solve it."""
    nx, ny = n1, n2
    n = nx * ny
    h = 1.0 / (nx + 1)

    def stretch(i, m):
        d_lo = np.maximum(0, pml_width - i)
        d_hi = np.maximum(0, i - (m - 1 - pml_width))
        depth = np.maximum(d_lo, d_hi) / max(pml_width, 1)
        return 1.0 + 1j * sigma * depth ** 2

    sx = stretch(np.arange(nx), nx)
    sy = stretch(np.arange(ny), ny)
    i, j = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny),
                                            indexing="ij"))
    r = i * ny + j
    rows, cols, vals = [], [], []
    # the reference's loop order per axis: every point's diagonal, then its
    # lower and its upper neighbour (from_coo sums duplicates in this order)
    for s, k, m, step in ((sx, i, nx, ny), (sy, j, ny, 1)):
        coef = 1.0 / (s[k] * h * h)
        lo, hi = k > 0, k < m - 1
        part_r = np.stack([r, r, r], 1)
        part_c = np.stack([r, r - step, r + step], 1)
        part_v = np.stack([2.0 * coef, -coef, -coef], 1)
        keep = np.stack([np.ones_like(lo), lo, hi], 1)
        rows.append(part_r[keep])
        cols.append(part_c[keep])
        vals.append(part_v[keep])
    rows.append(np.arange(n))
    cols.append(np.arange(n))
    vals.append(np.full(n, -omega ** 2, np.complex128))
    return SparseMatrix.from_coo(n, n, np.concatenate(rows),
                                 np.concatenate(cols),
                                 np.concatenate(vals).astype(np.complex128))


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
