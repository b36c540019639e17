"""DIA (diagonal) sparse format for banded and stencil matrices (PDE
Laplacians and Helmholtz operators, banded systems); counterpart of
``elemental_tpu/sparse/dia.py``.

A DIA product is y = Σ_d diag_d ∘ shift(x, off_d): contiguous streams and
no gather.  :meth:`DIAMatrix.matvec` is that sum in plain torch, and it is
the plain version of the stencil kernel K3 (``kernels/spmv.py``).
``best_device_format`` picks DIA when few diagonals cover the matrix, ELL
otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .csr import SparseMatrix


@dataclasses.dataclass
class DIAMatrix:
    """``diags[d, i]`` holds ``A[i, i + offsets[d]]`` (row-aligned storage):
    a host NumPy array until :meth:`to` makes it a tensor."""

    height: int
    width: int
    offsets: Tuple[int, ...]
    diags: object               # (ndiag, height)
    nnz: int

    def to(self, device=None, dtype=None) -> "DIAMatrix":
        """A copy whose diagonals are a tensor on ``device`` in ``dtype``
        (either kept when None)."""
        return dataclasses.replace(
            self, diags=torch.as_tensor(self.diags).to(device, dtype))

    def _padded(self, X: torch.Tensor) -> Tuple[torch.Tensor, int]:
        lo = -min(0, min(self.offsets))
        hi = max(0, max(self.offsets)) + max(0, self.width - self.height)
        pad = [0, 0] * (X.dim() - 1) + [lo, hi]
        return torch.nn.functional.pad(X, pad), lo

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        n = self.height
        xp, lo = self._padded(x)
        y = torch.zeros(n, dtype=x.dtype, device=x.device)
        for d, off in enumerate(self.offsets):
            y = y + self.diags[d] * xp.narrow(0, lo + off, n)
        return y

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        n = self.height
        xp, lo = self._padded(X)
        y = torch.zeros((n, X.shape[1]), dtype=X.dtype, device=X.device)
        for d, off in enumerate(self.offsets):
            y = y + self.diags[d][:, None] * xp.narrow(0, lo + off, n)
        return y


def to_dia(A: SparseMatrix, max_diags: Optional[int] = None
           ) -> Optional[DIAMatrix]:
    """CSR → DIA on the host; None when the diagonal count is too high for
    DIA to be profitable (default: more than max(8, 4·nnz/height))."""
    rows = A.row_ids()
    offsets = A.colind - rows
    uniq = np.unique(offsets)
    if max_diags is None:
        max_diags = max(8, int(4 * A.nnz / max(A.height, 1)))
    if uniq.shape[0] > max_diags:
        return None
    diags = np.zeros((uniq.shape[0], A.height), A.vals.dtype)
    diags[np.searchsorted(uniq, offsets), rows] = A.vals
    return DIAMatrix(A.height, A.width, tuple(int(o) for o in uniq),
                     diags, A.nnz)


def best_device_format(A: SparseMatrix, *, device, dtype):
    """DIA for stencil-like structure, padded ELL otherwise, on ``device``
    with values in ``dtype``."""
    dia = to_dia(A)
    if dia is not None:
        return dia.to(device, dtype)
    return A.device_ell(device=device, dtype=dtype)
