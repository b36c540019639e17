"""Sparse containers: ``SparseMatrix`` (host CSR), ``Graph`` (pattern),
``SparseBuilder`` (COO assembly) and the device forms ``CSRDevice`` and
``ELLMatrix``, and the block form ``BSRMatrix``/``BSRDevice`` (counterpart
of ``elemental_tpu/sparse/csr.py``).

Assembly and structure live on the host in NumPy, as in the JAX package;
the device forms hold tensors.  ``CSRDevice.matvec`` is ``index_select`` +
``index_add_``, as the JAX package computed it with an XLA gather and
``segment_sum``; ``BSRDevice.matvec`` is a gather of x's blocks and one
batched block product.  Values may be real or complex.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


class SparseBuilder:
    """COO accumulation with the reference's QueueUpdate/ProcessQueues
    protocol (``AbstractDistMatrix.hpp:162-171`` / ``BP.py:20-40``)."""

    def __init__(self, height: int, width: int, dtype=np.float64):
        self.height = height
        self.width = width
        self.dtype = np.dtype(dtype)
        self._rows: list = []
        self._cols: list = []
        self._vals: list = []

    def reserve(self, n: int) -> None:
        """Reference ``Reserve``: nothing to do, the queues are lists."""

    def queue_update(self, i, j, v) -> None:
        self._rows.append(i)
        self._cols.append(j)
        self._vals.append(v)

    def queue_updates(self, rows, cols, vals) -> None:
        self._rows.extend(np.asarray(rows).tolist())
        self._cols.extend(np.asarray(cols).tolist())
        self._vals.extend(np.asarray(vals).tolist())

    def process_queues(self) -> "SparseMatrix":
        return SparseMatrix.from_coo(
            self.height, self.width, np.asarray(self._rows, np.int64),
            np.asarray(self._cols, np.int64),
            np.asarray(self._vals, self.dtype))


@dataclasses.dataclass
class SparseMatrix:
    """Local CSR matrix: host index arrays and host values."""

    height: int
    width: int
    rowptr: np.ndarray   # int64 (height+1)
    colind: np.ndarray   # int64 (nnz)
    vals: np.ndarray     # dtype (nnz)

    # ---------------- constructors ----------------
    @classmethod
    def from_arrays(cls, height: int, width: int, rowptr, colind,
                    vals) -> "SparseMatrix":
        """CSR from arrays as they are (for example another package's
        matrix): int64 structure, values unchanged."""
        return cls(int(height), int(width), np.asarray(rowptr, np.int64),
                   np.asarray(colind, np.int64), np.asarray(vals))

    @classmethod
    def from_coo(cls, height: int, width: int, rows, cols, vals,
                 sum_duplicates: bool = True) -> "SparseMatrix":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            key = rows * width + cols
            uniq, inv = np.unique(key, return_inverse=True)
            summed = np.zeros(uniq.shape[0], dtype=vals.dtype)
            np.add.at(summed, inv, vals)
            rows = (uniq // width).astype(np.int64)
            cols = (uniq % width).astype(np.int64)
            vals = summed
        rowptr = np.zeros(height + 1, np.int64)
        np.add.at(rowptr, rows + 1, 1)
        rowptr = np.cumsum(rowptr)
        return cls(height, width, rowptr, cols, vals)

    @classmethod
    def from_dense(cls, a, tol: float = 0.0) -> "SparseMatrix":
        a = np.asarray(a)
        rows, cols = np.nonzero(np.abs(a) > tol)
        return cls.from_coo(a.shape[0], a.shape[1], rows, cols,
                            a[rows, cols])

    @classmethod
    def from_scipy(cls, m) -> "SparseMatrix":
        m = m.tocsr()
        return cls(m.shape[0], m.shape[1], m.indptr.astype(np.int64),
                   m.indices.astype(np.int64), m.data)

    # ---------------- queries ----------------
    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def dtype(self):
        return self.vals.dtype

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.rowptr)

    def row_ids(self) -> np.ndarray:
        """Row index of every stored entry (COO rows, CSR order)."""
        return np.repeat(np.arange(self.height), self.row_nnz())

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.height, self.width), self.vals.dtype)
        out[self.row_ids(), self.colind] = self.vals
        return out

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.vals, self.colind, self.rowptr),
                             shape=self.shape)

    def graph(self) -> "Graph":
        return Graph(self.height, self.width, self.rowptr.copy(),
                     self.colind.copy())

    # ---------------- transforms ----------------
    def transpose(self) -> "SparseMatrix":
        return SparseMatrix.from_coo(self.width, self.height, self.colind,
                                     self.row_ids(), self.vals,
                                     sum_duplicates=False)

    def conj(self) -> "SparseMatrix":
        return dataclasses.replace(self, vals=np.conj(self.vals))

    def change_nonzero_values(self, new_vals) -> "SparseMatrix":
        """Same structure, new values (reference ``ChangeNonzeroValues``)."""
        new_vals = np.asarray(new_vals)
        if new_vals.shape != self.vals.shape:
            raise ValueError(f"expected {self.vals.shape} values, got "
                             f"{new_vals.shape}")
        return dataclasses.replace(self, vals=new_vals)

    def scale(self, alpha) -> "SparseMatrix":
        return dataclasses.replace(self, vals=self.vals * alpha)

    def symmetric_scale(self, d) -> "SparseMatrix":
        """diag(d)·A·diag(d), on the stored entries."""
        d = np.asarray(d)
        return dataclasses.replace(
            self, vals=self.vals * d[self.row_ids()] * d[self.colind])

    def add(self, other: "SparseMatrix", alpha=1.0) -> "SparseMatrix":
        """A + alpha·other, entries at the same place summed."""
        return SparseMatrix.from_coo(
            self.height, self.width,
            np.concatenate([self.row_ids(), other.row_ids()]),
            np.concatenate([self.colind, other.colind]),
            np.concatenate([self.vals, alpha * other.vals]))

    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape), self.vals.dtype)
        rows = self.row_ids()
        on = rows == self.colind
        d[rows[on]] = self.vals[on]
        return d

    def update_diagonal(self, delta) -> "SparseMatrix":
        """A + diag(delta) (the diagonal entries added where A has none)."""
        idx = np.arange(min(self.shape))
        return self.add(SparseMatrix.from_coo(self.height, self.width, idx,
                                              idx, np.asarray(delta)))

    # ---------------- device forms ----------------
    def host_ell(self, width: Optional[int] = None, pad_align: int = 8):
        """Padded ELL arrays on host: (cols int32 h×w, vals h×w, dropped)."""
        nnzr = self.row_nnz()
        w = int(width if width is not None else (nnzr.max() if len(nnzr)
                                                 else 0))
        w = max(1, ((w + pad_align - 1) // pad_align) * pad_align)
        cols = np.zeros((self.height, w), np.int32)
        vals = np.zeros((self.height, w), self.vals.dtype)
        r = self.row_ids()
        offs = np.arange(self.nnz) - np.repeat(self.rowptr[:-1], nnzr)
        keep = offs < w
        cols[r[keep], offs[keep]] = self.colind[keep].astype(np.int32)
        vals[r[keep], offs[keep]] = self.vals[keep]
        dropped = int((~keep).sum())
        return cols, vals, dropped

    def device_ell(self, *, device, dtype, width: Optional[int] = None,
                   pad_align: int = 8) -> "ELLMatrix":
        """Padded ELL form on ``device`` with values in ``dtype``."""
        cols, vals, dropped = self.host_ell(width, pad_align)
        return ELLMatrix(self.height, self.width,
                         torch.as_tensor(cols).to(device),
                         torch.as_tensor(vals).to(device, dtype), dropped)

    def device_csr(self, *, device, dtype) -> "CSRDevice":
        """Row-id CSR form on ``device`` with values in ``dtype``."""
        return CSRDevice(
            self.height, self.width,
            torch.as_tensor(self.row_ids()).to(device),
            torch.as_tensor(self.colind).to(device),
            torch.as_tensor(self.vals).to(device, dtype))


@dataclasses.dataclass
class ELLMatrix:
    """Padded ELL: every row holds ``cols.shape[1]`` slots (zeros pad)."""
    height: int
    width: int
    cols: torch.Tensor   # (h, w) int32
    vals: torch.Tensor   # (h, w)
    dropped: int = 0     # entries that exceeded the ELL width (0 = exact)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.vals * x[self.cols], dim=1)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        return torch.einsum("hw,hwk->hk", self.vals, X[self.cols])


@dataclasses.dataclass
class CSRDevice:
    """Device CSR in row-id form: ``y = index_add(rows, vals·x[colind])``."""
    height: int
    width: int
    rows: torch.Tensor    # (nnz,) int64, sorted (CSR order)
    colind: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor    # (nnz,)

    def to(self, device=None, dtype=None) -> "CSRDevice":
        """A copy on ``device`` with values in ``dtype`` (either kept when
        None)."""
        return dataclasses.replace(
            self, rows=self.rows.to(device), colind=self.colind.to(device),
            vals=self.vals.to(device, dtype))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        prod = self.vals * x.index_select(0, self.colind)
        y = torch.zeros(self.height, dtype=prod.dtype, device=prod.device)
        return y.index_add_(0, self.rows, prod)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        prod = self.vals[:, None] * X.index_select(0, self.colind)
        y = torch.zeros((self.height, X.shape[1]), dtype=prod.dtype,
                        device=prod.device)
        return y.index_add_(0, self.rows, prod)


@dataclasses.dataclass
class Graph:
    """Pattern-only sparse structure (reference ``Graph``; adjacency used by
    the nested-dissection symbolic layer)."""

    num_sources: int
    num_targets: int
    rowptr: np.ndarray
    colind: np.ndarray

    @classmethod
    def from_edges(cls, num_sources: int, num_targets: int, sources,
                   targets) -> "Graph":
        s = np.asarray(sources, np.int64)
        t = np.asarray(targets, np.int64)
        order = np.lexsort((t, s))
        s, t = s[order], t[order]
        key = s * num_targets + t
        uniq = np.unique(key)
        s = (uniq // num_targets).astype(np.int64)
        t = (uniq % num_targets).astype(np.int64)
        rowptr = np.zeros(num_sources + 1, np.int64)
        np.add.at(rowptr, s + 1, 1)
        return cls(num_sources, num_targets, np.cumsum(rowptr), t)

    @property
    def num_edges(self) -> int:
        return int(self.colind.shape[0])

    def neighbors(self, i: int) -> np.ndarray:
        return self.colind[self.rowptr[i]:self.rowptr[i + 1]]

    def to_sparse(self, dtype=np.float64) -> SparseMatrix:
        """The pattern as a matrix of ones."""
        return SparseMatrix(self.num_sources, self.num_targets,
                            self.rowptr.copy(), self.colind.copy(),
                            np.ones(self.num_edges, dtype))

    def symmetrize(self) -> "Graph":
        rows = np.repeat(np.arange(self.num_sources),
                         np.diff(self.rowptr))
        return Graph.from_edges(
            max(self.num_sources, self.num_targets),
            max(self.num_sources, self.num_targets),
            np.concatenate([rows, self.colind]),
            np.concatenate([self.colind, rows]))


@dataclasses.dataclass
class BSRMatrix:
    """Block CSR with fixed b×b blocks (host arrays): ``colind`` holds
    block columns, ``vals`` the (nnzb, b, b) blocks."""

    height: int
    width: int
    block: int
    rowptr: np.ndarray     # (block rows + 1,)
    colind: np.ndarray     # (nnzb,) block-column indices
    vals: np.ndarray       # (nnzb, b, b)

    @classmethod
    def from_sparse(cls, A: SparseMatrix, block: int) -> "BSRMatrix":
        b = block
        nbc = -(-A.width // b)
        rows = A.row_ids()
        key = (rows // b) * nbc + A.colind // b
        uniq, inv = np.unique(key, return_inverse=True)
        vals = np.zeros((uniq.shape[0], b, b), A.vals.dtype)
        np.add.at(vals, (inv, rows % b, A.colind % b), A.vals)
        rowptr = np.zeros(-(-A.height // b) + 1, np.int64)
        np.add.at(rowptr, uniq // nbc + 1, 1)
        return cls(A.height, A.width, b, np.cumsum(rowptr),
                   (uniq % nbc).astype(np.int64), vals)

    @property
    def nnzb(self) -> int:
        return int(self.colind.shape[0])

    def device(self, *, device, dtype) -> "BSRDevice":
        """Padded block-ELL form on ``device``: every block row holds the
        longest row's count of blocks (zero blocks pad)."""
        nnzr = np.diff(self.rowptr)
        nbr = nnzr.shape[0]
        wmax = max(1, int(nnzr.max()) if nbr else 1)
        b = self.block
        cols = np.zeros((nbr, wmax), np.int64)
        vals = np.zeros((nbr, wmax, b, b), self.vals.dtype)
        r = np.repeat(np.arange(nbr), nnzr)
        offs = np.arange(self.nnzb) - np.repeat(self.rowptr[:-1], nnzr)
        cols[r, offs] = self.colind
        vals[r, offs] = self.vals
        return BSRDevice(self.height, self.width, b,
                         torch.as_tensor(cols).to(device),
                         torch.as_tensor(vals).to(device, dtype))

    def to_dense(self) -> np.ndarray:
        b = self.block
        nbr = self.rowptr.shape[0] - 1
        out = np.zeros((nbr, b, -(-self.width // b), b), self.vals.dtype)
        brow = np.repeat(np.arange(nbr), np.diff(self.rowptr))
        np.add.at(out, (brow, slice(None), self.colind), self.vals)
        return out.reshape(nbr * b, -1)[:self.height, :self.width]


@dataclasses.dataclass
class BSRDevice:
    """Device block-ELL: ``y[r] = Σ_w vals[r, w] · x_block[cols[r, w]]``."""
    height: int
    width: int
    block: int
    cols: torch.Tensor   # (block rows, wmax) int64
    vals: torch.Tensor   # (block rows, wmax, b, b)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        b = self.block
        pad = -x.shape[0] % b
        xb = torch.nn.functional.pad(x, (0, pad)).reshape(-1, b)
        y = torch.matmul(self.vals, xb[self.cols][..., None]).sum(1)
        return y.reshape(-1)[:self.height]
