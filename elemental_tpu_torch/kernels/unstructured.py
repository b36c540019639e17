"""K2: the general (unstructured) SpMV over a CSR matrix, as a hand-written
CUDA kernel (``csrc/csr_spmv.cu``), and its plain PyTorch version.

Replaces the TPU kernel ``elemental_tpu/kernels/unstructured.py:
gather_multiply`` together with the ``segment_sum`` that ``GatherPlan.matvec``
applies to its output: :func:`gather_spmv` computes y = A·x in one pass over
the row-sorted CSR.  The reference sorted entries by column into 1024-entry
tiles over 256-column windows (and split wide matrices into column chunks,
``ChunkedGatherPlan``) because Mosaic gathers only within one vreg and VMEM
is scoped; the H100 gathers x from device memory, so the port's plan is the
CSR itself.

The kernel is built with ``nvcc`` for sm_90a at first use (``_build.py``)
and loaded with ctypes; it launches on the current CUDA stream and allocates
nothing but its output.  :func:`gather_spmv` takes the plain version only
for tensors on the CPU.  For CUDA tensors it launches the kernel or raises:
nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np
import torch

from .._build import CSRC_DIR, build_cuda_library
from ..core.policy import index_dtype

SOURCE = os.path.join(CSRC_DIR, "csr_spmv.cu")

_FN_NAMES = {
    (torch.float32, torch.int32): "el_csr_spmv_f32_i32",
    (torch.float32, torch.int64): "el_csr_spmv_f32_i64",
    (torch.float64, torch.int32): "el_csr_spmv_f64_i32",
    (torch.float64, torch.int64): "el_csr_spmv_f64_i64",
}


@dataclasses.dataclass
class GatherPlan:
    """y = A·x over the row-sorted CSR of A.  ``rowptr``/``colind`` (and
    ``rows``, the row of each entry, which only the plain version reads)
    follow the index-width rule; ``col_max`` is the largest column index
    (-1 when there are no entries)."""

    n_rows: int
    n_cols: int
    nnz: int
    rowptr: torch.Tensor     # (n_rows + 1,)
    colind: torch.Tensor     # (nnz,)
    vals: torch.Tensor       # (nnz,)
    rows: torch.Tensor       # (nnz,)
    col_max: int

    def to(self, device=None, dtype=None) -> "GatherPlan":
        """A copy on ``device`` with values in ``dtype`` (either kept when
        None)."""
        return dataclasses.replace(
            self, rowptr=self.rowptr.to(device),
            colind=self.colind.to(device), vals=self.vals.to(device, dtype),
            rows=self.rows.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return gather_spmv(self, x)

    @property
    def group(self) -> int:
        """Lanes per row in the kernel: the power of two at or above the
        mean row length, within [2, 32]."""
        mean = -(-self.nnz // max(self.n_rows, 1))
        return int(min(32, max(2, 1 << max(0, mean - 1).bit_length())))

    @classmethod
    def from_reference(cls, ref) -> "GatherPlan":
        """The plan of the JAX package's column-sorted ``GatherPlan``
        ``ref`` (host arrays): column = 128·wb[tile] + cols_local, padding
        entries (row == n_rows) dropped, entries re-sorted by row."""
        rows = np.asarray(ref.rows, np.int64)
        tile = np.arange(rows.shape[0]) // 1024
        cols = (np.asarray(ref.cols_local, np.int64)
                + 128 * np.asarray(ref.wb, np.int64)[tile])
        keep = rows < ref.n_rows
        rows, cols = rows[keep], cols[keep]
        vals = np.asarray(ref.vals)[keep]
        order = np.lexsort((cols, rows))
        return _make_plan(ref.n_rows, ref.n_cols, rows[order], cols[order],
                          vals[order])


def _make_plan(n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray,
               vals: np.ndarray) -> GatherPlan:
    """Host plan from entries sorted by row."""
    nnz = int(cols.shape[0])
    idt = index_dtype(max(nnz, n_rows + 1, n_cols))
    rowptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=rowptr[1:])
    def conv(a, dtype=idt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype))

    return GatherPlan(n_rows, n_cols, nnz, conv(rowptr), conv(cols),
                      conv(vals, None), conv(rows),
                      int(cols.max()) if nnz else -1)


def plan_gather_spmv(A) -> GatherPlan:
    """The host plan of a CSR ``SparseMatrix`` (its own row-sorted arrays,
    values in their dtype); move it with :meth:`GatherPlan.to`."""
    return _make_plan(A.height, A.width, A.row_ids(),
                      np.asarray(A.colind, np.int64), np.asarray(A.vals))


def build() -> str:
    """Compile the kernel (if its library is not built yet); returns the
    library's path."""
    return build_cuda_library("csr_spmv", [SOURCE])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name in _FN_NAMES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def gather_spmv_plain(plan: GatherPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``vals · x.index_select(colind)``, then
    ``index_add_`` by row (``CSRDevice.matvec``)."""
    prod = plan.vals * x.to(plan.vals.dtype).index_select(0, plan.colind)
    y = torch.zeros(plan.n_rows, dtype=prod.dtype, device=prod.device)
    return y.index_add_(0, plan.rows, prod)


def _check(plan: GatherPlan, x: torch.Tensor) -> None:
    idx = (plan.rowptr, plan.colind)
    if any(t.device != x.device for t in idx + (plan.vals,)):
        raise ValueError("gather_spmv: plan and x are on different devices")
    if (plan.vals.dtype, plan.rowptr.dtype) not in _FN_NAMES or \
            plan.colind.dtype != plan.rowptr.dtype:
        raise TypeError(f"gather_spmv: unsupported types "
                        f"vals={plan.vals.dtype}, index="
                        f"{[t.dtype for t in idx]}")
    if x.dim() != 1 or not x.is_contiguous() or not all(
            t.is_contiguous() for t in idx + (plan.vals,)):
        raise ValueError("gather_spmv: x and the plan's arrays must be "
                         "contiguous 1-D tensors")
    if plan.rowptr.numel() != plan.n_rows + 1 or \
            plan.colind.numel() != plan.nnz or plan.vals.numel() != plan.nnz:
        raise ValueError("gather_spmv: plan arrays do not match its shape")
    if x.numel() != plan.n_cols or plan.col_max >= plan.n_cols:
        raise IndexError(f"gather_spmv: x has {x.numel()} entries; the plan "
                         f"has {plan.n_cols} columns and reads column "
                         f"{plan.col_max}")


def gather_spmv(plan: GatherPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A·x, with x cast to the plan's dtype.

    CPU tensors: the plain version.  CUDA tensors: the K2 kernel, or an
    exception.  ``gather_spmv.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return gather_spmv_plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"gather_spmv: no kernel for device {x.device}")
    x = x.to(plan.vals.dtype)
    _check(plan, x)
    fn = getattr(_lib(), _FN_NAMES[(plan.vals.dtype, plan.rowptr.dtype)])
    y = torch.empty(plan.n_rows, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(plan.rowptr.data_ptr(), plan.colind.data_ptr(),
                plan.vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                plan.n_rows, plan.group, stream)
    if rc != 0:
        raise RuntimeError(f"gather_spmv: kernel launch failed with CUDA "
                           f"error {rc}")
    gather_spmv.launches += 1
    return y


gather_spmv.launches = 0
