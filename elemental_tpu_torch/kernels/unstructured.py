"""The unstructured SpMV tiers, as hand-written CUDA kernels, each beside its
plain PyTorch version: K2, the CSR SpMV (``csrc/csr_spmv.cu``), and the
bridged tier, the stream gather and the bucketed combine K7
(``csrc/bridged.cu``).

Replaces the TPU kernel ``elemental_tpu/kernels/unstructured.py:
gather_multiply`` together with the ``segment_sum`` that ``GatherPlan.matvec``
applies to its output: :func:`gather_spmv` computes y = A·x in one pass over
the row-sorted CSR.  The reference sorted entries by column into 1024-entry
tiles over 256-column windows (and split wide matrices into column chunks,
``ChunkedGatherPlan``) because Mosaic gathers only within one vreg and VMEM
is scoped; the H100 gathers x from device memory, so the port's plan is the
CSR itself.

The bridged tier (:class:`BridgedPlan`) replaces the reference's
``BridgedPlan.matvec`` (``unstructured.py:248-484``): the column-sorted
gather, the extend-add route of the product stream into a bucket-major
layout, and the one-hot MXU combine ``onehot_combine_bucketed`` (K7).  The
route exists on the TPU for want of a vector scatter; the port's plan stores
the entries already in bucket-major slots, so the tier is two kernels:
:func:`stream_gather` (P[j] = vals_b[j]·x[cols_b[j]], 0 in padding slots)
and :func:`onehot_combine_bucketed` (y[b·bucket + LR] = Σ P, in float32).

Each kernel is built with ``nvcc`` for sm_90a at first use (``_build.py``)
and loaded with ctypes; it launches on the current CUDA stream and allocates
nothing but its output.  Every wrapper takes the plain version only for
tensors on the CPU.  For CUDA tensors it launches the kernel or raises:
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
BRIDGED_SOURCE = os.path.join(CSRC_DIR, "bridged.cu")

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


# ---------------------------------------------------------------------------
# The bridged tier: stream gather, then the bucketed combine K7
# ---------------------------------------------------------------------------

BUCKET = 8192            # rows per combine bucket (the reference's 2^13)
# entries per (8, 128) tile: of a bucket's slots, and of the reference's
# column-sorted gather stream
TILE = 1024
PRECISIONS = ("split2", "highest", "default")
# the combine keeps a bucket of float32 sums in one block's shared memory,
# at most 227 KiB on the H100
MAX_BUCKET = 232448 // 4

_GATHER_FNS = {
    (torch.float32, torch.int32): "el_stream_gather_f32_i32",
    (torch.float32, torch.int64): "el_stream_gather_f32_i64",
    (torch.float64, torch.int32): "el_stream_gather_f64_i32",
    (torch.float64, torch.int64): "el_stream_gather_f64_i64",
}
_COMBINE_FNS = {torch.float32: "el_combine_bucketed_f32",
                torch.float64: "el_combine_bucketed_f64"}


@dataclasses.dataclass
class BridgedPlan:
    """y = A·x as a stream gather into bucket-major slots, then a per-bucket
    combine.  Bucket b owns slots [b·sub·1024, (b+1)·sub·1024); a slot holds
    one entry (column ``cols_b``, value ``vals_b``, local row ``lr`` =
    row − b·bucket) or is padding (column -1, value 0, local row 0).
    ``cols_b`` follows the index-width rule; ``lr`` (below ``bucket``) is
    int32.  ``precision`` is the reference's combine precision; the port
    sums in plain float32 for every value of it.  y is float32 whatever the
    values' dtype, as in the reference."""

    n_rows: int
    n_cols: int
    nnz: int
    nbuckets: int
    sub: int
    bucket: int
    precision: str
    cols_b: torch.Tensor     # (slots,)
    vals_b: torch.Tensor     # (slots,)
    lr: torch.Tensor         # (nbuckets, sub, 8, 128)
    col_max: int

    @property
    def slots(self) -> int:
        return self.nbuckets * self.sub * TILE

    def to(self, device=None, dtype=None) -> "BridgedPlan":
        """A copy on ``device`` with values in ``dtype`` (either kept when
        None)."""
        return dataclasses.replace(
            self, cols_b=self.cols_b.to(device),
            vals_b=self.vals_b.to(device, dtype), lr=self.lr.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        P = stream_gather(self, x).view(self.lr.shape)
        y = onehot_combine_bucketed(P, self.lr, bucket=self.bucket,
                                    precision=self.precision)
        return y[:self.n_rows]

    @classmethod
    def from_reference(cls, ref) -> "BridgedPlan":
        """The plan of the JAX package's ``BridgedPlan`` ``ref`` (host
        arrays), with the reference's slot layout, so that P and LR match
        its ``seg`` and ``lr`` entry for entry.  The route is rebuilt from
        the rounds: for round (dstblk, wpair, idx), row r and lane l with
        idx[r, l] ≥ 0, the stream entry src = wpair[r, 0]·128 + idx[r, l]
        lands in slot (dstblk[r // 8]·8 + r % 8)·128 + l; the stream's
        column is cols_local[t] + 128·wb[t // 1024]."""
        g = ref.gather
        cl = np.asarray(g.cols_local, np.int64)
        stream_cols = cl + 128 * np.asarray(g.wb, np.int64)[
            np.arange(cl.shape[0]) // TILE]
        stream_vals = np.asarray(g.vals)
        lr = np.asarray(ref.lr)
        cols_b = np.full(lr.size, -1, np.int64)
        vals_b = np.zeros(lr.size, stream_vals.dtype)
        for dstblk, wpair, idx in ref.rounds:
            dstblk, wpair = np.asarray(dstblk, np.int64), np.asarray(wpair)
            idx = np.asarray(idx, np.int64)
            r, lane = np.nonzero(idx >= 0)
            src = wpair[r, 0].astype(np.int64) * 128 + idx[r, lane]
            dst = (dstblk[r // 8] * 8 + r % 8) * 128 + lane
            cols_b[dst] = stream_cols[src]
            vals_b[dst] = stream_vals[src]
        return _make_bridged(ref.n_rows, ref.n_cols, ref.nnz, ref.bucket,
                             ref.precision, cols_b, vals_b, lr)


def _make_bridged(n_rows: int, n_cols: int, nnz: int, bucket: int,
                  precision: str, cols_b: np.ndarray, vals_b: np.ndarray,
                  lr: np.ndarray) -> BridgedPlan:
    """Host plan from bucket-major slot arrays; ``lr`` is (nbuckets, sub,
    8, 128)."""
    nbuckets, sub = int(lr.shape[0]), int(lr.shape[1])
    idt = index_dtype(max(cols_b.shape[0], n_cols))
    return BridgedPlan(
        int(n_rows), int(n_cols), int(nnz), nbuckets, sub, int(bucket),
        precision, torch.from_numpy(np.ascontiguousarray(cols_b, idt)),
        torch.from_numpy(np.ascontiguousarray(vals_b)),
        torch.from_numpy(np.array(lr, index_dtype(bucket))),
        int(cols_b.max()) if cols_b.size else -1)


def plan_bridged_spmv(A, bucket: int = BUCKET,
                      precision: str = "split2") -> BridgedPlan:
    """The host plan of a CSR ``SparseMatrix`` for the bridged tier (values
    in their dtype); move it with :meth:`BridgedPlan.to`.  Vectorised:
    CSR order is row order, so each bucket's entries are already
    contiguous and keep their row order in their slots."""
    if precision not in PRECISIONS:
        raise ValueError(f"plan_bridged_spmv: precision must be one of "
                         f"{PRECISIONS}, got {precision!r}")
    if not 1 <= bucket <= MAX_BUCKET:
        raise ValueError(f"plan_bridged_spmv: bucket {bucket} outside "
                         f"[1, {MAX_BUCKET}]")
    rows = A.row_ids()
    nbuckets = -(-A.height // bucket)
    counts = np.bincount(rows // bucket, minlength=nbuckets)
    sub = max(1, -(-int(counts.max(initial=0)) // TILE))
    cap = sub * TILE
    first = np.zeros(nbuckets + 1, np.int64)
    np.cumsum(counts, out=first[1:])
    bkt = rows // bucket
    slot = bkt * cap + (np.arange(rows.shape[0]) - first[bkt])
    cols_b = np.full(nbuckets * cap, -1, np.int64)
    cols_b[slot] = A.colind
    vals_b = np.zeros(nbuckets * cap, np.asarray(A.vals).dtype)
    vals_b[slot] = A.vals
    lr = np.zeros(nbuckets * cap, np.int64)
    lr[slot] = rows - bkt * bucket
    return _make_bridged(A.height, A.width, A.nnz, bucket, precision, cols_b,
                         vals_b, lr.reshape(nbuckets, sub, 8, 128))


def build_bridged() -> str:
    """Compile the bridged tier's kernels (if their library is not built
    yet); returns the library's path."""
    return build_cuda_library("bridged", [BRIDGED_SOURCE])


@functools.cache
def _bridged_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_bridged())
    for name in _GATHER_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _COMBINE_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def stream_gather_plain(plan: BridgedPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``vals_b · x.index_select(cols_b.clamp(0))``
    with the padding slots set to exactly 0."""
    prod = plan.vals_b * x.to(plan.vals_b.dtype).index_select(
        0, plan.cols_b.clamp(min=0))
    return prod.masked_fill_(plan.cols_b < 0, 0)


def _check_gather(plan: BridgedPlan, x: torch.Tensor) -> None:
    arrays = (plan.cols_b, plan.vals_b)
    if any(t.device != x.device for t in arrays):
        raise ValueError("stream_gather: plan and x are on different "
                         "devices")
    if (plan.vals_b.dtype, plan.cols_b.dtype) not in _GATHER_FNS:
        raise TypeError(f"stream_gather: unsupported types "
                        f"vals={plan.vals_b.dtype}, index="
                        f"{plan.cols_b.dtype}")
    if x.dim() != 1 or not x.is_contiguous() or not all(
            t.is_contiguous() for t in arrays):
        raise ValueError("stream_gather: x and the plan's arrays must be "
                         "contiguous 1-D tensors")
    if any(t.numel() != plan.slots for t in arrays):
        raise ValueError("stream_gather: plan arrays do not match its "
                         "slot count")
    if x.numel() != plan.n_cols or plan.col_max >= plan.n_cols:
        raise IndexError(f"stream_gather: x has {x.numel()} entries; the "
                         f"plan has {plan.n_cols} columns and reads column "
                         f"{plan.col_max}")


def stream_gather(plan: BridgedPlan, x: torch.Tensor) -> torch.Tensor:
    """P[j] = vals_b[j]·x[cols_b[j]] over every slot (0 in padding slots),
    with x cast to the plan's dtype.

    CPU tensors: the plain version.  CUDA tensors: the stream-gather
    kernel, or an exception.  ``stream_gather.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return stream_gather_plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"stream_gather: no kernel for device {x.device}")
    x = x.to(plan.vals_b.dtype)
    _check_gather(plan, x)
    fn = getattr(_bridged_lib(),
                 _GATHER_FNS[(plan.vals_b.dtype, plan.cols_b.dtype)])
    p = torch.empty(plan.slots, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(plan.cols_b.data_ptr(), plan.vals_b.data_ptr(),
                x.data_ptr(), p.data_ptr(), plan.slots, stream)
    if rc != 0:
        raise RuntimeError(f"stream_gather: kernel launch failed with CUDA "
                           f"error {rc}")
    stream_gather.launches += 1
    return p


stream_gather.launches = 0


def onehot_combine_bucketed_plain(P: torch.Tensor, LR: torch.Tensor,
                                  bucket: int = BUCKET) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of P (as float32) at
    b·bucket + LR into float32 zeros."""
    nb = P.shape[0]
    base = torch.arange(nb, device=P.device, dtype=torch.int64) * bucket
    idx = (LR.reshape(nb, -1).to(torch.int64) + base[:, None]).reshape(-1)
    y = torch.zeros(nb * bucket, dtype=torch.float32, device=P.device)
    return y.index_add_(0, idx, P.reshape(-1).to(torch.float32))


def _check_combine(P: torch.Tensor, LR: torch.Tensor, bucket: int,
                   precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"onehot_combine_bucketed: precision must be one "
                         f"of {PRECISIONS}, got {precision!r}")
    if LR.device != P.device:
        raise ValueError("onehot_combine_bucketed: P and LR are on "
                         "different devices")
    if P.dtype not in _COMBINE_FNS or LR.dtype != torch.int32:
        raise TypeError(f"onehot_combine_bucketed: unsupported types "
                        f"P={P.dtype}, LR={LR.dtype}")
    if P.dim() != 4 or tuple(P.shape[2:]) != (8, 128) or \
            LR.shape != P.shape:
        raise ValueError(f"onehot_combine_bucketed: P {tuple(P.shape)} and "
                         f"LR {tuple(LR.shape)} must both be (nbuckets, "
                         f"SUB, 8, 128)")
    if not (P.is_contiguous() and LR.is_contiguous()):
        raise ValueError("onehot_combine_bucketed: P and LR must be "
                         "contiguous")
    if not 1 <= bucket <= MAX_BUCKET:
        raise ValueError(f"onehot_combine_bucketed: bucket {bucket} "
                         f"outside [1, {MAX_BUCKET}]")


def onehot_combine_bucketed(P: torch.Tensor, LR: torch.Tensor,
                            bucket: int = BUCKET,
                            precision: str = "split2") -> torch.Tensor:
    """K7: y[b·bucket + LR[b, ...]] = Σ P[b, ...] over each bucket, y of
    length nbuckets·bucket in float32.  P is float32 or float64 and LR
    int32, both (nbuckets, SUB, 8, 128).  ``precision`` is accepted for the
    reference's contract; every value of it is a plain float32 sum.  The
    kernel skips a local row outside [0, bucket) (the plain version
    raises); its shared atomics sum in no fixed order, so y is not
    bit-identical from run to run.

    CPU tensors: the plain version.  CUDA tensors: the K7 kernel, or an
    exception.  ``onehot_combine_bucketed.launches`` counts kernel
    launches."""
    _check_combine(P, LR, bucket, precision)
    if P.device.type == "cpu":
        return onehot_combine_bucketed_plain(P, LR, bucket)
    if P.device.type != "cuda":
        raise ValueError(f"onehot_combine_bucketed: no kernel for device "
                         f"{P.device}")
    nb = P.shape[0]
    fn = getattr(_bridged_lib(), _COMBINE_FNS[P.dtype])
    y = torch.empty(nb * bucket, dtype=torch.float32, device=P.device)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        rc = fn(P.data_ptr(), LR.data_ptr(), y.data_ptr(), nb,
                P[0].numel() if nb else 0, bucket, stream)
    if rc != 0:
        raise RuntimeError(f"onehot_combine_bucketed: kernel launch failed "
                           f"with CUDA error {rc}")
    onehot_combine_bucketed.launches += 1
    return y


onehot_combine_bucketed.launches = 0
