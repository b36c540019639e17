"""K3: the stencil (DIA) SpMV, as a hand-written CUDA kernel
(``csrc/stencil_spmv.cu``), and its plain PyTorch version.

Replaces the TPU kernel ``elemental_tpu/kernels/spmv.py:stencil_spmv``.
The reference viewed x as a halo panel so that each diagonal became one
static (row, lane) shift of a VMEM-resident panel; the port's plan holds
only what the product needs, the diagonal offsets and the weight planes:

    y[i] = Σ_s weights[s, i] · x[i + offsets[s]],  x[j] = 0 outside [0, width)

The kernel is built with ``nvcc`` for sm_90a at first use (``_build.py``)
and loaded with ctypes; it launches on the current CUDA stream and allocates
nothing but its output.  :func:`stencil_spmv` takes the plain version only
for tensors on the CPU.  For CUDA tensors it launches the kernel or raises:
nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .._build import CSRC_DIR, build_cuda_library
from ..core.policy import effective_dtype, index_dtype

SOURCE = os.path.join(CSRC_DIR, "stencil_spmv.cu")

_FN_NAMES = {
    (torch.float32, torch.int32): "el_stencil_spmv_f32_i32",
    (torch.float32, torch.int64): "el_stencil_spmv_f32_i64",
    (torch.float64, torch.int32): "el_stencil_spmv_f64_i32",
    (torch.float64, torch.int64): "el_stencil_spmv_f64_i64",
}


@dataclasses.dataclass
class StencilPlan:
    """y = Σ_s weights[s] ∘ shift(x, offsets[s]) for an n-row, ``width``-
    column banded matrix.  ``offsets`` is the host tuple (plan order) and
    ``offsets_t`` the same values as an int64 tensor beside ``weights``."""

    n: int
    width: int
    offsets: Tuple[int, ...]
    weights: torch.Tensor       # (S, n)
    offsets_t: torch.Tensor     # (S,) int64
    nnz: int

    def to(self, device=None, dtype=None) -> "StencilPlan":
        """A copy on ``device`` with weights in ``dtype`` (either kept when
        None)."""
        return dataclasses.replace(
            self, weights=self.weights.to(device, dtype),
            offsets_t=self.offsets_t.to(device))

    @classmethod
    def from_reference(cls, ref, width: Optional[int] = None
                       ) -> "StencilPlan":
        """The plan of the JAX package's halo-panel ``StencilPlan`` ``ref``
        (host arrays): offset = di·C + dj, weights = the first n entries of
        each flattened (R, C) weight plane."""
        offsets = tuple(int(di) * int(ref.cols) + int(dj)
                        for di, dj in ref.shifts)
        w = np.asarray(ref.weights).reshape(len(offsets), -1)[:, :ref.n]
        return _make_plan(offsets, w, ref.n, width, int(ref.nnz))


def _make_plan(offsets, weights: np.ndarray, n: int, width: Optional[int],
               nnz: int) -> StencilPlan:
    return StencilPlan(n, n if width is None else int(width), tuple(offsets),
                       torch.from_numpy(np.ascontiguousarray(weights)),
                       torch.tensor(offsets, dtype=torch.int64), nnz)


def plan_stencil_spmv(offsets, diags, n: int, cols: int = 1024,
                      max_halo: int = 256, width: Optional[int] = None
                      ) -> Optional[StencilPlan]:
    """Plan from DIA (``offsets``, ``diags[d, i] = A[i, i + off_d]``), host
    tensors in the diagonals' dtype; move it with :meth:`StencilPlan.to`.

    Returns None where the reference does: when some diagonal's lane shift
    in a ``cols``-wide panel exceeds ``max_halo``.  The port's kernel has no
    panel, but keeping the rule keeps ``plan_spmv``'s choice of tier the
    reference's.  ``width`` is the column count (default ``n``)."""
    offsets = [int(o) for o in offsets]
    halo = max((abs(((o % cols) + cols // 2) % cols - cols // 2)
                for o in offsets), default=0)
    if halo > max_halo:
        return None
    w = np.asarray(diags)[:, :n]
    return _make_plan(offsets, w, n, width, int(np.count_nonzero(w)))


def stencil_spmv_from_csr(A, cols: int = 1024) -> Optional[StencilPlan]:
    """CSR → host stencil plan; None if A is not stencil-shaped."""
    from ..sparse.dia import to_dia
    dia = to_dia(A)
    if dia is None:
        return None
    return plan_stencil_spmv(dia.offsets, dia.diags, A.height, cols,
                             width=A.width)


def build() -> str:
    """Compile the kernel (if its library is not built yet); returns the
    library's path."""
    return build_cuda_library("stencil_spmv", [SOURCE])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name in _FN_NAMES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def stencil_spmv_plain(plan: StencilPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: :meth:`~..sparse.dia.DIAMatrix.matvec` (pad,
    then one ``narrow`` per diagonal)."""
    from ..sparse.dia import DIAMatrix
    return DIAMatrix(plan.n, plan.width, plan.offsets, plan.weights,
                     plan.nnz).matvec(x)


def _check(plan: StencilPlan, x: torch.Tensor) -> None:
    w, off = plan.weights, plan.offsets_t
    if w.device != x.device or off.device != x.device:
        raise ValueError("stencil_spmv: plan and x are on different devices")
    if x.dtype != w.dtype or (w.dtype, torch.int32) not in _FN_NAMES \
            or off.dtype != torch.int64:
        raise TypeError(f"stencil_spmv: unsupported types x={x.dtype}, "
                        f"weights={w.dtype}, offsets={off.dtype}")
    if x.dim() != 1 or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("stencil_spmv: x must be a contiguous 1-D tensor "
                         "and the weights contiguous")
    S = len(plan.offsets)
    if tuple(w.shape) != (S, plan.n) or tuple(off.shape) != (S,):
        raise ValueError(f"stencil_spmv: weights {tuple(w.shape)} and "
                         f"offsets {tuple(off.shape)} do not match "
                         f"({S}, {plan.n})")
    if x.numel() != plan.width:
        raise IndexError(f"stencil_spmv: x has {x.numel()} entries, the "
                         f"plan reads {plan.width}")


def stencil_spmv(plan: StencilPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for a stencil plan.

    CPU tensors: the plain version.  CUDA tensors: the K3 kernel, or an
    exception.  ``stencil_spmv.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return stencil_spmv_plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_spmv: no kernel for device {x.device}")
    _check(plan, x)
    S = len(plan.offsets)
    idt = effective_dtype(index_dtype(S * plan.n))
    fn = getattr(_lib(), _FN_NAMES[(x.dtype, idt)])
    y = torch.empty(plan.n, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(plan.weights.data_ptr(), plan.offsets_t.data_ptr(),
                x.data_ptr(), y.data_ptr(), plan.n, plan.width, S, stream)
    if rc != 0:
        raise RuntimeError(f"stencil_spmv: kernel launch failed with CUDA "
                           f"error {rc}")
    stencil_spmv.launches += 1
    return y


stencil_spmv.launches = 0
