"""K6: the elementwise and transpose kernels (the reference's Hydrogen
``Axpy.cu``, ``Scale.cu``, ``Hadamard.cu``, ``Copy.cu``, ``Fill.cu`` and
``Transpose.cu``), as hand-written CUDA kernels (``csrc/elementwise.cu``),
each beside its plain PyTorch version.

Replaces the TPU kernels of ``elemental_tpu/kernels/elementwise.py``:
``axpy``, ``scale``, ``hadamard`` and ``copy`` (through ``_ew_call``),
``fill`` and ``transpose``.  The reference's ``_tile_grid`` cut arrays into
VMEM blocks and has no counterpart.  Every op takes 2-D tensors of any
shape in float32, float64 or bfloat16; bfloat16 computes in float32 and
rounds once.  ``axpy`` rounds once (a fused multiply-add), so a plain
version that rounds α·x first may differ from it by that one rounding;
``copy``, ``fill`` and ``transpose`` move bits and match their plain
versions exactly.

The kernels are built with ``nvcc`` for sm_90a at first use
(``_build.py``) and loaded with ctypes; they launch on the current CUDA
stream and allocate nothing but their outputs.  Each wrapper takes the plain
version only for tensors on the CPU (for ``fill``, which has no input, when
``device`` is the CPU).  For CUDA tensors it launches its kernel or raises:
nothing falls back.  Each wrapper's ``.launches`` counts its kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._build import CSRC_DIR, build_cuda_library

SOURCE = os.path.join(CSRC_DIR, "elementwise.cu")

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16"}
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}
_MATH_OPS = ("axpy", "scale", "hadamard")
_BITS_OPS = ("copy", "fill")


def build() -> str:
    """Compile the kernels (if their library is not built yet); returns the
    library's path."""
    return build_cuda_library("elementwise", [SOURCE])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    names = [f"el_{op}_{s}" for op in _MATH_OPS for s in _SUFFIX.values()]
    names += [f"el_{op}_{size}" for op in _BITS_OPS for size in _BITS]
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_double, ctypes.c_uint64, ctypes.c_int64,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for size in _BITS:
        fn = getattr(lib, f"el_transpose_{size}")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check(name: str, *ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: operands are on different devices")
    if ts[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {ts[0].device}")
    if ts[0].dtype not in DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"{name}: unsupported types "
                        f"{[t.dtype for t in ts]}")
    if any(t.dim() != 2 or not t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous 2-D tensors")
    if any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]} "
                         f"differ")


def _stream_op(name: str, fn_name: str, out: torch.Tensor, *ins: torch.Tensor,
               alpha: float = 0.0, bits: int = 0) -> torch.Tensor:
    """Launch one of the five streaming kernels; x and y are the inputs
    the op has (none for fill)."""
    x, y = (tuple(ins) + (None, None))[:2]
    ptrs = [t.data_ptr() for t in (*ins, out)]
    vec = int(all(p % 16 == 0 for p in ptrs))
    fn = getattr(_lib(), fn_name)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(None if x is None else x.data_ptr(),
                None if y is None else y.data_ptr(), out.data_ptr(),
                out.numel(), float(alpha), bits, vec, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    return out


def axpy_plain(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.add(y, x, alpha=α)``."""
    return torch.add(y, x, alpha=alpha)


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + α·x (reference ``Axpy.cu``), rounded once: fma(α, x, y)."""
    if _on_cpu(x, y):
        return axpy_plain(alpha, x, y)
    _check("axpy", x, y)
    out = _stream_op("axpy", f"el_axpy_{_SUFFIX[y.dtype]}",
                     torch.empty_like(y), x, y, alpha=alpha)
    axpy.launches += 1
    return out


def scale_plain(alpha, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``α * x``."""
    return alpha * x


def scale(alpha, x: torch.Tensor) -> torch.Tensor:
    """α·x (reference ``Scale.cu``)."""
    if _on_cpu(x):
        return scale_plain(alpha, x)
    _check("scale", x)
    out = _stream_op("scale", f"el_scale_{_SUFFIX[x.dtype]}",
                     torch.empty_like(x), x, alpha=alpha)
    scale.launches += 1
    return out


def hadamard_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x * y``."""
    return x * y


def hadamard(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x ∘ y (reference ``Hadamard.cu``)."""
    if _on_cpu(x, y):
        return hadamard_plain(x, y)
    _check("hadamard", x, y)
    out = _stream_op("hadamard", f"el_hadamard_{_SUFFIX[x.dtype]}",
                     torch.empty_like(x), x, y)
    hadamard.launches += 1
    return out


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x.clone()``."""
    return x.clone()


def copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of x, bit for bit (reference ``Copy.cu``)."""
    if _on_cpu(x):
        return copy_plain(x)
    _check("copy", x)
    out = _stream_op("copy", f"el_copy_{x.element_size()}",
                     torch.empty_like(x), x)
    copy.launches += 1
    return out


def fill_plain(shape, value, dtype=torch.float32, *, device) -> torch.Tensor:
    """Plain PyTorch version: ``torch.full``."""
    return torch.full(tuple(shape), value, dtype=dtype, device=device)


def fill(shape, value, dtype=torch.float32, *, device) -> torch.Tensor:
    """A (m, n) tensor of ``value`` in ``dtype`` on ``device`` (reference
    ``Fill.cu``).  ``value`` is rounded to ``dtype`` on the host, as
    ``torch.full`` rounds it, and the kernel writes its bits."""
    device = torch.device(device)
    if device.type == "cpu":
        return fill_plain(shape, value, dtype, device=device)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"fill: shape {shape} is not 2-D")
    out = torch.empty(shape, dtype=dtype, device=device)
    _check("fill", out)
    size = out.element_size()
    bits = int(torch.full((), value, dtype=dtype).view(_BITS[size]))
    _stream_op("fill", f"el_fill_{size}", out,
               bits=bits & ((1 << (8 * size)) - 1))
    fill.launches += 1
    return out


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x.t().contiguous()``."""
    return x.t().contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """The (n, m) transpose of an (m, n) x, out of place, bit for bit
    (reference ``Transpose.cu``)."""
    if _on_cpu(x):
        return transpose_plain(x)
    _check("transpose", x)
    m, n = x.shape
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    fn = getattr(_lib(), f"el_transpose_{x.element_size()}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), m, n, stream)
    if rc != 0:
        raise RuntimeError(f"transpose: kernel launch failed with CUDA error "
                           f"{rc}")
    transpose.launches += 1
    return out


for _op in (axpy, scale, hadamard, copy, fill, transpose):
    _op.launches = 0
del _op
