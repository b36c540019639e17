"""K1: the multifrontal extend-add of one level, as a hand-written CUDA kernel
(``csrc/extend_add.cu``), and its plain PyTorch version.

Replaces the TPU kernel ``elemental_tpu/kernels/extend_add.py:ea_route_add``.
The kernel is built with ``nvcc`` for sm_90a at first use (``_build.py``) and
loaded with ctypes; it launches on the current CUDA stream and allocates
nothing.

:func:`extend_add` takes the plain version only for a pool on the CPU.  For
a CUDA pool it launches the kernel or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._build import CSRC_DIR, build_cuda_library

SOURCE = os.path.join(CSRC_DIR, "extend_add.cu")

_FN_NAMES = {
    (torch.float32, torch.int32): "el_extend_add_f32_i32",
    (torch.float32, torch.int64): "el_extend_add_f32_i64",
    (torch.float64, torch.int32): "el_extend_add_f64_i32",
    (torch.float64, torch.int64): "el_extend_add_f64_i64",
}


def build() -> str:
    """Compile the kernel (if its library is not built yet); returns the
    library's path."""
    return build_cuda_library("extend_add", [SOURCE])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name in _FN_NAMES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def extend_add_plain(pool: torch.Tensor, level) -> None:
    """Plain PyTorch version: ``pool.index_add_(0, dst, pool[src])``."""
    pool.index_add_(0, level.dst, pool[level.src])


def _check(pool: torch.Tensor, level) -> None:
    idx = (level.udst, level.offsets, level.src)
    if any(t.device != pool.device for t in idx):
        raise ValueError("extend_add: plan and pool are on different devices")
    if pool.dim() != 1 or not pool.is_contiguous():
        raise ValueError("extend_add: pool must be a contiguous 1-D tensor")
    if not all(t.is_contiguous() and t.dim() == 1 for t in idx):
        raise ValueError("extend_add: plan index arrays must be contiguous")
    if (pool.dtype, level.udst.dtype) not in _FN_NAMES or any(
            t.dtype != level.udst.dtype for t in idx):
        raise TypeError(f"extend_add: unsupported types pool={pool.dtype}, "
                        f"index={[t.dtype for t in idx]}")
    n = pool.numel()
    if level.hi > n or level.src_max >= n or level.lo < 0:
        raise IndexError(f"extend_add: plan indexes past the pool "
                         f"(segment [{level.lo}, {level.hi}), largest "
                         f"source {level.src_max}, pool {n})")
    if level.offsets.numel() != level.udst.numel() + 1:
        raise ValueError("extend_add: offsets must have one more entry "
                         "than udst")


def extend_add(pool: torch.Tensor, level) -> None:
    """In place: ``pool[udst[i]] += Σ pool[src[offsets[i]:offsets[i+1]]]``
    for one level of an :class:`~..sparse_direct.ea_plan.EAPlan`.

    CPU pool: the plain version.  CUDA pool: the K1 kernel, or an
    exception.  ``extend_add.launches`` counts kernel launches."""
    if pool.device.type == "cpu":
        extend_add_plain(pool, level)
        return
    if pool.device.type != "cuda":
        raise ValueError(f"extend_add: no kernel for device {pool.device}")
    _check(pool, level)
    fn = getattr(_lib(), _FN_NAMES[(pool.dtype, level.udst.dtype)])
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        rc = fn(pool.data_ptr(), level.udst.data_ptr(),
                level.offsets.data_ptr(), level.src.data_ptr(),
                level.n_udst, stream)
    if rc != 0:
        raise RuntimeError(f"extend_add: kernel launch failed with CUDA "
                           f"error {rc}")
    extend_add.launches += 1


extend_add.launches = 0
