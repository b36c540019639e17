"""K1: the multifrontal extend-add of one level, as a hand-written CUDA kernel
(``csrc/extend_add.cu``), and its plain PyTorch version.

Replaces the TPU kernel ``elemental_tpu/kernels/extend_add.py:ea_route_add``.
The kernel is built with ``nvcc`` for sm_90a at first use (``_build.py``) and
loaded with ctypes; it launches on the current CUDA stream and allocates
nothing.  It takes float32, float64, complex64 and complex128 pools with
int32 or int64 plans (one plan serves every dtype: its indices count
elements).

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
# run pairs a block of the kernel takes: csrc/extend_add.cu's RUN_BLOCK
RUN_BLOCK = 2048

_FN_NAMES = {
    (torch.float32, torch.int32): "el_extend_add_f32_i32",
    (torch.float32, torch.int64): "el_extend_add_f32_i64",
    (torch.float64, torch.int32): "el_extend_add_f64_i32",
    (torch.float64, torch.int64): "el_extend_add_f64_i64",
    (torch.complex64, torch.int32): "el_extend_add_c64_i32",
    (torch.complex64, torch.int64): "el_extend_add_c64_i64",
    (torch.complex128, torch.int32): "el_extend_add_c128_i32",
    (torch.complex128, torch.int64): "el_extend_add_c128_i64",
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def extend_add_plain(pool: torch.Tensor, level) -> None:
    """Plain PyTorch version: ``pool.index_add_(0, dst, pool[src])``."""
    pool.index_add_(0, level.dst, pool[level.src])


def _check(pool: torch.Tensor, level) -> None:
    """What depends on the pool; ``EALevel.to`` checked the plan itself."""
    if level.run_off.device != pool.device:
        raise ValueError("extend_add: plan and pool are on different devices")
    if pool.dim() != 1 or not pool.is_contiguous():
        raise ValueError("extend_add: pool must be a contiguous 1-D tensor")
    if (pool.dtype, level.run_off.dtype) not in _FN_NAMES:
        raise TypeError(f"extend_add: unsupported types pool={pool.dtype}, "
                        f"index={level.run_off.dtype}")
    n = pool.numel()
    if level.hi > n or level.src_max >= n:
        raise IndexError(f"extend_add: plan indexes past the pool "
                         f"(segment [{level.lo}, {level.hi}), largest "
                         f"source {level.src_max}, pool {n})")


def _plan_args(level) -> tuple:
    """The kernel's arguments that come from the plan, converted for ctypes
    once and kept on the level (its arrays do not move)."""
    args = level.__dict__.get("_k1_args")
    if args is None:
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        args = (ptr(level.run_dst), ptr(level.run_src), ptr(level.run_off),
                ptr(level.run_blk), ctypes.c_int64(level.n_runs),
                ctypes.c_int64(level.n_run_pairs), ptr(level.udst),
                ptr(level.offsets), ptr(level.src),
                ctypes.c_int64(level.n_multi))
        level.__dict__["_k1_args"] = args
    return args


def extend_add(pool: torch.Tensor, level) -> None:
    """In place: ``pool[dst] += pool[src]`` over one level of an
    :class:`~..sparse_direct.ea_plan.EAPlan` (its runs and its
    multi-source destinations), duplicate destinations summed.

    CPU pool: the plain version.  CUDA pool: the K1 kernel, or an
    exception.  ``extend_add.launches`` counts kernel launches."""
    if pool.device.type == "cpu":
        extend_add_plain(pool, level)
        return
    if pool.device.type != "cuda":
        raise ValueError(f"extend_add: no kernel for device {pool.device}")
    _check(pool, level)
    fn = getattr(_lib(), _FN_NAMES[(pool.dtype, level.run_off.dtype)])
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        rc = fn(pool.data_ptr(), *_plan_args(level), stream)
    if rc != 0:
        raise RuntimeError(f"extend_add: kernel launch failed with CUDA "
                           f"error {rc}")
    extend_add.launches += 1


extend_add.launches = 0
