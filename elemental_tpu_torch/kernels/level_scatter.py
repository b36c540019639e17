"""K9: the tree solve's level scatter ``xe[front_rows] += w - xf`` over one
level's real front slots, as a hand-written CUDA kernel
(``csrc/level_scatter.cu``), and its plain PyTorch version.  Without
``xf`` it adds ``w`` itself: the plain solve's forward step adds K10's
``-L21·w1`` (``kernels/level_solve.py``) over a plan of the update slots.

Replaces no TPU kernel: the JAX package leaves the scatter of
``elemental_tpu/sparse_direct/numeric.py:_level_solve`` to XLA.  The kernel
follows a :class:`~..sparse_direct.solve_plan.ScatterLevel`: one thread a
destination row and column sums its segment's deltas in slot order, without
atomics, and never reads a padded slot.

The kernel is built with ``nvcc`` for sm_90a at first use (``_build.py``)
and loaded with ctypes; it launches on the current CUDA stream and
allocates nothing.  It takes float32, float64, complex64 and complex128
values, any number of columns k, and int32 or int64 plans.

:func:`level_scatter` takes the plain version only for tensors on the CPU.
For a CUDA ``xe`` it launches the kernel or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._build import CSRC_DIR, build_cuda_library

SOURCE = os.path.join(CSRC_DIR, "level_scatter.cu")

_FN_NAMES = {
    (torch.float32, torch.int32): "el_level_scatter_f32_i32",
    (torch.float32, torch.int64): "el_level_scatter_f32_i64",
    (torch.float64, torch.int32): "el_level_scatter_f64_i32",
    (torch.float64, torch.int64): "el_level_scatter_f64_i64",
    (torch.complex64, torch.int32): "el_level_scatter_c64_i32",
    (torch.complex64, torch.int64): "el_level_scatter_c64_i64",
    (torch.complex128, torch.int32): "el_level_scatter_c128_i32",
    (torch.complex128, torch.int64): "el_level_scatter_c128_i64",
}


def build() -> str:
    """Compile the kernel (if its library is not built yet); returns the
    library's path."""
    return build_cuda_library("level_scatter", [SOURCE])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name in _FN_NAMES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def level_scatter_plain(xe: torch.Tensor, w: torch.Tensor, xf, level) -> None:
    """Plain PyTorch version: ``xe.index_add_(0, dst, (w - xf)[slots])``
    (``w[slots]`` without ``xf``)."""
    delta = (w if xf is None else w - xf).reshape(-1, xe.shape[1])
    xe.index_add_(0, level.dst, delta[level.slots])


def on_device(device: torch.device, launch):
    """``launch(stream)`` with ``device`` current and its current stream's
    handle; the tree solve's kernels issue a few hundred launches a solve,
    so the handle is read without building a ``torch.cuda.Stream`` (7 µs a
    call on an H100's host, against 0.2 µs), and the device is switched
    only where it is not the current one already."""
    if device.index is None or device.index == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()))
    with torch.cuda.device(device):
        return launch(torch._C._cuda_getCurrentRawStream(device.index))


def _check(xe: torch.Tensor, w: torch.Tensor, xf, level) -> None:
    if level.rows.device != xe.device:
        raise ValueError("level_scatter: plan and xe are on different "
                         "devices")
    if xe.dim() != 2 or xe.shape[0] != level.n + 1:
        raise ValueError(f"level_scatter: xe must be ({level.n + 1}, k), "
                         f"got {tuple(xe.shape)}")
    k = xe.shape[1]
    for name, t in (("w", w), ("xf", w if xf is None else xf)):
        if t.device != xe.device or t.dtype != xe.dtype:
            raise ValueError(f"level_scatter: {name} must have xe's device "
                             f"and dtype")
        if t.numel() < level.n_level_slots * k or t.shape[-1] != k:
            raise ValueError(f"level_scatter: {name} must hold the level's "
                             f"{level.n_level_slots} slots × {k}, got "
                             f"{tuple(t.shape)}")
    if not (xe.is_contiguous() and w.is_contiguous()
            and (xf is None or xf.is_contiguous())):
        raise ValueError("level_scatter: xe, w and xf must be contiguous")
    if (xe.dtype, level.rows.dtype) not in _FN_NAMES:
        raise TypeError(f"level_scatter: unsupported types xe={xe.dtype}, "
                        f"index={level.rows.dtype}")


def _plan_args(level) -> tuple:
    """The kernel's arguments that come from the plan, converted for ctypes
    once and kept on the level (its arrays do not move)."""
    args = level.__dict__.get("_k9_args")
    if args is None:
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        args = (ptr(level.rows), ptr(level.offsets), ptr(level.slots),
                ctypes.c_int64(level.n_rows))
        level.__dict__["_k9_args"] = args
    return args


def level_scatter(xe: torch.Tensor, w: torch.Tensor, xf, level) -> None:
    """In place: ``xe[r] += Σ (w - xf)[s]`` over the real slots s of row r
    of one :class:`~..sparse_direct.solve_plan.ScatterLevel`, in ascending
    slot order; ``xe`` is (n + 1, k), ``w`` and ``xf`` the level's (nf, S,
    k) values (or at least as many, the level's first); ``xf`` None adds
    ``w[s]``.  Row n is left as it is.

    CPU ``xe``: the plain version.  CUDA ``xe``: the K9 kernel, or an
    exception.  ``level_scatter.launches`` counts the launches issued from
    the host: a CUDA graph that holds K9 (the refined KKT solve's,
    ``KKTFactor.solve_refined``) counts its launches when it is captured
    (and in the eager solve that warms a card's capture stream), not when
    it is replayed."""
    if xe.device.type == "cpu":
        level_scatter_plain(xe, w, xf, level)
        return
    if xe.device.type != "cuda":
        raise ValueError(f"level_scatter: no kernel for device {xe.device}")
    _check(xe, w, xf, level)
    fn = getattr(_lib(), _FN_NAMES[(xe.dtype, level.rows.dtype)])
    args = (xe.data_ptr(), w.data_ptr(),
            None if xf is None else xf.data_ptr(), *_plan_args(level),
            xe.shape[1])
    rc = on_device(xe.device, lambda stream: fn(*args, stream))
    if rc != 0:
        raise RuntimeError(f"level_scatter: kernel launch failed with CUDA "
                           f"error {rc}")
    level_scatter.launches += 1


level_scatter.launches = 0
