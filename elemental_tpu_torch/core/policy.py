"""Dtype policy: the working precision and the residual bounds derived from
it (counterpart of ``elemental_tpu/core/policy.py``).

The JAX package reads its working dtype from the x64 flag; the port takes
it from the caller, explicitly, at every entry point.  Residual bounds follow
the reference's test bounds (``tests/lapack_like/Cholesky.cpp:41-44``: pass
iff ``||X - A\\Y|| / (eps * n * ||Y||) <= 100``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["effective_dtype", "index_dtype", "real_working_dtype",
           "residual_bound", "tf32", "working_dtype"]

_WORKING = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def effective_dtype(requested) -> torch.dtype:
    """The torch dtype a request (torch or NumPy dtype, or a name) computes
    in.  There is no silent narrowing: float64 stays float64."""
    if isinstance(requested, torch.dtype):
        return requested
    name = np.dtype(requested).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype for {requested!r}")
    return dt


def working_dtype(requested) -> torch.dtype:
    """The factorization's working dtype, given explicitly by the caller:
    float32, float64, complex64 or complex128."""
    dt = effective_dtype(requested)
    if dt not in _WORKING:
        raise TypeError(f"working dtype must be float32, float64, "
                        f"complex64 or complex128, got {dt}")
    return dt


def real_working_dtype(requested) -> torch.dtype:
    """:func:`working_dtype` for the real engines (the interior-point
    methods and the sparse least squares): float32 or float64."""
    dt = working_dtype(requested)
    if dt.is_complex:
        raise TypeError(f"this solver works in float32 or float64, got {dt}")
    return dt


def residual_bound(dtype, n: int, factor: float = 100.0) -> float:
    """Acceptable relative residual for a backward-stable factor+solve of
    an n×n system: ``factor * eps(dtype) * n``."""
    eps = float(torch.finfo(effective_dtype(dtype)).eps)
    return factor * eps * max(int(n), 1)


def index_dtype(size: int) -> np.dtype:
    """The port's one index-width rule: int32 index arrays below 2³¹
    elements, int64 above."""
    return np.dtype(np.int32 if size < 2**31 - 1 else np.int64)


@contextlib.contextmanager
def tf32(allow: bool):
    """Run the block with TF32 on or off for cuBLAS and cuDNN; restore the
    caller's setting after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
