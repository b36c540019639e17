"""K4 and K5: the tiled matrix product and the masked rank-k update (the
Cholesky/LDL trailing-update shape, ``Trrk``), as one hand-written CUDA
kernel template (``csrc/matmul.cu``), and their plain PyTorch versions.

Replaces the TPU kernels ``elemental_tpu/kernels/matmul.py:matmul`` and
``masked_rank_k_update``.  The reference's ``tile_m/n/k`` arguments and
``fit`` sized VMEM blocks; the port has no counterpart for them.  float32
and bfloat16 sum in float32 and float64 in float64 (the reference summed
float64 in float32, for want of a float64 MXU); float32 is true float32,
never TF32.

The kernel is built with ``nvcc`` for sm_90a at first use (``_build.py``)
and loaded with ctypes; it launches on the current CUDA stream and allocates
nothing but its output.  Each wrapper takes the plain version only for
tensors on the CPU.  For CUDA tensors it launches the kernel or raises:
nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._build import CSRC_DIR, build_cuda_library

SOURCE = os.path.join(CSRC_DIR, "matmul.cu")

_MATMUL_FNS = {torch.float32: "el_matmul_f32", torch.float64: "el_matmul_f64",
               torch.bfloat16: "el_matmul_bf16"}
_RANK_K_FNS = {
    (torch.float32, True): "el_rank_k_lower_f32",
    (torch.float64, True): "el_rank_k_lower_f64",
    (torch.float32, False): "el_rank_k_upper_f32",
    (torch.float64, False): "el_rank_k_upper_f64",
}
# the kernel's output tile is 128 x 128 and its grid holds at most 65535
# row tiles
TILE = 128
MAX_ROWS = 65535 * TILE


def build() -> str:
    """Compile the kernels (if their library is not built yet); returns the
    library's path."""
    return build_cuda_library("matmul", [SOURCE])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name in (*_MATMUL_FNS.values(), *_RANK_K_FNS.values()):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, dtypes, *ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: operands are on different devices")
    if ts[0].dtype not in dtypes or any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"{name}: unsupported types "
                        f"{[t.dtype for t in ts]}")
    if any(t.dim() != 2 or not t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous 2-D tensors")


def _check_shapes(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")


def _launch(name: str, fn_name: str, a, b, c, out, alpha: float) -> None:
    m, k = a.shape
    n = b.shape[1]
    if m > MAX_ROWS:
        raise ValueError(f"{name}: {m} rows exceed the kernel's grid "
                         f"({MAX_ROWS})")
    fn = getattr(_lib(), fn_name)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
                m, n, k, float(alpha), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.matmul`` on the input dtype (on the
    card, with TF32 off where it is compared or timed)."""
    return torch.matmul(a, b)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4: C = A·B for any (m, k)·(k, n), in a's dtype (float32, bfloat16
    or float64; float32 sums for the first two, float64 for the last).

    CPU tensors: the plain version.  CUDA tensors: the K4 kernel, or an
    exception.  ``matmul.launches`` counts kernel launches."""
    _check_shapes("matmul", a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b)
    _check("matmul", _MATMUL_FNS, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {a.device}")
    out = torch.empty(a.shape[0], b.shape[1], dtype=a.dtype, device=a.device)
    _launch("matmul", _MATMUL_FNS[a.dtype], a, b, out, out, 1.0)
    matmul.launches += 1
    return out


matmul.launches = 0


def _mask(c: torch.Tensor, lower: bool) -> torch.Tensor:
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    cols = torch.arange(c.shape[1], device=c.device)[None, :]
    return rows >= cols if lower else rows <= cols


def masked_rank_k_update_plain(c: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor, alpha=1.0,
                               lower: bool = True) -> torch.Tensor:
    """Plain PyTorch version: ``where(mask, c + α·(a@b).to(c.dtype), c)``
    (on the card, with TF32 off where it is compared or timed)."""
    return torch.where(_mask(c, lower),
                       c + alpha * torch.matmul(a, b).to(c.dtype), c)


def masked_rank_k_update(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         alpha=1.0, lower: bool = True) -> torch.Tensor:
    """K5: a new tensor holding one triangle of C + α·A·B (rows ≥ columns
    for ``lower``, rows ≤ columns otherwise) and C elsewhere, bit for bit.
    c (m, n), a (m, k), b (k, n), all float32 or all float64.  The update is
    rounded as the plain version rounds it: the product, then α times it,
    then the sum, each once.

    CPU tensors: the plain version.  CUDA tensors: the K5 kernel, or an
    exception.  ``masked_rank_k_update.launches`` counts kernel launches."""
    _check_shapes("masked_rank_k_update", a, b)
    if c.dim() != 2 or tuple(c.shape) != (a.shape[0], b.shape[1]):
        raise ValueError(f"masked_rank_k_update: c {tuple(c.shape)} is not "
                         f"({a.shape[0]}, {b.shape[1]})")
    if all(t.device.type == "cpu" for t in (c, a, b)):
        return masked_rank_k_update_plain(c, a, b, alpha, lower)
    _check("masked_rank_k_update", (torch.float32, torch.float64), c, a, b)
    if c.device.type != "cuda":
        raise ValueError(f"masked_rank_k_update: no kernel for device "
                         f"{c.device}")
    out = torch.empty_like(c)
    _launch("masked_rank_k_update", _RANK_K_FNS[(c.dtype, bool(lower))],
            a, b, c, out, alpha)
    masked_rank_k_update.launches += 1
    return out


masked_rank_k_update.launches = 0
