"""K4 and K5: the matrix product and the masked rank-k update (the
Cholesky/LDL trailing-update shape, ``Trrk``), as hand-written CUDA kernels,
and their plain PyTorch versions.

Replaces the TPU kernels ``elemental_tpu/kernels/matmul.py:matmul`` and
``masked_rank_k_update``.  The reference's ``tile_m/n/k`` arguments and
``fit`` sized VMEM blocks; the port has no counterpart for them.  float32
and bfloat16 sum in float32 and float64 in float64 (the reference summed
float64 in float32, for want of a float64 MXU); float32 is true float32,
never TF32.

K4 has four kernels, and :func:`_matmul_path` picks one by a fixed rule of
dtype, shape and alignment (never on a failure: a refused launch raises):

* ``"wgmma"`` (bfloat16, ``csrc/matmul_sm90.cu``): tensor cores through
  wgmma, fed by TMA;
* ``"dmma"`` (float64, ``csrc/matmul_sm90.cu``): the float64 tensor cores
  through mma.sync, fed by cp.async;
* ``"ffma"`` (float32, ``csrc/matmul_sm90.cu``): an FFMA tile fed by
  double-buffered shared memory;
* ``"simt"`` (any of the three, ``csrc/matmul.cu``): the first port's
  shared-memory tile, for the shapes the others cannot take.

The first three load 16-byte vectors of rows (TMA boxes or cp.async), so
they need k > 0, k and n multiples of one 16-byte vector (8 bfloat16, 4
float32, 2 float64) and 16-byte aligned data; every other shape takes
``"simt"``.

K5 has three, and :func:`_rank_k_path` picks one by the same rule, with c
aligned too: ``"ffma"`` (float32) and ``"dmma"`` (float64) run K4's main
loops under a masked epilogue in ``csrc/matmul_sm90.cu``, with c's stream
overlapped with the product; ``"simt"`` is the first port's kernel in
``csrc/matmul.cu``.

The kernels are built with ``nvcc`` for sm_90a at first use
(``_build.py``) and loaded with ctypes; they launch on the current CUDA
stream and allocate nothing but their output.  Each wrapper takes the plain
version only for tensors on the CPU.  For CUDA tensors it launches a kernel
or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._build import CSRC_DIR, build_cuda_library

SOURCE = os.path.join(CSRC_DIR, "matmul.cu")
SOURCE_SM90 = os.path.join(CSRC_DIR, "matmul_sm90.cu")

_MATMUL_FNS = {torch.float32: "el_matmul_f32", torch.float64: "el_matmul_f64",
               torch.bfloat16: "el_matmul_bf16"}
_RANK_K_FNS = {
    (torch.float32, True): "el_rank_k_lower_f32",
    (torch.float64, True): "el_rank_k_lower_f64",
    (torch.float32, False): "el_rank_k_upper_f32",
    (torch.float64, False): "el_rank_k_upper_f64",
}
# the K4 paths of csrc/matmul_sm90.cu, by dtype, and the elements in one
# 16-byte vector of a row
_SM90_PATHS = {torch.bfloat16: ("wgmma", "el_matmul_wgmma_bf16", 8),
               torch.float32: ("ffma", "el_matmul_ffma_f32", 4),
               torch.float64: ("dmma", "el_matmul_dmma_f64", 2)}
PATHS = ("wgmma", "dmma", "ffma", "simt")
# K5's Hopper kernels in csrc/matmul_sm90.cu, by dtype and triangle; their
# paths are K4's for the dtype
_RANK_K_SM90_FNS = {
    (torch.float32, True): "el_rank_k_ffma_lower_f32",
    (torch.float32, False): "el_rank_k_ffma_upper_f32",
    (torch.float64, True): "el_rank_k_dmma_lower_f64",
    (torch.float64, False): "el_rank_k_dmma_upper_f64",
}
RANK_K_PATHS = ("dmma", "ffma", "simt")
_RANK_K_TYPES = (torch.float32, torch.float64)
# (a, b, c, out, m, n, k, alpha, stream): the C signature of the SIMT
# kernels and of K5's
_ABC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
    ctypes.c_double, ctypes.c_void_p]
# every kernel's output tile is 128 rows high and its grid holds at most
# 65535 row tiles
TILE = 128
MAX_ROWS = 65535 * TILE


def build() -> str:
    """Compile the SIMT kernels of K4 and K5 (if their library is not built
    yet); returns the library's path."""
    return build_cuda_library("matmul", [SOURCE])


def build_sm90() -> str:
    """Compile K4's wgmma, dmma and ffma kernels and K5's ffma and dmma
    kernels (if their library is not built yet); returns the library's
    path."""
    return build_cuda_library("matmul_sm90", [SOURCE_SM90])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name in (*_MATMUL_FNS.values(), *_RANK_K_FNS.values()):
        fn = getattr(lib, name)
        fn.argtypes = _ABC_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_sm90() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_sm90())
    for _, name, _ in _SM90_PATHS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _RANK_K_SM90_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = _ABC_ARGTYPES
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


def _launch(name: str, fn, a, b, *args) -> None:
    """Call the C entry ``fn`` with a, b, ``args`` and the current stream;
    raise if the launch was refused (CUDA error code, or -1/-2 when the
    driver's TMA encoder is missing or refuses a descriptor)."""
    if a.shape[0] > MAX_ROWS:
        raise ValueError(f"{name}: {a.shape[0]} rows exceed the kernel's "
                         f"grid ({MAX_ROWS})")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.matmul`` on the input dtype (on the
    card, with TF32 off where it is compared or timed)."""
    return torch.matmul(a, b)


def _matmul_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """The K4 kernel that multiplies a (m, k) by b (k, n): ``"wgmma"``
    (bfloat16), ``"dmma"`` (float64) or ``"ffma"`` (float32) when k > 0, k
    and n are multiples of the dtype's 16-byte vector (8, 2, 4 elements)
    and both data pointers are 16-byte aligned; ``"simt"`` otherwise, and
    for any other dtype.  A pure function of dtype, shape and alignment."""
    path = _SM90_PATHS.get(a.dtype)
    k, n = a.shape[1], b.shape[1]
    if path is None or b.dtype != a.dtype or k == 0:
        return "simt"
    vec = path[2]
    if k % vec or n % vec or a.data_ptr() % 16 or b.data_ptr() % 16:
        return "simt"
    return path[0]


def _run_matmul(a: torch.Tensor, b: torch.Tensor, path: str) -> torch.Tensor:
    """Launch K4's ``path`` kernel on contiguous CUDA a, b; no counting.
    Raises if ``path`` cannot take these operands."""
    if path not in ("simt", _matmul_path(a, b)):
        raise ValueError(f"matmul: path {path!r} cannot take {a.dtype} "
                         f"{tuple(a.shape)}·{tuple(b.shape)} (the rule "
                         f"gives {_matmul_path(a, b)!r})")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    if path == "simt":
        _launch("matmul", getattr(_lib(), _MATMUL_FNS[a.dtype]), a, b,
                out.data_ptr(), out.data_ptr(), m, n, k, 1.0)
    else:
        _launch("matmul", getattr(_lib_sm90(), _SM90_PATHS[a.dtype][1]), a,
                b, out.data_ptr(), m, n, k)
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4: C = A·B for any (m, k)·(k, n), in a's dtype (float32, bfloat16
    or float64; float32 sums for the first two, float64 for the last).

    CPU tensors: the plain version.  CUDA tensors: the K4 kernel that
    :func:`_matmul_path` names, or an exception.  ``matmul.launches``
    counts kernel launches, ``matmul.launches_by_path`` them by path."""
    _check_shapes("matmul", a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b)
    _check("matmul", _MATMUL_FNS, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {a.device}")
    path = _matmul_path(a, b)
    out = _run_matmul(a, b, path)
    matmul.launches += 1
    matmul.launches_by_path[path] += 1
    return out


matmul.launches = 0
matmul.launches_by_path = dict.fromkeys(PATHS, 0)


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


def _rank_k_path(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> str:
    """The K5 kernel for c (m, n) and a (m, k)·b (k, n): ``"ffma"``
    (float32) or ``"dmma"`` (float64) when k > 0, k and n are multiples of
    the dtype's 16-byte vector (4, 2 elements) and the three data pointers
    are 16-byte aligned; ``"simt"`` otherwise.  A pure function of dtype,
    shape and alignment; any other dtype, or mixed dtypes, raise
    ``TypeError``."""
    if c.dtype not in _RANK_K_TYPES or a.dtype != c.dtype \
            or b.dtype != c.dtype:
        raise TypeError(f"masked_rank_k_update: unsupported types "
                        f"{[t.dtype for t in (c, a, b)]}")
    path, _, vec = _SM90_PATHS[c.dtype]
    k, n = a.shape[1], b.shape[1]
    if k == 0 or k % vec or n % vec or any(t.data_ptr() % 16
                                           for t in (c, a, b)):
        return "simt"
    return path


def _run_rank_k(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, alpha,
                lower: bool, path: str) -> torch.Tensor:
    """Launch K5's ``path`` kernel on contiguous CUDA c, a, b; no counting.
    Raises if ``path`` cannot take these operands."""
    if path not in ("simt", _rank_k_path(c, a, b)):
        raise ValueError(f"masked_rank_k_update: path {path!r} cannot take "
                         f"{c.dtype} c {tuple(c.shape)} with k = "
                         f"{a.shape[1]} (the rule gives "
                         f"{_rank_k_path(c, a, b)!r})")
    m, k = a.shape
    out = torch.empty_like(c)
    lib, fns = ((_lib(), _RANK_K_FNS) if path == "simt"
                else (_lib_sm90(), _RANK_K_SM90_FNS))
    _launch("masked_rank_k_update", getattr(lib, fns[(c.dtype, bool(lower))]),
            a, b, c.data_ptr(), out.data_ptr(), m, b.shape[1], k,
            float(alpha))
    return out


def masked_rank_k_update(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         alpha=1.0, lower: bool = True) -> torch.Tensor:
    """K5: a new tensor holding one triangle of C + α·A·B (rows ≥ columns
    for ``lower``, rows ≤ columns otherwise) and C elsewhere, bit for bit.
    c (m, n), a (m, k), b (k, n), all float32 or all float64.  The update is
    rounded as the plain version rounds it: the product, then α times it,
    then the sum, each once.

    CPU tensors: the plain version.  CUDA tensors: the K5 kernel that
    :func:`_rank_k_path` names, or an exception.
    ``masked_rank_k_update.launches`` counts kernel launches,
    ``masked_rank_k_update.launches_by_path`` them by path."""
    _check_shapes("masked_rank_k_update", a, b)
    if c.dim() != 2 or tuple(c.shape) != (a.shape[0], b.shape[1]):
        raise ValueError(f"masked_rank_k_update: c {tuple(c.shape)} is not "
                         f"({a.shape[0]}, {b.shape[1]})")
    if all(t.device.type == "cpu" for t in (c, a, b)):
        return masked_rank_k_update_plain(c, a, b, alpha, lower)
    _check("masked_rank_k_update", _RANK_K_TYPES, c, a, b)
    if c.device.type != "cuda":
        raise ValueError(f"masked_rank_k_update: no kernel for device "
                         f"{c.device}")
    path = _rank_k_path(c, a, b)
    out = _run_rank_k(c, a, b, alpha, lower, path)
    masked_rank_k_update.launches += 1
    masked_rank_k_update.launches_by_path[path] += 1
    return out


masked_rank_k_update.launches = 0
masked_rank_k_update.launches_by_path = dict.fromkeys(RANK_K_PATHS, 0)
