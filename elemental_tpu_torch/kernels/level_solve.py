"""K10: the plain tree solve's level step, by substitution with each front's
L panel read in place from the pool, as a hand-written CUDA kernel
(``csrc/level_solve.cu``), and its plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves the batched triangular solve
of ``elemental_tpu/sparse_direct/numeric.py:_level_solve`` to XLA.  For each
front of one level (``ns`` pivots, ``sz`` real rows): forward, the front's
pivot rows of ``xe`` become ``w1 = L11⁻¹·x1`` and ``-L21·w1`` goes to the
front's update slots of a buffer, which K9 (``kernels/level_scatter.py``)
adds into their rows; backward, the pivot rows become ``w1 = L11⁻ᵀ·(x1 −
L21ᵀ·x2)`` (``L⁻ᴴ``, ``L21ᴴ`` for a Hermitian factor).  Only the L panels'
entries are read: no padded slot, no diagonal (D), no trailing block.  The
level's plan is a :class:`~..sparse_direct.solve_plan.SubstitutionLevel`.

The kernel is built with ``nvcc`` for sm_90a at first use (``_build.py``)
and loaded with ctypes; it launches on the current CUDA stream, allocates
nothing and never waits for the host, so a solve that runs it can be
captured in a CUDA graph.  It takes float32, float64, complex64 and
complex128 values, any number of columns k (up to 65,535), and int32 or
int64 plans.

:func:`level_solve` takes the plain version only for tensors on the CPU.
For a CUDA ``xe`` it launches the kernel or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np
import torch

from .._build import CSRC_DIR, build_cuda_library
from .level_scatter import on_device

SOURCE = os.path.join(CSRC_DIR, "level_solve.cu")

_FN_NAMES = {
    (torch.float32, torch.int32): "el_level_solve_f32_i32",
    (torch.float32, torch.int64): "el_level_solve_f32_i64",
    (torch.float64, torch.int32): "el_level_solve_f64_i32",
    (torch.float64, torch.int64): "el_level_solve_f64_i64",
    (torch.complex64, torch.int32): "el_level_solve_c64_i32",
    (torch.complex64, torch.int64): "el_level_solve_c64_i64",
    (torch.complex128, torch.int32): "el_level_solve_c128_i32",
    (torch.complex128, torch.int64): "el_level_solve_c128_i64",
}


def build() -> str:
    """Compile the kernel (if its library is not built yet); returns the
    library's path."""
    return build_cuda_library("level_solve", [SOURCE])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name in _FN_NAMES.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 3
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                                  ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_int64,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@dataclasses.dataclass
class _Gathers:
    """Where the plain version finds one level's L panels: flat indices
    into the level's fronts (``*_src``) and into the dense zero-filled
    (nf, m, m) L11 and (nf, S, m) L21 (``*_dst``), m the largest ``ns``;
    ``piv``: (nf, m) the pivot rows of ``xe``, n past a front's ``ns``;
    ``piv_rows``, ``piv_pos``: the real pivot rows and their flat positions
    in (nf, m)."""
    l11_src: torch.Tensor
    l11_dst: torch.Tensor
    l21_src: torch.Tensor
    l21_dst: torch.Tensor
    piv: torch.Tensor
    piv_rows: torch.Tensor
    piv_pos: torch.Tensor


def _entries(count: np.ndarray):
    """(front, local index) of ``count[f]`` entries a front."""
    f = np.repeat(np.arange(count.size), count)
    return f, np.arange(f.size) - np.repeat(np.cumsum(count) - count, count)


def _gathers(lev, sub, device) -> _Gathers:
    """The plain version's gathers of one level, built once and kept on the
    level's plan."""
    key = ("_plain_gathers", str(device))
    got = sub.__dict__.get(key)
    if got is not None:
        return got
    fr = lev.front_rows.cpu().numpy().astype(np.int64)
    ns = np.asarray(sub.ns.cpu() if torch.is_tensor(sub.ns) else sub.ns,
                    np.int64)
    sz = np.asarray(sub.sz.cpu() if torch.is_tensor(sub.sz) else sub.sz,
                    np.int64)
    nf, S = fr.shape
    m = sub.max_ns
    f, loc = _entries(ns * ns)
    i, j = loc // ns[f], loc % ns[f]
    low = j < i
    f, i, j = f[low], i[low], j[low]
    l11 = (f * S * S + i * S + j, f * m * m + i * m + j)
    f, loc = _entries((sz - ns) * ns)
    i, j = ns[f] + loc // ns[f], loc % ns[f]
    l21 = (f * S * S + i * S + j, f * S * m + i * m + j)
    pivot = np.arange(m)[None, :] < ns[:, None]
    piv = np.where(pivot, fr[:, :m], sub.update.n)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                     device=device)
    got = _Gathers(*map(as_t, l11 + l21), as_t(piv), as_t(piv[pivot]),
                   as_t(np.flatnonzero(pivot)))
    sub.__dict__[key] = got
    return got


def level_solve_plain(xe: torch.Tensor, pool: torch.Tensor, lev, sub,
                      forward: bool, conjugate: bool = False,
                      delta=None) -> None:
    """Plain PyTorch version of :func:`level_solve`: the level's L11 and
    L21 gathered from the pool into zero-filled dense batches, one batched
    triangular solve and one batched product.  It writes ``delta`` at
    every slot of the level (0 at the pivot and padded ones)."""
    g = _gathers(lev, sub, xe.device)
    nf, S = lev.front_rows.shape
    m, k = sub.max_ns, xe.shape[1]
    fronts = pool[lev.offset:lev.offset + nf * S * S]
    l11 = fronts.new_zeros(nf * m * m)
    l11[g.l11_dst] = fronts[g.l11_src]
    l11 = l11.view(nf, m, m)
    l21 = fronts.new_zeros(nf * S * m)
    l21[g.l21_dst] = fronts[g.l21_src]
    l21 = l21.view(nf, S, m)
    x1 = xe[g.piv]
    if forward:
        w1 = torch.linalg.solve_triangular(l11, x1, upper=False,
                                           unitriangular=True)
        delta[:nf * S] = -torch.matmul(l21, w1).reshape(nf * S, k)
    else:
        def adj(t):
            return t.mH if conjugate else t.mT
        y1 = x1 - torch.matmul(adj(l21), xe[lev.front_rows])
        w1 = torch.linalg.solve_triangular(adj(l11), y1, upper=True,
                                           unitriangular=True)
    xe[g.piv_rows] = w1.reshape(nf * m, k)[g.piv_pos]


def _check(xe, pool, lev, sub, forward, delta) -> int:
    """The launch's front count, after checking what the kernel needs."""
    nf, S = lev.front_rows.shape
    k = xe.shape[1] if xe.dim() == 2 else 0
    if xe.dim() != 2 or xe.shape[0] != sub.update.n + 1 or not 0 < k < 65536:
        raise ValueError(f"level_solve: xe must be ({sub.update.n + 1}, k), "
                         f"0 < k < 65536, got {tuple(xe.shape)}")
    if pool.dim() != 1 or pool.numel() < lev.offset + nf * S * S:
        raise ValueError("level_solve: the pool does not hold the level")
    ts = [("pool", pool)] + ([("delta", delta)] if forward else [])
    for name, t in ts:
        if t is None or t.device != xe.device or t.dtype != xe.dtype:
            raise ValueError(f"level_solve: {name} must have xe's device "
                             f"and dtype")
    if forward and (delta.dim() != 2 or delta.shape[0] < nf * S
                    or delta.shape[1] != k):
        raise ValueError(f"level_solve: delta must be (>= {nf * S}, {k}), "
                         f"got {tuple(delta.shape)}")
    if not (xe.is_contiguous() and pool.is_contiguous()
            and (not forward or delta.is_contiguous())):
        raise ValueError("level_solve: xe, pool and delta must be "
                         "contiguous")
    for t in (lev.front_rows, sub.ns, sub.sz):
        if t.device != xe.device or t.dtype != sub.ns.dtype:
            raise ValueError("level_solve: the plan must lie on xe's device "
                             "in one index type")
    if (xe.dtype, sub.ns.dtype) not in _FN_NAMES:
        raise TypeError(f"level_solve: unsupported types xe={xe.dtype}, "
                        f"index={sub.ns.dtype}")
    return nf


def level_solve(xe: torch.Tensor, pool: torch.Tensor, lev, sub,
                forward: bool, conjugate: bool = False,
                delta=None) -> None:
    """One level step of the plain tree solve, in place on the extended
    right-hand side ``xe`` ((n + 1, k); row n is read as padding and left
    as it is).  ``pool``: the factor's flat fronts; ``lev``: the level's
    :class:`~..sparse_direct.symbolic.LevelPlan`, ``sub``: its
    :class:`~..sparse_direct.solve_plan.SubstitutionLevel`; ``conjugate``:
    the factor is L·D·Lᴴ.  Forward writes ``-L21·w1`` into the (≥ nf·S,
    k) ``delta`` at the level's update slots, for K9 to add.

    CPU ``xe``: the plain version.  CUDA ``xe``: the K10 kernel (one launch,
    or two a panel on a level its plan splits: ``sub.launches``), or an
    exception.  ``level_solve.launches`` counts the launches issued from
    the host (a CUDA graph that holds K10 counts them when it is captured,
    not when it is replayed)."""
    if xe.device.type == "cpu":
        level_solve_plain(xe, pool, lev, sub, forward, conjugate, delta)
        return
    if xe.device.type != "cuda":
        raise ValueError(f"level_solve: no kernel for device {xe.device}")
    nf = _check(xe, pool, lev, sub, forward, delta)
    fn = getattr(_lib(), _FN_NAMES[(xe.dtype, sub.ns.dtype)])
    args = (pool.data_ptr(), lev.offset, lev.front_size, nf,
            lev.front_rows.data_ptr(), sub.ns.data_ptr(), sub.sz.data_ptr(),
            xe.data_ptr(), xe.shape[1],
            delta.data_ptr() if forward else None, int(forward),
            int(conjugate and xe.dtype.is_complex), sub.warps,
            int(sub.split), sub.update_warps, sub.max_ns)
    rc = on_device(xe.device, lambda stream: fn(*args, stream))
    if rc != 0:
        raise RuntimeError(f"level_solve: kernel launch failed with CUDA "
                           f"error {rc}")
    level_solve.launches += sub.launches


level_solve.launches = 0
