"""K8: one panel of the blocked LDLᵀ (LDLᴴ) front factor, for every front of a
level, as a hand-written CUDA kernel (``csrc/front_panel.cu``), and its plain
PyTorch version.

Replaces no TPU kernel: the JAX package leaves this column loop of
``elemental_tpu/sparse_direct/numeric.py:_masked_partial_ldl_blocked`` to
XLA.  Run from Python, the loop issued about 15 small operations a column
over the level's whole batch; the kernel eliminates a panel's columns
``[j0, j0 + w)`` of every front in one launch, in place in the pool.

The kernel is built with ``nvcc`` for sm_90a at first use (``_build.py``)
and loaded with ctypes; it launches on the fronts' device and its current
stream and allocates nothing.  It takes float32, float64, complex64 and
complex128 fronts and panels of at most :data:`NB` columns; a wider panel
is eliminated as sub-panels of :data:`NB` (:func:`_wide_panel`).

:func:`ldl_panel` takes the plain version only for fronts on the CPU.  For
CUDA fronts it launches the kernel or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._build import CSRC_DIR, build_cuda_library

SOURCE = os.path.join(CSRC_DIR, "front_panel.cu")
# the widest panel the kernel takes: csrc/front_panel.cu's NB
NB = 32

_FN_NAMES = {torch.float32: "el_ldl_panel_f32",
             torch.float64: "el_ldl_panel_f64",
             torch.complex64: "el_ldl_panel_c64",
             torch.complex128: "el_ldl_panel_c128"}


def build() -> str:
    """Compile the kernel (if its library is not built yet); returns the
    library's path."""
    return build_cuda_library("front_panel", [SOURCE])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name in _FN_NAMES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _clamp_pivot(dk, s):
    """Dynamic pivot regularization (reference ``RegularizedLDL``): where a
    signed floor s ≠ 0 is given, boost a too-small pivot's MAGNITUDE to |s|,
    keeping the pivot's own sign (an exactly-zero pivot takes s's sign).
    On complex pivots the sign is z/|z|, as ``jnp.sign`` takes it."""
    mag = torch.abs(s)
    keep = torch.where(dk == 0, torch.sgn(s), torch.sgn(dk))
    return torch.where((s != 0) & (torch.abs(dk) < mag), keep * mag, dk)


def ldl_panel_plain(F, ns, j0: int, w: int, conjugate: bool, pf=None,
                    lp=None, ld=None) -> None:
    """Plain PyTorch version of :func:`ldl_panel`: the blocked factor's
    column loop, one column at a time over the whole batch."""
    S = F.shape[1]
    j1 = j0 + w
    idx = torch.arange(S, device=F.device)
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    Fp = F[:, :, j0:j1].clone()
    for kk in range(w):
        k = j0 + kk
        elim = ns > k
        dk = Fp[:, k, kk].clone()
        if pf is not None:
            dk = torch.where(elim, _clamp_pivot(dk, pf[:, k]), dk)
        safe = torch.where(dk == 0, torch.ones_like(dk), dk)
        below = (idx > k)[None, :] & elim[:, None]
        col = torch.where(below, Fp[:, :, kk] / safe[:, None], zero)
        # within-panel update: rows > k, panel columns > kk
        row = col[:, k + 1:j1]
        if conjugate:
            row = row.conj()
        Fp[:, k + 1:, kk + 1:] -= col[:, k + 1:, None] \
            * row[:, None, :] * dk[:, None, None]
        Fp[:, :, kk] = torch.where(below, col, Fp[:, :, kk])
        Fp[:, k, kk] = dk
    F[:, :, j0:j1] = Fp
    if lp is not None:
        # the masked panel: non-eliminated columns (pivot ≥ ns) hold Schur
        # data, and Lp·dp, rows ≥ j0
        tpan = torch.arange(w, device=F.device)
        prow = j0 + tpan
        dp = Fp[:, prow, tpan]
        keep = ((idx[j0:, None] > prow[None, :])[None]
                & (prow[None, None, :] < ns[:, None, None]))
        Lp = torch.where(keep, Fp[:, j0:], zero)
        lp.copy_(Lp)
        ld.copy_(Lp * dp[:, None, :])


def _check(F, ns, j0: int, w: int, pf, lp, ld, arrivals) -> None:
    if F.dtype not in _FN_NAMES:
        raise TypeError(f"ldl_panel: unsupported dtype {F.dtype}")
    if F.dim() != 3 or not F.is_contiguous():
        raise ValueError("ldl_panel: fronts must be a contiguous "
                         "(nf, S, C) tensor")
    nf, S, C = F.shape
    if not 0 <= j0 < j0 + w <= min(S, C):
        raise ValueError(f"ldl_panel: panel [{j0}, {j0 + w}) does not lie "
                         f"in fronts of {S} rows and {C} columns")
    if ns.dtype != torch.int64 or ns.shape != (nf,):
        raise TypeError(f"ldl_panel: ns must be int64 of shape ({nf},)")
    parts = [("ns", ns)]
    if pf is not None:
        if pf.dtype != F.dtype or pf.shape != (nf, S) \
                or not pf.is_contiguous():
            raise ValueError(f"ldl_panel: pf must be a contiguous ({nf}, "
                             f"{S}) tensor of {F.dtype}")
        parts.append(("pf", pf))
    if (lp is None) != (ld is None):
        raise ValueError("ldl_panel: give both scratch panels or neither")
    for name, t in (("lp", lp), ("ld", ld)):
        if t is None:
            continue
        if t.dtype != F.dtype or t.shape != (nf, S - j0, w) \
                or not t.is_contiguous():
            raise ValueError(f"ldl_panel: {name} must be a contiguous "
                             f"({nf}, {S - j0}, {w}) tensor of {F.dtype}")
        parts.append((name, t))
    if arrivals is not None:
        if arrivals.dtype != torch.int32 or arrivals.shape != (nf,):
            raise TypeError(f"ldl_panel: arrivals must be int32 of shape "
                            f"({nf},)")
        parts.append(("arrivals", arrivals))
    for name, t in parts:
        if t.device != F.device:
            raise ValueError(f"ldl_panel: {name} and the fronts are on "
                             f"different devices")


def _wide_panel(F, ns, j0: int, w: int, conjugate: bool, pf, lp, ld,
                arrivals) -> None:
    """:func:`ldl_panel` for w > :data:`NB`: sub-panels of :data:`NB`
    columns, each eliminated by one :func:`ldl_panel` call and followed by
    its rank-:data:`NB` update of the panel's later columns (rows ≥ its
    first), as the blocked factor updates its trailing columns.  Equal to
    the column loop up to rounding."""
    nf, S, _ = F.shape
    e = j0 + w
    if lp is not None:
        lp.zero_()
        ld.zero_()
    for s0 in range(j0, e, NB):
        s1 = min(s0 + NB, e)
        ws = s1 - s0
        lps = F.new_empty(nf, S - s0, ws)
        lds = torch.empty_like(lps)
        ldl_panel(F, ns, s0, ws, conjugate, pf, lps, lds, arrivals)
        if s1 < e:
            Lt = lps[:, ws:ws + e - s1]
            F[:, s0:, s1:e] -= torch.matmul(lds, Lt.mH if conjugate
                                            else Lt.mT)
        if lp is not None:
            lp[:, s0 - j0:, s0 - j0:s1 - j0] = lps
            ld[:, s0 - j0:, s0 - j0:s1 - j0] = lds


def ldl_panel(F, ns, j0: int, w: int, conjugate: bool, pf=None, lp=None,
              ld=None, arrivals=None) -> None:
    """Eliminate columns ``[j0, j0 + w)`` of each front ``F[f]`` (nf×S×S,
    lower; or nf×S×C, S rows of C columns, as the distributed front's
    gathered panel, whose pivot k sits on row k) in place, as the blocked
    factor's column loop does: where
    ``ns[f] > k``, column k's pivot (clamped by the signed floor ``pf[f,
    k]``, see :func:`_clamp_pivot`) and unit-L column, and the rank-1
    update of the panel's later columns (LDLᴴ with ``conjugate``); where
    ``ns[f] ≤ k`` the column keeps its Schur values.

    ``lp``, ``ld``: optional (nf, S − j0, w) outputs, the masked panel rows
    ≥ j0 (eliminated columns below the diagonal, zero elsewhere) and the
    same times each column's pivot, for the trailing update.
    ``arrivals``: on the card, nf zeroed int32 the kernel orders its blocks
    with and leaves zeroed (made here when not given; a caller that runs
    many panels gives one).

    CPU fronts: the plain version.  CUDA fronts: the kernel, or an
    exception.  On every device a panel wider than :data:`NB` is taken as
    sub-panels (:func:`_wide_panel`).  ``ldl_panel.launches`` counts kernel
    launches."""
    _check(F, ns, j0, w, pf, lp, ld, arrivals)
    if w > NB:
        _wide_panel(F, ns, j0, w, conjugate, pf, lp, ld, arrivals)
        return
    if F.device.type == "cpu":
        ldl_panel_plain(F, ns, j0, w, conjugate, pf, lp, ld)
        return
    if F.device.type != "cuda":
        raise ValueError(f"ldl_panel: no kernel for device {F.device}")
    if arrivals is None:
        arrivals = torch.zeros(F.shape[0], dtype=torch.int32,
                               device=F.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(_lib(), _FN_NAMES[F.dtype])
    nf, S, C = F.shape
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        rc = fn(F.data_ptr(), ns.data_ptr(), ptr(pf), ptr(lp), ptr(ld),
                arrivals.data_ptr(), nf, S, C, j0, w, int(conjugate), stream)
    if rc != 0:
        raise RuntimeError(f"ldl_panel: kernel launch failed with CUDA "
                           f"error {rc}")
    ldl_panel.launches += 1


ldl_panel.launches = 0
