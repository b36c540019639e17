"""Scalar and type helpers on torch dtypes (counterpart of
``elemental_tpu/core/types.py``; reference ``include/El/core/Element/``,
``limits``).  ``epsilon`` and ``safe_min`` mirror the reference's
``limits::Epsilon`` and ``limits::SafeMin`` of the real type underneath."""

from __future__ import annotations

import torch

from .policy import effective_dtype

__all__ = ["complex_type", "conj_if", "epsilon", "is_complex", "real_type",
           "safe_min"]

_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def real_type(dtype) -> torch.dtype:
    """The real dtype under ``dtype`` (complex64 → float32, complex128 →
    float64; a real dtype is its own)."""
    dt = effective_dtype(dtype)
    return _REAL_OF.get(dt, dt)


def complex_type(dtype) -> torch.dtype:
    """complex128 for float64 and complex128, complex64 otherwise."""
    dt = effective_dtype(dtype)
    return (torch.complex128 if dt in (torch.float64, torch.complex128)
            else torch.complex64)


def is_complex(dtype) -> bool:
    return effective_dtype(dtype).is_complex


def epsilon(dtype) -> float:
    return float(torch.finfo(real_type(dtype)).eps)


def safe_min(dtype) -> float:
    return float(torch.finfo(real_type(dtype)).tiny)


def conj_if(cond: bool, x):
    """``x.conj()`` resolved into memory when ``cond``, else ``x``."""
    return x.conj().resolve_conj() if cond else x
