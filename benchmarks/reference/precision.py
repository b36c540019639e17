"""Rounding to a lower precision, for the controls: the reference computed
in the precision below the one a configuration states must fail the
checks."""

from __future__ import annotations

import numpy as np


def same(v):
    return v


def tf32(v: np.ndarray) -> np.ndarray:
    """Round to TF32 (float32 with 10 explicit mantissa bits, to nearest
    even), returned as float64."""
    a = np.ascontiguousarray(np.asarray(v, np.float64).astype(np.float32))
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~np.uint64(0x1FFF)
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def float32(v: np.ndarray) -> np.ndarray:
    return np.asarray(v, np.float64).astype(np.float32).astype(np.float64)


# the nearest precision below each one a configuration states
BELOW = {"float32": tf32, "float64": float32}
