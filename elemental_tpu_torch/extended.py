"""Double-word ("double-double") arithmetic: the part of
``elemental_tpu/extended.py`` that the LP's compensated residuals and gap
use.

Error-free transformations (Knuth TwoSum, Dekker split + TwoProd) on
tensors.  Eager PyTorch runs each operation as its own kernel, so no
compiler re-associates or contracts the compensation into an FMA.
"""

from __future__ import annotations

import dataclasses

import torch


def two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Dekker FastTwoSum; requires |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


_SPLIT = {torch.float32: (1 << 12) + 1, torch.float64: (1 << 27) + 1}


def split(a):
    """Dekker split: a == hi + lo with both halves on half-width mantissas."""
    c = _SPLIT[a.dtype] * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProd: p + err == a*b exactly."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


@dataclasses.dataclass
class DD:
    """Double-word number/array: value = hi + lo, |lo| <= ulp(hi)/2."""
    hi: torch.Tensor
    lo: torch.Tensor


def _as_dd(x) -> DD:
    return x if isinstance(x, DD) else DD(x, torch.zeros_like(x))


def dd_neg(a: DD) -> DD:
    return DD(-a.hi, -a.lo)


def dd_add(a: DD, b: DD) -> DD:
    """Full (accurate) DD addition: 20 flops, ~2 ulp DD error."""
    s, e = two_sum(a.hi, b.hi)
    t, f = two_sum(a.lo, b.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return DD(*quick_two_sum(s, e))


def dd_sum(a: DD, dim: int = -1) -> DD:
    """Compensated sum along ``dim`` by a log-depth pairwise DD tree."""
    hi = torch.movedim(a.hi, dim, -1)
    lo = torch.movedim(a.lo, dim, -1)
    n = hi.shape[-1]
    # pad to a power of two with exact zeros
    m = 1 << max(0, (n - 1)).bit_length()
    x = DD(torch.nn.functional.pad(hi, (0, m - n)),
           torch.nn.functional.pad(lo, (0, m - n)))
    while x.hi.shape[-1] > 1:
        half = x.hi.shape[-1] // 2
        x = dd_add(DD(x.hi[..., :half], x.lo[..., :half]),
                   DD(x.hi[..., half:], x.lo[..., half:]))
    return DD(x.hi[..., 0], x.lo[..., 0])


def dd_dot(x, y) -> DD:
    """Dot product with exact per-element products (TwoProd) and a DD tree
    reduction."""
    xd, yd = _as_dd(x), _as_dd(y)
    p, e = two_prod(xd.hi, yd.hi)
    e = e + (xd.hi * yd.lo + xd.lo * yd.hi)
    return dd_sum(DD(p, e), dim=-1)
