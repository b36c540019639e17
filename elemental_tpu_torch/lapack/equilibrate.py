"""Equilibration (counterpart of ``elemental_tpu/lapack/equilibrate.py``;
reference ``src/lapack_like/equilibrate``: Ruiz, Geom, SymmetricRuiz,
SymmetricDiagonal).

Each returns the scaled matrix and the scaling vectors, so that callers
can unscale solutions."""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from ..core.distmatrix import DistMatrix, as_array

Arr = Union[torch.Tensor, DistMatrix]


class Equilibrated(NamedTuple):
    a: torch.Tensor
    drow: torch.Tensor  # A_scaled = diag(1/drow) · A · diag(1/dcol)
    dcol: torch.Tensor


def _safe(x):
    return torch.where(x == 0, 1.0, x)


def _ones(n: int, a: torch.Tensor) -> torch.Tensor:
    return torch.ones((n,), dtype=a.real.dtype, device=a.device)


def ruiz_equil(A: Arr, iters: int = 3) -> Equilibrated:
    """Ruiz scaling: iteratively divide rows/cols by sqrt of their max-abs
    (reference ``Ruiz``)."""
    a = as_array(A)
    m, n = a.shape
    dr, dc = _ones(m, a), _ones(n, a)
    for _ in range(iters):
        rmax = torch.sqrt(_safe(torch.amax(a.abs(), dim=1)))
        a = a / rmax[:, None].to(a.dtype)
        dr = dr * rmax
        cmax = torch.sqrt(_safe(torch.amax(a.abs(), dim=0)))
        a = a / cmax[None, :].to(a.dtype)
        dc = dc * cmax
    return Equilibrated(a, dr, dc)


def geom_equil(A: Arr, iters: int = 3) -> Equilibrated:
    """Geometric-mean scaling: divide by sqrt(min·max) per row/col
    (reference ``GeomEquil``)."""
    a = as_array(A)
    m, n = a.shape
    dr, dc = _ones(m, a), _ones(n, a)
    tiny = torch.finfo(a.real.dtype).tiny

    def geo(x, dim):
        ab = x.abs()
        mx = torch.amax(ab, dim=dim)
        mn = torch.amin(torch.where(ab == 0, float("inf"), ab), dim=dim)
        mn = torch.where(torch.isinf(mn), 1.0, mn)
        return torch.sqrt(_safe(torch.sqrt(mx * torch.clamp(mn, min=tiny)))
                          ** 2)

    for _ in range(iters):
        r = geo(a, 1)
        a = a / r[:, None].to(a.dtype)
        dr = dr * r
        c = geo(a, 0)
        a = a / c[None, :].to(a.dtype)
        dc = dc * c
    return Equilibrated(a, dr, dc)


def symmetric_ruiz_equil(A: Arr, iters: int = 3) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Symmetric Ruiz: A ← D⁻¹AD⁻¹ preserving symmetry (reference
    ``SymmetricRuiz``); returns (A_scaled, d)."""
    a = as_array(A)
    d = _ones(a.shape[0], a)
    for _ in range(iters):
        s = torch.sqrt(_safe(torch.amax(a.abs(), dim=1)))
        a = a / (s[:, None] * s[None, :]).to(a.dtype)
        d = d * s
    return a, d


def symmetric_diagonal_equil(A: Arr) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobi scaling by sqrt of the diagonal (reference
    ``SymmetricDiagonalEquil``)."""
    a = as_array(A)
    d = torch.sqrt(_safe(torch.diagonal(a).real.abs()))
    return a / (d[:, None] * d[None, :]).to(a.dtype), d
