"""Matrix properties (counterpart of ``elemental_tpu/lapack/props.py``;
reference ``src/lapack_like/props``: the Norm family, Condition,
Determinant, Inertia, Trace)."""

from __future__ import annotations

from typing import Union

import torch

from ..core.distmatrix import DistMatrix, as_array
from .ldl import inertia as _ldl_inertia
from .ldl import ldl
from .lu import determinant as _lu_determinant

Arr = Union[torch.Tensor, DistMatrix]


def one_norm(A: Arr):
    return torch.max(torch.sum(as_array(A).abs(), dim=0))


def infinity_norm(A: Arr):
    return torch.max(torch.sum(as_array(A).abs(), dim=1))


def frobenius_norm(A: Arr):
    return torch.linalg.vector_norm(as_array(A).reshape(-1))


def max_norm(A: Arr):
    return torch.max(as_array(A).abs())


def entrywise_norm(A: Arr, p: float = 1.0):
    return torch.sum(as_array(A).abs() ** p) ** (1.0 / p)


def two_norm_estimate(A: Arr, iters: int = 20):
    """Power iteration on AᴴA (reference ``TwoNormEstimate``) from a fixed
    start: float32 normal draws of a generator seeded 0 on A's device (the
    JAX package's fixed ``PRNGKey(0)``), so the estimate does not depend on
    the module's random state."""
    a = as_array(A)
    gen = torch.Generator(device=a.device).manual_seed(0)
    x = torch.randn(a.shape[1], generator=gen, dtype=torch.float32,
                    device=a.device).to(a.dtype)
    x = x / torch.linalg.vector_norm(x)
    for _ in range(iters):
        y = a.mH @ (a @ x)
        x = y / torch.linalg.vector_norm(y)
    return torch.linalg.vector_norm(a @ x)


def two_norm(A: Arr):
    """Exact spectral norm via the singular values (reference
    ``Norm(TWO_NORM)``)."""
    return torch.max(torch.linalg.svdvals(as_array(A)))


def nuclear_norm(A: Arr):
    return torch.sum(torch.linalg.svdvals(as_array(A)))


def schatten_norm(A: Arr, p: float):
    s = torch.linalg.svdvals(as_array(A))
    return torch.sum(s ** p) ** (1.0 / p)


def norm(A: Arr, kind: str = "frobenius"):
    kind = kind.lower()
    table = {
        "one": one_norm, "1": one_norm,
        "infinity": infinity_norm, "inf": infinity_norm,
        "frobenius": frobenius_norm, "fro": frobenius_norm,
        "max": max_norm,
        "two": two_norm, "2": two_norm,
        "nuclear": nuclear_norm,
    }
    return table[kind](A)


def condition(A: Arr, kind: str = "two"):
    """Condition number (reference ``Condition``)."""
    a = as_array(A)
    if kind == "two":
        s = torch.linalg.svdvals(a)
        return torch.max(s) / torch.min(s)
    return norm(a, kind) * norm(torch.linalg.inv(a), kind)


def determinant(A: Arr):
    return _lu_determinant(A)


def hpd_determinant(uplo: str, A: Arr):
    from .cholesky import cholesky
    L = as_array(cholesky(uplo, A))
    return torch.prod(torch.diagonal(L).real) ** 2


def log_det(A: Arr):
    """log|det| via LU: overflow-safe (reference SafeDeterminant shape)."""
    from .lu import lu as _lu
    return torch.sum(torch.log(torch.diagonal(_lu(A).lu).abs()))


def inertia(A: Arr, conjugate: bool = True):
    """Sylvester inertia via LDL (reference ``Inertia``)."""
    return _ldl_inertia(ldl(A, conjugate=conjugate))


def trace(A: Arr):
    return torch.trace(as_array(A))
