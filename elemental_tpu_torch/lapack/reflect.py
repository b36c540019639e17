"""Householder reflectors (counterpart of ``elemental_tpu/lapack/reflect.py``;
reference ``src/lapack_like/reflect``: form/apply packed reflector products,
expand, hyperbolic variants)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..core.distmatrix import DistMatrix, as_array, like

Arr = Union[torch.Tensor, DistMatrix]


def _one(x: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=x.dtype, device=x.device)


def householder(x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compute (v, tau, beta) with (I − τ v vᴴ) x = β e₁, v[0] = 1
    (reference ``reflect/Householder``)."""
    x = as_array(x).reshape(-1)
    alpha = x[0]
    xnorm = torch.linalg.vector_norm(x)
    absa = alpha.abs()
    phase = torch.where(absa == 0, _one(x), alpha / absa)
    beta = -phase * xnorm
    denom = alpha - beta
    safe = torch.where(denom == 0, _one(x), denom)
    v = x / safe
    v[0] = 1.0
    # standard LAPACK tau: τ = (β − α)/β
    tau = torch.where(xnorm == 0, torch.zeros_like(beta),
                      (beta - alpha) / beta)
    return v, tau, beta


def apply_packed_reflectors(side: str, uplo: str, order: str, packed: Arr,
                            taus, B: Arr, offset: int = 0) -> Arr:
    """Apply a product of Householder reflectors stored column-wise in the
    (strict) lower triangle of ``packed`` (reference
    ``ApplyPackedReflectors``), one reflector after another."""
    a = as_array(packed)
    b = as_array(B)
    taus = torch.as_tensor(taus, device=a.device)
    m = a.shape[0]
    k = taus.shape[0]
    left = side.upper().startswith("L")
    forward = order.upper().startswith("F")
    rows = torch.arange(m, device=a.device)
    for j in (range(k) if forward else reversed(range(k))):
        v = torch.where(rows > j, a[:, j], 0.0)
        v[j] = 1.0
        tau = taus[j]
        if left:
            b = b - tau * torch.outer(v, v.conj() @ b)
        else:
            b = b - tau * torch.outer(b @ v, v.conj())
    return like(B, b)


def expand_packed_reflectors(packed: Arr, taus) -> torch.Tensor:
    """Form the explicit unitary Q from packed reflectors (reference
    ``ExpandPackedReflectors``)."""
    a = as_array(packed)
    return torch.linalg.householder_product(
        a, torch.as_tensor(taus, device=a.device))


def hyperbolic_reflector(x) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Hyperbolic reflector for the signature (1, −1, ..., −1): maps x to
    ±√(x₀² − ‖x₁:‖²) e₁ (reference ``reflect/Hyperbolic``)."""
    x = as_array(x).reshape(-1)
    alpha = x[0].real
    rest2 = torch.sum(x[1:].abs() ** 2)
    beta2 = alpha ** 2 - rest2
    beta = torch.sign(alpha) * torch.sqrt(torch.clamp(beta2, min=0.0))
    denom = alpha - beta
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    v = x / safe
    v[0] = 1.0
    tau = torch.where(beta2 <= 0, torch.zeros_like(beta),
                      (beta - alpha) / beta)
    return v, tau.to(x.dtype), beta.to(x.dtype)
