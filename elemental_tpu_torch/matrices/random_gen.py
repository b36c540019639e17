"""Random generators (counterpart of ``elemental_tpu/matrices/random_gen.py``;
reference ``src/matrices/random``: Uniform, Gaussian, Bernoulli, Wigner,
Haar, HermitianUniformSpectrum, NormalUniformSpectrum and the misc and
lattice generators).

Every draw comes from :mod:`..core.random_`'s generator for ``device``
(keyword-only), so the same seed gives the same matrix on the same device
and torch build; torch's draws are not ``jax.random``'s.
"""

from __future__ import annotations

import math

import torch

from ..core import random_ as rng
from ..ops.level3 import with_precision


def _shape(m, n):
    return (m, n if n is not None else m)


def uniform(m, n=None, dtype=torch.float32, center=0.0, radius=1.0, *,
            device):
    return rng.uniform(_shape(m, n), dtype, center, radius, device=device)


def gaussian(m, n=None, dtype=torch.float32, mean=0.0, stddev=1.0, *,
             device):
    return rng.gaussian(_shape(m, n), dtype, mean, stddev, device=device)


def bernoulli(m, n=None, p=0.5, dtype=torch.float32, *, device):
    return rng.bernoulli(_shape(m, n), p, device=device).to(dtype)


def rademacher(m, n=None, dtype=torch.float32, *, device):
    return rng.rademacher(_shape(m, n), dtype, device=device)


def wigner(n, dtype=torch.float32, *, device):
    """Gaussian Wigner ensemble: Hermitian with N(0,1) entries (reference
    ``Wigner``)."""
    g = rng.gaussian((n, n), dtype, device=device)
    return (g + g.conj().T) / math.sqrt(2)


def haar(n, dtype=torch.float32, *, device):
    """Haar-distributed orthogonal/unitary matrix via QR of a Ginibre sample
    with the phase fix (reference ``Haar``)."""
    g = rng.gaussian((n, n), dtype, device=device)
    q, r = torch.linalg.qr(g)
    d = torch.diagonal(r)
    ph = d / d.abs()
    return q * ph.conj()[None, :]


@with_precision
def hermitian_uniform_spectrum(n, lower=0.0, upper=1.0, dtype=torch.float32,
                               *, device):
    """Hermitian matrix with eigenvalues drawn Uniform[lower, upper] under a
    Haar conjugation (reference ``HermitianUniformSpectrum``)."""
    q = haar(n, dtype, device=device)
    lam = rng.uniform((n,), rng._real(dtype), (lower + upper) / 2,
                      (upper - lower) / 2, device=device)
    return (q * lam[None, :].to(q.dtype)) @ q.conj().T


@with_precision
def normal_uniform_spectrum(n, center=0.0, radius=1.0, dtype=torch.complex64,
                            *, device):
    """Normal matrix with eigenvalues uniform in a disk (reference
    ``NormalUniformSpectrum``)."""
    q = haar(n, dtype, device=device)
    lam = rng.uniform((n,), dtype, center, radius, device=device)
    return (q * lam[None, :]) @ q.conj().T


def three_valued(m, n=None, p=0.5, dtype=torch.float32, *, device):
    """Entries −1/+1 each with probability p/2, else 0 (reference
    ``random/independent/ThreeValued.cpp``)."""
    u = torch.rand(_shape(m, n), generator=rng.generator(device),
                   device=device)
    return torch.where(u <= p / 2, -1.0,
                       torch.where(u <= p, 1.0, 0.0)).to(dtype)


def hatano_nelson(n, center=0.0, radius=1.0, g=0.5, periodic=True,
                  dtype=torch.float64, *, device):
    """Hatano–Nelson non-Hermitian hopping matrix: uniform diagonal,
    super-diagonal e^g, sub-diagonal e^{−g}, optionally periodic (reference
    ``random/misc/HatanoNelson.cpp``)."""
    if n < 3:
        raise ValueError("HatanoNelson requires n ≥ 3")
    d = rng.uniform((n,), dtype, center, radius, device=device)
    eg = torch.exp(torch.tensor(g, dtype=dtype, device=device))
    emg = torch.exp(torch.tensor(-g, dtype=dtype, device=device))
    ones = torch.ones(n - 1, dtype=dtype, device=device)
    A = torch.diag(d) + eg * torch.diag(ones, 1) + emg * torch.diag(ones, -1)
    if periodic:
        A[n - 1, 0] = eg
        A[0, n - 1] = emg
    return A


def uniform_helmholtz_greens(n, lam, dtype=torch.complex128, *, device):
    """Green's kernel G(x,y)=e^{ik₀‖x−y‖}/‖x−y‖ (k₀=2π/λ) between n uniform
    samples of the 3-D unit ball, zero diagonal (reference
    ``random/misc/UniformHelmholtzGreens.cpp``)."""
    gen = rng.generator(device)
    real_dt = torch.float32 if dtype == torch.complex64 else torch.float64
    k0 = 2.0 * math.pi / lam
    # rejection-free ball sampling: direction × cube-root radius
    z = torch.randn((n, 3), generator=gen, dtype=real_dt, device=device)
    z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    r = torch.rand((n, 1), generator=gen, dtype=real_dt,
                   device=device) ** (1.0 / 3.0)
    X = z * r
    diff = X[:, None, :] - X[None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    gamma = k0 * dist
    safe = torch.where(gamma == 0, 1.0, gamma)
    G = torch.exp(1j * gamma.to(dtype)) / safe.to(dtype)
    return torch.where(torch.eye(n, dtype=torch.bool, device=device),
                       torch.zeros((), dtype=dtype, device=device), G)


def ajtai_type_basis(n, alpha, dtype=torch.float64, *, device):
    """Ajtai-type lattice basis: diagonal β_j = round(2^{(2n−j+1)^α}), strict
    upper triangle uniform in [0, β_j/2) (reference
    ``random/lattice/AjtaiTypeBasis.cpp``)."""
    j = torch.arange(n, device=device).to(dtype)
    beta = torch.round(2.0 ** ((2.0 * n - j + 1.0) ** alpha))
    u = torch.rand((n, n), generator=rng.generator(device), dtype=dtype,
                   device=device)
    upper = torch.triu(u * (beta[None, :] / 2.0), diagonal=1)
    return torch.diag(beta) + upper


def knapsack_type_basis(n, radius, dtype=torch.float64, *, device):
    """Knapsack-type lattice basis: (n+1)×n with identity on top and a
    rounded-uniform bottom row (reference
    ``random/lattice/KnapsackTypeBasis.cpp``)."""
    bottom = torch.round(rng.uniform((1, n), dtype, 0.0, radius,
                                     device=device))
    return torch.cat([torch.eye(n, dtype=dtype, device=device), bottom], 0)
