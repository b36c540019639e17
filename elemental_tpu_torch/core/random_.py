"""Global RNG state + samplers (counterpart of
``elemental_tpu/core/random_.py``; reference ``src/core/random.cpp``,
``include/El/core/random/``): seeded generators with
``Uniform``/``Gaussian``/``Bernoulli`` samplers.

Module state is one ``torch.Generator`` per device, each seeded with the
module's seed when first used.  The draws are torch's, not ``jax.random``'s:
the same seed gives the same numbers on the same device and torch build.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_seed = 0
_generators: Dict[torch.device, torch.Generator] = {}


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed(s: int) -> None:
    """Reseed: every device's generator restarts from ``s``."""
    global _seed
    _seed = int(s)
    _generators.clear()


def generator(device) -> torch.Generator:
    """The module's generator for ``device``."""
    device = _key(device)
    g = _generators.get(device)
    if g is None:
        g = torch.Generator(device=device)
        g.manual_seed(_seed)
        _generators[device] = g
    return g


def _real(dtype: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def uniform(shape, dtype=torch.float32, center=0.0, radius=1.0, *, device):
    """Draws from the ball of ``radius`` about ``center`` (a box in the
    complex plane), on ``device``."""
    g, rdt = generator(device), _real(dtype)

    def unit():
        return 2 * torch.rand(shape, generator=g, dtype=rdt,
                              device=device) - 1

    if dtype.is_complex:
        re, im = unit(), unit()
        return center + radius * torch.complex(re, im).to(dtype)
    return center + radius * unit()


def gaussian(shape, dtype=torch.float32, mean=0.0, stddev=1.0, *, device):
    """Normal draws (complex: E|z - mean|² = stddev²), on ``device``."""
    g, rdt = generator(device), _real(dtype)

    def normal():
        return torch.randn(shape, generator=g, dtype=rdt, device=device)

    if dtype.is_complex:
        re, im = normal(), normal()
        return mean + stddev * (torch.complex(re, im) / math.sqrt(2)).to(dtype)
    return mean + stddev * normal()


def bernoulli(shape, p=0.5, *, device):
    """Boolean draws, True with probability ``p``."""
    return torch.rand(shape, generator=generator(device),
                      device=device) < p


def rademacher(shape, dtype=torch.float32, *, device):
    """±1 with equal probability."""
    return torch.where(bernoulli(shape, device=device), 1.0, -1.0).to(dtype)
