"""Inputs made from the seed, and the seeded sample of a window's answers
that the check compares."""

from __future__ import annotations

import numpy as np

MASK = 2 ** 63 - 1


def mixed_seed(seed: int, *key: int) -> int:
    """One 63-bit seed from the run's seed and a key, for generators that
    take one integer (``torch.Generator.manual_seed``)."""
    return int(np.random.default_rng([seed & (2 ** 64 - 1), *key])
               .integers(0, MASK))


def device_normal(seed: int, key: int, shape, dtype, device):
    """Standard normal values made on ``device`` from the seed, in one
    call."""
    import torch
    g = torch.Generator(device=device).manual_seed(mixed_seed(seed, key))
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


class Reservoir:
    """A uniform sample of ``size`` of the window's answers, drawn from the
    seed as they come (reservoir sampling): the check compares answers from
    the whole window while the run holds only ``size`` of them."""

    def __init__(self, size: int, seed: int, key: int = 99):
        self.size = size
        self.rng = np.random.default_rng([seed & (2 ** 64 - 1), key])
        self.items = {}                 # slot -> (request index, answer)

    def offer(self, k: int, answer) -> None:
        if k < self.size:
            self.items[k] = (k, answer)
            return
        j = int(self.rng.integers(0, k + 1))
        if j < self.size:
            self.items[j] = (k, answer)

    def sample(self):
        """(request index, answer) pairs, by request index."""
        return sorted(self.items.values(), key=lambda t: t[0])
