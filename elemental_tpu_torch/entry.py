"""The single-card forward step (counterpart of ``__graft_entry__.entry``):
25 CG iterations on the unscaled 64² Laplacian in its ELL form, float32,
plain torch.

    forward, args = entry()          # on the card
    x, rnorm = forward(*args)

``dryrun_multichip`` has no counterpart yet: it needs the dense LAPACK tier
and the distributed sparse-direct factor.
"""

from __future__ import annotations

import numpy as np
import torch

from .matrices import sparse_laplacian_2d

ITERATIONS = 25


def entry(device=None):
    """Return ``(forward, (cols, vals, b))`` on ``device`` (default
    ``cuda``); ``forward(cols, vals, b)`` returns ``(x, ‖r‖)``."""
    device = torch.device("cuda" if device is None else device)
    n1 = 64
    A = sparse_laplacian_2d(n1, n1, scaled=False)
    ell = A.device_ell(device=device, dtype=torch.float32)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(n1 * n1)
                         .astype(np.float32)).to(device)

    def forward(cols, vals, b):
        def matvec(x):
            return torch.sum(vals * x[cols], dim=1)

        x = torch.zeros_like(b)
        r = b - matvec(x)
        p = r
        rz = torch.dot(r, r)
        for _ in range(ITERATIONS):
            ap = matvec(p)
            alpha = rz / torch.dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            rz_new = torch.dot(r, r)
            p = r + (rz_new / rz) * p
            rz = rz_new
        return x, torch.linalg.norm(r)

    return forward, (ell.cols, ell.vals, b)
