"""Symmetric tridiagonal eigensolver, the PMRRR slot (counterpart of
``elemental_tpu/lapack/tridiag_eig.py``; reference external ``pmrrr``).

The JAX package's division of labour:
  * eigenvalues by Sturm-sequence bisection, every target at once: each
    bisection step runs over the rows of T in a Python loop, one vector
    operation over all targets a row (the JAX package's ``lax.scan``
    ``vmap``-ped over the targets);
  * eigenvectors by shifted inverse iteration (Thomas algorithm, a
    forward and a backward sweep over the rows, all eigenpairs at once),
    with one Gram-Schmidt pass inside clusters of close eigenvalues.

The sweeps are sequential over n: bisection takes ``iters``·n row steps
(60·n) of about four launches each, inverse iteration 2n row steps an
iteration.  The start vectors of inverse iteration are normal draws in
T's dtype from a host ``torch.Generator`` seeded 0, moved to T's device
(so every device starts from the same vectors), where the JAX package
draws from ``PRNGKey(0)``: the vectors agree with the JAX ones up to
sign.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _sturm_count(d: torch.Tensor, e2: torch.Tensor, sigma: torch.Tensor,
                 big: float = None) -> torch.Tensor:
    """#eigenvalues < σ for each entry of ``sigma`` (int32), by the LDL
    pivot-sign recurrence q_i = (d_i − σ) − e2_i/q_{i−1} from q = ``big``
    (1e300, or 1e30 in float32)."""
    if big is None:
        big = 1e300 if d.dtype == torch.float64 else 1e30
    dms = d[:, None] - sigma[None, :]
    tiny = torch.full((), 1e-300, dtype=d.dtype, device=d.device)
    qs = torch.empty_like(dms)
    q = torch.full_like(sigma, big)
    for i in range(d.shape[0]):
        q = torch.sub(dms[i], e2[i] / torch.where(q == 0, tiny, q),
                      out=qs[i])
    return torch.sum(qs < 0, 0, dtype=torch.int32)


def tridiag_eigvalsh(d: torch.Tensor, e: torch.Tensor,
                     select: Optional[Tuple[int, int]] = None,
                     iters: int = 60) -> torch.Tensor:
    """All (or the index range ``select``, inclusive) eigenvalues by
    batched bisection from the Gershgorin interval."""
    n = d.shape[0]
    e2 = torch.cat([torch.zeros(1, dtype=d.dtype, device=d.device), e * e])
    rad = torch.zeros(n, dtype=d.dtype, device=d.device)
    rad[:-1] += torch.abs(e)
    rad[1:] += torch.abs(e)
    lo = torch.min(d - rad)
    hi = torch.max(d + rad)
    il, iu = (0, n - 1) if select is None else select
    targets = torch.arange(il, iu + 1, device=d.device)
    a = lo.expand(targets.shape[0])
    b = hi.expand(targets.shape[0])
    for _ in range(iters):
        mid = (a + b) / 2
        go_right = _sturm_count(d, e2, mid) <= targets
        a, b = torch.where(go_right, mid, a), torch.where(go_right, b, mid)
    return (a + b) / 2


def _tridiag_solve(d: torch.Tensor, e: torch.Tensor,
                   rhs: torch.Tensor) -> torch.Tensor:
    """Thomas algorithm, each row of ``d`` (k×n, already shifted) with the
    off-diagonal ``e`` against the same row of ``rhs``."""
    k, n = d.shape
    d, rhs = d.T.contiguous(), rhs.T.contiguous()
    zero = torch.zeros(1, dtype=d.dtype, device=d.device)
    el = torch.cat([zero, e])                   # lower off-diagonal
    eu = torch.cat([e, zero])                   # upper off-diagonal
    tiny = torch.full((), 1e-300, dtype=d.dtype, device=d.device)
    cps = d.new_empty((n, k))
    dps = d.new_empty((n, k))
    cp = dp = torch.zeros((), dtype=d.dtype, device=d.device)
    for i in range(n):
        denom = d[i] - el[i] * cp
        denom = torch.where(torch.abs(denom) < tiny, tiny, denom)
        cp = torch.div(eu[i], denom, out=cps[i])
        dp = torch.div(rhs[i] - el[i] * dp, denom, out=dps[i])
    xs = d.new_empty((n, k))
    x = torch.zeros((), dtype=d.dtype, device=d.device)
    for i in range(n - 1, -1, -1):
        x = torch.sub(dps[i], cps[i] * x, out=xs[i])
    return xs.T


def tridiag_eig(d: torch.Tensor, e: torch.Tensor,
                select: Optional[Tuple[int, int]] = None,
                inv_iters: int = 3):
    """(w, Z): eigenvalues by bisection, eigenvectors by shifted inverse
    iteration on all eigenpairs at once with intra-cluster Gram-Schmidt
    (one host read: which neighbours are close)."""
    n = d.shape[0]
    w = tridiag_eigvalsh(d, e, select)
    eps = torch.finfo(d.dtype).eps
    tnorm = (torch.max(torch.abs(d)) + 2 * torch.max(torch.abs(e))
             if e.numel() else torch.max(torch.abs(d)))
    # separate shifts inside clusters so that inverse iteration can tell
    # nearly equal eigenvalues apart
    k = w.shape[0]
    pert = ((torch.arange(k, dtype=d.dtype, device=d.device) % 7 - 3) * 16
            * eps * tnorm)
    shifts = w + pert
    gen = torch.Generator().manual_seed(0)
    v = torch.randn((k, n), generator=gen, dtype=d.dtype).to(d.device)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    shifted = d[None, :] - shifts[:, None]
    for _ in range(inv_iters):
        x = _tridiag_solve(shifted, e, v)
        v = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    # one Gram-Schmidt sweep over neighbours within clusters
    close = (torch.abs(torch.diff(w)) < 1e3 * eps * tnorm).tolist()
    Z = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    for i, is_close in enumerate(close, start=1):
        if is_close:
            z = v[i] - (Z[i - 1] @ v[i]) * Z[i - 1]
            Z[i] = z / torch.linalg.vector_norm(z)
    return w, Z.T
