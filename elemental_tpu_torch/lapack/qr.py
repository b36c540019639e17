"""QR factorization (counterpart of ``elemental_tpu/lapack/qr.py``; reference
``src/lapack_like/factor/QR/``: blocked Householder, tall-skinny TSQR
``TS.hpp``, BusingerGolub column pivoting, Cholesky-QR, Explicit, ApplyQ).

  * general QR: ``torch.linalg.qr`` (LAPACK on the host, cuSOLVER on the
    card).  Its Q and R may differ from ``jnp.linalg.qr``'s by the signs
    (phases) of Q's columns and R's rows; Q·R, QᴴQ and R's triangle agree.
  * TSQR over the port's :class:`~..core.grid.Grid` in the single-controller
    model: each grid position (row-major) factors its row block on its
    device, then the n×n R factors combine, by one gather of all p of them
    (``tree=False``) or by log₂p butterfly rounds (``tree=True``); both
    exchanges are recorded in an open
    :func:`~..utils.transfers.count_transfers` log.
  * CholeskyQR2, and the column-pivoted and packed Householder loops (one
    host read per column for the pivot).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from ..core.distmatrix import DistMatrix, as_array, like
from ..core.grid import Grid
from ..ops.level3 import trsm, with_precision
from ..utils import transfers
from .cholesky import _adj, cholesky
from .perm import _swap_cols, _swap_rows

Arr = Union[torch.Tensor, DistMatrix]


class QR(NamedTuple):
    q: torch.Tensor
    r: torch.Tensor


class QRPivoted(NamedTuple):
    q: torch.Tensor
    r: torch.Tensor
    perm: torch.Tensor  # A[:, perm] = Q·R


@with_precision
def qr(A: Arr, full_matrices: bool = False) -> QR:
    """Householder QR (reference ``QR``)."""
    a = as_array(A)
    q, r = torch.linalg.qr(a, mode="complete" if full_matrices else
                           "reduced")
    return QR(q, r)


@with_precision
def qr_householder(A: Arr):
    """Packed Householder form (LAPACK ``geqrf``'s convention: R in the
    upper triangle, reflector vectors below the diagonal with implicit unit
    heads, plus ``taus``), by the JAX package's loop of reflections.  Each
    reflection is applied to the columns from its own on: the JAX loop also
    applies it to the reflectors already stored in the earlier columns, so
    its packed form does not reproduce A (its R and taus are these)."""
    a = as_array(A).clone()
    m, n = a.shape
    k = min(m, n)
    taus = torch.zeros((k,), dtype=a.dtype, device=a.device)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for j in range(k):
        x = a[j:, j]
        normx = torch.linalg.vector_norm(x)
        alpha = a[j, j].clone()
        absa = alpha.abs()
        phase = torch.where(absa == 0, one, alpha / absa)
        beta = -phase * normx
        denom = alpha - beta
        safe = torch.where(denom == 0, one, denom)
        v = x / safe
        v[0] = 1.0
        tau = torch.where(normx == 0, torch.zeros_like(beta),
                          (beta - alpha) / beta)
        a[j:, j:] -= tau * torch.outer(v, v.conj() @ a[j:, j:])
        # store the reflector below the diagonal of column j
        a[j + 1:, j] = v[1:]
        a[j, j] = torch.where(normx == 0, alpha, beta)
        taus[j] = tau
    return a, taus


def apply_q(packed: torch.Tensor, taus: torch.Tensor, B: Arr,
            adjoint: bool = False) -> Arr:
    """Apply Q (or Qᴴ) from packed Householder form to B (reference
    ``qr::ApplyQ``)."""
    q = torch.linalg.householder_product(packed, taus)
    b = as_array(B)
    return like(B, q.mH @ b if adjoint else q @ b)


def _record(kind: str, out, pieces, dst) -> None:
    if transfers.recording:
        transfers.record(kind, out, pieces, dst)


@with_precision
def tsqr(A: Arr, grid: Grid = None, tree: bool = None) -> QR:
    """Tall-skinny QR over the grid's positions (reference ``QR/TS.hpp``).

    A is cut into p row blocks, one a position (row-major, zero rows padding
    the last); each position factors its block, then the n×n R factors
    combine by one of two strategies:

    * ``tree=True``: the butterfly all-reduce TSQR, log₂p rounds of pairwise
      R exchange and a 2n×n QR, the lower position's R stacked first, so
      that every position ends with the same R;
    * ``tree=False``: one gather of all p R factors and one p·n×n QR at
      every position;
    * ``tree=None``: the butterfly when p is a power of two and the
      gathered stack exceeds 4 MiB, as in the JAX package.

    Q is assembled on the first position's device, R is that position's.
    """
    a = as_array(A)
    if grid is None and isinstance(A, DistMatrix):
        grid = A.grid
    if grid is None or grid.size == 1:
        return qr(a)
    p = grid.size
    m, n = a.shape
    mb = -(-m // p)
    pow2 = (p & (p - 1)) == 0
    if tree is None:
        tree = pow2 and p * n * n * a.element_size() > (4 << 20)
    if tree and not pow2:
        raise ValueError(f"tree TSQR needs a power-of-two mesh, got p={p}")
    if mb < n:
        raise ValueError(f"TSQR needs row blocks at least as tall as wide: "
                         f"{m}×{n} over {p} positions")
    pos = grid.positions()
    dev = [grid.device(*ij) for ij in pos]
    a_p = torch.nn.functional.pad(a, (0, 0, 0, mb * p - m))
    q, r = zip(*(torch.linalg.qr(a_p[k * mb:(k + 1) * mb].to(dev[k]))
                 for k in range(p)))
    q = list(q)
    if tree:
        for lvl in range(p.bit_length() - 1):
            stride = 1 << lvl
            new_r = []
            for k in range(p):
                other = r[k ^ stride].to(dev[k])
                _record("collective-permute", other,
                        [(r[k ^ stride], pos[k ^ stride])], pos[k])
                half = (k >> lvl) & 1
                stack = torch.cat([r[k], other] if half == 0 else
                                  [other, r[k]])
                q1, rk = torch.linalg.qr(stack)
                q[k] = q[k] @ q1[half * n:(half + 1) * n]
                new_r.append(rk)
            r = new_r
    else:
        new_r = []
        for k in range(p):
            rs = torch.cat([rj.to(dev[k]) for rj in r])
            _record("all-gather", rs, zip(r, pos), pos[k])
            q1, rk = torch.linalg.qr(rs)
            q[k] = q[k] @ q1[k * n:(k + 1) * n]
            new_r.append(rk)
        r = new_r
    qall = torch.cat([qk.to(dev[0]) for qk in q])
    return QR(qall[:m], r[0])


@with_precision
def cholesky_qr(A: Arr, iterations: int = 2) -> QR:
    """CholeskyQR2 (reference ``QR/Cholesky.hpp``): Q·R via Gram-matrix
    Cholesky, iterated twice for stability."""
    a = as_array(A)
    q = a
    r_total = torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    for _ in range(iterations):
        g = torch.matmul(q.mH, q)
        rr = _adj(torch.tril(as_array(cholesky("L", g))))  # upper
        q = as_array(trsm("R", "U", "N", "N", 1, rr, q))
        r_total = rr @ r_total
    return QR(q, r_total)


@with_precision
def qr_pivoted(A: Arr) -> QRPivoted:
    """Column-pivoted (BusingerGolub) QR by a Householder loop (reference
    ``QR/BusingerGolub.hpp``): at step k the live column of largest norm
    (the first of equal ones, one host read) is swapped to k.  R comes from
    the reduced matrix, Q from applying the reflectors to I."""
    a = as_array(A).clone()
    m, n = a.shape
    steps = min(m, n)
    perm = torch.arange(n, device=a.device)
    taus = torch.zeros((steps,), dtype=a.dtype, device=a.device)
    vs = torch.zeros((steps, m), dtype=a.dtype, device=a.device)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for k in range(steps):
        norms = torch.sum(a[k:, k:].abs() ** 2, dim=0)
        j = k + int(torch.argmax(norms))
        _swap_cols(a, k, j)
        _swap_rows(perm, k, j)
        # Householder on column k, rows k: (phase-aligned for complex)
        x = a[k:, k]
        normx = torch.linalg.vector_norm(x)
        alpha = a[k, k]
        absa = alpha.abs()
        phase = torch.where(absa > 0,
                            alpha / torch.where(absa > 0, absa, 1.0), one)
        v = x.clone()
        v[0] += phase * normx
        vnorm2 = torch.sum(v.abs() ** 2)
        vnorm2 = torch.where(vnorm2 == 0, 1.0, vnorm2)
        tau = (2.0 / vnorm2).to(a.dtype)
        w = tau * (v.conj() @ a[k:])
        a[k:] -= torch.outer(v, w)
        taus[k] = tau
        vs[k, k:] = v
    r = torch.triu(a[:steps])
    # Q = H_0 · H_1 · … · H_{s−1} · I_{m×s}: apply reflectors in reverse
    q = torch.eye(m, steps, dtype=a.dtype, device=a.device)
    for k in reversed(range(steps)):
        v = vs[k]
        q = q - taus[k] * torch.outer(v, v.conj() @ q)
    return QRPivoted(q, r, perm)


def explicit_qr(A: Arr) -> QR:
    """Explicit unitary Q and triangular R (reference ``QR/Explicit.hpp``)."""
    return qr(A)


def lq(A: Arr) -> Tuple[torch.Tensor, torch.Tensor]:
    """LQ factorization A = L·Q (reference ``factor/LQ``) via QR of Aᴴ."""
    a = as_array(A)
    q, r = torch.linalg.qr(_adj(a), mode="reduced")
    return _adj(r), _adj(q)


def rq(A: Arr) -> Tuple[torch.Tensor, torch.Tensor]:
    """RQ factorization A = R·Q (reference ``factor/RQ``) via flipped LQ."""
    a = as_array(A)
    low, q = lq(a.flip(0))
    # a[::-1] = L Q ⇒ a = (L row-flipped) Q; make R upper by col-flip of L
    return low.flip(0, 1), q.flip(0)
