"""Condensed forms (counterpart of ``elemental_tpu/lapack/condense.py``;
reference ``src/lapack_like/condense``: HermitianTridiag, Bidiag,
Hessenberg + ApplyQ).

The JAX package's reductions, step for step: the rank-2 (tridiagonal) and
rank-1 (bidiagonal, Hessenberg) Householder loops, and the blocked panel
variants (LAPACK ``latrd``/``labrd``/``lahr2`` shapes: each panel column
reflected against the implicitly updated matrix, then one compact-WY
trailing update of a few matmuls).  The JAX ``fori_loop``s over the
columns are Python loops here; a column past the last reflector, which
the JAX loop masks to an exact no-op, is skipped.  Each reduction keeps
the JAX dispatch thresholds (blocked tridiagonalization at n ≥ 192,
blocked bidiagonalization for real n ≥ 192, blocked Hessenberg at
n ≥ 3072), so both packages run the same algorithm at each size.

The blocked tridiagonalization's column step multiplies the whole
untouched ``a`` by v and corrects it with the panel's V, W: the rows above
k are not zero and the trailing rank-2nb update needs them, so the
products stay full width.  The inner column loops are launch-bound (a few
vector operations a column); every matmul runs with TF32 off
(:func:`..ops.level3.with_precision`).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..core.distmatrix import DistMatrix, as_array
from ..ops.level3 import with_precision

Arr = Union[torch.Tensor, DistMatrix]


class Tridiag(NamedTuple):
    d: torch.Tensor        # main diagonal (real)
    e: torch.Tensor        # sub-diagonal (real)
    q: torch.Tensor        # accumulated unitary (A = Q T Qᴴ)


class Bidiag(NamedTuple):
    d: torch.Tensor
    e: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


class Hess(NamedTuple):
    h: torch.Tensor
    q: torch.Tensor


def _adj(x: torch.Tensor) -> torch.Tensor:
    return x.mH.resolve_conj()


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x[:, None] * y[None, :]


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(v) ** 2)


def _reflector(x: torch.Tensor, piv: int):
    """(v, τ) with (I − τ·v·vᴴ)·x = −phase(x_piv)·‖x‖·e_piv: v = x with
    phase·‖x‖ added at ``piv``, τ = 2/‖v‖² (0 for v = 0)."""
    normx = torch.linalg.vector_norm(x)
    pivot = x[piv]
    absp = torch.abs(pivot)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    phase = torch.where(absp == 0, one, pivot / absp)
    v = x.clone()
    v[piv] += phase * normx
    vn = _sq_norm(v)
    tau = torch.where(vn == 0, torch.zeros_like(vn),
                      2.0 / torch.where(vn == 0, torch.ones_like(vn), vn))
    return v, tau.to(x.dtype)


def _real_tridiag(a: torch.Tensor, q: torch.Tensor) -> Tridiag:
    """(d, e, Q) from the reduced ``a``; a complex sub-diagonal's phases go
    into a diagonal unitary D (D_{j+1} = φ_j·D_j, LAPACK ``zhetrd``'s
    convention) folded into Q's columns, so that e = |sub|."""
    d = torch.real(torch.diagonal(a)).contiguous()
    sub = torch.diagonal(a, -1)
    if a.is_complex():
        absd = torch.abs(sub)
        phases = torch.where(absd == 0, torch.ones_like(sub), sub / absd)
        dscale = torch.cat([torch.ones(1, dtype=a.dtype, device=a.device),
                            torch.cumprod(phases, 0)])
        return Tridiag(d, absd, q * dscale[None, :])
    return Tridiag(d, sub.contiguous(), q)


@with_precision
def hermitian_tridiag(uplo: str, A: Arr, want_q: bool = True,
                      blocksize: int = 32) -> Tridiag:
    """Reduce Hermitian A to real symmetric tridiagonal T = Qᴴ A Q
    (reference ``HermitianTridiag``).  The blocked panel variant for
    n ≥ 192; smaller problems use the rank-2 loop.  ``want_q`` is accepted
    and Q is always formed, as in the JAX package."""
    a0 = as_array(A)
    if a0.shape[0] >= 192:
        return _hermitian_tridiag_blocked(uplo, a0, nb=blocksize)
    a = a0 if uplo.upper().startswith("L") else _adj(a0)
    n = a.shape[0]
    q = torch.eye(n, dtype=a.dtype, device=a.device)
    for k in range(n - 2):
        x = torch.zeros_like(a[:, k])
        x[k + 1:] = a[k + 1:, k]
        v, tau = _reflector(x, k + 1)
        # similarity a ← (I − τ v vᴴ) a (I − τ v vᴴ) as a rank-2 update
        w = tau * (a @ v)
        w = w - (tau / 2) * torch.vdot(v, w) * v
        a = a - _outer(v, w.conj()) - _outer(w, v.conj())
        q = q - tau * _outer(q @ v, v.conj())
    return _real_tridiag(a, q)


def _wy_t(V: torch.Tensor, taus: torch.Tensor, nb: int) -> torch.Tensor:
    """Compact-WY T for H = H₀·H₁⋯ = I − V·T·Vᴴ:
    T⁻¹ = diag(1/τ) + strict_upper(VᴴV) (τ = 0 columns are exact
    no-ops)."""
    M = _adj(V) @ V
    one = torch.ones_like(taus)
    inv_t = torch.where(taus == 0, one, 1.0 / torch.where(taus == 0, one,
                                                           taus))
    Tinv = torch.triu(M, 1) + torch.diag(inv_t)
    eye = torch.eye(nb, dtype=V.dtype, device=V.device)
    return torch.linalg.solve_triangular(Tinv, eye, upper=True)


def _apply_panels(q: torch.Tensor, Vall: torch.Tensor, taus: torch.Tensor,
                  nb: int) -> torch.Tensor:
    """Q ← Q·H_p for each panel p in order, H_p = I − V_p·T_p·V_pᴴ."""
    for j0 in range(0, Vall.shape[1], nb):
        V = Vall[:, j0:j0 + nb]
        T = _wy_t(V, taus[j0:j0 + nb], nb)
        q = q - (q @ V) @ T @ _adj(V)
    return q


@with_precision
def _hermitian_tridiag_blocked(uplo: str, a: torch.Tensor,
                               nb: int = 32) -> Tridiag:
    """Blocked Householder tridiagonalization (reference
    ``HermitianTridiag.cpp:86-94`` panel algorithm, LAPACK ``latrd``
    shape): per nb-column panel, each column's reflector is computed
    against the implicitly updated A − V·Wᴴ − W·Vᴴ; the trailing similarity
    update is one rank-2nb matmul pair, and Q is formed at the end by
    compact-WY block reflectors (two matmuls a panel)."""
    if not uplo.upper().startswith("L"):
        a = _adj(a)
    n = a.shape[0]
    dtype, dev = a.dtype, a.device
    npan = max(1, -(-max(n - 2, 0) // nb))
    Vall = torch.zeros((n, npan * nb), dtype=dtype, device=dev)
    taus = torch.zeros(npan * nb, dtype=dtype, device=dev)
    for j0 in range(0, npan * nb, nb):
        V = torch.zeros((n, nb), dtype=dtype, device=dev)
        W = torch.zeros((n, nb), dtype=dtype, device=dev)
        for j in range(nb):
            k = j0 + j
            if k >= n - 2:          # τ = 0, v = w = 0 in the JAX loop
                break
            # implicit column k of A − VWᴴ − WVᴴ (rows > k)
            colk = a[:, k] - V @ W[k, :].conj() - W @ V[k, :].conj()
            x = torch.zeros_like(colk)
            x[k + 1:] = colk[k + 1:]
            v, tau = _reflector(x, k + 1)
            # w = τ·(A − VWᴴ − WVᴴ)·v, then the two-sided correction
            w = tau * (a @ v - V @ (_adj(W) @ v) - W @ (_adj(V) @ v))
            w = w - (tau / 2) * torch.vdot(v, w) * v
            V[:, j] = v
            W[:, j] = w
            Vall[:, k] = v
            taus[k] = tau
        # the trailing rank-2nb similarity update
        a = a - V @ _adj(W) - W @ _adj(V)
    q = _apply_panels(torch.eye(n, dtype=dtype, device=dev), Vall, taus, nb)
    return _real_tridiag(a, q)


def _seq_apply(P, taus, w, upto: int):
    """w ← (Π_{j<upto} (I − τ_j p_j p_jᴴ))ᴴ·w, H₀ᴴ first."""
    for j in range(upto):
        pj = P[:, j]
        w = w - taus[j].conj() * pj * torch.vdot(pj, w)
    return w


def _seq_apply_rev(P, taus, w, upto: int):
    """w ← H₀·H₁⋯H_{upto−1}·w (the last reflector first), with the
    coefficients c of w_out = w_in − P·c."""
    c = torch.zeros(P.shape[1], dtype=P.dtype, device=P.device)
    for j in range(upto - 1, -1, -1):
        pj = P[:, j]
        alpha = taus[j] * torch.vdot(pj, w)
        w = w - alpha * pj
        c[j] = alpha            # each j once: c[j] = 0 + alpha
    return w, c


def _unit(n: int, i: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros(n, dtype=like.dtype, device=like.device)
    e[i] = 1.0
    return e


@with_precision
def _bidiag_blocked(a: torch.Tensor, nb: int = 32) -> Bidiag:
    """Blocked upper bidiagonalization (reference ``Bidiag/`` panel
    algorithm; LAPACK ``gebrd``/``labrd`` shape): per nb-panel each
    column/row of the implicit Ã = Uᴴ·A·V is rebuilt from the panel's
    reflectors (two fresh matvecs a column), and the two-sided trailing
    update is applied as compact-WY matmuls on both sides:
        A ← A − Uq·Tqᴴ·(Uqᴴ·A) − (A·Vp)·Tp·Vpᴴ + Uq·Tqᴴ·(Uqᴴ·A·Vp)·Tp·Vpᴴ.
    """
    m, n = a.shape
    dtype, dev = a.dtype, a.device
    npan = -(-n // nb)
    Uall = torch.zeros((m, npan * nb), dtype=dtype, device=dev)
    Vall = torch.zeros((n, npan * nb), dtype=dtype, device=dev)
    tq_all = torch.zeros(npan * nb, dtype=dtype, device=dev)
    tp_all = torch.zeros(npan * nb, dtype=dtype, device=dev)
    for j0 in range(0, npan * nb, nb):
        Uq = torch.zeros((m, nb), dtype=dtype, device=dev)
        Vp = torch.zeros((n, nb), dtype=dtype, device=dev)
        Ya = torch.zeros((m, nb), dtype=dtype, device=dev)     # A·Vp
        tq = torch.zeros(nb, dtype=dtype, device=dev)
        tp = torch.zeros(nb, dtype=dtype, device=dev)
        for jj in range(nb):
            k = j0 + jj
            if k >= n:              # all-zero reflectors in the JAX loop
                break
            # column k of Ã = Uᴴ·A·V: A·(V·e_k) = a_k − (A·Vp)·c
            _, c = _seq_apply_rev(Vp, tp, _unit(n, k, a), jj)
            t = a[:, k] - Ya @ c
            colk = _seq_apply(Uq, tq, t, jj)
            x = torch.zeros_like(colk)
            x[k:] = colk[k:]
            u_k, tauq = _reflector(x, min(k, m - 1))
            Uq[:, jj] = u_k
            tq[jj] = tauq
            if k >= n - 2:          # no right reflector: v = 0, τ = 0
                continue
            # row k of H_ukᴴ·Ã, the right reflector's source
            ue, _ = _seq_apply_rev(Uq, tq, _unit(m, k, a), jj + 1)
            s = _adj(a) @ ue
            rowk = _seq_apply(Vp, tp, s, jj).conj()
            xr = torch.zeros_like(rowk)
            xr[k + 1:] = rowk[k + 1:].conj()
            v_k, taup = _reflector(xr, k + 1)
            Vp[:, jj] = v_k
            tp[jj] = taup
            Ya[:, jj] = a @ v_k
        # the two-sided compact-WY trailing update
        Tq = _wy_t(Uq, tq, nb)
        Tp = _wy_t(Vp, tp, nb)
        UhA = _adj(Uq) @ a
        a = a - Uq @ (_adj(Tq) @ UhA)                            # left
        AV = Ya - Uq @ (_adj(Tq) @ (_adj(Uq) @ Ya))
        a = a - AV @ (Tp @ _adj(Vp))                             # right
        Uall[:, j0:j0 + nb] = Uq
        Vall[:, j0:j0 + nb] = Vp
        tq_all[j0:j0 + nb] = tq
        tp_all[j0:j0 + nb] = tp
    u = _apply_panels(torch.eye(m, dtype=dtype, device=dev), Uall, tq_all, nb)
    v = _apply_panels(torch.eye(n, dtype=dtype, device=dev), Vall, tp_all, nb)
    # the blocked path is dispatched for real dtypes only
    d = torch.diagonal(a)[:n]
    e = torch.diagonal(a, 1)[:max(n - 1, 0)]
    return Bidiag(torch.real(d).contiguous(), torch.real(e).contiguous(),
                  u, v)


@with_precision
def bidiag(A: Arr, blocksize: int = 32) -> Bidiag:
    """Reduce A (m ≥ n) to upper bidiagonal B = Uᴴ A V (reference
    ``Bidiag``).  ``blocksize > 0`` with real n ≥ 192 takes the blocked
    panel variant (``blocksize=0`` forces the rank-1 loop).  As in the JAX
    package, d and e are the real parts of the reduced diagonals."""
    a0 = as_array(A)
    if a0.shape[1] >= 192 and blocksize > 0 and not a0.is_complex():
        return _bidiag_blocked(a0, nb=blocksize)
    a = a0
    m, n = a.shape
    u = torch.eye(m, dtype=a.dtype, device=a.device)
    v = torch.eye(n, dtype=a.dtype, device=a.device)
    for k in range(n):
        x = torch.zeros_like(a[:, k])
        x[k:] = a[k:, k]
        w, tau = _reflector(x, k)
        a = a - tau * _outer(w, w.conj() @ a)
        u = u - tau * _outer(u @ w, w.conj())
        if k < n - 2:
            x = torch.zeros_like(a[k, :])
            x[k + 1:] = a[k, k + 1:].conj()
            w, tau = _reflector(x, k + 1)
            a = a - tau * _outer(a @ w.conj(), w)
            v = v - tau * _outer(v @ w.conj(), w)
    return Bidiag(torch.real(torch.diagonal(a)).contiguous(),
                  torch.real(torch.diagonal(a, 1)).contiguous(), u, v)


@with_precision
def _hessenberg_blocked(a: torch.Tensor, nb: int = 32) -> Hess:
    """Blocked Hessenberg reduction (reference ``Hessenberg`` panel
    variant; LAPACK ``gehrd``/``lahr2`` shape): per nb-panel the reflectors
    are formed against the implicit Ã = Hᴴ·A·H (each column rebuilt from
    the caches V and Y = A·V, one fresh matvec a column), then the
    two-sided update is four matmuls through H = I − V·T·Vᴴ:
        A ← A − V·Tᴴ·(Vᴴ·A) − Y·T·Vᴴ + V·Tᴴ·(Vᴴ·Y)·T·Vᴴ.
    """
    n = a.shape[0]
    dtype, dev = a.dtype, a.device
    q = torch.eye(n, dtype=dtype, device=dev)
    if n <= 2:
        return Hess(a, q)
    npan = -(-(n - 2) // nb)
    Vall = torch.zeros((n, npan * nb), dtype=dtype, device=dev)
    taus_all = torch.zeros(npan * nb, dtype=dtype, device=dev)
    for j0 in range(0, npan * nb, nb):
        V = torch.zeros((n, nb), dtype=dtype, device=dev)
        Y = torch.zeros((n, nb), dtype=dtype, device=dev)       # Y = A·V
        taus = torch.zeros(nb, dtype=dtype, device=dev)
        for jj in range(nb):
            k = j0 + jj
            if k >= n - 2:          # v = 0, τ = 0 in the JAX loop
                break
            # u = H·e_k = e_k − V·c; t = A·u = a_k − Y·c (A is unchanged
            # within the panel); w = Hᴴ·t
            _, c = _seq_apply_rev(V, taus, _unit(n, k, a), jj)
            t = a[:, k] - Y @ c
            w = _seq_apply(V, taus, t, jj)
            x = torch.zeros_like(w)
            x[k + 1:] = w[k + 1:]
            v, tau = _reflector(x, k + 1)
            V[:, jj] = v
            Y[:, jj] = a @ v                # the one fresh matvec
            taus[jj] = tau
        T = _wy_t(V, taus, nb)
        VhA = _adj(V) @ a
        a = a - V @ (_adj(T) @ VhA)                       # left:  Hᴴ·A
        AV = Y - V @ (_adj(T) @ (_adj(V) @ Y))            # Hᴴ·A·V
        a = a - AV @ (T @ _adj(V))                        # right: (Hᴴ·A)·H
        Vall[:, j0:j0 + nb] = V
        taus_all[j0:j0 + nb] = taus
    q = _apply_panels(q, Vall, taus_all, nb)
    # mask the reduction's roundoff below the subdiagonal
    return Hess(torch.triu(a, -1), q)


@with_precision
def hessenberg(uplo: str, A: Arr, blocksize: int = 32) -> Hess:
    """Reduce A to upper Hessenberg H = Qᴴ A Q (reference ``Hessenberg``).
    The blocked panel variant at n ≥ 3072 (the JAX package's threshold;
    ``blocksize=0`` forces the rank-1 loop)."""
    a0 = as_array(A)
    if a0.shape[0] >= 3072 and blocksize > 0:
        return _hessenberg_blocked(a0, nb=blocksize)
    a = a0
    n = a.shape[0]
    q = torch.eye(n, dtype=a.dtype, device=a.device)
    for k in range(n - 2):
        x = torch.zeros_like(a[:, k])
        x[k + 1:] = a[k + 1:, k]
        v, tau = _reflector(x, k + 1)
        a = a - tau * _outer(v, v.conj() @ a)          # left
        a = a - tau * _outer(a @ v, v.conj())          # right
        q = q - tau * _outer(q @ v, v.conj())
    return Hess(a, q)
