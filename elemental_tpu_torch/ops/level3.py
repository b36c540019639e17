"""BLAS-like level 3 (counterpart of ``elemental_tpu/ops/level3.py``;
reference ``src/blas_like/level3``): Gemm (SUMMA), Symm/Hemm,
Herk/Syrk/Her2k/Syr2k, Trrk/Trr2k, Trmm, Trsm, MultiShiftTrsm,
TwoSidedTrsm/Trmm, QuasiTrsm.

  * Gemm — one ``torch.matmul``, or the explicit SUMMA variants of
    :mod:`.summa` on a grid of more than one position, chosen by the size
    heuristic of ``Gemm/NN.hpp:582-599`` as in the JAX package.
  * Trsm — the JAX package's recursive blocked split at the midpoint
    (``_MIN_RECURSIVE``), with ``torch.linalg.solve_triangular`` as the base
    case.
  * rank-k updates (Herk/Syrk/Trrk) — the full product, then the reference's
    triangular mask.

Every product is ``torch.matmul`` (cuBLAS on the card); no kernel of the
port is reached.  Precision: 'highest' (the default) runs each op with TF32
off and restores the caller's setting afterwards, so float32 products are
true float32; 'high' and 'default' allow TF32.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Union

import torch

from ..core.distmatrix import DistMatrix, as_array, grid_of, like
from . import summa

Arr = Union[torch.Tensor, DistMatrix]

_MIN_RECURSIVE = 256  # below this, call torch.linalg.solve_triangular directly

_PRECISIONS = ("highest", "high", "default")
_matmul_precision = "highest"


def set_matmul_precision(p: str) -> None:
    """'highest' (default; true float32 everywhere), 'high', or 'default'
    (both allow TF32 on the card)."""
    global _matmul_precision
    if p not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {p!r}")
    _matmul_precision = p


@contextlib.contextmanager
def _tf32(allow: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def with_precision(fn):
    """Run an op under the library's matmul precision: TF32 off for
    'highest', on otherwise; the caller's setting is restored after."""
    @functools.wraps(fn)
    def wrapper(*a, **k):
        with _tf32(_matmul_precision != "highest"):
            return fn(*a, **k)
    return wrapper


def _orient(X: torch.Tensor, orientation: str) -> torch.Tensor:
    o = orientation.upper()[0]
    if o == "N":
        return X
    if o == "T":
        return X.T
    if o in ("C", "A"):  # conjugate-transpose / adjoint
        return X.conj().T
    raise ValueError(f"bad orientation {orientation!r}")


def _common(*xs: torch.Tensor):
    """The operands in their promoted dtype (JAX promotes mixed operands;
    torch's matmul does not)."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return tuple(x.to(dt) for x in xs)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _common(a, b)
    return torch.matmul(a, b)


def _mask_tri(x: torch.Tensor, uplo: str) -> torch.Tensor:
    return torch.tril(x) if uplo.upper().startswith("L") else torch.triu(x)


def _unit_diag(tri: torch.Tensor) -> torch.Tensor:
    return (tri - torch.diag(torch.diagonal(tri))
            + torch.eye(tri.shape[0], dtype=tri.dtype, device=tri.device))


@with_precision
def gemm(orientA: str, orientB: str, alpha, A: Arr, B: Arr,
         beta=None, C: Optional[Arr] = None, alg: str = "auto") -> Arr:
    """C := α·op(A)·op(B) + β·C (reference ``Gemm``, ``Gemm.cpp:274``)."""
    a, b = _common(_orient(as_array(A), orientA),
                   _orient(as_array(B), orientB))
    grid = grid_of(A, B, C)
    m, k = a.shape
    n = b.shape[1]
    if alg == "auto":
        alg = (summa.choose_algorithm(m, n, k, grid)
               if grid is not None and grid.size > 1 else "xla")
    if alg == "xla" or grid is None or grid.size == 1:
        prod = summa.gemm_xla(a, b, grid)
    else:
        prod = summa.gemm_summa(a, b, grid, alg)
    out = prod if isinstance(alpha, (int, float)) and alpha == 1 \
        else alpha * prod
    if C is not None:
        out = out + (beta if beta is not None else 1) * as_array(C)
        return like(C, out)
    template = A if isinstance(A, DistMatrix) else B
    return like(template, out)


@with_precision
def symm(side: str, uplo: str, alpha, A: Arr, B: Arr, beta=0,
         C: Optional[Arr] = None, conjugate: bool = False) -> Arr:
    """C := α·A·B + β·C with A symmetric/Hermitian stored in one triangle
    (reference ``Symm``/``Hemm``)."""
    a = as_array(A)
    tri = _mask_tri(a, uplo)
    opp = tri.conj().T if conjugate else tri.T
    d = torch.real(torch.diagonal(a)) if conjugate else torch.diagonal(a)
    full = tri + opp - torch.diag(d.to(a.dtype))
    b = as_array(B)
    prod = _mm(full, b) if side.upper().startswith("L") else _mm(b, full)
    out = alpha * prod + (beta * as_array(C) if C is not None else 0)
    return like(C if C is not None else B, out)


def hemm(side: str, uplo: str, alpha, A: Arr, B: Arr, beta=0,
         C: Optional[Arr] = None) -> Arr:
    return symm(side, uplo, alpha, A, B, beta, C, conjugate=True)


@with_precision
def herk(uplo: str, orient: str, alpha, A: Arr, beta=0,
         C: Optional[Arr] = None) -> Arr:
    """C := α·op(A)·op(A)ᴴ + β·C, one triangle kept (reference ``Herk``)."""
    a = as_array(A)
    op = a if orient.upper().startswith("N") else a.conj().T
    prod = torch.matmul(op, op.conj().T)
    out = alpha * prod + (beta * as_array(C) if C is not None else 0)
    return like(C if C is not None else A, _mask_tri(out, uplo))


@with_precision
def syrk(uplo: str, orient: str, alpha, A: Arr, beta=0,
         C: Optional[Arr] = None) -> Arr:
    a = as_array(A)
    op = a if orient.upper().startswith("N") else a.T
    prod = torch.matmul(op, op.T)
    out = alpha * prod + (beta * as_array(C) if C is not None else 0)
    return like(C if C is not None else A, _mask_tri(out, uplo))


@with_precision
def her2k(uplo: str, orient: str, alpha, A: Arr, B: Arr, beta=0,
          C: Optional[Arr] = None) -> Arr:
    a, b = _common(as_array(A), as_array(B))
    calpha = (alpha.conj() if isinstance(alpha, torch.Tensor)
              else alpha.conjugate())
    if orient.upper().startswith("N"):
        prod = alpha * (a @ b.conj().T) + calpha * (b @ a.conj().T)
    else:
        prod = alpha * (a.conj().T @ b) + calpha * (b.conj().T @ a)
    out = prod + (beta * as_array(C) if C is not None else 0)
    return like(C if C is not None else A, _mask_tri(out, uplo))


@with_precision
def syr2k(uplo: str, orient: str, alpha, A: Arr, B: Arr, beta=0,
          C: Optional[Arr] = None) -> Arr:
    a, b = _common(as_array(A), as_array(B))
    if orient.upper().startswith("N"):
        prod = alpha * (a @ b.T + b @ a.T)
    else:
        prod = alpha * (a.T @ b + b.T @ a)
    out = prod + (beta * as_array(C) if C is not None else 0)
    return like(C if C is not None else A, _mask_tri(out, uplo))


@with_precision
def trrk(uplo: str, orientA: str, orientB: str, alpha, A: Arr, B: Arr,
         beta, C: Arr) -> Arr:
    """Triangular rank-k: one triangle of C := α·op(A)op(B) + β·C
    (reference ``Trrk`` — the Cholesky/LDL trailing-update kernel)."""
    a = _orient(as_array(A), orientA)
    b = _orient(as_array(B), orientB)
    c = as_array(C)
    prod = _mm(a, b)
    upd = _mask_tri(alpha * prod, uplo) + beta * c
    # preserve the untouched triangle of C
    if uplo.upper().startswith("L"):
        out = torch.tril(upd) + torch.triu(c, 1)
    else:
        out = torch.triu(upd) + torch.tril(c, -1)
    return like(C, out)


@with_precision
def trr2k(uplo: str, oA: str, oB: str, oC: str, oD: str, alpha, A: Arr,
          B: Arr, beta, C: Arr, D: Arr, gamma, E: Arr) -> Arr:
    a = _orient(as_array(A), oA)
    b = _orient(as_array(B), oB)
    c = _orient(as_array(C), oC)
    d = _orient(as_array(D), oD)
    e = as_array(E)
    prod = alpha * _mm(a, b) + beta * _mm(c, d)
    # update the named triangle; leave the other untouched
    if uplo.upper().startswith("L"):
        out = torch.tril(prod + gamma * e) + torch.triu(e, 1)
    else:
        out = torch.triu(prod + gamma * e) + torch.tril(e, -1)
    return like(E, out)


@with_precision
def trmm(side: str, uplo: str, orient: str, diag: str, alpha, A: Arr,
         B: Arr) -> Arr:
    """B := α·op(tri(A))·B or α·B·op(tri(A)) (reference ``Trmm``)."""
    tri = _mask_tri(as_array(A), uplo)
    if diag.upper().startswith("U"):  # unit diagonal
        tri = _unit_diag(tri)
    op = _orient(tri, orient)
    b = as_array(B)
    out = alpha * (_mm(op, b) if side.upper().startswith("L")
                   else _mm(b, op))
    return like(B, out)


# -- triangular solve -------------------------------------------------------

def _trsm_base(a, b, left, lower, trans_a, conj_a, unit):
    """Solve op(tri(a))·x = b (left) or x·op(tri(a)) = b, op = transpose
    and/or conjugate as ``jax.lax.linalg.triangular_solve`` takes them."""
    if trans_a:
        a, lower = a.T, not lower
    if conj_a:
        a = a.conj()
    a, b = _common(a, b)
    if b.ndim == 1:   # a vector, as jax.lax.linalg.triangular_solve takes it
        col = b[:, None] if left else b[None, :]
        return _trsm_base(a, col, left, lower, False, False, unit) \
            .reshape(-1)
    return torch.linalg.solve_triangular(a, b, upper=not lower, left=left,
                                         unitriangular=unit)


def _trsm_rec(a, b, left, lower, trans_a, conj_a, unit):
    """Recursive blocked triangular solve: the midpoint split turns half the
    flops into matmuls (the reference's Large-variant dispatch,
    ``Trsm.cpp:184-233``)."""
    n = a.shape[0]
    if n <= _MIN_RECURSIVE:
        return _trsm_base(a, b, left, lower, trans_a, conj_a, unit)
    m = n // 2
    A11, A21, A12, A22 = a[:m, :m], a[m:, :m], a[:m, m:], a[m:, m:]

    def opx(x):
        if trans_a:
            x = x.T
        if conj_a:
            x = x.conj()
        return x

    # Effective blocks of op(tri(A)); the stored off-diagonal block is A21 for
    # LOWER and A12 for UPPER, and transposition moves it across the diagonal.
    eff_lower = lower != trans_a
    if eff_lower:
        eff21 = A21 if not trans_a else opx(A12)
    else:
        eff12 = A12 if not trans_a else opx(A21)

    def rec(ablk, bblk):
        return _trsm_rec(ablk, bblk, left, lower, trans_a, conj_a, unit)

    if left:
        B1, B2 = b[:m], b[m:]
        if eff_lower:
            X1 = rec(A11, B1)
            X2 = rec(A22, B2 - _mm(eff21, X1))
        else:
            X2 = rec(A22, B2)
            X1 = rec(A11, B1 - _mm(eff12, X2))
        return torch.cat([X1, X2], dim=0)
    B1, B2 = b[:, :m], b[:, m:]
    if eff_lower:
        X2 = rec(A22, B2)
        X1 = rec(A11, B1 - _mm(X2, eff21))
    else:
        X1 = rec(A11, B1)
        X2 = rec(A22, B2 - _mm(X1, eff12))
    return torch.cat([X1, X2], dim=1)


def _trsm_flags(uplo: str, orient: str):
    lower = uplo.upper().startswith("L")
    o = orient.upper()[0]
    return lower, o in ("T", "C", "A"), o in ("C", "A")


@with_precision
def trsm(side: str, uplo: str, orient: str, diag: str, alpha, A: Arr,
         B: Arr) -> Arr:
    """Solve op(tri(A))·X = α·B (LEFT) or X·op(tri(A)) = α·B (RIGHT)."""
    a = as_array(A)
    b = alpha * as_array(B)
    lower, trans_a, conj_a = _trsm_flags(uplo, orient)
    x = _trsm_rec(a, b, side.upper().startswith("L"), lower, trans_a, conj_a,
                  diag.upper().startswith("U"))
    return like(B, x)


@with_precision
def multishift_trsm(side: str, uplo: str, orient: str, alpha, A: Arr,
                    shifts, B: Arr) -> Arr:
    """Solve (op(tri(A)) − σ_j I)·x_j = α·b_j for each column j (reference
    ``MultiShiftTrsm`` — the Pseudospectra/TriangEig workhorse), as one
    batched triangular solve over the shifts (the JAX package's ``vmap``).
    Like the JAX function, it solves from the left whatever ``side``."""
    a = as_array(A)
    b = alpha * as_array(B)
    shifts = torch.as_tensor(shifts).to(a.device)
    lower, trans_a, conj_a = _trsm_flags(uplo, orient)
    # op(a − σ'I) = op(a) − σI requires σ' = conj(σ) when op conjugates
    sig = shifts.conj() if conj_a else shifts
    a, b, sig = _common(a, b, sig)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    shifted = a[None] - sig[:, None, None] * eye
    if trans_a:
        shifted, lower = shifted.mT, not lower
    if conj_a:
        shifted = shifted.conj()
    x = torch.linalg.solve_triangular(shifted, b.T[:, :, None],
                                      upper=not lower)
    return like(B, x[:, :, 0].T)


def quasi_trsm(side: str, uplo: str, orient: str, alpha, A: Arr,
               B: Arr) -> Arr:
    """Solve against a quasi-triangular matrix (1x1/2x2 diagonal blocks, real
    Schur form).  Dense path, as in the JAX package: a general solve with
    the masked quasi-triangle, from the left whatever ``side``."""
    a = as_array(A)
    ones = torch.ones_like(a)
    lower = uplo.upper().startswith("L")
    mask = torch.tril(ones, 1) if lower else torch.triu(ones, -1)
    op = _orient(a * mask, orient)
    b = alpha * as_array(B)
    op, b = _common(op, b)
    return like(B, torch.linalg.solve(op, b))


@with_precision
def twosided_trsm(uplo: str, diag: str, A: Arr, B: Arr,
                  conjugate: bool = True) -> Arr:
    """A := L⁻¹ A L⁻ᴴ (LOWER) or U⁻ᴴ A U⁻¹ — reduction of a Hermitian
    generalized eigenproblem to standard form (reference ``TwoSidedTrsm``)."""
    a = as_array(A)
    l = as_array(B)
    adj = "C" if conjugate else "T"
    if uplo.upper().startswith("L"):
        tmp = trsm("L", uplo, "N", diag, 1, l, a)
        out = trsm("R", uplo, adj, diag, 1, l, tmp)
    else:
        tmp = trsm("L", uplo, adj, diag, 1, l, a)
        out = trsm("R", uplo, "N", diag, 1, l, tmp)
    return like(A, as_array(out))


@with_precision
def twosided_trmm(uplo: str, diag: str, A: Arr, B: Arr,
                  conjugate: bool = True) -> Arr:
    """A := Lᴴ A L (LOWER) or U A Uᴴ (reference ``TwoSidedTrmm``)."""
    a = as_array(A)
    l = _mask_tri(as_array(B), uplo)
    if diag.upper().startswith("U"):
        l = _unit_diag(l)
    adj = l.conj().T if conjugate else l.T
    if uplo.upper().startswith("L"):
        out = _mm(_mm(adj, a), l)
    else:
        out = _mm(_mm(l, a), adj)
    return like(A, out)


@with_precision
def hermitian_from_evd(uplo: str, w, Z: Arr) -> Arr:
    """A := Z·diag(w)·Zᴴ (reference ``HermitianFromEVD``)."""
    z = as_array(Z)
    w = torch.as_tensor(w).to(z.device, z.dtype)
    a = torch.matmul(z * w[None, :], z.conj().T)
    return like(Z, _mask_tri(a, uplo) if uplo else a)


@with_precision
def normal_from_evd(w, Z: Arr) -> Arr:
    """A := Z·diag(w)·Zᴴ with complex w (reference ``NormalFromEVD``)."""
    z = as_array(Z)
    w = torch.as_tensor(w).to(z.device)
    zw, zh = _common(z * w[None, :], z.conj().T)
    return like(Z, torch.matmul(zw, zh))


def safe_multishift_trsm(side: str, uplo: str, orient: str, alpha, A: Arr,
                         shifts, B: Arr):
    """Overflow-guarded multishift triangular solve (reference
    ``SafeMultiShiftTrsm`` — the eigenvector back-substitution used by
    ``TriangEig``): solves (op(tri(A)) − σ_j I)·x_j = s_j·α·b_j where each
    column's scale s_j ≤ 1 keeps the solution representable.  Returns
    ``(X, scales)``.  As in the JAX package: solve once, then derive each
    column's scale from the solution's magnitude."""
    x = multishift_trsm(side, uplo, orient, alpha, A, shifts, B)
    xa = as_array(x)
    rdt = xa.real.dtype
    big = torch.tensor(torch.finfo(rdt).max, dtype=rdt) ** 0.5
    colmax = torch.amax(torch.abs(xa), dim=0)
    finite = torch.isfinite(colmax)
    one = torch.ones((), dtype=rdt, device=xa.device)
    scales = torch.where(finite & (colmax > big), big / colmax, one)
    scales = torch.where(finite, scales, torch.zeros_like(one))
    safe = torch.where(torch.isfinite(xa), xa, torch.zeros_like(xa)) \
        * scales[None, :]
    return like(B, safe), scales
