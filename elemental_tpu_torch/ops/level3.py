"""BLAS-like level 3 (counterpart of ``elemental_tpu/ops/level3.py``;
reference ``src/blas_like/level3``): Gemm (SUMMA), Symm/Hemm,
Herk/Syrk/Her2k/Syr2k, Trrk/Trr2k, Trmm, Trsm, MultiShiftTrsm,
TwoSidedTrsm/Trmm, QuasiTrsm.

  * Gemm — one ``torch.matmul`` of local operands; on distributed ones
    the SUMMA variants of :mod:`.summa` on their blocks, chosen by the
    size heuristic of ``Gemm/NN.hpp:582-599`` as in the JAX package.
  * Symm/Hemm, the rank-k updates (Herk/Syrk/Her2k/Syr2k/Trrk/Trr2k),
    Trmm, TwoSidedTrmm and the EVD products — the same block product of
    relabelled (transposed) operands, the triangle masked block by block
    by global indices, as the reference masks the full product.
  * Trsm, MultiShiftTrsm, QuasiTrsm, TwoSidedTrsm — the operands
    assembled at the grid's first position (recorded), as the JAX HLO
    gathers them whole; Trsm is the JAX package's recursive blocked split
    at the midpoint (``_MIN_RECURSIVE``), with
    ``torch.linalg.solve_triangular`` as the base case.

Every product is ``torch.matmul`` (cuBLAS on the card); no kernel of the
port is reached.  Precision: 'highest' (the default) runs each op with TF32
off and restores the caller's setting afterwards, so float32 products are
true float32; 'high' and 'default' allow TF32.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix, as_array, grid_of, like, \
    vector_piece
from ..core.policy import tf32
from . import summa
from ._blocks import diag_offset, each, tri, vec

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


def with_precision(fn):
    """Run an op under the library's matmul precision: TF32 off for
    'highest', on otherwise; the caller's setting is restored after."""
    @functools.wraps(fn)
    def wrapper(*a, **k):
        with tf32(_matmul_precision != "highest"):
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


def _dist(X, grid) -> DistMatrix:
    """X on ``grid``: a DistMatrix as it is, a local array cut [MC,MR]
    (unrecorded, as :func:`~..core.distmatrix.distribute` cuts it)."""
    if isinstance(X, DistMatrix):
        return X
    return DistMatrix._from_whole(as_array(X), MC, MR, grid, 0, warn=False)


def _op(X: Arr, orientation: str) -> Arr:
    """op(X): a relabelled DistMatrix (``transpose``/``adjoint``, no copy
    between positions), or the oriented tensor."""
    if not isinstance(X, DistMatrix):
        return _orient(as_array(X), orientation)
    o = orientation.upper()[0]
    if o == "N":
        return X
    if o == "T":
        return X.transpose()
    if o in ("C", "A"):
        return X.adjoint()
    raise ValueError(f"bad orientation {orientation!r}")


def _product(a: Arr, b: Arr, alg: str = "auto") -> Arr:
    """a·b in their promoted dtype: one ``torch.matmul`` of local
    operands; on a grid, SUMMA on the blocks (:func:`.summa.summa_dist`),
    the variant chosen by the size heuristic for ``auto``."""
    grid = grid_of(a, b)
    if grid is None:
        return _mm(a, b)
    a, b = _dist(a, grid), _dist(b, grid)
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.astype(dt), b.astype(dt)
    if alg == "auto":
        alg = (summa.choose_algorithm(a.shape[0], b.shape[1], a.shape[1],
                                      grid) if grid.size > 1 else "xla")
    return summa.summa_dist(a, b, alg)


def _result(P: Arr, T: Arr) -> Arr:
    """P with the template T's distribution: relaid out (recorded) where
    its layout differs, or assembled where T is local."""
    if not isinstance(P, DistMatrix):
        return like(T, P)
    if not isinstance(T, DistMatrix):
        return as_array(P)
    if P.grid is T.grid and P.dist() == T.dist():
        return P
    return P._relayout(T.grid, T.coldist, T.rowdist, warn=False)


def _combine(fn, P: Arr, T: Arr, *others) -> Arr:
    """fn(at, p, *o) blockwise on P laid out as T (the others too), or on
    the tensors."""
    return each(fn, _result(P, T), *others)


def _lower(uplo: str) -> bool:
    return uplo.upper().startswith("L")


def _triangle(A: Arr, uplo: str, unit: bool = False) -> Arr:
    """tri(A), with a unit diagonal if ``unit``, block by block."""
    def block(at, a):
        t = tri(a, at, _lower(uplo))
        if unit:
            loc, _ = diag_offset(at)
            torch.diagonal(t, loc).fill_(1)
        return t
    return each(block, A)


def _mirror(T: Arr, conjugate: bool) -> Arr:
    """Tᴴ (Tᵀ) in T's own layout: relabelled, then redistributed."""
    return _result(_op(T, "C" if conjugate else "T"), T)


def _full(A: Arr, uplo: str, conjugate: bool) -> Arr:
    """tri + oppᵀ − diag: the whole symmetric/Hermitian matrix from its
    stored triangle, block by block."""
    T = _triangle(A, uplo)

    def block(at, t, o):
        out = t + o
        loc, _ = diag_offset(at)
        d = torch.diagonal(t, loc)
        torch.diagonal(out, loc).sub_(
            (torch.real(d) if conjugate else d).to(out.dtype))
        return out
    return each(block, T, _mirror(T, conjugate))


@with_precision
def gemm(orientA: str, orientB: str, alpha, A: Arr, B: Arr,
         beta=None, C: Optional[Arr] = None, alg: str = "auto") -> Arr:
    """C := α·op(A)·op(B) + β·C (reference ``Gemm``, ``Gemm.cpp:274``):
    one ``torch.matmul`` of local operands, SUMMA on the blocks of
    distributed ones (``alg``: a variant of :mod:`.summa`, or ``auto``, the
    size heuristic of ``Gemm/NN.hpp:582-599``)."""
    P = _product(_op(A, orientA), _op(B, orientB), alg)
    scaled = not (isinstance(alpha, (int, float)) and alpha == 1)
    if C is not None:
        b = beta if beta is not None else 1
        return _combine(lambda _, p, c: (alpha * p if scaled else p) + b * c,
                        P, C, C)
    template = A if isinstance(A, DistMatrix) else B
    return _combine(lambda _, p: alpha * p if scaled else p, P, template)


def _plus_beta(alpha, P: Arr, beta, C: Optional[Arr], T: Arr) -> Arr:
    """α·P + β·C (α·P without C) laid out as C, else as T."""
    if C is None:
        return _combine(lambda _, p: alpha * p, P, T)
    return _combine(lambda _, p, c: alpha * p + beta * c, P, C, C)


@with_precision
def symm(side: str, uplo: str, alpha, A: Arr, B: Arr, beta=0,
         C: Optional[Arr] = None, conjugate: bool = False) -> Arr:
    """C := α·A·B + β·C with A symmetric/Hermitian stored in one triangle
    (reference ``Symm``/``Hemm``): the whole A built block by block from
    its triangle and the mirrored triangle, then the block product."""
    full = _full(A, uplo, conjugate)
    P = (_product(full, B) if side.upper().startswith("L")
         else _product(B, full))
    return _plus_beta(alpha, P, beta, C, B)


def hemm(side: str, uplo: str, alpha, A: Arr, B: Arr, beta=0,
         C: Optional[Arr] = None) -> Arr:
    return symm(side, uplo, alpha, A, B, beta, C, conjugate=True)


def _masked(uplo: str, out: Arr) -> Arr:
    return each(lambda at, o: tri(o, at, _lower(uplo)), out)


@with_precision
def herk(uplo: str, orient: str, alpha, A: Arr, beta=0,
         C: Optional[Arr] = None) -> Arr:
    """C := α·op(A)·op(A)ᴴ + β·C, one triangle kept (reference ``Herk``)."""
    op = _op(A, "N" if orient.upper().startswith("N") else "C")
    P = _product(op, _op(op, "C"))
    return _masked(uplo, _plus_beta(alpha, P, beta, C, A))


@with_precision
def syrk(uplo: str, orient: str, alpha, A: Arr, beta=0,
         C: Optional[Arr] = None) -> Arr:
    op = _op(A, "N" if orient.upper().startswith("N") else "T")
    P = _product(op, _op(op, "T"))
    return _masked(uplo, _plus_beta(alpha, P, beta, C, A))


def _conj_scalar(alpha):
    return alpha.conj() if isinstance(alpha, torch.Tensor) \
        else alpha.conjugate()


@with_precision
def her2k(uplo: str, orient: str, alpha, A: Arr, B: Arr, beta=0,
          C: Optional[Arr] = None) -> Arr:
    calpha = _conj_scalar(alpha)
    if orient.upper().startswith("N"):
        P1, P2 = _product(A, _op(B, "C")), _product(B, _op(A, "C"))
    else:
        P1, P2 = _product(_op(A, "C"), B), _product(_op(B, "C"), A)
    T = C if C is not None else A
    out = _combine(lambda _, p, q: alpha * p + calpha * q, P1, T, P2)
    if C is not None:
        out = each(lambda _, o, c: o + beta * c, out, C)
    return _masked(uplo, out)


@with_precision
def syr2k(uplo: str, orient: str, alpha, A: Arr, B: Arr, beta=0,
          C: Optional[Arr] = None) -> Arr:
    if orient.upper().startswith("N"):
        P1, P2 = _product(A, _op(B, "T")), _product(B, _op(A, "T"))
    else:
        P1, P2 = _product(_op(A, "T"), B), _product(_op(B, "T"), A)
    T = C if C is not None else A
    out = _combine(lambda _, p, q: alpha * (p + q), P1, T, P2)
    if C is not None:
        out = each(lambda _, o, c: o + beta * c, out, C)
    return _masked(uplo, out)


def _keep_other(uplo: str, upd: Arr, C: Arr) -> Arr:
    """The ``uplo`` triangle of ``upd`` and the strict other triangle of
    C, block by block."""
    lower = _lower(uplo)
    return each(lambda at, u, c: tri(u, at, lower)
                + tri(c, at, not lower, 1 if lower else -1), upd, C)


@with_precision
def trrk(uplo: str, orientA: str, orientB: str, alpha, A: Arr, B: Arr,
         beta, C: Arr) -> Arr:
    """Triangular rank-k: one triangle of C := α·op(A)op(B) + β·C
    (reference ``Trrk`` — the Cholesky/LDL trailing-update kernel)."""
    P = _product(_op(A, orientA), _op(B, orientB))
    lower = _lower(uplo)
    upd = _combine(lambda at, p, c: tri(alpha * p, at, lower) + beta * c,
                   P, C, C)
    return _keep_other(uplo, upd, C)


@with_precision
def trr2k(uplo: str, oA: str, oB: str, oC: str, oD: str, alpha, A: Arr,
          B: Arr, beta, C: Arr, D: Arr, gamma, E: Arr) -> Arr:
    P1 = _product(_op(A, oA), _op(B, oB))
    P2 = _product(_op(C, oC), _op(D, oD))
    upd = _combine(lambda _, p, q, e: alpha * p + beta * q + gamma * e,
                   P1, E, _result(P2, E), E)
    return _keep_other(uplo, upd, E)


@with_precision
def trmm(side: str, uplo: str, orient: str, diag: str, alpha, A: Arr,
         B: Arr) -> Arr:
    """B := α·op(tri(A))·B or α·B·op(tri(A)) (reference ``Trmm``)."""
    op = _op(_triangle(A, uplo, diag.upper().startswith("U")), orient)
    P = _product(op, B) if side.upper().startswith("L") else _product(B, op)
    return _combine(lambda _, p: alpha * p, P, B)


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


def multishift_trsm(side: str, uplo: str, orient: str, alpha, A: Arr,
                    shifts, B: Arr) -> Arr:
    """Solve (op(tri(A)) − σ_j I)·x_j = α·b_j for each column j (reference
    ``MultiShiftTrsm`` — the Pseudospectra/TriangEig workhorse), as one
    batched triangular solve over the shifts (the JAX package's ``vmap``).
    Like the JAX function, it solves from the left whatever ``side``; the
    operands are assembled at the first position, as the JAX HLO gathers
    them whole."""
    return like(B, _multishift(uplo, orient, alpha, A, shifts, B))


@with_precision
def _multishift(uplo, orient, alpha, A, shifts, B) -> torch.Tensor:
    """The whole solution of :func:`multishift_trsm`."""
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
    return x[:, :, 0].T


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
    """A := Lᴴ A L (LOWER) or U A Uᴴ (reference ``TwoSidedTrmm``): two
    block products."""
    l = _triangle(B, uplo, diag.upper().startswith("U"))
    adj = _op(l, "C" if conjugate else "T")
    if _lower(uplo):
        out = _product(_product(adj, A), l)
    else:
        out = _product(_product(l, A), adj)
    return _result(out, A)


@with_precision
def hermitian_from_evd(uplo: str, w, Z: Arr) -> Arr:
    """A := Z·diag(w)·Zᴴ (reference ``HermitianFromEVD``)."""
    w = vec(w)
    zw = each(lambda at, z: z * vector_piece(w, *at.cols, at)
              .to(z.dtype)[None, :], Z)
    a = _result(_product(zw, _op(Z, "C")), Z)
    return _masked(uplo, a) if uplo else a


@with_precision
def normal_from_evd(w, Z: Arr) -> Arr:
    """A := Z·diag(w)·Zᴴ with complex w (reference ``NormalFromEVD``)."""
    w = vec(w)
    zw = each(lambda at, z: z * vector_piece(w, *at.cols, at)[None, :], Z)
    return _result(_product(zw, _op(Z, "C")), Z)


def safe_multishift_trsm(side: str, uplo: str, orient: str, alpha, A: Arr,
                         shifts, B: Arr):
    """Overflow-guarded multishift triangular solve (reference
    ``SafeMultiShiftTrsm`` — the eigenvector back-substitution used by
    ``TriangEig``): solves (op(tri(A)) − σ_j I)·x_j = s_j·α·b_j where each
    column's scale s_j ≤ 1 keeps the solution representable.  Returns
    ``(X, scales)``.  As in the JAX package: solve once, then derive each
    column's scale from the solution's magnitude."""
    xa = _multishift(uplo, orient, alpha, A, shifts, B)
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
