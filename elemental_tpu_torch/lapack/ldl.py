"""Dense LDL factorizations (counterpart of ``elemental_tpu/lapack/ldl.py``;
reference ``src/lapack_like/factor/LDL/dense/`` unpivoted and
Bunch-Kaufman, and ``factor/RegularizedLDL/``).

``ldl``: the JAX package's recursive blocked LDLᵀ/LDLᴴ (unit-lower L,
diagonal D), the trailing update one ``torch.matmul`` per level (TF32 off),
the base (at most 128 columns) the unblocked right-looking column loop.

``ldl_pivoted``: Bunch-Kaufman with 1×1 and 2×2 pivots (LAPACK ``sytf2``'s
rule).  One host decision per pivot, from a few scalars read off the
device (λ, r and |a_kk|; then σ and |a_rr| when the first test does not
settle it), compared on the device in the matrix's dtype as the JAX
package compares them; then one 1×1 or 2×2 step with in-place symmetric
swaps.  The JAX package's masked formulation computes both steps and
selects one (and evaluates the 2×2 step at k = n−1 on clamped indices); the
host branch takes the chosen step only.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision
from .perm import _swap_symmetric

Arr = Union[torch.Tensor, DistMatrix]

_BASE = 128


class LDL(NamedTuple):
    lower: torch.Tensor  # unit-lower L (unit diagonal stored)
    diag: torch.Tensor   # D as a vector


def _ldl_base(a: torch.Tensor, conjugate: bool) -> torch.Tensor:
    """Unblocked right-looking LDL; returns packed L\\D (L strictly lower,
    D on the diagonal; the strict upper triangle holds stale values)."""
    a = a.clone()
    for k in range(a.shape[0]):
        d = a[k, k]
        col = a[k + 1:, k] / d
        row = col.conj() if conjugate else col
        a[k + 1:, k + 1:] -= torch.outer(col, row) * d
        a[k + 1:, k] = col
    return a


def _ldl_into(a: torch.Tensor, out: torch.Tensor, conjugate: bool) -> None:
    n = a.shape[0]
    if n <= _BASE:
        out.copy_(_ldl_base(a, conjugate))
        return
    m = n // 2
    _ldl_into(a[:m, :m], out[:m, :m], conjugate)
    F11 = out[:m, :m]
    d1 = torch.diagonal(F11)
    # L21 = A21 · L11⁻ᴴ · D1⁻¹
    adj = "C" if conjugate else "T"
    L21 = as_array(trsm("R", "L", adj, "U", 1, F11, a[m:, :m])) / d1[None, :]
    out[m:, :m] = L21
    L21d = L21 * d1[None, :]
    rhs = L21.mH if conjugate else L21.T
    _ldl_into(a[m:, m:] - torch.matmul(L21d, rhs), out[m:, m:], conjugate)


@with_precision
def ldl(A: Arr, conjugate: bool = True) -> LDL:
    """Unpivoted LDLᴴ (conjugate=True) or LDLᵀ: A = L·D·Lᴴ with unit-lower L
    (reference dense ``LDL``, for HPD and quasi-definite operands)."""
    a = as_array(A)
    packed = torch.zeros_like(a)
    _ldl_into(a, packed, conjugate)
    d = torch.diagonal(packed).clone()
    n = packed.shape[0]
    lower = torch.tril(packed, -1) + torch.eye(n, dtype=packed.dtype,
                                               device=packed.device)
    return LDL(lower, d)


@with_precision
def regularized_ldl(A: Arr, reg, conjugate: bool = False) -> LDL:
    """LDL of A + diag(reg) (reference ``RegularizedLDL``): the caller's
    signed per-row regularization makes the quasi-definite factorization
    pivot-free."""
    a = as_array(A)
    a = a + torch.diag(torch.as_tensor(reg).to(device=a.device,
                                               dtype=a.dtype))
    return ldl(a, conjugate)


def solve_after(fact: LDL, B: Arr, conjugate: bool = True) -> Arr:
    """X = A⁻¹B from an LDL factorization: L, D, then Lᴴ solves."""
    b = as_array(B)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    y = as_array(trsm("L", "L", "N", "U", 1, fact.lower, b))
    y = y / fact.diag[:, None]
    adj = "C" if conjugate else "T"
    x = as_array(trsm("L", "L", adj, "U", 1, fact.lower, y))
    if squeeze:
        x = x[:, 0]
    return like(B, x)


@with_precision
def solve_after_refined(A: Arr, fact: LDL, B: Arr, conjugate: bool = False,
                        max_refine_iters: int = 8,
                        relative_tol: float = None) -> Arr:
    """Solve with iterative refinement against the *unregularized* A
    (reference ``reg_ldl::SolveAfter``): x ← x + A⁻̃¹(b − A·x), a fixed
    ``max_refine_iters`` times, as in the JAX package."""
    a = as_array(A)
    b = as_array(B)
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b
    x = as_array(solve_after(fact, bb, conjugate))
    for _ in range(max_refine_iters):
        r = bb - a @ x
        x = x + as_array(solve_after(fact, r, conjugate))
    if squeeze:
        x = x[:, 0]
    return like(B, x)


def inertia(fact: LDL):
    """(num positive, num negative, num zero) eigen-signs from D (reference
    ``props/Inertia`` via LDL)."""
    d = fact.diag.real
    return ((d > 0).sum(), (d < 0).sum(), (d == 0).sum())


# --------------------------------------------------------------------------
# Bunch-Kaufman pivoted LDL (reference ``factor/LDL/dense`` pivoted variant)
# --------------------------------------------------------------------------

class LDLPivoted(NamedTuple):
    lower: torch.Tensor    # unit-lower L (in pivoted order)
    diag: torch.Tensor     # main diagonal of block-diagonal D
    subdiag: torch.Tensor  # subdiagonal of D (nonzero at 2x2 pivots)
    perm: torch.Tensor     # row permutation: P·A·Pᵀ = L·D·Lᵀ, P = I[perm]


_BK_ALPHA = (1.0 + 17.0 ** 0.5) / 8.0


def _bk_choice(a: torch.Tensor, k: int) -> tuple:
    """Bunch-Kaufman's choice at column k: (2×2?, swap row r) where the
    1×1 step swaps k ↔ r when r != k and the 2×2 step swaps k+1 ↔ r.
    The tests are the JAX package's, evaluated on the device."""
    n = a.shape[0]
    if k == n - 1:
        return False, k
    alpha = _BK_ALPHA
    absc = a[k + 1:, k].abs()
    lam, r = torch.max(absc, 0)
    akk = a[k, k].abs()
    no_swap, r = torch.stack([(akk >= alpha * lam).to(r.dtype), r]).tolist()
    if no_swap:
        return False, k
    r += k + 1
    # column r of the trailing block without its diagonal, from the lower
    # triangle: row r left of the diagonal, column r below it
    sigma = torch.max(torch.cat([a[r, k:r], a[r + 1:, r]]).abs())
    tests = torch.stack([akk * sigma >= alpha * lam * lam,
                         a[r, r].abs() >= alpha * sigma]).tolist()
    if tests[0]:
        return False, k
    if tests[1]:
        return False, r
    return True, r


def _pivot1(a: torch.Tensor, k: int, conjugate: bool) -> None:
    d = a[k, k]
    safe = torch.where(d == 0, torch.ones_like(d), d)
    col = a[k + 1:, k] / safe
    row = col.conj() if conjugate else col
    a[k + 1:, k + 1:] -= torch.outer(col, row) * d
    a[k + 1:, k] = col


def _pivot2(a: torch.Tensor, k: int, conjugate: bool) -> torch.Tensor:
    E00, E11, E10 = a[k, k], a[k + 1, k + 1], a[k + 1, k].clone()
    E10h = E10.conj() if conjugate else E10
    det = E00 * E11 - E10 * E10h
    safe = torch.where(det == 0, torch.ones_like(det), det)
    w0, w1 = a[k + 2:, k].clone(), a[k + 2:, k + 1].clone()
    # [l0 l1] = [w0 w1]·E⁻¹ with E = [[E00, E10ᴴ], [E10, E11]]
    l0 = (w0 * E11 - w1 * E10) / safe
    l1 = (w1 * E00 - w0 * E10h) / safe
    r0 = w0.conj() if conjugate else w0
    r1 = w1.conj() if conjugate else w1
    a22 = a[k + 2:, k + 2:]
    a22 -= torch.outer(l0, r0)
    a22 -= torch.outer(l1, r1)
    a[k + 2:, k] = l0
    a[k + 2:, k + 1] = l1
    return E10


@with_precision
def ldl_pivoted(A: Arr, conjugate: bool = False) -> LDLPivoted:
    """Bunch-Kaufman partially-pivoted LDLᵀ/LDLᴴ with 1×1 and 2×2 pivots
    (reference dense pivoted ``LDL``; LAPACK ``sytf2``'s decision rule):
    stable for symmetric indefinite matrices where the unpivoted path
    breaks down."""
    a = as_array(A).clone()
    n = a.shape[0]
    dt = a.dtype
    if n <= 1:
        return LDLPivoted(torch.eye(n, dtype=dt, device=a.device),
                          torch.diagonal(a).clone(),
                          torch.zeros((0,), dtype=dt, device=a.device),
                          torch.arange(n, device=a.device))
    perm = torch.arange(n, device=a.device)
    e = torch.zeros(n - 1, dtype=dt, device=a.device)
    k = 0
    while k < n:
        two, r = _bk_choice(a, k)
        if two:
            _swap_symmetric(a, perm, k + 1, r)
            e[k] = _pivot2(a, k, conjugate)
            k += 2
        else:
            _swap_symmetric(a, perm, k, r)
            _pivot1(a, k, conjugate)
            k += 1
    d = torch.diagonal(a).clone()
    lower = torch.tril(a, -1) + torch.eye(n, dtype=dt, device=a.device)
    # the entry under each 2x2 pivot head holds E10, not L: zero it
    heads = torch.nonzero(e != 0).reshape(-1)
    lower[heads + 1, heads] = 0
    return LDLPivoted(lower, d, e, perm)


def solve_after_pivoted(fact: LDLPivoted, B: Arr,
                        conjugate: bool = False) -> Arr:
    """X = A⁻¹B from a Bunch-Kaufman factorization: permute, L solve,
    block-diagonal solve (1×1/2×2), Lᴴ solve, unpermute."""
    b = as_array(B).to(fact.lower.dtype)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n = b.shape[0]
    pb = b[fact.perm.to(b.device)]
    y = as_array(trsm("L", "L", "N", "U", 1, fact.lower, pb))
    d, e = fact.diag, fact.subdiag
    z = y / d[:, None]
    if n > 1:
        eh = e.conj() if conjugate else e
        head = (e != 0)[:, None]            # k heads a 2x2 block
        det = d[:-1] * d[1:] - e * eh
        det = torch.where(e != 0, det, torch.ones_like(det))
        y0, y1 = y[:-1], y[1:]
        z0 = (d[1:, None] * y0 - eh[:, None] * y1) / det[:, None]
        z1 = (d[:-1, None] * y1 - e[:, None] * y0) / det[:, None]
        z[:-1] = torch.where(head, z0, z[:-1])
        z[1:] = torch.where(head, z1, z[1:])
    adj = "C" if conjugate else "T"
    x = as_array(trsm("L", "L", adj, "U", 1, fact.lower, z))
    x = x[torch.argsort(fact.perm).to(x.device)]
    if squeeze:
        x = x[:, 0]
    return like(B, x)
