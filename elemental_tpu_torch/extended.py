"""Extended precision: double-word ("double-double") and quad-double
arithmetic (counterpart of ``elemental_tpu/extended.py``; reference
``src/core/imports/qd.cpp``, DoubleDouble/QuadDouble).

Error-free transformations (Knuth TwoSum, Dekker split + TwoProd) on
tensors: base float32 gives ~48-bit significands, base float64 ~106 bits
(DD) or ~212 bits (QD).  Eager PyTorch runs each operation as its own
kernel, so every product and sum is rounded on its own and no compiler
re-associates or contracts the compensation into an FMA.  Never wrap these
functions in ``torch.compile``.

``DD`` and ``QD`` are plain dataclasses of same-shape tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# ------------------------------------------------------------------
# error-free transformations
# ------------------------------------------------------------------

def two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Dekker FastTwoSum; requires |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


_SPLIT = {torch.float32: (1 << 12) + 1, torch.float64: (1 << 27) + 1}


def split(a):
    """Dekker split: a == hi + lo with both halves on half-width mantissas."""
    c = _SPLIT[a.dtype] * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProd: p + err == a*b exactly."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ------------------------------------------------------------------
# the DD pair
# ------------------------------------------------------------------

@dataclasses.dataclass
class DD:
    """Double-word number/array: value = hi + lo, |lo| <= ulp(hi)/2."""
    hi: torch.Tensor
    lo: torch.Tensor

    # -------------- conversions --------------
    @classmethod
    def from_array(cls, x, dtype=torch.float32, *, device) -> "DD":
        """Split a (wider or equal) host value into (hi, lo) base-dtype
        words on ``device``: hi = round(x), lo = round(x - hi)."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().double().numpy()
        x = np.asarray(x, np.float64)
        word = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        hi = x.astype(word)
        lo = (x - hi.astype(np.float64)).astype(word)
        return cls(torch.as_tensor(hi, device=device),
                   torch.as_tensor(lo, device=device))

    def to_float64(self) -> np.ndarray:
        return (self.hi.detach().cpu().double().numpy()
                + self.lo.detach().cpu().double().numpy())

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    # -------------- operators --------------
    def __add__(self, other):
        return dd_add(self, _as_dd(other, self.hi))

    def __sub__(self, other):
        return dd_add(self, dd_neg(_as_dd(other, self.hi)))

    def __mul__(self, other):
        return dd_mul(self, _as_dd(other, self.hi))

    def __truediv__(self, other):
        return dd_div(self, _as_dd(other, self.hi))

    def __neg__(self):
        return dd_neg(self)

    def __getitem__(self, idx):
        return DD(self.hi[idx], self.lo[idx])


def _as_dd(x, like=None) -> DD:
    """``x`` as a DD: itself, or (x, 0) in the dtype and on the device of
    the tensor ``like`` (x's own where there is none)."""
    if isinstance(x, DD):
        return x
    x = (torch.as_tensor(x) if like is None else
         torch.as_tensor(x, dtype=like.dtype, device=like.device))
    return DD(x, torch.zeros_like(x))


def dd_neg(a: DD) -> DD:
    return DD(-a.hi, -a.lo)


def dd_add(a: DD, b: DD) -> DD:
    """Full (accurate) DD addition: 20 flops, ~2 ulp DD error."""
    s, e = two_sum(a.hi, b.hi)
    t, f = two_sum(a.lo, b.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return DD(*quick_two_sum(s, e))


def dd_mul(a: DD, b: DD) -> DD:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    return DD(*quick_two_sum(p, e))


def dd_div(a: DD, b: DD) -> DD:
    # one Newton step on the hi-word quotient
    q1 = a.hi / b.hi
    r = dd_add(a, dd_neg(dd_mul(_as_dd(q1), b)))
    q2 = r.hi / b.hi
    r = dd_add(r, dd_neg(dd_mul(_as_dd(q2), b)))
    q3 = r.hi / b.hi
    q, e = quick_two_sum(q1, q2)
    return DD(*quick_two_sum(q, e + q3))


def dd_sqrt(a: DD) -> DD:
    # Karp-Markstein: y ≈ 1/sqrt(hi); s = hi*y; refine with one DD step
    y = 1.0 / torch.sqrt(a.hi)
    s = a.hi * y
    e = dd_add(a, dd_neg(dd_mul(_as_dd(s), _as_dd(s))))
    return dd_add(_as_dd(s), _as_dd(e.hi * (0.5 * y)))


def dd_abs(a: DD) -> DD:
    neg = a.hi < 0
    return DD(torch.where(neg, -a.hi, a.hi), torch.where(neg, -a.lo, a.lo))


# ------------------------------------------------------------------
# reductions / linear-algebra kernels (log-depth trees)
# ------------------------------------------------------------------

def dd_sum(a: DD, axis: int = -1) -> DD:
    """Compensated sum along ``axis`` by a log-depth pairwise DD tree: each
    level is one vectorized ``dd_add``."""
    hi = torch.movedim(a.hi, axis, -1)
    lo = torch.movedim(a.lo, axis, -1)
    n = hi.shape[-1]
    # pad to a power of two with exact zeros
    m = 1 << max(0, (n - 1)).bit_length()
    x = DD(torch.nn.functional.pad(hi, (0, m - n)),
           torch.nn.functional.pad(lo, (0, m - n)))
    while x.hi.shape[-1] > 1:
        half = x.hi.shape[-1] // 2
        x = dd_add(DD(x.hi[..., :half], x.lo[..., :half]),
                   DD(x.hi[..., half:], x.lo[..., half:]))
    return DD(x.hi[..., 0], x.lo[..., 0])


def dd_dot(x, y) -> DD:
    """Dot product with exact per-element products (TwoProd) and a DD tree
    reduction: ~full double-word accuracy."""
    xd, yd = _as_dd(x), _as_dd(y)
    p, e = two_prod(xd.hi, yd.hi)
    e = e + (xd.hi * yd.lo + xd.lo * yd.hi)
    return dd_sum(DD(p, e), axis=-1)


def dd_norm2(x) -> DD:
    s = dd_dot(x, x)
    return dd_sqrt(s)


def dd_axpy(alpha, x: DD, y: DD) -> DD:
    return dd_add(dd_mul(_as_dd(alpha, x.hi), x), y)


def dd_matvec(A: DD, x: DD, block: int = 2048) -> DD:
    """y = A·x in double-word precision: per-row TwoProd and a DD tree sum,
    vectorized over the rows."""
    p, e = two_prod(A.hi, x.hi[None, :])
    e = e + (A.hi * x.lo[None, :] + A.lo * x.hi[None, :])
    return dd_sum(DD(p, e), axis=-1)


def dd_gemm(A: DD, B: DD, block_k: int = 16) -> DD:
    """C = A·B in double-word precision.

    A loop over K-slabs of ``block_k``: each slab forms the exact (TwoProd)
    product tensor m×kb×n and folds its DD tree sum into the DD
    accumulator (the JAX package's ``lax.scan``).  A software path, like
    the reference's QD GEMM; for float32 accuracy at the library's speed
    use ``ops.level3`` (TF32 off), and DD for ~2× the hardware mantissa."""
    m, k = A.hi.shape
    k2, n = B.hi.shape
    assert k == k2
    kb = min(block_k, k)
    acc = DD(torch.zeros((m, n), dtype=A.hi.dtype, device=A.hi.device),
             torch.zeros((m, n), dtype=A.hi.dtype, device=A.hi.device))
    for s in range(0, k, kb):
        ah, al = A.hi[:, s:s + kb, None], A.lo[:, s:s + kb, None]
        bh, bl = B.hi[None, s:s + kb], B.lo[None, s:s + kb]
        # (m, kb, n) exact products of the hi words; a short last slab is
        # the JAX package's zero padding left out (its products are 0)
        p, e = two_prod(ah, bh)
        e = e + (ah * bl + al * bh)
        acc = dd_add(acc, dd_sum(DD(p, e), axis=1))
    return acc


# ------------------------------------------------------------------
# applications: extended-precision iterative refinement
# ------------------------------------------------------------------

def refined_solve_dd(A, solve_fn, b, iters: int = 3):
    """Iterative refinement with the residual in double-word precision (the
    reference's reason for carrying QD: ``Refined.hpp`` promotes a
    hardware-precision factorization to near-double-word accuracy).  ``A``
    is the hardware-precision matrix, ``solve_fn`` an approximate solver
    (e.g. a Cholesky solve), ``b`` the right-hand side."""
    A = torch.as_tensor(A)
    b = torch.as_tensor(b, dtype=A.dtype, device=A.device)
    Add = _as_dd(A)
    bdd = _as_dd(b)
    x = solve_fn(b)
    xdd = _as_dd(x, A)
    for _ in range(iters):
        r = dd_add(bdd, dd_neg(dd_matvec(Add, xdd)))
        d = solve_fn(r.hi + r.lo)
        xdd = dd_add(xdd, _as_dd(d, A))
    return xdd


# ------------------------------------------------------------------
# QD: quad-double (4-word) expansions (Hida-Li-Bailey "sloppy"
# algorithms, branch-free renormalization)
# ------------------------------------------------------------------

def _three_sum(a, b, c):
    t1, t2 = two_sum(a, b)
    a, t3 = two_sum(c, t1)
    b, c = two_sum(t2, t3)
    return a, b, c


def _three_sum2(a, b, c):
    t1, t2 = two_sum(a, b)
    a, t3 = two_sum(c, t1)
    return a, t2 + t3


@dataclasses.dataclass
class QD:
    """Quad-double value: x ≈ c0 + c1 + c2 + c3 (non-overlapping words);
    ~212-bit significand on float64 words, ~96-bit on float32."""

    c0: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    c3: torch.Tensor

    @classmethod
    def from_array(cls, x, dtype=torch.float64, *, device) -> "QD":
        hi = torch.as_tensor(x, dtype=dtype, device=device)
        z = torch.zeros_like(hi)
        return cls(hi, z, z, z)

    @classmethod
    def from_dd(cls, d: DD) -> "QD":
        z = torch.zeros_like(d.hi)
        return cls(d.hi, d.lo, z, z)

    def to_float64(self) -> np.ndarray:
        return sum(w.detach().cpu().double().numpy() for w in self.words)

    @property
    def words(self):
        return (self.c0, self.c1, self.c2, self.c3)

    def __add__(self, other):
        return qd_add(self, _as_qd(other, self.c0))

    def __sub__(self, other):
        o = _as_qd(other, self.c0)
        return qd_add(self, QD(-o.c0, -o.c1, -o.c2, -o.c3))

    def __mul__(self, other):
        return qd_mul(self, _as_qd(other, self.c0))

    def __neg__(self):
        return QD(-self.c0, -self.c1, -self.c2, -self.c3)


def _as_qd(x, like: torch.Tensor) -> QD:
    if isinstance(x, QD):
        return x
    if isinstance(x, DD):
        return QD.from_dd(x)
    return QD.from_array(x, like.dtype, device=like.device)


def qd_renormalize(c0, c1, c2, c3, c4) -> QD:
    """Renormalize a 5-term expansion (standard HLB ladder)."""
    s, t3 = quick_two_sum(c3, c4)
    s, t2 = quick_two_sum(c2, s)
    s, t1 = quick_two_sum(c1, s)
    r0, s = quick_two_sum(c0, s)
    # push the residuals down a second time (branch-free variant of the
    # QD library's conditional ladder; loses <1 ulp of the last word)
    r1, s2 = quick_two_sum(s, t1)
    r2, s3 = quick_two_sum(s2, t2)
    r3 = s3 + t3
    return QD(r0, r1, r2, r3)


def qd_add(a: QD, b: QD) -> QD:
    """a + b (HLB sloppy addition: componentwise two_sums + carry chain)."""
    s0, t0 = two_sum(a.c0, b.c0)
    s1, t1 = two_sum(a.c1, b.c1)
    s2, t2 = two_sum(a.c2, b.c2)
    s3, t3 = two_sum(a.c3, b.c3)
    s1, t0 = two_sum(s1, t0)
    s2, t0, t1 = _three_sum(s2, t0, t1)
    s3, t0 = _three_sum2(s3, t0, t2)
    t0 = t0 + t1 + t3
    return qd_renormalize(s0, s1, s2, s3, t0)


def qd_mul(a: QD, b: QD) -> QD:
    """a · b (HLB sloppy multiplication: O(eps^4) cross terms dropped)."""
    p0, q0 = two_prod(a.c0, b.c0)
    p1, q1 = two_prod(a.c0, b.c1)
    p2, q2 = two_prod(a.c1, b.c0)
    p3, q3 = two_prod(a.c0, b.c2)
    p4, q4 = two_prod(a.c1, b.c1)
    p5, q5 = two_prod(a.c2, b.c0)

    # order-1 terms
    p1, p2, q0 = _three_sum(p1, p2, q0)
    # order-2 terms
    p2, q1, q2 = _three_sum(p2, q1, q2)
    p3, p4, p5 = _three_sum(p3, p4, p5)
    s0, t0 = two_sum(p2, p3)
    s1, t1 = two_sum(q1, p4)
    s2 = q2 + p5
    s1, t0 = two_sum(s1, t0)
    s2 = s2 + t0 + t1
    # order-3 terms
    s3 = (q3 + q4 + q5
          + a.c1 * b.c2 + a.c2 * b.c1 + a.c0 * b.c3 + a.c3 * b.c0)
    return qd_renormalize(p0, p1, s0, s1, s2 + s3)


def qd_sum(a: QD, axis: int = -1) -> QD:
    """Compensated sum along ``axis`` by a log-depth pairwise QD tree, each
    level one vectorized ``qd_add`` (as :func:`dd_sum`)."""
    ws = [torch.movedim(w, axis, -1) for w in a.words]
    n = ws[0].shape[-1]
    m = 1 << max(0, (n - 1)).bit_length()
    x = QD(*(torch.nn.functional.pad(w, (0, m - n)) for w in ws))
    while x.c0.shape[-1] > 1:
        half = x.c0.shape[-1] // 2
        x = qd_add(QD(*(w[..., :half] for w in x.words)),
                   QD(*(w[..., half:] for w in x.words)))
    return QD(*(w[..., 0] for w in x.words))


def qd_dot(x, y) -> QD:
    """Compensated dot product at quad-double precision: exact products
    (TwoProd) summed by the log-depth QD tree."""
    xj = torch.as_tensor(x)
    yj = torch.as_tensor(y, dtype=xj.dtype, device=xj.device)
    p, e = two_prod(xj, yj)
    z = torch.zeros_like(p)
    return qd_sum(QD(p, e, z, z), axis=-1)
