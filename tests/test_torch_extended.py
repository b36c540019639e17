"""Parity of the port's extended precision (``elemental_tpu_torch.extended``:
double-word DD and quad-double QD) with the JAX package on the CPU,
mirroring ``tests/core/test_extended.py`` (its pytree case has no
counterpart: ``DD`` is a plain dataclass in the port).

The invariant is the reference test's: base-float32 DD arithmetic reaches
≥ ~1.8× the hardware mantissa (~1e-13 relative), base-float64 DD and QD
are exact against ``Fraction`` arithmetic to their word counts.  The same
seeded inputs also go through the JAX functions: the error-free
transformations are exact in both, so results agree bit for bit where the
operations are the same, and within 1e-14 of the largest value where
XLA fuses a chain of them.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elemental_tpu import extended as JX

from elemental_tpu_torch import extended as X

torch.set_num_threads(1)

CPU = torch.device("cpu")


def dd(x, dtype=torch.float32):
    return X.DD.from_array(x, dtype, device=CPU)


def agree(got, want, tol=1e-14):
    """Values within ``tol`` of the largest: XLA may order or contract
    the compensation terms of a fused chain otherwise than eager torch, so
    results agree to the double-word accuracy, not bit for bit."""
    got, want = got.to_float64(), want.to_float64()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_two_sum_and_two_prod_are_error_free():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal(512), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(512), dtype=torch.float32) * 1e-4
    s, e = X.two_sum(a, b)
    a64, b64 = a.double().numpy(), b.double().numpy()
    assert np.abs((s.double() + e.double()).numpy() - (a64 + b64)).max() == 0
    p, f = X.two_prod(a, b)
    assert np.abs((p.double() + f.double()).numpy() - a64 * b64).max() == 0
    js, je = JX.two_prod(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    np.testing.assert_array_equal(p.numpy(), np.asarray(js))
    np.testing.assert_array_equal(f.numpy(), np.asarray(je))


def test_dd_field_ops_reach_double_word_precision():
    rng = np.random.default_rng(1)
    a64 = rng.standard_normal(1000) * np.exp(rng.standard_normal(1000))
    b64 = rng.standard_normal(1000) * np.exp(rng.standard_normal(1000))
    A, B = dd(a64), dd(b64)
    ae, be = A.to_float64(), B.to_float64()
    assert np.abs((A + B).to_float64() - (ae + be)).max() < 5e-14 * np.abs(
        ae + be).max()
    rel = np.abs((A * B).to_float64() - ae * be) / np.abs(ae * be)
    assert rel.max() < 5e-14
    rel = np.abs((A / B).to_float64() - ae / be) / np.abs(ae / be)
    assert rel.max() < 5e-14
    s = X.dd_sqrt(dd(np.abs(a64)))
    rel = np.abs(s.to_float64() - np.sqrt(np.abs(ae))) / np.sqrt(np.abs(ae))
    assert rel.max() < 1e-13
    # the same words through the JAX functions
    JA, JB = JX.DD.from_array(a64), JX.DD.from_array(b64)
    np.testing.assert_array_equal(A.hi.numpy(), np.asarray(JA.hi))
    np.testing.assert_array_equal(A.lo.numpy(), np.asarray(JA.lo))
    for got, want in (((A - B), JA - JB), (A / B, JA / JB),
                      (X.dd_abs(-A), JX.dd_abs(-JA)),
                      (X.dd_sqrt(dd(np.abs(a64))),
                       JX.dd_sqrt(JX.DD.from_array(np.abs(a64))))):
        agree(got, want)


def test_dd_dot_beats_f32_by_many_orders():
    rng = np.random.default_rng(2)
    n = 4096
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    xd, yd = dd(x), dd(y)
    d = X.dd_dot(xd, yd).to_float64()
    truth = math.fsum(a * b for a, b in zip(xd.to_float64(), yd.to_float64()))
    dd_err = abs(d - truth) / abs(truth)
    f32_err = abs(float(np.float32(x) @ np.float32(y)) - truth) / abs(truth)
    assert dd_err < 1e-12
    assert dd_err < 1e-5 * f32_err
    agree(X.dd_dot(xd, yd), JX.dd_dot(JX.DD.from_array(x),
                                      JX.DD.from_array(y)))
    agree(X.dd_norm2(xd), JX.dd_norm2(JX.DD.from_array(x)))


def test_dd_dot_survives_catastrophic_cancellation():
    x = np.array([1e8, 1.0, -1e8, 1e-4])
    y = np.array([1.0, 1.0, 1.0, 1.0])
    d = X.dd_dot(dd(x), dd(y)).to_float64()
    assert abs(d - (1.0 + 1e-4)) < 1e-10


@pytest.mark.parametrize("k", [100, 96])
def test_dd_gemm_and_matvec(k):
    """k = 100 leaves a short last slab of the 16-wide K loop."""
    rng = np.random.default_rng(3)
    m, n = 24, 16
    Am, Bm = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    Add, Bdd = dd(Am), dd(Bm)
    C = X.dd_gemm(Add, Bdd)
    truth = Add.to_float64() @ Bdd.to_float64()
    assert np.abs(C.to_float64() - truth).max() < 1e-12 * np.abs(truth).max()
    agree(C, JX.dd_gemm(JX.DD.from_array(Am), JX.DD.from_array(Bm)))
    xv = rng.standard_normal(k)
    mv = X.dd_matvec(Add, dd(xv))
    truth = Add.to_float64() @ dd(xv).to_float64()
    assert np.abs(mv.to_float64() - truth).max() < 1e-12 * np.abs(truth).max()
    agree(mv, JX.dd_matvec(JX.DD.from_array(Am), JX.DD.from_array(xv)))
    agree(X.dd_axpy(0.5, dd(xv), dd(xv)),
          JX.dd_axpy(0.5, JX.DD.from_array(xv), JX.DD.from_array(xv)))


def test_refined_solve_dd_promotes_f32_factorization():
    import scipy.linalg as sla
    rng = np.random.default_rng(4)
    n = 64
    Q = rng.standard_normal((n, n))
    A = (Q @ Q.T + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    L = np.linalg.cholesky(np.float64(A)).astype(np.float32)

    def solve(r):
        r = np.asarray(r, np.float64)
        return torch.from_numpy(
            sla.cho_solve((np.float64(L), True), r).astype(np.float32))

    xdd = X.refined_solve_dd(torch.from_numpy(A), solve,
                             torch.from_numpy(b), iters=4)
    x_true = np.linalg.solve(np.float64(A), np.float64(b))
    err_dd = np.abs(xdd.to_float64() - x_true).max() / np.abs(x_true).max()
    err_f32 = np.abs(np.float64(solve(b).numpy()) - x_true).max() \
        / np.abs(x_true).max()
    assert err_dd < 1e-10
    assert err_dd < 1e-2 * err_f32
    ref = JX.refined_solve_dd(A, lambda r: jnp.asarray(solve(r).numpy()), b,
                              iters=4)
    np.testing.assert_allclose(xdd.to_float64(), ref.to_float64(),
                               rtol=0, atol=1e-15 * np.abs(x_true).max())


def test_dd_base_f64_reaches_quad_class():
    rng = np.random.default_rng(5)
    a = rng.standard_normal(100)
    b = rng.standard_normal(100)
    zero = torch.zeros(100, dtype=torch.float64)
    P = X.dd_mul(X.DD(torch.from_numpy(a), zero),
                 X.DD(torch.from_numpy(b), zero))
    assert np.abs(P.hi.numpy() - a * b).max() == 0.0
    for i in range(10):
        exact = Fraction(float(a[i])) * Fraction(float(b[i]))
        got = Fraction(float(P.hi[i])) + Fraction(float(P.lo[i]))
        assert got == exact


def test_qd_quad_double_precision():
    """QD add/mul reach ~212-bit precision on f64 words, against exact
    Fraction arithmetic; the same operations in the JAX package give the
    same words."""
    def to_frac(q):
        return sum(Fraction(float(c)) for c in q.words)

    def qd(x):
        return X.QD.from_array(x, device=CPU)

    rng = np.random.default_rng(1)
    for _ in range(10):
        v = [rng.standard_normal() for _ in range(4)]
        a = X.qd_add(qd(v[0]), qd(v[1] * 2.0 ** -60))
        b = X.qd_add(qd(v[2]), qd(v[3] * 2.0 ** -60))
        s = X.qd_add(a, b)
        m = X.qd_mul(a, b)
        assert abs(to_frac(s) - (to_frac(a) + to_frac(b))) \
            <= Fraction(1, 2 ** 180) * abs(to_frac(s))
        assert abs(to_frac(m) - to_frac(a) * to_frac(b)) \
            <= Fraction(1, 2 ** 180) * abs(to_frac(m))
        ja = JX.qd_add(JX.QD.from_array(v[0]),
                       JX.QD.from_array(v[1] * 2.0 ** -60))
        jb = JX.qd_add(JX.QD.from_array(v[2]),
                       JX.QD.from_array(v[3] * 2.0 ** -60))
        assert to_frac(m) == to_frac(JX.qd_mul(ja, jb))
        assert to_frac(a - b) == to_frac(ja - jb)
        assert to_frac(X.QD.from_dd(X.DD(a.c0, a.c1)) * b) == to_frac(
            JX.QD.from_dd(JX.DD(ja.c0, ja.c1)) * jb)
    d = X.qd_dot(torch.tensor([1.0, 1e-30, -1.0, 1e-30], dtype=torch.float64),
                 torch.ones(4, dtype=torch.float64))
    assert abs(float(to_frac(d)) - 2e-30) < 1e-45
    xs = rng.standard_normal(37)
    s = X.qd_sum(X.QD(*(torch.from_numpy(w) for w in
                        (xs, xs * 2.0 ** -53, xs * 0, xs * 0))))
    js = JX.qd_sum(JX.QD(jnp.asarray(xs), jnp.asarray(xs * 2.0 ** -53),
                         jnp.zeros(37), jnp.zeros(37)))
    assert to_frac(s) == to_frac(js)
