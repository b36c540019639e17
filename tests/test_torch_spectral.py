"""Parity of the port's spectral tier (``elemental_tpu_torch.lapack``:
condensed forms, eigensolvers, SVD, Schur, pseudospectra, polar, the
secular equation, the matrix functions and the Lanczos family) with the
JAX package on the CPU, mirroring the spectral cases of
``tests/lapack/test_spectral_solve.py`` and the Lanczos cases of
``tests/ops/test_generators_breadth.py``: the same seeded NumPy inputs go
through both packages; the port's result is held to the reference test's
own check and to the JAX result.

Tolerances: eigenvalues and singular values within 1e-12 (float64) and
1e-5 (float32) of the JAX values, relative to the largest.  Eigenvectors
and singular vectors, which LAPACK and ``torch.linalg`` may sign or phase
differently, through their residuals and |Qᴴ·Q_jax| = I within 1e-8.
Reductions (tridiagonal, bidiagonal, Hessenberg) through ‖QᴴAQ − T‖ and
against the JAX reduction, carried across by ``lapack.from_reference``.
Iterations that start from a random vector (inverse iteration,
pseudospectra) start from torch's draws: held to the reference test's
gates.  ``sign`` and ``square_root`` stop on the JAX loop's iteration.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elemental_tpu import lapack as jla
from elemental_tpu.lapack import condense as jcondense
from elemental_tpu.lapack import funcs as jfuncs
from elemental_tpu.matrices import sparse_laplacian_2d as jlaplacian

from elemental_tpu_torch import lapack as tla
from elemental_tpu_torch.lapack import condense as tcondense
from elemental_tpu_torch.lapack import spectral as tspectral
from elemental_tpu_torch.matrices import sparse_laplacian_2d as tlaplacian

torch.set_num_threads(2)

CPU = torch.device("cpu")
VAL_TOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-5}


def T(x):
    return torch.from_numpy(np.array(x))


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)


def close(got, ref, tol):
    got, ref = npy(got), npy(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, (err, tol * scale)


def same_span(q, qj, tol=1e-8):
    """Columns equal up to sign or phase: |Qᴴ·Q_jax| = I."""
    q, qj = npy(q), npy(qj)
    g = np.abs(q.conj().T @ qj)
    assert np.abs(g - np.eye(g.shape[0])).max() < tol


def _herm(rng, n, dtype=np.float64):
    a = rng.standard_normal((n, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
    a = a.astype(dtype)
    return ((a + a.conj().T) / 2).astype(dtype)


def _rand(rng, shape, dtype=np.float64):
    a = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _tridiag(d, e):
    d, e = npy(d), npy(e)
    return np.diag(d) + np.diag(e, -1) + np.diag(e, 1)


# -- eigensolvers -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("alg", ["direct", "tridiag"])
def test_hermitian_eig(alg, dtype):
    n = 50
    a = _herm(np.random.default_rng(5), n, dtype)
    pair = tla.hermitian_eig("L", T(a), alg=alg)
    ref = jla.hermitian_eig("L", jnp.asarray(a), alg=alg)
    w, q = npy(pair.w), npy(pair.q)
    tol = VAL_TOL[np.dtype(dtype)]
    np.testing.assert_allclose(w, np.linalg.eigvalsh(a.astype(np.float64)),
                               rtol=1e-8 if tol < 1e-8 else 1e-4,
                               atol=1e-8 if tol < 1e-8 else 1e-4)
    assert np.abs(a @ q - q * w[None, :]).max() < (1e-7 if tol < 1e-8
                                                    else 1e-4)
    close(w, ref.w, tol)
    same_span(q.astype(np.float64), np.asarray(ref.q, np.float64),
              1e-8 if tol < 1e-8 else 1e-3)


def test_hermitian_eig_complex():
    n = 40
    a = _herm(np.random.default_rng(6), n, np.complex128)
    pair = tla.hermitian_eig("L", T(a))
    ref = jla.hermitian_eig("L", jnp.asarray(a))
    w, q = npy(pair.w), npy(pair.q)
    assert np.abs(a @ q - q * w[None, :]).max() < 1e-8
    close(w, ref.w, 1e-12)
    same_span(q, ref.q)


def test_hermitian_eig_subset():
    n = 30
    a = _herm(np.random.default_rng(7), n)
    for alg in ("direct", "tridiag"):
        pair = tla.hermitian_eig("L", T(a), alg=alg, subset=(5, 10))
        assert pair.w.shape == (6,) and pair.q.shape == (n, 6)
        np.testing.assert_allclose(npy(pair.w),
                                   np.linalg.eigvalsh(a)[5:11], rtol=1e-9)
        close(pair.w, jla.hermitian_eig("L", jnp.asarray(a), alg=alg,
                                        subset=(5, 10)).w, 1e-12)


def test_hermitian_tridiag():
    n = 30
    a = _herm(np.random.default_rng(8), n, np.complex128)
    t = tla.hermitian_tridiag("L", T(a))
    tj = jla.hermitian_tridiag("L", jnp.asarray(a))
    q = npy(t.q)
    np.testing.assert_allclose(q @ _tridiag(t.d, t.e) @ q.conj().T, a,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(q @ q.conj().T, np.eye(n), atol=1e-8)
    # the same reflectors and phase convention: the JAX reduction itself
    ref = tla.from_reference(tj, device=CPU)
    for got, want in zip(t, ref):
        close(got, want, 1e-12)


def test_tridiag_eig_estimate():
    rng = np.random.default_rng(9)
    n = 40
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1) * 0.5
    w = np.linalg.eigvalsh(_tridiag(d, e))
    cnt = tla.hermitian_tridiag_eig_estimate(T(d), T(e), w[9] + 1e-9,
                                             w[29] + 1e-9)
    assert cnt.dtype == torch.int32 and int(cnt) == 20
    assert int(cnt) == int(jla.hermitian_tridiag_eig_estimate(
        jnp.asarray(d), jnp.asarray(e), w[9] + 1e-9, w[29] + 1e-9))


def test_skew_hermitian_eig():
    rng = np.random.default_rng(10)
    n = 20
    a = rng.standard_normal((n, n))
    a = a - a.T
    pair = tla.skew_hermitian_eig("L", T(a))
    w = npy(pair.w)
    expect = np.sort(np.imag(np.linalg.eigvals(a)))
    np.testing.assert_allclose(np.sort(w), expect, atol=1e-8)
    close(w, jla.skew_hermitian_eig("L", jnp.asarray(a)).w, 1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_svd_and_norms(dtype):
    rng = np.random.default_rng(11)
    m, n = 40, 25
    a = _rand(rng, (m, n), dtype)
    out = tla.svd(T(a))
    ref = jla.svd(jnp.asarray(a))
    u, s, vh = npy(out.u), npy(out.s), npy(out.vh)
    tol = VAL_TOL[np.dtype(dtype)]
    atol = 1e-9 if tol < 1e-8 else 1e-4
    np.testing.assert_allclose(u @ np.diag(s) @ vh, a, rtol=atol, atol=atol)
    close(s, ref.s, tol)
    close(tla.singular_values(T(a)), ref.s, tol)
    assert tla.svd(T(a), vectors=False).u is None
    same_span(u.astype(np.float64), np.asarray(ref.u, np.float64),
              1e-8 if tol < 1e-8 else 1e-3)
    np.testing.assert_allclose(float(tla.two_norm(T(a))), s[0],
                               rtol=1e-10 if tol < 1e-8 else 1e-5)
    np.testing.assert_allclose(float(tla.nuclear_norm(T(a))), s.sum(),
                               rtol=1e-10 if tol < 1e-8 else 1e-5)


def test_schur_and_eig():
    rng = np.random.default_rng(12)
    n = 20
    a = _rand(rng, (n, n))
    sch = tla.schur(T(a))
    ref = jla.schur(jnp.asarray(a))
    t, q = npy(sch.t), npy(sch.q)
    assert sch.t.dtype == torch.complex128
    np.testing.assert_allclose(q @ t @ q.conj().T, a, rtol=1e-9, atol=1e-9)
    assert np.abs(np.tril(t, -1)).max() < 1e-10
    # the same host LAPACK call on the same input
    for got, want in zip(sch, ref):
        np.testing.assert_array_equal(npy(got), np.asarray(want))
    w, v = tla.eig(T(a))
    wj, vj = jla.eig(jnp.asarray(a))
    np.testing.assert_array_equal(npy(w), np.asarray(wj))
    np.testing.assert_array_equal(npy(v), np.asarray(vj))


def test_triang_eig(monkeypatch):
    rng = np.random.default_rng(13)
    n = 15
    t = np.triu(_rand(rng, (n, n))) + np.diag(np.arange(1.0, n + 1) * 2)
    X = npy(tla.triang_eig(T(t)))
    lam = np.diag(t)
    assert np.abs(t @ X - X * lam[None, :]).max() < 1e-7
    close(X, jla.triang_eig(jnp.asarray(t)), 1e-12)
    # batches of 4 columns give one batch's bits
    monkeypatch.setattr(tspectral, "_CHUNK_BYTES", 4 * n * n * 8)
    np.testing.assert_array_equal(npy(tla.triang_eig(T(t))), X)


def test_pseudospectra(monkeypatch):
    rng = np.random.default_rng(14)
    n = 24
    a = _rand(rng, (n, n))
    shifts = np.array([0.5 + 0.1j, 2.0 - 1.0j, -1.0 + 0.5j])
    smin = npy(tla.pseudospectra(T(a), T(shifts), iters=200))
    expect = np.array([np.linalg.svd(a - z * np.eye(n), compute_uv=False)[-1]
                       for z in shifts])
    np.testing.assert_allclose(smin, expect, rtol=1e-2)
    ref = np.asarray(jla.pseudospectra(jnp.asarray(a), jnp.asarray(shifts),
                                       iters=200))
    np.testing.assert_allclose(smin, ref, rtol=1e-2)
    # one shift a batch: the same numbers
    s30 = npy(tla.pseudospectra(T(a), T(shifts), iters=30))
    monkeypatch.setattr(tspectral, "_CHUNK_BYTES", n * n * 16)
    np.testing.assert_array_equal(
        npy(tla.pseudospectra(T(a), T(shifts), iters=30)), s30)


def test_polar():
    rng = np.random.default_rng(15)
    n = 18
    a = _rand(rng, (n, n)) + 3 * np.eye(n)
    q, p = map(npy, tla.polar(T(a)))
    np.testing.assert_allclose(q @ p, a, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(q.T @ q, np.eye(n), atol=1e-6)
    assert np.all(np.linalg.eigvalsh((p + p.T) / 2) > 0)
    qj, pj = jla.polar(jnp.asarray(a))
    close(q, qj, 1e-12)
    close(p, pj, 1e-12)


def test_secular_evd():
    rng = np.random.default_rng(16)
    n = 12
    d = np.sort(rng.standard_normal(n))
    z = rng.standard_normal(n)
    rho = 0.7
    w = npy(tla.secular_evd(T(d), rho, T(z), iters=80))
    expect = np.linalg.eigvalsh(np.diag(d) + rho * np.outer(z, z))
    np.testing.assert_allclose(np.sort(w), expect, atol=1e-6)
    close(w, jla.secular_evd(jnp.asarray(d), rho, jnp.asarray(z), iters=80),
          1e-12)


# -- matrix functions ---------------------------------------------------------

def test_inverse_funcs():
    rng = np.random.default_rng(17)
    n = 30
    a = _rand(rng, (n, n)) + n * np.eye(n)
    inv = npy(tla.inverse(T(a)))
    np.testing.assert_allclose(inv, np.linalg.inv(a), rtol=1e-8, atol=1e-8)
    close(inv, jla.inverse(jnp.asarray(a)), 1e-12)
    hpd = a @ a.T
    hinv = npy(tla.hpd_inverse("L", T(hpd)))
    np.testing.assert_allclose(hinv, np.linalg.inv(hpd), rtol=1e-6,
                               atol=1e-6)
    close(hinv, jla.hpd_inverse("L", jnp.asarray(hpd)), 1e-12)
    close(tla.hpd_inverse("U", T(hpd)), jla.hpd_inverse("U", jnp.asarray(hpd)),
          1e-12)
    close(tla.triangular_inverse("U", "N", T(a)),
          jla.triangular_inverse("U", "N", jnp.asarray(a)), 1e-12)
    sym = a + a.T
    close(tla.symmetric_inverse(T(sym)),
          jla.symmetric_inverse(jnp.asarray(sym)), 1e-12)
    b = _rand(rng, (40, 20))
    pb = npy(tla.pseudoinverse(T(b)))
    np.testing.assert_allclose(b @ pb @ b, b, rtol=1e-8, atol=1e-8)
    close(pb, jla.pseudoinverse(jnp.asarray(b)), 1e-12)


class _Count:
    """Counts the calls of a wrapped function."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


def _jax_iterations(monkeypatch, fn, *args):
    """(result, iterations) of a JAX ``while_loop`` function: its carry's
    last entry counts the iterations."""
    real = jax.lax.while_loop
    seen = []

    def counted(cond, body, init):
        out = real(cond, body, init)
        seen.append(int(out[-1]))
        return out

    monkeypatch.setattr(jfuncs.jax.lax, "while_loop", counted)
    out = fn(*args)
    monkeypatch.setattr(jfuncs.jax.lax, "while_loop", real)
    return out, seen[-1]


def _port_iterations(monkeypatch, fn, *args, per=1):
    count = _Count(torch.linalg.inv)
    monkeypatch.setattr(torch.linalg, "inv", count)
    out = fn(*args)
    monkeypatch.setattr(torch.linalg, "inv", count.fn)
    return out, count.calls // per


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sign_and_sqrt(dtype, monkeypatch):
    rng = np.random.default_rng(18)
    n = 20
    a = _rand(rng, (n, n))
    a = (a @ a.T + n * np.eye(n)).astype(dtype)   # SPD → sign = I
    tol = 1e-6 if dtype == np.float64 else 1e-4
    s, its = _port_iterations(monkeypatch, tla.sign, T(a))
    sj, its_j = _jax_iterations(monkeypatch, jla.sign, jnp.asarray(a))
    np.testing.assert_allclose(npy(s), np.eye(n), atol=tol)
    assert its == its_j, (its, its_j)
    close(s, sj, VAL_TOL[np.dtype(dtype)])
    r, its = _port_iterations(monkeypatch, tla.square_root, T(a), per=2)
    rj, its_j = _jax_iterations(monkeypatch, jla.square_root,
                                jnp.asarray(a))
    assert its == its_j, (its, its_j)
    if dtype == np.float32:
        assert its == 64          # tol 1e-12 is out of float32's reach
    r = npy(r).astype(np.float64)
    np.testing.assert_allclose(r @ r, a, rtol=1e-7 if tol < 1e-5 else 1e-4,
                               atol=tol * n)
    close(r, rj, VAL_TOL[np.dtype(dtype)] * 10)
    r2 = npy(tla.hpd_square_root("L", T(a))).astype(np.float64)
    np.testing.assert_allclose(r2 @ r2, a, rtol=1e-7 if tol < 1e-5 else 1e-4,
                               atol=tol * n)
    close(r2, jla.hpd_square_root("L", jnp.asarray(a)),
          VAL_TOL[np.dtype(dtype)] * 10)


# -- condensed forms ----------------------------------------------------------

def test_condense_bidiag_hessenberg():
    rng = np.random.default_rng(19)
    m, n = 25, 25
    a = _rand(rng, (m, n))
    bd = tla.bidiag(T(a))
    B = np.diag(npy(bd.d)) + np.diag(npy(bd.e), 1)
    u, v = npy(bd.u), npy(bd.v)
    np.testing.assert_allclose(u.conj().T @ a @ v, B, atol=1e-8)
    for got, want in zip(bd, tla.from_reference(jla.bidiag(jnp.asarray(a)),
                                                 device=CPU)):
        close(got, want, 1e-12)
    h = tla.hessenberg("L", T(a))
    hh, q = npy(h.h), npy(h.q)
    np.testing.assert_allclose(q @ hh @ q.conj().T, a, atol=1e-8)
    assert np.abs(np.tril(hh, -2)).max() < 1e-10
    for got, want in zip(h, tla.from_reference(
            jla.hessenberg("L", jnp.asarray(a)), device=CPU)):
        close(got, want, 1e-12)


@pytest.mark.parametrize("n,cplx", [(60, False), (197, False), (80, True)])
def test_hermitian_tridiag_blocked_matches_unblocked(n, cplx):
    """Blocked (latrd panel + rank-2nb) == rank-2 loop reduction, and the
    port's blocked reduction == the JAX one."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n))
    if cplx:
        a = a + 1j * rng.standard_normal((n, n))
    a = (a + a.conj().T) / 2
    d, e, q = map(npy, tcondense._hermitian_tridiag_blocked("L", T(a),
                                                            nb=16))
    Tm = _tridiag(d, e)
    assert np.abs(q @ Tm @ q.conj().T - a).max() < 1e-11 * n
    assert np.abs(q.conj().T @ q - np.eye(n)).max() < 1e-11
    d2, e2, _ = tla.hermitian_tridiag("L", T(a), blocksize=8)
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(Tm)),
                               np.sort(np.linalg.eigvalsh(_tridiag(d2, e2))),
                               rtol=1e-9, atol=1e-9)
    ref = jcondense._hermitian_tridiag_blocked("L", jnp.asarray(a), nb=16)
    for got, want in zip((d, e, q), ref):
        close(got, want, 1e-10)


def test_blocked_bidiag_hessenberg_match():
    """Blocked (latrd-style panel) Bidiag/Hessenberg at sizes above the
    dispatch threshold, against their invariants and the JAX results."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((210, 200))
    d, e, U, V = map(npy, tcondense._bidiag_blocked(T(a), nb=32))
    B = np.zeros((210, 200))
    B[np.arange(200), np.arange(200)] = d
    B[np.arange(199), np.arange(1, 200)] = e
    assert np.abs(U @ B @ V.T - a).max() / np.abs(a).max() < 1e-12
    assert np.abs(U.T @ U - np.eye(210)).max() < 1e-12
    assert np.abs(V.T @ V - np.eye(200)).max() < 1e-12
    ref = jcondense._bidiag_blocked(jnp.asarray(a), nb=32)
    for got, want in zip((d, e, U, V), ref):
        close(got, want, 1e-10)

    h = rng.standard_normal((200, 200)) + 1j * rng.standard_normal((200, 200))
    H, Q = map(npy, tcondense._hessenberg_blocked(T(h), nb=32))
    assert np.abs(Q @ H @ Q.conj().T - h).max() / np.abs(h).max() < 1e-12
    assert np.abs(Q.conj().T @ Q - np.eye(200)).max() < 1e-12
    assert np.abs(np.tril(H, -2)).max() == 0.0
    Hj, Qj = jcondense._hessenberg_blocked(jnp.asarray(h), nb=32)
    close(H, Hj, 1e-10)
    close(Q, Qj, 1e-10)


def test_tridiag_eig_on_the_jax_reduction():
    """A JAX reduction carried across: the port's tridiagonal solver and
    its back-transform reproduce A's eigenpairs."""
    a = _herm(np.random.default_rng(20), 40)
    t = tla.from_reference(jla.hermitian_tridiag("L", jnp.asarray(a)),
                           device=CPU)
    w, z = tla.hermitian_tridiag_eig(t.d, t.e, alg="mrrr")
    q = npy(t.q @ z)
    w = npy(w)
    assert np.abs(a @ q - q * w[None, :]).max() < 1e-8
    close(w, np.linalg.eigvalsh(a), 1e-12)
    pair = tla.from_reference(jla.hermitian_eig("L", jnp.asarray(a)),
                              device=CPU)
    close(w, pair.w, 1e-12)
    sv = tla.from_reference(jla.svd(jnp.asarray(a), vectors=False),
                            device=CPU)
    assert sv.u is None and sv.vh is None
    close(sv.s, np.sort(np.abs(w))[::-1].copy(), 1e-12)


# -- Lanczos ------------------------------------------------------------------

def test_lanczos_ritz_values_match_extremal_eigs():
    rng = np.random.default_rng(0)
    n = 40
    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2
    v0 = rng.standard_normal(n)
    Tm = tla.lanczos(n, lambda v: T(A) @ v, basis_size=n, v0=T(v0))
    ritz = np.sort(np.linalg.eigvalsh(npy(Tm)))
    ev = np.sort(np.linalg.eigvalsh(A))
    assert abs(ritz[0] - ev[0]) < 1e-8 and abs(ritz[-1] - ev[-1]) < 1e-8
    Tj = jla.lanczos(n, lambda v: jnp.asarray(A) @ v, basis_size=n,
                     v0=jnp.asarray(v0))
    # without reorthogonalization the interior Ritz values of a full basis
    # follow the rounding; the extremal ones agree
    np.testing.assert_allclose(ritz[[0, -1]], np.sort(np.linalg.eigvalsh(
        np.asarray(Tj)))[[0, -1]], atol=1e-8)
    V, T2, v, beta = tla.lanczos_decomp(n, lambda x: T(A) @ x, 15, v0=T(v0))
    V = npy(V)
    assert np.abs(V.T @ V - np.eye(15)).max() < 1e-10
    resid = A @ V - V @ npy(T2) - float(beta) * np.outer(npy(v),
                                                          np.eye(15)[-1])
    assert np.abs(resid).max() < 1e-10
    ref = jla.lanczos_decomp(n, lambda x: jnp.asarray(A) @ x, 15,
                             v0=jnp.asarray(v0))
    for got, want in zip((V, T2, v, beta), ref):
        close(got, want, 1e-12)
    with pytest.raises(ValueError, match="device"):
        tla.lanczos_decomp(n, lambda x: x, 5)
    # without v0 the start is drawn on the given device
    assert tla.lanczos(n, lambda x: T(A) @ x, 5, device=CPU).shape == (5, 5)


def test_product_lanczos_singular_value_estimates():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((50, 30))
    smin, smax = tla.extremal_singular_value_estimates(T(A), basis_size=30)
    sv = np.linalg.svd(A, compute_uv=False)
    assert abs(float(smax) - sv[0]) < 1e-6 * sv[0]
    assert abs(float(smin) - sv[-1]) < 1e-4 * sv[0]
    v0 = rng.standard_normal(30)
    got = tla.extremal_singular_value_estimates(T(A), basis_size=30,
                                                v0=T(v0))
    Tj = jla.lanczos(30, lambda x: jnp.asarray(A).T @ (jnp.asarray(A) @ x),
                     30, v0=jnp.asarray(v0))
    ritz = np.clip(np.linalg.eigvalsh(np.asarray(Tj)), 0, None)
    close(torch.stack(got), np.sqrt(ritz[[0, -1]]), 1e-10)


def test_product_lanczos_on_sparse_operator():
    A = tlaplacian(8, 8, scaled=False)
    Tm = tla.product_lanczos(A, basis_size=40, device=CPU)
    ritz = np.linalg.eigvalsh(npy(Tm))
    sv = np.linalg.svd(A.to_scipy().toarray(), compute_uv=False)
    assert abs(np.sqrt(ritz[-1]) - sv[0]) < 1e-6 * sv[0]
    Tj = np.asarray(jla.product_lanczos(jlaplacian(8, 8, scaled=False),
                                        basis_size=40))
    assert abs(np.sqrt(np.linalg.eigvalsh(Tj)[-1]) - sv[0]) < 1e-6 * sv[0]


class _Dense:
    """A matvec operator over a dense tensor, with an adjoint given as
    ``rmatvec`` or as ``transpose()``."""

    def __init__(self, a, adjoint):
        self.a, self.height, self.width = a, a.shape[0], a.shape[1]
        if adjoint == "rmatvec":
            self.rmatvec = lambda x: a.mH @ x
        elif adjoint == "transpose":
            self.transpose = lambda: _Dense(a.T, None)

    def matvec(self, x):
        return self.a @ x


@pytest.mark.parametrize("branch", ["dense", "sparse_matrix", "csr_device",
                                    "rmatvec", "transpose", "wide"])
def test_product_lanczos_operator_branches(branch):
    """Each operator the JAX function recognizes (a dense array, a host
    SparseMatrix, a device CSR, ``matvec`` with ``rmatvec`` or
    ``transpose``) gives the same tridiagonal T from the same v0, equal to
    the JAX Lanczos of the same Gram operator."""
    rng = np.random.default_rng(21)
    a = rng.standard_normal((30, 18)) * (rng.random((30, 18)) < 0.3)
    a[np.arange(18), np.arange(18)] += 1.0
    if branch == "wide":
        a = a.T.copy()
    dim = min(a.shape)
    v0 = rng.standard_normal(dim)
    from elemental_tpu_torch.sparse import SparseMatrix
    op = {"dense": T(a), "wide": T(a),
          "sparse_matrix": SparseMatrix.from_dense(a),
          "csr_device": SparseMatrix.from_dense(a).device_csr(
              device=CPU, dtype=torch.float64),
          "rmatvec": _Dense(T(a), "rmatvec"),
          "transpose": _Dense(T(a), "transpose")}[branch]
    got = tla.product_lanczos(op, basis_size=12, v0=T(v0), device=CPU)
    aj = jnp.asarray(a)
    gram = ((lambda x: aj.T @ (aj @ x)) if a.shape[0] >= a.shape[1]
            else (lambda x: aj @ (aj.T @ x)))
    close(got, jla.lanczos(dim, gram, 12, v0=jnp.asarray(v0)), 1e-12)


def test_product_lanczos_needs_an_adjoint():
    op = _Dense(T(np.eye(3)), None)
    with pytest.raises(ValueError, match="adjoint"):
        tla.product_lanczos(op, basis_size=2, v0=T(np.ones(3)))
