"""Parity of the port's dense LAPACK tier (``elemental_tpu_torch.lapack``:
Cholesky, LU, LDL, QR, their solves, the helpers, props, equilibration and
the Euclidean minimizations) with the JAX package on the CPU, mirroring
``tests/lapack/test_factor.py`` case for case: the same seeded NumPy inputs
go through both packages, the port's result is held to the reference
test's own check and to the JAX result.

Tolerances, relative to the largest entry of the JAX result: float64 and
complex128 1e-12, float32 and complex64 1e-5.  Factors that LAPACK and
``torch.linalg`` may sign differently (Q, R) are held through Q·R, QᴴQ
and R's triangle.  Pivots, permutations and ranks must be equal.  Each
``solve_after*`` also runs on the JAX factor itself, carried across by
``lapack.from_reference``, within 1e-12.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elemental_tpu import lapack as jla
from elemental_tpu.core import MC, MR, STAR, VC
from elemental_tpu.core import distribute as jdistribute
from elemental_tpu.core import epsilon
from elemental_tpu.matrices import gepp_growth as jgepp_growth

from elemental_tpu_torch import lapack as tla
from elemental_tpu_torch.core import Grid
from elemental_tpu_torch.core import distribute as tdistribute
from elemental_tpu_torch.matrices import gepp_growth
from elemental_tpu_torch.utils.transfers import count_transfers

# the ``ldl`` modules (each package's ``lapack.ldl`` is the function)
jldl_mod = importlib.import_module("elemental_tpu.lapack.ldl")
tldl_mod = importlib.import_module("elemental_tpu_torch.lapack.ldl")

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = {np.dtype(np.float32): 1e-5, np.dtype(np.complex64): 1e-5,
       np.dtype(np.float64): 1e-12, np.dtype(np.complex128): 1e-12}


@pytest.fixture(scope="module")
def tgrid8():
    return Grid(devices=[CPU] * 8, height=2)


def _hpd(rng, n, dtype=np.float64):
    a = rng.standard_normal((n, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
    a = a.astype(dtype)
    return (a @ a.conj().T + n * np.eye(n)).astype(dtype)


def _rand(rng, shape, dtype=np.float64):
    a = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def T(x):
    return torch.from_numpy(np.array(x))


def npy(x):
    if isinstance(x, tuple):
        return tuple(npy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().resolve_neg().numpy()
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    return np.asarray(x)


def close(got, ref, tol):
    got, ref = npy(got), npy(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, (err, tol * scale)


# -- Cholesky ---------------------------------------------------------------

@pytest.mark.parametrize("uplo", ["L", "U"])
def test_cholesky_residual(dtype, uplo):
    rng = np.random.default_rng(3)
    n = 100
    a = _hpd(rng, n, dtype)
    f = npy(tla.cholesky(uplo, T(a)))
    recon = f @ f.conj().T if uplo == "L" else f.conj().T @ f
    rel = np.abs(recon - a).max() / (epsilon(dtype) * n * np.abs(a).max())
    assert rel < 100, rel
    close(f, jla.cholesky(uplo, jnp.asarray(a)), TOL[dtype])


def test_cholesky_solve_residual(rdtype):
    rng = np.random.default_rng(4)
    n, k = 120, 5
    a = _hpd(rng, n, rdtype)
    y = _rand(rng, (n, k), rdtype)
    x = npy(tla.hpd_solve("L", T(a), T(y)))
    relerr = np.abs(x - np.linalg.solve(a, y)).max() / (
        epsilon(rdtype) * n * np.abs(y).sum(axis=0).max())
    assert relerr < 100, relerr
    close(x, jla.hpd_solve("L", jnp.asarray(a), jnp.asarray(y)),
          TOL[rdtype] * 100)


def test_cholesky_recursive_large():
    rng = np.random.default_rng(5)
    n = 700  # exercises the recursion (base 256)
    a = _hpd(rng, n)
    f = npy(tla.cholesky("L", T(a)))
    assert np.allclose(f @ f.T, a, rtol=1e-10, atol=1e-8)
    assert np.allclose(np.triu(f, 1), 0)
    close(f, jla.cholesky("L", jnp.asarray(a)), 1e-12)


def test_cholesky_not_positive_definite_is_nan():
    """JAX writes NaN over a factor that is not positive definite;
    ``cholesky_ex`` reports it in ``info`` and the port writes NaN too."""
    a = -np.eye(4)
    for uplo in ("L", "U"):
        got = npy(tla.cholesky(uplo, T(a)))
        assert np.isnan(got).sum() == 10
        np.testing.assert_array_equal(
            got, np.asarray(jla.cholesky(uplo, jnp.asarray(a))))


def test_pivoted_cholesky():
    rng = np.random.default_rng(6)
    n = 40
    a = _hpd(rng, n)
    fact = tla.pivoted_cholesky("L", T(a))
    L, p = npy(fact.factor), npy(fact.perm)
    assert np.allclose(L @ L.T, a[p][:, p], rtol=1e-9, atol=1e-9)
    assert int(fact.rank) == n
    d = np.diag(L)
    assert np.all(d[:-1] >= d[1:] - 1e-12)
    ref = jla.pivoted_cholesky("L", jnp.asarray(a))
    np.testing.assert_array_equal(p, np.asarray(ref.perm))
    close(L, ref.factor, 1e-12)
    # a rank-deficient PSD matrix: the rank rule pivot > tol is JAX's
    g = _rand(rng, (n, 7))
    psd = g @ g.T
    got = tla.pivoted_cholesky("U", T(psd), tol=1e-10)
    ref = jla.pivoted_cholesky("U", jnp.asarray(psd), tol=1e-10)
    assert int(got.rank) == int(ref.rank) == 7
    # past the rank the live diagonal is rounding noise: the pivots agree up
    # to the rank
    np.testing.assert_array_equal(npy(got.perm)[:7], np.asarray(ref.perm)[:7])


def test_reverse_cholesky():
    rng = np.random.default_rng(7)
    n = 30
    a = _hpd(rng, n)
    low = npy(tla.reverse_cholesky("L", T(a)))
    assert np.allclose(low.T @ low, a, rtol=1e-9, atol=1e-9)  # A = LᴴL
    assert np.allclose(np.triu(low, 1), 0)
    u = npy(tla.reverse_cholesky("U", T(a)))
    assert np.allclose(u @ u.T, a, rtol=1e-9, atol=1e-9)      # A = U·Uᴴ
    assert np.allclose(np.tril(u, -1), 0)
    close(low, jla.reverse_cholesky("L", jnp.asarray(a)), 1e-12)
    close(u, jla.reverse_cholesky("U", jnp.asarray(a)), 1e-12)


def test_cholesky_mod():
    rng = np.random.default_rng(8)
    n, k = 25, 3
    a = _hpd(rng, n)
    L = npy(tla.cholesky("L", T(a)))
    v = _rand(rng, (n, k))
    L2 = npy(tla.cholesky_mod("L", T(L), 0.5, T(v)))
    assert np.allclose(L2 @ L2.T, a + 0.5 * v @ v.T, rtol=1e-8, atol=1e-8)
    close(L2, jla.cholesky_mod("L", jnp.asarray(L), 0.5, jnp.asarray(v)),
          1e-12)


def test_cholesky_distributed(grid8, tgrid8):
    rng = np.random.default_rng(9)
    n = 96
    a = _hpd(rng, n, np.float32)
    F = tla.cholesky("L", tdistribute(a, MC, MR, tgrid8))
    assert F.dist() == (MC, MR) and F.grid == tgrid8
    f = F.to_numpy()
    assert np.allclose(f @ f.T, a, rtol=1e-2, atol=1e-2)
    ref = jla.cholesky("L", jdistribute(a, MC, MR, grid8))
    close(f, ref.to_numpy(), 1e-5)


# -- LU ---------------------------------------------------------------------

def test_lu_solve(dtype):
    rng = np.random.default_rng(10)
    n, k = 80, 4
    a = _rand(rng, (n, n), dtype) + n * np.eye(n, dtype=dtype)
    b = _rand(rng, (n, k), dtype)
    fact = tla.lu(T(a))
    x = npy(tla.lu_solve_after(fact, T(b)))
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-3,
                               atol=1e-3)
    ref = jla.lu(jnp.asarray(a))
    np.testing.assert_array_equal(npy(fact.pivots), np.asarray(ref.pivots))
    np.testing.assert_array_equal(npy(fact.perm), np.asarray(ref.perm))
    close(fact.lu, ref.lu, TOL[dtype] * 10)
    close(x, jla.lu_solve_after(ref, jnp.asarray(b)), TOL[dtype] * 10)


def test_lu_transpose_solve():
    rng = np.random.default_rng(11)
    n = 50
    a = _rand(rng, (n, n)) + n * np.eye(n)
    b = _rand(rng, (n, 2))
    fact = tla.lu(T(a))
    x = npy(tla.lu_solve_after(fact, T(b), orient="T"))
    np.testing.assert_allclose(x, np.linalg.solve(a.T, b), rtol=1e-8)
    ref = jla.lu(jnp.asarray(a))
    close(x, jla.lu_solve_after(ref, jnp.asarray(b), orient="T"), 1e-12)


def test_lu_full_pivoting():
    rng = np.random.default_rng(12)
    n = 30
    a = _rand(rng, (n, n))
    fact = tla.lu_full(T(a))
    lu = npy(fact.lu)
    L = np.tril(lu, -1) + np.eye(n)
    U = np.triu(lu)
    rp, cp = npy(fact.rowperm), npy(fact.colperm)
    np.testing.assert_allclose(L @ U, a[rp][:, cp], rtol=1e-9, atol=1e-9)
    b = _rand(rng, (n, 1))
    x = npy(tla.solve_after_full(fact, T(b)))
    np.testing.assert_allclose(a @ x, b, rtol=1e-7, atol=1e-7)
    ref = jla.lu_full(jnp.asarray(a))
    np.testing.assert_array_equal(rp, np.asarray(ref.rowperm))
    np.testing.assert_array_equal(cp, np.asarray(ref.colperm))
    close(lu, ref.lu, 1e-12)


def test_determinant():
    rng = np.random.default_rng(13)
    n = 12
    a = _rand(rng, (n, n))
    got = float(tla.determinant(T(a)))
    np.testing.assert_allclose(got, np.linalg.det(a), rtol=1e-8)
    np.testing.assert_allclose(got, float(jla.determinant(jnp.asarray(a))),
                               rtol=1e-12)


def test_lu_pivots_and_determinant_sign_with_swaps():
    """A matrix that forces row swaps (an anti-diagonal dominant part):
    0-based pivots and the permutation as JAX holds them, and the
    determinant's sign from the swap count."""
    rng = np.random.default_rng(14)
    n = 9
    a = np.fliplr(np.diag(np.arange(1.0, n + 1))) + 0.01 * _rand(rng, (n, n))
    fact, ref = tla.lu(T(a)), jla.lu(jnp.asarray(a))
    piv = npy(fact.pivots)
    assert (piv != np.arange(n)).sum() > 0
    np.testing.assert_array_equal(piv, np.asarray(ref.pivots))
    np.testing.assert_array_equal(npy(fact.perm), np.asarray(ref.perm))
    L = np.tril(npy(fact.lu), -1) + np.eye(n)
    np.testing.assert_allclose(L @ np.triu(npy(fact.lu)),
                               a[npy(fact.perm)], atol=1e-12)
    det = float(tla.determinant(T(a)))
    assert np.sign(det) == np.sign(np.linalg.det(a))
    np.testing.assert_allclose(det, np.linalg.det(a), rtol=1e-10)
    np.testing.assert_array_equal(npy(tla.pivot_parity(fact.pivots)),
                                  np.asarray(jla.pivot_parity(ref.pivots)))


def test_gepp_growth_lu_attains_2_to_n_minus_1():
    """Every pivot choice on Wilkinson's matrix is a tie; LAPACK's getrf
    takes the first row and the growth is exactly 2ⁿ⁻¹ in both."""
    n = 20
    a = gepp_growth(n, device=CPU)
    np.testing.assert_array_equal(npy(a), np.asarray(jgepp_growth(n)))
    fact = tla.lu(a)
    growth = np.abs(np.triu(npy(fact.lu))).max() / np.abs(npy(a)).max()
    assert growth == 2.0 ** (n - 1)
    ref = jla.lu(jnp.asarray(npy(a)))
    np.testing.assert_array_equal(npy(fact.pivots), np.asarray(ref.pivots))
    np.testing.assert_array_equal(npy(fact.lu), np.asarray(ref.lu))


def test_lu_mod_and_linear_solve():
    rng = np.random.default_rng(15)
    n = 20
    a = _rand(rng, (n, n)) + n * np.eye(n)
    u, v, b = _rand(rng, n), _rand(rng, n), _rand(rng, (n, 2))
    got = tla.lu_mod(tla.lu(T(a)), T(u), T(v))
    ref = jla.lu_mod(jla.lu(jnp.asarray(a)), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(npy(got.perm), np.asarray(ref.perm))
    close(got.lu, ref.lu, 1e-12)
    close(tla.linear_solve(T(a), T(b)),
          jla.linear_solve(jnp.asarray(a), jnp.asarray(b)), 1e-12)


# -- QR ---------------------------------------------------------------------

def test_qr_residual(dtype):
    rng = np.random.default_rng(16)
    m, n = 60, 40
    a = _rand(rng, (m, n), dtype)
    q, r = npy(tla.qr(T(a)))
    assert np.allclose(q @ r, a, rtol=1e-4, atol=1e-4)
    assert np.allclose(q.conj().T @ q, np.eye(n), atol=1e-4)
    assert np.allclose(np.tril(r, -1), 0, atol=1e-6)
    # R's rows up to LAPACK's phases: |R| equal
    rq_ = np.asarray(jla.qr(jnp.asarray(a)).r)
    close(np.abs(r), np.abs(rq_), TOL[dtype] * 10)
    qc, rc = npy(tla.qr(T(a), full_matrices=True))
    assert qc.shape == (m, m) and rc.shape == (m, n)
    assert np.allclose(qc @ rc, a, rtol=1e-4, atol=1e-4)


def test_tsqr_matches_qr(grid8, tgrid8):
    rng = np.random.default_rng(17)
    m, n = 512, 24
    a = _rand(rng, (m, n), np.float64)
    q, r = npy(tla.tsqr(tdistribute(a, VC, STAR, tgrid8), tgrid8))
    assert np.allclose(q @ r, a, rtol=1e-9, atol=1e-9)
    assert np.allclose(q.T @ q, np.eye(n), atol=1e-9)
    jq, jr = jla.tsqr(jdistribute(a, VC, STAR, grid8), grid8)
    close(np.abs(r), np.abs(np.asarray(jr)), 1e-12)
    close(np.abs(q), np.abs(np.asarray(jq)), 1e-12)


def test_cholesky_qr():
    rng = np.random.default_rng(18)
    m, n = 200, 16
    a = _rand(rng, (m, n))
    q, r = npy(tla.cholesky_qr(T(a)))
    assert np.allclose(q @ r, a, rtol=1e-8, atol=1e-8)
    assert np.allclose(q.T @ q, np.eye(n), atol=1e-8)
    ref = jla.cholesky_qr(jnp.asarray(a))
    close(q, ref.q, 1e-12)
    close(r, ref.r, 1e-12)


def test_qr_pivoted():
    rng = np.random.default_rng(19)
    m, n = 40, 25
    a = _rand(rng, (m, n))
    fact = tla.qr_pivoted(T(a))
    q, r, p = npy(fact.q), npy(fact.r), npy(fact.perm)
    assert np.allclose(q @ r, a[:, p], rtol=1e-8, atol=1e-8)
    d = np.abs(np.diag(r))
    assert np.all(d[:-1] >= d[1:] - 1e-8)
    assert np.allclose(q.T @ q, np.eye(n), atol=1e-8)
    ref = jla.qr_pivoted(jnp.asarray(a))
    np.testing.assert_array_equal(p, np.asarray(ref.perm))
    close(q, ref.q, 1e-12)
    close(r, ref.r, 1e-12)


def test_qr_pivoted_complex():
    rng = np.random.default_rng(7)
    m, n = 24, 16
    a = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    fact = tla.qr_pivoted(T(a))
    q, r, p = npy(fact.q), npy(fact.r), npy(fact.perm)
    assert np.allclose(q @ r, a[:, p], rtol=1e-8, atol=1e-8)
    assert np.allclose(q.conj().T @ q, np.eye(n), atol=1e-8)
    assert np.abs(np.tril(r, -1)).max() < 1e-10
    ref = jla.qr_pivoted(jnp.asarray(a))
    np.testing.assert_array_equal(p, np.asarray(ref.perm))
    close(r, ref.r, 1e-12)


def test_lq_rq():
    rng = np.random.default_rng(20)
    m, n = 30, 50
    a = _rand(rng, (m, n))
    low, q = npy(tla.lq(T(a)))
    assert np.allclose(low @ q, a, rtol=1e-9, atol=1e-9)
    assert np.allclose(np.triu(low, 1), 0, atol=1e-9)
    r, q2 = npy(tla.rq(T(a)))
    assert np.allclose(r @ q2, a, rtol=1e-9, atol=1e-9)
    jl, _ = jla.lq(jnp.asarray(a))
    jr, _ = jla.rq(jnp.asarray(a))
    close(np.abs(low), np.abs(np.asarray(jl)), 1e-12)
    close(np.abs(r), np.abs(np.asarray(jr)), 1e-12)


def test_apply_q_householder():
    rng = np.random.default_rng(21)
    m, n = 30, 30
    a = _rand(rng, (m, n))
    packed, taus = tla.qr_householder(T(a))
    q = npy(tla.expand_packed_reflectors(packed, taus))
    b = _rand(rng, (m, 3))
    qb = npy(tla.apply_q(packed, taus, T(b)))
    np.testing.assert_allclose(qb, q @ b, rtol=1e-8, atol=1e-8)
    # the packed form reproduces A; the JAX loop's does not (it reflects
    # the stored reflectors of earlier columns too), but its R and taus
    # are the same
    np.testing.assert_allclose(q @ np.triu(npy(packed)), a, atol=1e-12)
    jpacked, jtaus = jla.qr_householder(jnp.asarray(a))
    jq = np.asarray(jla.expand_packed_reflectors(jpacked, jtaus))
    assert np.abs(jq @ np.triu(np.asarray(jpacked)) - a).max() > 1e-3
    close(np.triu(npy(packed)), np.triu(np.asarray(jpacked)), 1e-12)
    close(taus, jtaus, 1e-12)
    jpacked = jnp.asarray(npy(packed))
    close(tla.apply_q(packed, taus, T(b), adjoint=True),
          jla.apply_q(jpacked, jtaus, jnp.asarray(b), adjoint=True), 1e-12)
    close(tla.apply_packed_reflectors("L", "L", "B", packed, taus, T(b)),
          jla.apply_packed_reflectors("L", "L", "B", jpacked, jtaus,
                                      jnp.asarray(b)), 1e-12)


# -- LDL --------------------------------------------------------------------

@pytest.mark.parametrize("conjugate", [False, True])
def test_ldl_residual(conjugate):
    rng = np.random.default_rng(22)
    n = 150   # one recursion level over the 128-column base
    dt = np.complex128 if conjugate else np.float64
    a = _hpd(rng, n, dt)
    if not conjugate:
        a = (a + a.T) / 2
    fact = tla.ldl(T(a), conjugate=conjugate)
    L, d = npy(fact.lower), npy(fact.diag)
    rhs = L.conj().T if conjugate else L.T
    assert np.allclose((L * d[None, :]) @ rhs, a, rtol=1e-9, atol=1e-8)
    assert np.allclose(np.diag(L), 1.0)
    ref = jla.ldl(jnp.asarray(a), conjugate=conjugate)
    close(L, ref.lower, 1e-12)
    close(d, ref.diag, 1e-12)


def test_ldl_indefinite_quasidefinite():
    rng = np.random.default_rng(23)
    n, m = 30, 20
    A = _rand(rng, (m, n))
    kkt = np.block([[np.eye(n), A.T], [A, -np.eye(m)]])
    fact = tla.ldl(T(kkt), conjugate=False)
    L, d = npy(fact.lower), npy(fact.diag)
    assert np.allclose((L * d[None, :]) @ L.T, kkt, rtol=1e-9, atol=1e-8)
    pos, neg, zero = tla.ldl_inertia(fact)
    assert (int(pos), int(neg)) == (n, m)
    close(d, jla.ldl(jnp.asarray(kkt), conjugate=False).diag, 1e-12)


def test_regularized_ldl_solve_refined():
    rng = np.random.default_rng(24)
    n = 60
    a = _hpd(rng, n)
    reg = np.full(n, 1e-4)
    fact = tla.regularized_ldl(T(a), T(reg))
    b = _rand(rng, (n,))
    x = npy(tla.solve_after_refined(T(a), fact, T(b)))
    np.testing.assert_allclose(a @ x, b, rtol=1e-8, atol=1e-8)
    ref = jla.solve_after_refined(
        jnp.asarray(a), jla.regularized_ldl(jnp.asarray(a), jnp.asarray(reg)),
        jnp.asarray(b))
    close(x, ref, 1e-12)


def test_inertia():
    rng = np.random.default_rng(25)
    d = np.array([3.0, -2.0, 5.0, -1.0, 4.0])
    q, _ = np.linalg.qr(_rand(rng, (5, 5)))
    a = q @ np.diag(d) @ q.T
    a = (a + a.T) / 2
    got = tuple(int(v) for v in tla.inertia(T(a), conjugate=False))
    assert got == (3, 2, 0)
    ref = jla.inertia(jnp.asarray(a), conjugate=False)
    assert got == tuple(int(v) for v in ref)


def test_tsqr_tree_matches_gather(grid8, tgrid8):
    """Butterfly tree TSQR == gather TSQR == reference QR, on the 2×4
    grid; the transfer log holds p(p−1)·n² and p·log₂p·n² elements."""
    rng = np.random.default_rng(26)
    a = rng.standard_normal((256, 12))
    rs = {}
    for tree in (False, True):
        with count_transfers() as log:
            q, r = npy(tla.tsqr(T(a), grid=tgrid8, tree=tree))
        np.testing.assert_allclose(q @ r, a, atol=1e-10)
        np.testing.assert_allclose(q.T @ q, np.eye(12), atol=1e-10)
        assert np.abs(np.tril(r, -1)).max() < 1e-12
        p, n = 8, 12
        want = p * (p - 1) * n * n * 8 if not tree else p * 3 * n * n * 8
        assert log.bytes() == want
        assert len(log) == (p if not tree else 3 * p)
        jq, jr = jla.tsqr(jnp.asarray(a), grid=grid8, tree=tree)
        close(r, jr, 1e-12)
        close(q, jq, 1e-12)
        rs[tree] = r
    # R is unique up to the signs of its rows
    close(np.abs(rs[True]), np.abs(rs[False]), 1e-12)
    with pytest.raises(ValueError, match="power-of-two"):
        tla.tsqr(T(a), grid=Grid(devices=[CPU] * 6, height=2), tree=True)


@pytest.mark.parametrize("n,cplx", [(2, False), (31, False), (64, False),
                                    (24, True)])
def test_bunch_kaufman_pivoted_ldl(n, cplx):
    """Bunch-Kaufman handles indefinite matrices with tiny diagonals; the
    port's factor equals the JAX one (n = 2 is the case where JAX's
    masked 2×2 step reads a clamped index k+1 = n)."""
    rng = np.random.default_rng(9 + n)
    a = rng.standard_normal((n, n))
    if cplx:
        a = a + 1j * rng.standard_normal((n, n))
    a = (a + a.conj().T) / 2
    np.fill_diagonal(a, 1e-12 * np.real(np.diag(a)))
    f = tldl_mod.ldl_pivoted(T(a), conjugate=cplx)
    L, d, e, p = npy(tuple(f))
    D = np.diag(d)
    if n > 1:
        D = D + np.diag(e, -1) + np.diag(np.conj(e) if cplx else e, 1)
    recon = L @ D @ L.conj().T if cplx else L @ D @ L.T
    err = np.abs(recon - a[np.ix_(p, p)]).max()
    assert err < 1e-12 * max(1, np.abs(a).max()) * n, err
    assert np.abs(L).max() < 10.0
    b = rng.standard_normal(n)
    x = npy(tldl_mod.solve_after_pivoted(f, T(b), conjugate=cplx))
    assert np.linalg.norm(a @ x - b) < 1e-8 * np.linalg.norm(b)
    ref = jldl_mod.ldl_pivoted(jnp.asarray(a), conjugate=cplx)
    np.testing.assert_array_equal(p, np.asarray(ref.perm))
    for got, want in zip((L, d, e), ref[:3]):
        close(got, want, 1e-12)


# -- solve_after* on the JAX factors ---------------------------------------

def test_solves_on_reference_factors():
    """Each port ``solve_after*`` on the JAX package's own factor, carried
    across by ``from_reference``, agrees with the JAX solve to 1e-12."""
    rng = np.random.default_rng(27)
    n = 40
    a = _rand(rng, (n, n)) + n * np.eye(n)
    spd = _hpd(rng, n)
    b = _rand(rng, (n, 3))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for orient in ("N", "T", "C"):
        f = jla.lu(ja)
        close(tla.lu_solve_after(tla.from_reference(f, device=CPU), T(b),
                                 orient=orient),
              jla.lu_solve_after(f, jb, orient=orient), 1e-12)
    f = jla.lu_full(ja)
    close(tla.solve_after_full(tla.from_reference(f, device=CPU), T(b)),
          jla.solve_after_full(f, jb), 1e-12)
    f = jla.ldl(jnp.asarray(spd), conjugate=False)
    close(tla.ldl_solve_after(tla.from_reference(f, device=CPU), T(b),
                              conjugate=False),
          jla.ldl_solve_after(f, jb, conjugate=False), 1e-12)
    sym = (a + a.T) / 2
    np.fill_diagonal(sym, 1e-9)
    f = jldl_mod.ldl_pivoted(jnp.asarray(sym))
    close(tldl_mod.solve_after_pivoted(tla.from_reference(f, device=CPU),
                                       T(b)),
          jldl_mod.solve_after_pivoted(f, jb), 1e-12)
    L = jla.cholesky("L", jnp.asarray(spd))
    close(tla.cholesky_solve_after("L", "N", T(np.asarray(L)), T(b)),
          jla.cholesky_solve_after("L", "N", L, jb), 1e-12)
    pc = tla.from_reference(jla.pivoted_cholesky("L", jnp.asarray(spd)),
                            device=CPU)
    assert isinstance(pc, tla.PivotedCholesky) and pc.perm.dtype == torch.int64
    qrp = tla.from_reference(jla.qr_pivoted(ja), device=CPU)
    assert isinstance(qrp, tla.QRPivoted)


# -- helpers, props, equilibration, Euclidean minimization ------------------

def test_util_median_sort_and_tagged_sort_ties():
    even = np.array([4.0, 1.0, 3.0, 2.0, 8.0, 5.0])
    assert float(tla.median(T(even))) == float(jla.median(jnp.asarray(even)))
    assert float(tla.median(T(even))) == 3.5
    close(tla.sort(T(even), descending=True),
          jla.sort(jnp.asarray(even), descending=True), 0)
    ties = np.array([3.0, 1.0, 2.0, 1.0, 3.0, 2.0, 1.0])
    for desc in (False, True):
        v, i = npy(tla.tagged_sort(T(ties), desc))
        jv, ji = jla.tagged_sort(jnp.asarray(ties), desc)
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_array_equal(v, np.asarray(jv))


def test_permutations_and_reflectors():
    rng = np.random.default_rng(28)
    piv = np.array([3, 1, 4, 4, 4])
    P = tla.pivots_to_permutation(piv)
    np.testing.assert_array_equal(npy(P.perm), np.asarray(
        jla.pivots_to_permutation(piv).perm))
    np.testing.assert_array_equal(npy(tla.permutation_to_pivots(P)), piv)
    a = _rand(rng, (5, 5))
    close(P.permute_rows(T(a), inverse=True),
          jla.pivots_to_permutation(piv).permute_rows(jnp.asarray(a),
                                                       inverse=True), 0)
    x = _rand(rng, 7, np.complex128)
    for got, want in zip(tla.householder(T(x)),
                         jla.householder(jnp.asarray(x))):
        close(got, want, 1e-12)
    y = np.array([3.0, 1.0, -1.5, 0.5])
    for got, want in zip(tla.hyperbolic_reflector(T(y)),
                         jla.hyperbolic_reflector(jnp.asarray(y))):
        close(got, want, 1e-12)


def test_props():
    rng = np.random.default_rng(29)
    a = _rand(rng, (20, 20))
    spd = _hpd(rng, 20)
    ja = jnp.asarray(a)
    for name in ("one_norm", "infinity_norm", "frobenius_norm", "max_norm",
                 "two_norm", "nuclear_norm", "trace", "condition",
                 "log_det"):
        close(getattr(tla, name)(T(a)), getattr(jla, name)(ja), 1e-12)
    close(tla.entrywise_norm(T(a), 3.0), jla.entrywise_norm(ja, 3.0), 1e-12)
    close(tla.schatten_norm(T(a), 3.0), jla.schatten_norm(ja, 3.0), 1e-12)
    close(tla.norm(T(a), "inf"), jla.norm(ja, "inf"), 1e-12)
    close(tla.condition(T(a), "one"), jla.condition(ja, "one"), 1e-10)
    close(tla.hpd_determinant("L", T(spd)) / np.linalg.det(spd), 1.0, 1e-10)
    close(tla.props.determinant(T(a)), jla.props.determinant(ja), 1e-12)
    # the power iteration starts elsewhere than JAX's (torch's draws): both
    # reach the two-norm
    g = np.diag(np.r_[10.0, np.linspace(1.0, 5.0, 19)]) @ np.linalg.qr(a)[0]
    np.testing.assert_allclose(float(tla.two_norm_estimate(T(g))), 10.0,
                               rtol=1e-6)


def test_equilibration():
    rng = np.random.default_rng(30)
    a = _rand(rng, (30, 20)) * np.exp(3 * rng.standard_normal((30, 1)))
    a[3, :] = 0.0
    for name in ("ruiz_equil", "geom_equil"):
        for got, want in zip(getattr(tla, name)(T(a)),
                             getattr(jla, name)(jnp.asarray(a))):
            close(got, want, 1e-12)
    s = a[:20] @ a[:20].T
    for name in ("symmetric_ruiz_equil", "symmetric_diagonal_equil"):
        for got, want in zip(getattr(tla, name)(T(s)),
                             getattr(jla, name)(jnp.asarray(s))):
            close(got, want, 1e-12)


@pytest.mark.parametrize("orient", ["N", "T", "C"])
def test_euclidean_min(orient):
    rng = np.random.default_rng(31)
    a = _rand(rng, (50, 20), np.complex128)
    m = 50 if orient == "N" else 20
    b = _rand(rng, (m, 2), np.complex128)
    close(tla.least_squares(orient, T(a), T(b)),
          jla.least_squares(orient, jnp.asarray(a), jnp.asarray(b)), 1e-12)
    close(tla.ridge(orient, T(a), T(b), 0.7),
          jla.ridge(orient, jnp.asarray(a), jnp.asarray(b), 0.7), 1e-12)
    G = _rand(rng, (a.shape[1] if orient == "N" else 50,) * 2)
    close(tla.tikhonov(orient, T(a), T(b), T(G)),
          jla.tikhonov(orient, jnp.asarray(a), jnp.asarray(b),
                       jnp.asarray(G)), 1e-12)


def test_lse_glm_and_dense_solvers():
    rng = np.random.default_rng(32)
    A, B = _rand(rng, (30, 16)), _rand(rng, (5, 16))
    c, d = _rand(rng, 30), _rand(rng, 5)
    close(tla.lse(T(A), T(B), T(c), T(d)),
          jla.lse(*(jnp.asarray(v) for v in (A, B, c, d))), 1e-12)
    Ag, Bg, dg = _rand(rng, (20, 6)), _rand(rng, (20, 25)), _rand(rng, 20)
    for got, want in zip(tla.glm(T(Ag), T(Bg), T(dg)),
                         jla.glm(*(jnp.asarray(v) for v in (Ag, Bg, dg)))):
        close(got, want, 1e-12)
    s = _hpd(rng, 20, np.complex128)
    rhs = _rand(rng, (20, 2), np.complex128)
    for name in ("hermitian_solve", "sqsd_solve", "symmetric_solve"):
        close(getattr(tla, name)(T(s), T(rhs)),
              getattr(jla, name)(jnp.asarray(s), jnp.asarray(rhs)), 1e-12)
    h = np.triu(_rand(rng, (12, 12)), -1)
    shifts = _rand(rng, 3)
    rhs = _rand(rng, (12, 3))
    close(tla.multishift_hess_solve(T(h), T(shifts), T(rhs)),
          jla.multishift_hess_solve(jnp.asarray(h), jnp.asarray(shifts),
                                    jnp.asarray(rhs)), 1e-12)


# -- the slice's cases of tests/lapack/test_spectral_solve.py --------------
# each at the reference test's own gate, and against the JAX result

def test_linear_and_symmetric_solves():
    rng = np.random.default_rng(33)
    n = 60
    a = _rand(rng, (n, n)) + n * np.eye(n)
    b = _rand(rng, (n, 3))
    x = npy(tla.linear_solve(T(a), T(b)))
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-8)
    s = (a + a.T) / 2
    xs = npy(tla.symmetric_solve(T(s), T(b)))
    np.testing.assert_allclose(xs, np.linalg.solve(s, b), rtol=1e-8)
    close(xs, jla.symmetric_solve(jnp.asarray(s), jnp.asarray(b)), 1e-12)


def test_refined_solve_on_float32_lu():
    rng = np.random.default_rng(34)
    n = 50
    a = _rand(rng, (n, n)) + n * np.eye(n)
    b = _rand(rng, (n,))
    fact = tla.lu(T(a.astype(np.float32)))
    A = T(a)
    res = tla.refined_solve(
        lambda v: A @ v,
        lambda v: tla.lu_solve_after(fact, v.float()).double(),
        T(b), tol=1e-13)
    assert np.linalg.norm(a @ npy(res.x) - b) < 1e-9


def test_multishift_hess_solve():
    rng = np.random.default_rng(35)
    n, k = 20, 4
    h = np.triu(_rand(rng, (n, n)), -1) + n * np.eye(n)
    shifts = rng.standard_normal(k)
    b = _rand(rng, (n, k))
    x = npy(tla.multishift_hess_solve(T(h), T(shifts), T(b)))
    for j in range(k):
        np.testing.assert_allclose((h - shifts[j] * np.eye(n)) @ x[:, j],
                                   b[:, j], atol=1e-8)
    close(x, jla.multishift_hess_solve(jnp.asarray(h), jnp.asarray(shifts),
                                       jnp.asarray(b)), 1e-12)


@pytest.mark.parametrize("shape", [(60, 25), (25, 60)])
def test_least_squares(shape):
    """Overdetermined through QR, underdetermined to the minimum norm."""
    rng = np.random.default_rng(36)
    a, b = _rand(rng, shape), _rand(rng, (shape[0],))
    x = npy(tla.least_squares("N", T(a), T(b)))
    np.testing.assert_allclose(x, np.linalg.lstsq(a, b, rcond=None)[0],
                               rtol=1e-8, atol=1e-8)
    close(x, jla.least_squares("N", jnp.asarray(a), jnp.asarray(b)), 1e-12)


def test_ridge_tikhonov():
    rng = np.random.default_rng(37)
    m, n = 50, 20
    a, b = _rand(rng, (m, n)), _rand(rng, (m,))
    x = npy(tla.ridge("N", T(a), T(b), 0.3))
    np.testing.assert_allclose(
        x, np.linalg.solve(a.T @ a + 0.09 * np.eye(n), a.T @ b),
        rtol=1e-9, atol=1e-9)
    g = _rand(rng, (n, n)) * 0.1
    x = npy(tla.tikhonov("N", T(a), T(b), T(g)))
    np.testing.assert_allclose(x, np.linalg.solve(a.T @ a + g.T @ g, a.T @ b),
                               rtol=1e-8, atol=1e-8)


def test_lse():
    import scipy.linalg as sla
    rng = np.random.default_rng(38)
    m, n, p = 40, 20, 8
    a, b = _rand(rng, (m, n)), _rand(rng, (p, n))
    c, d = _rand(rng, (m,)), _rand(rng, (p,))
    x = npy(tla.lse(T(a), T(b), c, d))
    np.testing.assert_allclose(b @ x, d, atol=1e-8)
    Z = sla.null_space(b)
    np.testing.assert_allclose(Z.T @ (a.T @ (a @ x - c)), 0, atol=1e-6)


def test_glm():
    rng = np.random.default_rng(39)
    m, n, p = 30, 12, 30
    a, b, d = _rand(rng, (m, n)), _rand(rng, (m, p)), _rand(rng, (m,))
    x, y = npy(tla.glm(T(a), T(b), d))
    np.testing.assert_allclose(a @ x + b @ y, d, atol=1e-8)


def test_equilibrate():
    rng = np.random.default_rng(40)
    m, n = 30, 20
    a = _rand(rng, (m, n)) * np.exp(rng.standard_normal((m, n)) * 3)
    scaled, drow, dcol = npy(tuple(tla.ruiz_equil(T(a), iters=10)))
    assert np.abs(scaled).max() < 2.0
    np.testing.assert_allclose(drow[:, None] * scaled * dcol[None, :], a,
                               rtol=1e-9)
    a2, r2, c2 = npy(tuple(tla.geom_equil(T(a))))
    np.testing.assert_allclose(r2[:, None] * a2 * c2[None, :], a, rtol=1e-9)
    s = a[:n, :n] + a[:n, :n].T
    sa, d = npy(tla.symmetric_ruiz_equil(T(s)))
    np.testing.assert_allclose(d[:, None] * sa * d[None, :], s, rtol=1e-6)


def test_permutation():
    rng = np.random.default_rng(41)
    n = 10
    perm = rng.permutation(n)
    p = tla.Permutation(perm)
    a = _rand(rng, (n, n))
    pa = npy(p.permute_rows(T(a)))
    np.testing.assert_array_equal(pa, a[perm])
    back = npy(p.inverse().permute_rows(T(pa)))
    np.testing.assert_array_equal(back, a[npy(p.compose(p.inverse()).perm)])
    np.testing.assert_array_equal(
        npy(p.permute_rows(p.permute_rows(T(a)), inverse=True)), a)
    jp = jla.Permutation(perm)
    np.testing.assert_array_equal(npy(p.permute_cols(T(a))),
                                  np.asarray(jp.permute_cols(jnp.asarray(a))))
    np.testing.assert_array_equal(
        npy(p.permute_symmetric(T(a))),
        np.asarray(jp.permute_symmetric(jnp.asarray(a))))
