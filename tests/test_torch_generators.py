"""Parity of the port's matrix generators (``elemental_tpu_torch.matrices``:
``deterministic.py`` and ``random_gen.py``) with the JAX package on the
CPU, and the cases of ``tests/ops/test_generators_breadth.py`` that need
only these generators and the dense factorizations.

Deterministic generators: the same call in both packages, float64 results
equal within 1e-15 of their largest entry (the transcendental ones may
differ in the last bit), dtypes and shapes equal.  Random generators: torch's
draws are not ``jax.random``'s, so each is held to its shape, dtype,
structure (Hermitian, unitary, support) and the mean and variance of its
distribution within 5σ.
"""

import numpy as np
import pytest
import torch

import elemental_tpu.matrices as JM

import elemental_tpu_torch.matrices as M
from elemental_tpu_torch.core import random_ as rng
from elemental_tpu_torch.lapack import lu

torch.set_num_threads(1)

CPU = torch.device("cpu")
F32 = torch.float32

# (name, arguments) of every deterministic generator built from nothing
FROM_NOTHING = [
    ("zeros", (3, 4)), ("ones", (3,)), ("identity", (4,)),
    ("jordan", (5, 2.0)), ("hilbert", (6,)), ("lotkin", (6,)),
    ("fourier", (8,)), ("walsh", (3,)), ("walsh", (3, True)),
    ("wilkinson", (3,)), ("kahan", (6, 0.3)), ("demmel", (6,)),
    ("minij", (5,)), ("onetwoone", (5,)), ("pei", (5, 2.0)),
    ("parter", (5,)), ("redheffer", (7,)), ("riemann", (7,)),
    ("ris", (5,)), ("lehmer", (5,)), ("forsythe", (5, 1e-3, 2.0)),
    ("lauchli", (4, 0.1)), ("gcd_matrix", (6,)), ("gear", (6,)),
    ("gkms", (5,)), ("kms", (5, 0.3)), ("hanowa", (6, 2.0)),
    ("grcar", (7,)), ("triangle", (6,)), ("trefethen_embree", (6,)),
    ("ehrenfest", (6,)), ("egorov", (6,)),
    ("dynamic_regularization_counter", (6,)), ("gks", (6,)),
    ("legendre", (6,)), ("extended_kahan", (2, 0.9, 0.1)),
    ("gepp_growth", (6,)), ("jordan_cholesky", (6,)),
    ("druinsky_toledo", (5,)), ("riffle", (7,)),
    ("riffle_stationary", (7,)), ("riffle_decay", (7,)),
    ("bulls_head", (6,)), ("whale", (8,)), ("tri_w", (6, -2.0, 3)),
    ("fox_li", (16, 16.0)),
]

# (name, arguments) of the generators built from given vectors
FROM_VECTORS = [
    ("diagonal", ([1.0, 2.0],)), ("cauchy", ([1.0, 2.0], [0.5, 3.0])),
    ("circulant", ([1.0, 2.0, 3.0],)),
    ("toeplitz", ([1.0, 2.0, 3.0], [1.0, 5.0, 6.0, 7.0])),
    ("toeplitz", ([1.0, 2.0, 3.0],)),
    ("hankel", ([1.0, 2.0, 3.0], [3.0, 5.0])),
    ("fiedler", ([1.0, 4.0, 2.0],)),
    ("cauchy_like", ([1.0, 2.0], [3.0, 4.0, 5.0], [2.0, 3.0],
                     [0.0, 1.0, -1.0])),
]


def npy(t):
    return t.detach().resolve_conj().numpy()


def same(got, ref, tol=1e-15):
    got, ref = npy(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, ref.shape, got.dtype, ref.dtype)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    assert np.abs(got - ref).max(initial=0.0) <= tol * scale


@pytest.mark.parametrize("name,args", FROM_NOTHING,
                         ids=[f"{n}{len(a)}" for n, a in FROM_NOTHING])
def test_deterministic_generator_matches_jax(name, args):
    same(getattr(M, name)(*args, device=CPU), getattr(JM, name)(*args))


@pytest.mark.parametrize("name,args", FROM_VECTORS,
                         ids=[f"{n}{len(a)}" for n, a in FROM_VECTORS])
def test_vector_generator_matches_jax(name, args):
    same(getattr(M, name)(*args), getattr(JM, name)(*args), 0.0)


def test_generators_take_dtype_as_jax():
    for name, args in (("hilbert", (6,)), ("kms", (5, 0.3)),
                       ("gepp_growth", (6,)), ("legendre", (6,))):
        got = getattr(M, name)(*args, dtype=F32, device=CPU)
        same(got, getattr(JM, name)(*args, dtype=np.float32), 1e-7)
    got = M.fox_li(8, 3.0, dtype=torch.complex64, device=CPU)
    same(got, JM.fox_li(8, 3.0, dtype=np.complex64), 1e-6)


# -- the breadth cases (tests/ops/test_generators_breadth.py) --------------

def test_riffle_is_stochastic_with_known_stationary():
    n = 10
    P = npy(M.riffle(n, device=CPU))
    assert np.abs(P.sum(axis=1) - 1).max() < 1e-12
    pi = npy(M.riffle_stationary(n, device=CPU))[0]
    assert abs(pi.sum() - 1) < 1e-12
    assert np.abs(pi @ P - pi).max() < 1e-12
    assert np.abs(npy(M.riffle_decay(n, device=CPU)) - (P - pi)).max() \
        < 1e-14


def test_legendre_eigenvalues_are_gauss_nodes():
    n = 12
    w = np.sort(np.linalg.eigvalsh(npy(M.legendre(n, device=CPU))))
    x, _ = np.polynomial.legendre.leggauss(n)
    assert np.abs(w - np.sort(x)).max() < 1e-12


def test_fox_li_unit_two_norm():
    A = npy(M.fox_li(64, 16.0, device=CPU))
    assert abs(np.linalg.norm(A, 2) - 1.0) < 1e-8
    assert np.abs(np.linalg.eigvals(A)).max() <= 1.0 + 1e-8


def test_gepp_growth_exhibits_2_to_n_growth():
    n = 10
    fact = lu(M.gepp_growth(n, device=CPU))
    U = np.triu(npy(fact.lu))
    assert abs(U[-1, -1] - 2.0 ** (n - 1)) < 1e-9


def test_jordan_cholesky_factor_is_jordan():
    n = 8
    L = np.linalg.cholesky(npy(M.jordan_cholesky(n, device=CPU)))
    U = L.T
    assert np.abs(np.diag(U) - 1.0).max() < 1e-12
    assert np.abs(np.diag(U, 1) - 2.0).max() < 1e-12
    assert np.abs(np.triu(U, 2)).max() < 1e-12


def test_druinsky_toledo_symmetric_and_indefinite():
    A = npy(M.druinsky_toledo(6, device=CPU))
    assert np.abs(A - A.T).max() == 0
    ev = np.linalg.eigvalsh(A)
    assert ev[0] < 0 < ev[-1]


def test_extended_kahan_rank_deficiency_signal():
    c2 = np.linalg.cond(npy(M.extended_kahan(2, 0.9, 0.1, device=CPU)))
    c3 = np.linalg.cond(npy(M.extended_kahan(3, 0.9, 0.1, device=CPU)))
    assert c3 > 10 * c2 > 0
    with pytest.raises(ValueError):
        M.extended_kahan(2, 1.5, 0.1, device=CPU)


def test_gks_columns_have_unit_norm():
    A = npy(M.gks(16, device=CPU))
    assert np.abs(np.triu(A) - A).max() == 0
    assert np.abs(np.linalg.norm(A, axis=0) - 1.0).max() < 1e-12


def test_banded_toeplitz_symbols():
    W = npy(M.whale(10, device=CPU))
    assert W[1, 0] == 10.0 and W[0, 1] == 1.0 and W[0, 4] == -1.0
    B = npy(M.bulls_head(8, device=CPU))
    assert B[0, 1] == 2j and B[2, 0] == 1.0 and B[3, 0] == 0.7
    T = npy(M.tri_w(6, -2.0, 3, device=CPU))
    assert np.abs(np.diag(T) - 1).max() == 0
    assert T[0, 3] == -2.0 and T[0, 4] == 0.0 and T[1, 0] == 0.0
    for f, n in ((M.whale, 4), (M.bulls_head, 3)):
        with pytest.raises(ValueError):
            f(n, device=CPU)


def test_cauchy_like():
    r, s = [1.0, 2.0], [3.0, 4.0, 5.0]
    x, y = [2.0, 3.0], [0.0, 1.0, -1.0]
    A = npy(M.cauchy_like(r, s, x, y))
    for i in range(2):
        for j in range(3):
            assert abs(A[i, j] - r[i] * s[j] / (x[i] - y[j])) < 1e-12


def test_lattice_bases():
    rng.seed(7)
    A = npy(M.ajtai_type_basis(6, 0.5, device=CPU))
    assert np.abs(np.tril(A, -1)).max() == 0
    d = np.diag(A)
    assert (d[:-1] >= d[1:]).all() and d.min() >= 1
    assert (np.triu(A, 1) <= d[None, :] / 2 + 1e-12).all()
    np.testing.assert_array_equal(d, np.diag(np.asarray(
        JM.ajtai_type_basis(6, 0.5))))
    K = npy(M.knapsack_type_basis(5, 100.0, device=CPU))
    assert K.shape == (6, 5)
    assert np.abs(K[:5] - np.eye(5)).max() == 0
    assert np.abs(K[5] - np.round(K[5])).max() == 0


def test_three_valued_support():
    rng.seed(3)
    A = npy(M.three_valued(50, 50, p=0.5, device=CPU))
    assert set(np.unique(A)).issubset({-1.0, 0.0, 1.0})
    assert 0.3 < (A != 0).mean() < 0.7


def test_hatano_nelson_structure():
    rng.seed(4)
    A = npy(M.hatano_nelson(6, g=0.3, periodic=True, device=CPU))
    eg = np.exp(0.3)
    assert abs(A[0, 1] - eg) < 1e-12 and abs(A[1, 0] - 1 / eg) < 1e-12
    assert abs(A[5, 0] - eg) < 1e-12 and abs(A[0, 5] - 1 / eg) < 1e-12
    assert A.dtype == np.float64 and np.all(np.abs(np.diag(A)) <= 1.0)
    with pytest.raises(ValueError):
        M.hatano_nelson(2, device=CPU)


def test_uniform_helmholtz_greens():
    rng.seed(5)
    A = npy(M.uniform_helmholtz_greens(20, 0.5, device=CPU))
    assert np.abs(np.diag(A)).max() == 0
    assert A.shape == (20, 20) and A.dtype == np.complex128
    assert np.abs(A - A.T).max() < 1e-12


# -- the random generators: structure and distribution ---------------------

def _moments(x: np.ndarray, mean: float, var: float):
    """Sample mean and variance of x within 5σ of (mean, var)."""
    n = x.size
    assert abs(x.mean() - mean) < 5 * np.sqrt(var / n)
    # the variance estimator's own spread, for a distribution whose fourth
    # central moment is at most 3·var² (normal) or 1.8·var² (uniform)
    assert abs(x.var() - var) < 5 * np.sqrt(2.0 * var ** 2 / n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_uniform_gaussian_bernoulli_rademacher(dtype):
    rng.seed(11)
    n = 256
    U = npy(M.uniform(n, n, dtype, 1.0, 2.0, device=CPU))
    assert U.shape == (n, n) and U.dtype == np.dtype(str(dtype)[6:])
    parts = (U.real, U.imag) if dtype.is_complex else (U,)
    for p, c in zip(parts, (1.0, 0.0)):
        assert np.abs(p - c).max() <= 2.0
        _moments(p, c, 4.0 / 3.0)
    G = npy(M.gaussian(n, None, dtype, 0.5, 2.0, device=CPU))
    assert G.shape == (n, n)
    if dtype.is_complex:
        _moments(G.real, 0.5, 2.0)
        _moments(G.imag, 0.0, 2.0)
    else:
        _moments(G, 0.5, 4.0)
    if not dtype.is_complex:
        B = npy(M.bernoulli(n, n, 0.3, dtype, device=CPU))
        assert set(np.unique(B)) == {0.0, 1.0}
        _moments(B, 0.3, 0.21)
        R = npy(M.rademacher(n, n, dtype, device=CPU))
        assert set(np.unique(R)) == {-1.0, 1.0}
        _moments(R, 0.0, 1.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_wigner_and_haar(dtype):
    rng.seed(12)
    n = 128
    W = npy(M.wigner(n, dtype, device=CPU))
    assert np.abs(W - W.conj().T).max() == 0
    off = W[np.triu_indices(n, 1)]
    if dtype.is_complex:
        _moments(off.real, 0.0, 0.5)
    else:
        _moments(off, 0.0, 1.0)
    Q = npy(M.haar(n, dtype, device=CPU))
    assert np.abs(Q.conj().T @ Q - np.eye(n)).max() < 1e-12
    # Haar: each entry has mean 0 and variance 1/n
    entries = Q.real.ravel() if not dtype.is_complex else Q.ravel().real
    _moments(entries, 0.0, 1.0 / n / (2 if dtype.is_complex else 1))


def test_spectrum_generators():
    rng.seed(13)
    n = 64
    H = npy(M.hermitian_uniform_spectrum(n, 2.0, 5.0, torch.complex128,
                                         device=CPU))
    assert np.abs(H - H.conj().T).max() < 1e-12
    ev = np.linalg.eigvalsh(H)
    assert ev.min() >= 2.0 - 1e-10 and ev.max() <= 5.0 + 1e-10
    N = npy(M.normal_uniform_spectrum(n, 1.0, 0.5, torch.complex128,
                                      device=CPU))
    assert np.abs(N @ N.conj().T - N.conj().T @ N).max() < 1e-12
    ev = np.linalg.eigvals(N)
    assert np.abs(ev.real - 1.0).max() <= 0.5 + 1e-10
    assert np.abs(ev.imag).max() <= 0.5 + 1e-10


def test_random_generators_follow_the_seed():
    rng.seed(21)
    a = npy(M.gaussian(8, device=CPU))
    rng.seed(21)
    np.testing.assert_array_equal(a, npy(M.gaussian(8, device=CPU)))


def test_safe_multishift_trsm_matches_unscaled_solve():
    from elemental_tpu_torch.ops import safe_multishift_trsm
    r = np.random.default_rng(2)
    n, k = 24, 6
    U = np.triu(r.standard_normal((n, n))) + 5 * np.eye(n)
    shifts = r.standard_normal(k)
    B = r.standard_normal((n, k))
    X, sc = safe_multishift_trsm("L", "U", "N", 1.0, torch.from_numpy(U),
                                 torch.from_numpy(shifts),
                                 torch.from_numpy(B))
    X, sc = npy(X), npy(sc)
    for j in range(k):
        res = (U - shifts[j] * np.eye(n)) @ X[:, j] - sc[j] * B[:, j]
        assert np.abs(res).max() < 1e-10
