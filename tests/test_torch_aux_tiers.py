"""Parity of the port's control, io, tridiagonal-eigensolver and roofline
modules with the JAX package on the CPU, mirroring their cases of
``tests/lapack/test_aux_tiers.py``: the same seeded NumPy inputs go through
both packages; the port's result is held to the reference test's own check
and to the JAX result.

Tolerances: the control solvers within 1e-10 of the JAX solution,
relative to its largest entry (both iterate the same sign function to
tol 1e-12); bisection eigenvalues within 1e-12; inverse-iteration vectors
(torch's start vectors, not ``PRNGKey(0)``'s) up to sign, within 1e-8 of
the JAX ones through |Zᵀ·Z_jax| = I, and through T·Z − Z·Λ and ZᵀZ − I;
files byte-equal to the JAX package's.
"""

import io as _io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elemental_tpu import control as jcontrol
from elemental_tpu import io as jio
from elemental_tpu.lapack import tridiag_eig as jtridiag_eig
from elemental_tpu.lapack import tridiag_eigvalsh as jtridiag_eigvalsh
from elemental_tpu.lapack.spectral import hermitian_tridiag_eig as jhte

from elemental_tpu_torch import control, io as elio
from elemental_tpu_torch.lapack import tridiag_eig, tridiag_eigvalsh
from elemental_tpu_torch.lapack.spectral import hermitian_tridiag_eig
from elemental_tpu_torch.utils import roofline

torch.set_num_threads(2)

CPU = torch.device("cpu")


def T(x):
    return torch.from_numpy(np.array(x))


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)


def close(got, ref, tol):
    got, ref = npy(got), npy(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, tol * scale)


def _tridiag(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


# -- control ------------------------------------------------------------------

def test_sylvester():
    rng = np.random.default_rng(61)
    m, n = 12, 9
    A = rng.standard_normal((m, m))
    A = A @ A.T / 10 + 2 * np.eye(m)       # spectra in right half-plane
    B = rng.standard_normal((n, n))
    B = B @ B.T / 10 + 2 * np.eye(n)
    X0 = rng.standard_normal((m, n))
    C = A @ X0 + X0 @ B
    X = npy(control.sylvester(T(A), T(B), T(C)))
    np.testing.assert_allclose(X, X0, rtol=1e-6, atol=1e-7)
    close(X, jcontrol.sylvester(jnp.asarray(A), jnp.asarray(B),
                                jnp.asarray(C)), 1e-10)


def test_lyapunov():
    rng = np.random.default_rng(62)
    n = 10
    A = rng.standard_normal((n, n))
    A = A @ A.T / 10 + 2 * np.eye(n)
    X0 = rng.standard_normal((n, n))
    X0 = X0 + X0.T
    C = A @ X0 + X0 @ A.T
    X = npy(control.lyapunov(T(A), T(C)))
    np.testing.assert_allclose(X, X0, rtol=1e-6, atol=1e-7)
    close(X, jcontrol.lyapunov(jnp.asarray(A), jnp.asarray(C)), 1e-10)


def test_riccati():
    rng = np.random.default_rng(63)
    n = 6
    A = -2 * np.eye(n) + 0.1 * rng.standard_normal((n, n))
    K = np.eye(n)
    L = np.eye(n) * 0.5
    X = npy(control.ricatti_hamiltonian(T(A), T(K), T(L)))
    res = A.T @ X + X @ A + K - X @ L @ X
    assert np.abs(res).max() < 1e-6
    np.testing.assert_allclose(X, X.T, atol=1e-8)
    assert np.linalg.eigvalsh((X + X.T) / 2).min() > -1e-8
    # the port solves the 2n×n system with LAPACK's gelsd on the host, the
    # JAX package with its SVD-based lstsq: the same least-squares solution
    close(X, jcontrol.ricatti_hamiltonian(jnp.asarray(A), jnp.asarray(K),
                                          jnp.asarray(L)), 1e-10)


def test_ricatti_overloads():
    """ricatti(W) and ricatti(uplo, A, K, L) match solve_continuous_are and
    the JAX package."""
    import scipy.linalg as sla
    rng = np.random.default_rng(11)
    n = 6
    A = rng.standard_normal((n, n)) - 3 * np.eye(n)
    B = rng.standard_normal((n, 2))
    Q = rng.standard_normal((n, n))
    Q = Q @ Q.T + np.eye(n)
    L = B @ B.T
    ref = sla.solve_continuous_are(A, B, Q, np.eye(2))
    W = np.block([[A, -L], [-Q, -A.T]])
    X1 = npy(control.ricatti(T(W)))
    np.testing.assert_allclose(X1, ref, rtol=1e-6, atol=1e-8)
    close(X1, jcontrol.ricatti(jnp.asarray(W)), 1e-10)
    for uplo, tri in (("L", np.tril), ("U", np.triu)):
        X2 = npy(control.ricatti(uplo, T(A), T(tri(Q)), T(tri(L))))
        np.testing.assert_allclose(X2, ref, rtol=1e-6, atol=1e-8)
        close(X2, jcontrol.ricatti(uplo, jnp.asarray(A),
                                   jnp.asarray(tri(Q)), jnp.asarray(tri(L))),
              1e-10)


# -- io -----------------------------------------------------------------------

def test_io_roundtrips(tmp_path):
    a = np.random.default_rng(64).standard_normal((7, 5))
    for fmt in ("ascii", "binary", "binary_flat", "matrix_market"):
        p = tmp_path / f"m.{fmt}"
        elio.write(str(p), T(a), fmt=fmt)
        back = elio.read(str(p), fmt=fmt, shape=a.shape, device=CPU)
        assert back.device == CPU
        np.testing.assert_allclose(npy(back), a, rtol=1e-12)
        # the JAX package writes the same bytes and reads the port's file
        pj = tmp_path / f"j.{fmt}"
        jio.write(str(pj), jnp.asarray(a), fmt=fmt)
        assert p.read_bytes() == pj.read_bytes()
        np.testing.assert_array_equal(
            np.asarray(jio.read(str(p), fmt=fmt, shape=a.shape)), npy(back))
    # the binary format keeps every bit
    np.testing.assert_array_equal(
        npy(elio.read(str(tmp_path / "m.binary"), device=CPU)), a)
    elio.write(str(tmp_path / "m.m"), T(a), fmt="ascii_matlab")
    jio.write(str(tmp_path / "j.m"), jnp.asarray(a), fmt="ascii_matlab")
    assert (tmp_path / "m.m").read_bytes() == (tmp_path / "j.m").read_bytes()
    buf, jbuf = _io.StringIO(), _io.StringIO()
    elio.print_matrix(T(a), "t", file=buf)
    jio.print_matrix(jnp.asarray(a), "t", file=jbuf)
    assert "t" in buf.getvalue() and buf.getvalue() == jbuf.getvalue()
    with pytest.raises(ValueError, match="format"):
        elio.write(str(tmp_path / "x"), T(a), fmt="hdf5")


def test_display_spy(tmp_path):
    a = np.random.default_rng(65).standard_normal((6, 6))
    elio.display(T(a), "d", save=str(tmp_path / "d.png"))
    from elemental_tpu_torch.sparse import SparseMatrix
    elio.spy(SparseMatrix.from_dense(np.triu(a)), save=str(tmp_path / "s.png"))
    elio.spy(T(a), save=str(tmp_path / "t.png"))
    assert all((tmp_path / f).exists() for f in ("d.png", "s.png", "t.png"))
    rgba = elio.color_map(T(np.arange(4.0)))
    assert rgba.shape == (4, 4)


def test_display_spy_without_matplotlib(monkeypatch, capsys):
    """Where matplotlib is missing, display prints and returns None, spy
    returns None and color_map raises."""
    import builtins
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    a = T(np.eye(2))
    assert elio.display(a, "shown") is None
    assert "shown" in capsys.readouterr().out
    assert elio.spy(a) is None
    with pytest.raises(ImportError):
        elio.color_map([0.0, 1.0])


# -- tridiag eig (PMRRR slot) -------------------------------------------------

def test_tridiag_bisection_eigenvalues():
    rng = np.random.default_rng(66)
    n = 60
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    w = npy(tridiag_eigvalsh(T(d), T(e)))
    np.testing.assert_allclose(w, np.linalg.eigvalsh(_tridiag(d, e)),
                               atol=1e-10)
    close(w, jtridiag_eigvalsh(jnp.asarray(d), jnp.asarray(e)), 1e-12)


def test_tridiag_bisection_subset():
    rng = np.random.default_rng(67)
    n = 40
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    w = npy(tridiag_eigvalsh(T(d), T(e), select=(5, 14)))
    np.testing.assert_allclose(w, np.linalg.eigvalsh(_tridiag(d, e))[5:15],
                               atol=1e-10)
    close(w, jtridiag_eigvalsh(jnp.asarray(d), jnp.asarray(e),
                               select=(5, 14)), 1e-12)


def test_tridiag_bisection_float32():
    rng = np.random.default_rng(68)
    d = rng.standard_normal(30).astype(np.float32)
    e = rng.standard_normal(29).astype(np.float32)
    w = npy(tridiag_eigvalsh(T(d), T(e)))
    assert w.dtype == np.float32
    close(w, jtridiag_eigvalsh(jnp.asarray(d), jnp.asarray(e)), 1e-5)


def test_tridiag_eig_vectors():
    rng = np.random.default_rng(69)
    n = 50
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    w, Z = map(npy, tridiag_eig(T(d), T(e)))
    Tm = _tridiag(d, e)
    res = np.abs(Tm @ Z - Z * w[None, :]).max()
    assert res < 1e-7, res
    ortho = np.abs(Z.T @ Z - np.eye(n)).max()
    assert ortho < 1e-5, ortho
    wj, Zj = jtridiag_eig(jnp.asarray(d), jnp.asarray(e))
    close(w, wj, 1e-12)
    assert np.abs(np.abs(Z.T @ np.asarray(Zj)) - np.eye(n)).max() < 1e-8


def test_hermitian_tridiag_eig_mrrr_path():
    rng = np.random.default_rng(70)
    n = 30
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    w, Z = hermitian_tridiag_eig(T(d), T(e), alg="mrrr")
    np.testing.assert_allclose(npy(w), np.linalg.eigvalsh(_tridiag(d, e)),
                               atol=1e-9)
    close(w, jhte(jnp.asarray(d), jnp.asarray(e), alg="mrrr")[0], 1e-12)
    w2, none = hermitian_tridiag_eig(T(d), T(e), vectors=False, alg="mrrr",
                                     select=(3, 7))
    assert none is None
    close(w2, npy(w)[3:8], 1e-12)
    wd, zd = hermitian_tridiag_eig(T(d), T(e), select=(3, 7))
    assert zd.shape == (n, 5)
    close(wd, npy(w)[3:8], 1e-12)


# -- roofline -----------------------------------------------------------------

def test_chip_specs_raise_without_a_known_card(monkeypatch):
    """No TPU peak, and no fallback: the CPU has no spec, nor does a card
    missing from CHIPS."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            roofline.chip_specs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(LookupError, match="A100"):
        roofline.chip_specs()
    for name, key in (("NVIDIA H100 80GB HBM3", "h100 sxm"),
                      ("NVIDIA H100 PCIe", "h100 pcie")):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, name=name: name)
        assert roofline.chip_specs() is roofline.CHIPS[key]
    assert not any("v5" in k or "v4" in k or "v6" in k
                   for k in roofline.CHIPS)


def test_audit_with_an_explicit_h100_spec():
    spec = roofline.CHIPS["h100 sxm"]
    assert (spec.hbm_bw, spec.peak_f32, spec.peak_bf16, spec.peak_f64) == (
        3.35e12, 67e12, 989e12, 67e12)
    nbytes = 3 * 4 * 8192 ** 2
    r = roofline.audit(lambda x: x, None, flops=2 * 8192 ** 2,
                       bytes_accessed=nbytes, seconds=2.5e-4, spec=spec)
    assert r.bound == "memory"
    assert r.sol_seconds == nbytes / 3.35e12
    assert r.sol_fraction == r.sol_seconds / 2.5e-4
    assert r.achieved_bw == nbytes / 2.5e-4 and "of SoL" in str(r)
    big = roofline.audit(lambda x: x, None, flops=1e12, bytes_accessed=8,
                         dtype=torch.bfloat16, seconds=1.0, spec=spec)
    assert big.bound == "compute" and big.sol_seconds == 1e12 / 989e12
    f64 = roofline.audit(lambda x: x, None, flops=1e12, bytes_accessed=8,
                         dtype=torch.float64, seconds=1.0,
                         spec=roofline.CHIPS["h100 pcie"])
    assert f64.sol_seconds == 1e12 / 51e12


def test_marginal_time_of_a_dependent_chain():
    x0 = torch.ones(1024, dtype=torch.float64)
    t = roofline.marginal_time(lambda x: x * 1.0000001, x0, r1=2, r2=6,
                               tries=2)
    assert 0 < t < 1.0
    r = roofline.audit(lambda x: x + 1, x0, flops=1024, bytes_accessed=16384,
                       chain=False, spec=roofline.CHIPS["h100 sxm"])
    assert r.seconds > 0 and 0 < r.sol_fraction
