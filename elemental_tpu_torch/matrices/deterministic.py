"""Deterministic generators (counterpart of
``elemental_tpu/matrices/deterministic.py``; reference
``src/matrices/deterministic/{classical,misc,sparse_toeplitz}``).

A generator that builds its matrix from nothing takes a keyword-only
``device``; one built from given vectors (``diagonal``, ``cauchy``,
``circulant``, ``toeplitz``, ``hankel``, ``fiedler``, ``cauchy_like``)
lies on their device.  Dtypes and defaults are the JAX package's with x64
on: a Python float is float64, a Python complex complex128.  The host-side
pieces (the riffle chain's log-binomials and Eulerian numbers,
Druinsky-Toledo's recurrence) are NumPy, as there, then moved to
``device``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.distmatrix import as_array

F64 = torch.float64
C128 = torch.complex128


def _ij(m, n=None, *, device):
    n = m if n is None else n
    i = torch.arange(m, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return i, j


def _eye(n, k=0, dtype=F64, *, device):
    """``jnp.eye(n, k=k)``: ones on the k-th diagonal."""
    if abs(k) >= n:
        return torch.zeros((n, n), dtype=dtype, device=device)
    return torch.diag(torch.ones(n - abs(k), dtype=dtype, device=device), k)


def _scalar_dtype(x) -> torch.dtype:
    """The dtype ``jnp.asarray(x)`` takes with x64 on."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    return {bool: torch.bool, int: torch.int64, float: F64,
            complex: C128}.get(type(x), None) or \
        getattr(torch, np.asarray(x).dtype.name)


def zeros(m, n=None, dtype=torch.float32, *, device):
    return torch.zeros((m, n if n is not None else m), dtype=dtype,
                       device=device)


def ones(m, n=None, dtype=torch.float32, *, device):
    return torch.ones((m, n if n is not None else m), dtype=dtype,
                      device=device)


def identity(n, dtype=torch.float32, *, device):
    return torch.eye(n, dtype=dtype, device=device)


def diagonal(d):
    return torch.diag(as_array(d))


def jordan(n, lam, dtype=None, *, device):
    dtype = dtype or _scalar_dtype(lam)
    return (lam * _eye(n, 0, dtype, device=device)
            + _eye(n, 1, dtype, device=device))


def cauchy(x, y):
    x = as_array(x)[:, None]
    y = as_array(y).to(x.device)[None, :]
    return 1.0 / (x - y)


def hilbert(n, dtype=F64, *, device):
    i, j = _ij(n, device=device)
    return (1.0 / (i + j + 1).to(F64)).to(dtype)


def lotkin(n, dtype=F64, *, device):
    h = hilbert(n, dtype, device=device)
    h[0, :] = 1.0
    return h


def fourier(n, *, device):
    i, j = _ij(n, device=device)
    w = torch.exp(-2j * math.pi * i.to(F64) * j / n)
    return w / math.sqrt(n)


def circulant(c):
    c = as_array(c)
    n = c.shape[0]
    i, j = _ij(n, device=c.device)
    return c[(i - j) % n]


def toeplitz(c, r=None):
    """First column c, first row r (r[0] ignored)."""
    c = as_array(c)
    r = c if r is None else as_array(r).to(c.device)
    m, n = c.shape[0], r.shape[0]
    i, j = _ij(m, n, device=c.device)
    d = i - j
    # jnp's out-of-range gathers clamp; only the selected side is in range
    dt = torch.promote_types(c.dtype, r.dtype)
    return torch.where(d >= 0, c[d.abs().clamp(max=m - 1)].to(dt),
                       r[d.abs().clamp(max=n - 1)].to(dt))


def hankel(c, r=None):
    c = as_array(c)
    r = c if r is None else as_array(r).to(c.device)
    m, n = c.shape[0], r.shape[0]
    i, j = _ij(m, n, device=c.device)
    dt = torch.promote_types(c.dtype, r.dtype)
    full = torch.cat([c.to(dt), r[1:].to(dt)])
    return full[i + j]


def walsh(k, binary: bool = False, *, device):
    """Walsh/Hadamard matrix of order 2^k (reference ``Walsh``)."""
    h = torch.tensor([[1.0, 1.0], [1.0, -1.0]], dtype=F64, device=device)
    out = h
    for _ in range(k - 1):
        out = torch.kron(out, h)
    if binary:
        out = (out + 1) / 2
    return out


def wilkinson(k, *, device):
    """Wilkinson tridiagonal W_{2k+1} (reference ``Wilkinson``)."""
    n = 2 * k + 1
    d = (torch.arange(n, device=device) - k).abs().to(F64)
    e = torch.ones(n - 1, dtype=F64, device=device)
    return torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)


def kahan(n, phi, dtype=F64, *, device):
    """Kahan's upper-triangular counterexample (reference ``Kahan``)."""
    c = np.cos(phi)
    s = np.sin(phi)
    i, j = _ij(n, device=device)
    pow_s = torch.pow(float(s), torch.arange(n, dtype=F64,
                                             device=device)).to(dtype)
    upper = torch.where(j > i, torch.tensor(-float(c), dtype=F64,
                                            device=device), 0.0)
    return pow_s[:, None] * (torch.eye(n, dtype=dtype, device=device)
                             + upper.to(dtype))


def demmel(n, dtype=F64, *, device):
    """Demmel's counterexample matrix (reference ``Demmel``): upper-triangular
    with entries β^(j−i), β = 10^(4/(n−1))."""
    i, j = _ij(n, device=device)
    beta = float(np.power(10.0, 4.0 / (n - 1)))
    return torch.where(j >= i, torch.pow(beta, (j - i).to(dtype)),
                       torch.zeros((), dtype=dtype, device=device))


def minij(n, dtype=F64, *, device):
    i, j = _ij(n, device=device)
    return (torch.minimum(i, j) + 1).to(dtype)


def onetwoone(n, dtype=F64, *, device):
    """1-2-1 tridiagonal (reference ``OneTwoOne``)."""
    return (2 * _eye(n, device=device) + _eye(n, 1, device=device)
            + _eye(n, -1, device=device)).to(dtype)


def pei(n, alpha, dtype=F64, *, device):
    return (alpha * _eye(n, device=device)
            + torch.ones((n, n), dtype=F64, device=device)).to(dtype)


def parter(n, dtype=F64, *, device):
    i, j = _ij(n, device=device)
    return (1.0 / ((i - j).to(F64) + 0.5)).to(dtype)


def redheffer(n, dtype=F64, *, device):
    i, j = _ij(n, device=device)
    return torch.where((j == 0) | ((j + 1) % (i + 1) == 0), 1.0, 0.0) \
        .to(dtype)


def riemann(n, dtype=F64, *, device):
    i, j = _ij(n, device=device)
    ii, jj = i + 2, j + 2
    return torch.where(jj % ii == 0, (ii - 1).to(dtype),
                       torch.full((), -1.0, dtype=dtype, device=device))


def ris(n, dtype=F64, *, device):
    i, j = _ij(n, device=device)
    return (0.5 / ((n - i - j).to(F64) - 0.5)).to(dtype)


def lehmer(n, dtype=F64, *, device):
    i, j = _ij(n, device=device)
    lo = torch.minimum(i, j) + 1
    hi = torch.maximum(i, j) + 1
    return (lo.to(F64) / hi).to(dtype)


def fiedler(c):
    c = as_array(c)
    return (c[:, None] - c[None, :]).abs()


def forsythe(n, alpha, lam, dtype=F64, *, device):
    out = jordan(n, lam, dtype, device=device)
    out[n - 1, 0] = alpha
    return out


def lauchli(n, mu, dtype=F64, *, device):
    top = torch.ones((1, n), dtype=dtype, device=device)
    return torch.cat([top, mu * torch.eye(n, dtype=dtype, device=device)],
                     dim=0)


def gcd_matrix(n, dtype=F64, *, device):
    g = np.gcd.outer(np.arange(1, n + 1), np.arange(1, n + 1))
    return torch.as_tensor(g).to(device=device, dtype=dtype)


def gear(n, s=None, t=None, dtype=F64, *, device):
    s = n if s is None else s
    t = -n if t is None else t
    out = _eye(n, 1, dtype, device=device) + _eye(n, -1, dtype,
                                                  device=device)
    out[0, abs(s) - 1] = float(np.sign(s))
    out[n - 1, n - abs(t)] = float(np.sign(t))
    return out


def gkms(n, dtype=F64, *, device):
    i, j = _ij(n, device=device)
    return torch.pow(0.5, (i - j).abs().to(F64)).to(dtype)


def kms(n, rho=0.5, dtype=F64, *, device):
    i, j = _ij(n, device=device)
    e = (i - j).abs().to(F64)
    rho = torch.as_tensor(rho, dtype=_scalar_dtype(rho), device=device)
    return torch.pow(rho, e).to(dtype)


def hanowa(n, alpha, dtype=F64, *, device):
    m = n // 2
    d = alpha * torch.eye(m, dtype=dtype, device=device)
    dd = torch.diag(torch.arange(1, m + 1, device=device).to(dtype))
    return torch.cat([torch.cat([d, -dd], 1), torch.cat([dd, d], 1)], 0)


def grcar(n, k=3, dtype=F64, *, device):
    """Grcar nonnormal Toeplitz (reference sparse_toeplitz ``Grcar``)."""
    i, j = _ij(n, device=device)
    d = j - i
    return torch.where((d >= 0) & (d <= k), 1.0,
                       torch.where(d == -1, -1.0, 0.0)).to(dtype)


def triangle(n, dtype=C128, *, device):
    """'Triangle' sparse-toeplitz matrix (reference ``Triangle``): symbol
    z^{-1} + (1/4) z^2."""
    i, j = _ij(n, device=device)
    d = j - i
    out = torch.where(d == -1, 1.0, 0.0) + torch.where(d == 2, 0.25, 0.0)
    return out.to(dtype)


def trefethen_embree(n, dtype=C128, *, device):
    """Trefethen–Embree pseudospectra demo matrix (sparse_toeplitz tier)."""
    return _banded_complex(n, [(1, 1.0), (-2, 1j), (2, -1.0), (-1, 0.0)],
                           dtype, device=device)


def ehrenfest(n, dtype=F64, *, device):
    """Ehrenfest diffusion transition matrix (reference ``Ehrenfest``):
    P(k→k+1) = (n−1−k)/(n−1), P(k→k−1) = k/(n−1)."""
    k = torch.arange(n, device=device).to(dtype)
    return (torch.diag((n - 1 - k[:-1]) / (n - 1), 1)
            + torch.diag(k[1:] / (n - 1), -1))


def egorov(n, phase_fn=None, dtype=C128, *, device):
    i, j = _ij(n, device=device)
    if phase_fn is None:
        def phase_fn(x, y):
            return -2 * math.pi * x.to(F64) * y / n
    return torch.exp(1j * phase_fn(i, j)).to(dtype) / math.sqrt(n)


def dynamic_regularization_counter(n, dtype=F64, *, device):
    """Druinsky–Toledo style counterexample (reference
    ``examples/interface/DynamicRegCounter.py``): [[G, I],[I, I]] with G
    built from ones and a scaled identity."""
    k = n // 2
    phi = (1 + np.sqrt(5)) / 2
    g = torch.ones((k, k), dtype=dtype, device=device) * float(-(phi ** 2)) \
        + float(1 + phi) * torch.eye(k, dtype=dtype, device=device)
    eye = torch.eye(k, dtype=dtype, device=device)
    return torch.cat([torch.cat([g, eye], 1), torch.cat([eye, eye], 1)], 0)


def cauchy_like(r, s, x, y):
    """Cauchy-like matrix A(i,j) = r_i·s_j/(x_i − y_j) (reference
    ``deterministic/classical/CauchyLike.cpp``)."""
    r = as_array(r)[:, None]
    s = as_array(s).to(r.device)[None, :]
    x = as_array(x).to(r.device)[:, None]
    y = as_array(y).to(r.device)[None, :]
    return r * s / (x - y)


def gks(n, dtype=F64, *, device):
    """Golub–Klema–Stewart upper-triangular matrix: A(j,j)=1/√(j+1),
    A(i,j)=−1/√(j+1) for i<j (reference ``misc/GKS.cpp``)."""
    i, j = _ij(n, device=device)
    col = 1.0 / torch.sqrt(torch.arange(1, n + 1, device=device)
                           .to(dtype))[None, :]
    zero = torch.zeros((), dtype=col.dtype, device=device)
    return torch.where(i < j, -col, torch.where(i == j, col, zero)).to(dtype)


def legendre(n, dtype=F64, *, device):
    """Jacobi (Golub–Welsch) tridiagonal whose eigenvalues are the
    Gauss–Legendre nodes (reference ``misc/Legendre.cpp``)."""
    j = torch.arange(1, n, device=device).to(dtype)
    beta = 0.5 / torch.sqrt(1.0 - 1.0 / (2.0 * j) ** 2)
    return torch.diag(beta, 1) + torch.diag(beta, -1)


def extended_kahan(k, phi, mu, dtype=F64, *, device):
    """Extended Kahan matrix of order n=3·2^k: S·K with K built from
    Walsh blocks and S = diag(ζ^i), ζ=√(1−φ²) (reference
    ``misc/ExtendedKahan.cpp``; QR-pivoting stress test)."""
    if not (0 < phi < 1) or not (0 < mu < 1):
        raise ValueError("phi and mu must be in (0,1)")
    ell = 1 << k
    n = 3 * ell
    A = torch.eye(n, dtype=dtype, device=device)
    W = (walsh(k, device=device).to(dtype) if k > 0 else
         torch.ones((1, 1), dtype=dtype, device=device))
    A[2 * ell:, 2 * ell:] *= mu
    A[:ell, ell:2 * ell] = -phi * W
    A[ell:2 * ell, 2 * ell:] = phi * W
    zeta = np.sqrt(1.0 - phi * phi)
    gamma = torch.pow(torch.tensor(zeta, dtype=dtype, device=device),
                      torch.arange(n, device=device).to(dtype))
    return gamma[:, None] * A


def gepp_growth(n, dtype=F64, *, device):
    """Wilkinson's GEPP worst-case growth matrix: identity, last column of
    ones, all subdiagonals −1 (reference ``misc/GEPPGrowth.cpp``)."""
    i, j = _ij(n, device=device)
    A = torch.where(i == j, 1.0, torch.where(i > j, -1.0, 0.0)).to(dtype)
    A[:, n - 1] = 1.0
    return A


def jordan_cholesky(n, dtype=F64, *, device):
    """Tridiagonal [2,5,2] with A(0,0)=1, whose Cholesky factor is a scaled
    Jordan block (reference ``misc/JordanCholesky.cpp``)."""
    A = 5.0 * _eye(n, 0, dtype, device=device) + 2.0 * (
        _eye(n, 1, dtype, device=device) + _eye(n, -1, dtype, device=device))
    if n > 0:
        A[0, 0] = 1.0
    return A


def druinsky_toledo(k, dtype=F64, *, device):
    """Druinsky–Toledo counterexample of order n=2k for Bunch–Kaufman growth
    (reference ``misc/DruinskyToledo.cpp``)."""
    n = 2 * k
    if k == 0:
        return torch.zeros((0, 0), dtype=dtype, device=device)
    if k == 1:
        return torch.ones((n, n), dtype=dtype, device=device)
    eps = torch.finfo(dtype).eps
    phi = 1.0 + 4.0 * eps
    alpha_phi = (1.0 + np.sqrt(17.0)) / 8.0 * phi
    d = np.empty(k - 2)
    sigma = 1.0
    for i in range(k - 2):
        d[i] = -alpha_phi / sigma
        sigma -= 1.0 / d[i]
    A = torch.zeros((n, n), dtype=dtype, device=device)
    A[k - 2:k, :k] = 1.0   # G_BL rows of ones
    A[:k, k - 2:k] = 1.0   # G_TR cols of ones
    A[:k - 2, :k - 2] = torch.diag(torch.as_tensor(d).to(device=device,
                                                         dtype=dtype))
    eye = torch.eye(k, dtype=dtype, device=device)
    A[k:, :k] = eye
    A[:k, k:] = eye
    A[k:, k:] = eye
    return A


def _log_binomial(n):
    """log(choose(n,k)) for k=0..n (reference ``random/impl.hpp:69``)."""
    from scipy.special import gammaln
    k = np.arange(n + 1)
    return gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)


def _log_eulerian(n):
    """log of Eulerian numbers A(n,j), j=0..n−1 (reference
    ``random/impl.hpp:87``), via the stable log-space recurrence."""
    euler = np.zeros(n)
    for j in range(1, n):
        new = euler.copy()
        for kk in range(1, j):
            new[kk] = np.logaddexp(np.log(kk + 1) + euler[kk],
                                   np.log(j - kk + 1) + euler[kk - 1])
        euler = new
    return euler


def riffle(n, dtype=F64, *, device):
    """Gilbert–Shannon–Reeds riffle-shuffle transition matrix:
    P(i,j) = 2^{−n}·C(n+1, 2i−j+1)·α_{j+1}/α_{i+1} (reference
    ``misc/Riffle.cpp``)."""
    lb = _log_binomial(n + 1)
    le = _log_eulerian(n)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    k = 2 * i - j + 1
    valid = (k >= 0) & (k <= n + 1)
    # exp overflows only in entries outside `valid`, which are dropped
    with np.errstate(over="ignore"):
        P = np.where(valid,
                     np.exp(lb[np.clip(k, 0, n + 1)] - n * np.log(2.0)
                            + le[j] - le[i]),
                     0.0)
    return torch.as_tensor(P).to(device=device, dtype=dtype)


def riffle_stationary(n, dtype=F64, *, device):
    """Stationary distribution of the riffle chain, replicated over rows
    (reference ``RiffleStationary``)."""
    sigma = np.zeros(n)
    sigma[0] = 1.0
    for j in range(1, n):
        new = sigma.copy()
        for kk in range(1, j + 1):
            new[kk] = (kk + 1) * sigma[kk] + (j - kk + 1) * sigma[kk - 1]
        sigma = new / (j + 1)
    return torch.as_tensor(sigma).to(device=device, dtype=dtype) \
        .expand(n, n).clone()


def riffle_decay(n, dtype=F64, *, device):
    """P − P∞: the decaying part of the riffle chain (reference
    ``RiffleDecay``)."""
    return (riffle(n, dtype, device=device)
            - riffle_stationary(n, dtype, device=device))


def _banded_complex(n, bands, dtype=C128, *, device):
    out = torch.zeros((n, n), dtype=dtype, device=device)
    i, j = _ij(n, device=device)
    for off, val in bands:
        band = torch.where(j - i == off,
                           torch.tensor(val, dtype=C128, device=device), 0.0)
        out = out + band.to(dtype)
    return out


def bulls_head(n, dtype=C128, *, device):
    """Bull's-head banded Toeplitz (symbol 2i·z⁻¹ + z² + 7/10·z³;
    reference ``sparse_toeplitz/BullsHead.cpp``)."""
    if n < 4:
        raise ValueError("BullsHead needs n ≥ 4 for its third-order symbol")
    return _banded_complex(n, [(1, 2j), (-2, 1.0), (-3, 0.7)], dtype,
                           device=device)


def whale(n, dtype=C128, *, device):
    """Whale banded Toeplitz, a fourth-order pseudospectra demo symbol
    (reference ``sparse_toeplitz/Whale.cpp``)."""
    if n < 5:
        raise ValueError("Whale needs n ≥ 5 for its fourth-order symbol")
    return _banded_complex(
        n, [(4, -1.0), (3, -3.0 - 2.0j), (2, 1.0j), (1, 1.0),
            (-1, 10.0), (-2, 3.0 + 1.0j), (-3, 4.0), (-4, 1.0j)], dtype,
        device=device)


def tri_w(n, alpha, k, dtype=F64, *, device):
    """Upper-triangular Toeplitz with unit diagonal and k superdiagonals of
    α (reference ``sparse_toeplitz/TriW.cpp``)."""
    if k < 0:
        raise ValueError("k must be non-negative")
    i, j = _ij(n, device=device)
    d = j - i
    A = torch.where((d >= 1) & (d <= k),
                    torch.tensor(alpha, dtype=_scalar_dtype(alpha),
                                 device=device), 0.0).to(dtype)
    return A + torch.eye(n, dtype=dtype, device=device)


def fox_li(n, omega, dtype=C128, *, device):
    """Fox–Li laser cavity integral operator discretized by Gauss–Legendre
    quadrature: A(i,j) = √(iω/π)·exp(−iω(x_i−x_j)²)·√(w_i w_j) (reference
    ``integral/FoxLi.cpp``; nodes and weights from ``leggauss``)."""
    x, w = np.polynomial.legendre.leggauss(n)
    phi = complex(np.sqrt(1j * omega / np.pi))
    real_dt = torch.float32 if dtype == torch.complex64 else F64
    sq = torch.as_tensor(np.sqrt(w)).to(device=device, dtype=real_dt)
    xs = torch.as_tensor(x).to(device=device, dtype=real_dt)
    theta = -omega * (xs[:, None] - xs[None, :]) ** 2
    A = phi * torch.exp(1j * theta).to(dtype)
    return (sq[:, None] * A * sq[None, :]).to(dtype)
