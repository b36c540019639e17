"""Spectral decompositions (counterpart of ``elemental_tpu/lapack/
spectral.py``; reference ``src/lapack_like/spectral``: HermitianEig,
HermitianTridiagEig, SVD, SecularEVD, Schur, Pseudospectra, Polar,
SkewHermitianEig, TriangEig, Lanczos).

  * ``hermitian_eig`` — ``torch.linalg.eigh`` (cuSOLVER on the card, LAPACK
    on the host), or the tridiagonal path ``alg='tridiag'``:
    :func:`.condense.hermitian_tridiag`, :func:`hermitian_tridiag_eig`,
    then the back-transform;
  * ``svd`` — ``torch.linalg.svd``, on the card with cuSOLVER's
    ``gesvd`` (QR iteration, as LAPACK's on the host): torch's default
    there, ``gesvdj``, reads ‖UΣVᴴ − A‖/‖A‖ ≈ 5e-4 in float32 and 1e-12
    in float64 at 4096 × 2048 on an H100, where ``gesvd`` reads 8e-6 and
    2e-14 (``chip_smoke.py`` phase 23 prints both);
  * ``schur`` and ``eig`` run on the host in scipy/NumPy, as in the JAX
    package (a nonsymmetric eigenproblem has no device primitive there
    either); the result goes to the input's device;
  * ``triang_eig`` and ``pseudospectra`` batch n (or k) full-size
    triangular solves; the batch is cut into chunks of at most
    ``_CHUNK_BYTES`` of shifted matrices, so the peak stays bounded;
  * the Lanczos family keeps the JAX package's fixed-length recurrence (a
    vanishing residual freezes it), on the device with no host read.

``pseudospectra`` starts its power iterations from float64 normal draws
of a host generator seeded 7, moved to the device (where the JAX package
uses ``PRNGKey(7)``), so every device starts alike.
``product_lanczos`` and ``extremal_singular_value_estimates`` also take a
keyword-only ``v0`` (the start vector; drawn from ``core.random_`` when
None, as in the JAX package) and ``device`` (where a host ``SparseMatrix``
goes; the card when None).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.distmatrix import DistMatrix, as_array, as_numpy
from ..ops.level3 import _mm, multishift_trsm, with_precision
from .condense import hermitian_tridiag

Arr = Union[torch.Tensor, DistMatrix]

# the most bytes of shifted n×n matrices that one batch of triang_eig or
# pseudospectra holds at a time
_CHUNK_BYTES = 1 << 28


def _adj(x: torch.Tensor) -> torch.Tensor:
    return x.mH.resolve_conj()


def _chunk(n: int, dtype: torch.dtype) -> int:
    """Shifted n×n matrices of ``dtype`` that fit in ``_CHUNK_BYTES``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(1, _CHUNK_BYTES // (n * n * itemsize))


class EigPair(NamedTuple):
    w: torch.Tensor
    q: Optional[torch.Tensor] = None


@with_precision
def hermitian_eig(uplo: str, A: Arr, vectors: bool = True,
                  alg: str = "direct",
                  subset: Optional[Tuple[int, int]] = None) -> EigPair:
    """Hermitian eigensolver (reference ``HermitianEig``).  ``subset=(il,
    iu)`` selects eigenpair indices (inclusive, ascending order)."""
    a = as_array(A)
    if uplo.upper().startswith("U"):
        a = _adj(a)
    a = (a + _adj(a)) / 2   # symmetrize the stored triangle's completion
    if alg == "tridiag":
        t = hermitian_tridiag("L", a)
        w, z = hermitian_tridiag_eig(t.d, t.e, vectors=vectors)
        pair = EigPair(w, _mm(t.q, z) if vectors else None)
    elif vectors:
        pair = EigPair(*torch.linalg.eigh(a))
    else:
        pair = EigPair(torch.linalg.eigvalsh(a), None)
    if subset is not None:
        il, iu = subset
        q = pair.q[:, il:iu + 1] if pair.q is not None else None
        pair = EigPair(pair.w[il:iu + 1], q)
    return pair


def skew_hermitian_eig(uplo: str, A: Arr, vectors: bool = True) -> EigPair:
    """Eigen-decomposition of skew-Hermitian A, eigenvalues iλ with λ real
    (reference ``SkewHermitianEig``): the Hermitian problem of −iA."""
    a = as_array(A)
    cdt = (torch.complex128 if a.dtype in (torch.float64, torch.complex128)
           else torch.complex64)
    return hermitian_eig(uplo, -1j * a.to(cdt), vectors=vectors)


def hermitian_tridiag_eig(d: torch.Tensor, e: torch.Tensor,
                          vectors: bool = True, alg: str = "dense",
                          select=None):
    """Symmetric tridiagonal eigensolver (reference ``HermitianTridiagEig``,
    the PMRRR slot).  ``alg='dense'``: densify and ``eigh``;
    ``alg='mrrr'``: batched bisection and inverse iteration
    (:mod:`.tridiag_eig`), with subsets."""
    if alg == "mrrr":
        from .tridiag_eig import tridiag_eig, tridiag_eigvalsh
        if not vectors:
            return tridiag_eigvalsh(d, e, select), None
        return tridiag_eig(d, e, select)
    T = torch.diag(d) + torch.diag(e, -1) + torch.diag(e, 1)
    if not vectors:
        w = torch.linalg.eigvalsh(T)
        return (w if select is None else w[select[0]:select[1] + 1]), None
    w, z = torch.linalg.eigh(T)
    if select is not None:
        w = w[select[0]:select[1] + 1]
        z = z[:, select[0]:select[1] + 1]
    return w, z


def hermitian_tridiag_eig_estimate(d: torch.Tensor, e: torch.Tensor,
                                   vlo: float, vhi: float):
    """Count the eigenvalues in (vlo, vhi] by Sturm sequences (reference
    ``MRRREstimate``): the LDL pivot signs of T − σI at both ends, in one
    pass over the rows (int32, on T's device)."""
    from .tridiag_eig import _sturm_count
    e2 = torch.cat([torch.zeros(1, dtype=d.dtype, device=d.device), e ** 2])
    sigma = torch.tensor([vhi, vlo], dtype=d.dtype, device=d.device)
    hi, lo = _sturm_count(d, e2, sigma, big=1e300)
    return hi - lo


class SVD(NamedTuple):
    u: Optional[torch.Tensor]
    s: torch.Tensor
    vh: Optional[torch.Tensor]


def _driver(a: torch.Tensor):
    """cuSOLVER's QR-iteration SVD on the card (LAPACK's on the host)."""
    return "gesvd" if a.is_cuda else None


def svd(A: Arr, vectors: bool = True, full_matrices: bool = False) -> SVD:
    """Singular value decomposition (reference ``SVD``)."""
    a = as_array(A)
    if vectors:
        return SVD(*torch.linalg.svd(a, full_matrices=full_matrices,
                                     driver=_driver(a)))
    return SVD(None, singular_values(a), None)


def singular_values(A: Arr) -> torch.Tensor:
    a = as_array(A)
    return torch.linalg.svdvals(a, driver=_driver(a))


class Schur(NamedTuple):
    t: torch.Tensor
    q: torch.Tensor
    w: torch.Tensor


def schur(A: Arr) -> Schur:
    """Complex Schur decomposition A = Q T Qᴴ (reference ``Schur``), in
    complex128 on the host (scipy's LAPACK ``zgees``), as in the JAX
    package; the factors go to A's device."""
    import scipy.linalg as sla
    a = as_array(A)
    t, q = sla.schur(as_numpy(a).astype(np.complex128), output="complex")

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(a.device)
    return Schur(dev(t), dev(q), dev(np.diag(t)))


def eig(A: Arr):
    """General (nonsymmetric) eigendecomposition on the host (NumPy's
    ``geev``) in complex128, like :func:`schur`; (w, V) on A's device."""
    a = as_array(A)
    w, v = np.linalg.eig(as_numpy(a).astype(np.complex128))
    return torch.from_numpy(w).to(a.device), torch.from_numpy(v).to(a.device)


def triang_eig(T: Arr) -> torch.Tensor:
    """Eigenvectors of an upper-triangular matrix (reference
    ``TriangEig``): column j solves (T − t_jj I)·x = 0 with x_j = 1 and
    x_{j+1:} = 0, as the full-size triangular system whose rows ≥ j are
    identity rows (diagonal entries below 1e-30 raised to 1e-30), then
    normalized.  The n systems are solved in batches of as many as fit in
    ``_CHUNK_BYTES``."""
    t = as_array(T)
    n = t.shape[0]
    dev = t.device
    lam = torch.diagonal(t)
    eye = torch.eye(n, dtype=t.dtype, device=dev)
    rows = torch.arange(n, device=dev)
    tiny = torch.full((), 1e-30, dtype=t.dtype, device=dev)
    out = torch.empty((n, n), dtype=t.dtype, device=dev)
    step = _chunk(n, t.dtype)
    for j0 in range(0, n, step):
        js = torch.arange(j0, min(j0 + step, n), device=dev)
        lead = (rows[None, :] < js[:, None])[:, :, None]
        m = torch.where(lead, t[None] - lam[js][:, None, None] * eye[None],
                        eye[None])
        diag = torch.diagonal(m, dim1=1, dim2=2)
        safe = torch.where(torch.abs(diag) < 1e-30, tiny, diag)
        diag.copy_(diag + (safe - diag))
        rhs = (rows[None, :] == js[:, None]).to(t.dtype)[:, :, None]
        x = torch.linalg.solve_triangular(m, rhs, upper=True)[:, :, 0]
        out[:, j0:j0 + js.shape[0]] = (
            x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).T
        del m, diag, safe, x        # freed before the next batch's
    return out


def pseudospectra(A: Arr, shifts, iters: int = 30) -> torch.Tensor:
    """ε-pseudospectrum portrait: σ_min(A − zI) for each shift z
    (reference ``Pseudospectra``): one host Schur form, then power
    iteration on (T − zI)⁻ᴴ(T − zI)⁻¹ by multishift triangular solves on
    T's device, the shifts in batches of as many shifted matrices as fit in
    ``_CHUNK_BYTES``."""
    t = schur(A).t
    n = t.shape[0]
    shifts = torch.as_tensor(shifts).to(t.device, t.dtype)
    k = shifts.shape[0]
    gen = torch.Generator().manual_seed(7)
    x0 = torch.randn((n, k), generator=gen, dtype=torch.float64).to(
        t.device, t.dtype)
    x0 = x0 / torch.linalg.vector_norm(x0, dim=0, keepdim=True)
    lam = torch.ones(k, dtype=t.real.dtype, device=t.device)
    step = _chunk(n, t.dtype)
    for j0 in range(0, k, step):
        z = shifts[j0:j0 + step]
        x = x0[:, j0:j0 + step]
        nw = lam[j0:j0 + step]
        for _ in range(iters):
            y = multishift_trsm("L", "U", "N", 1.0, t, z, x)
            w = multishift_trsm("L", "U", "C", 1.0, t, z.conj(), y)
            nw = torch.linalg.vector_norm(w, dim=0)
            x = w / torch.where(nw == 0, torch.ones_like(nw), nw)[None, :]
        lam[j0:j0 + step] = nw
    return 1.0 / torch.sqrt(torch.where(lam == 0, torch.full_like(lam, np.inf),
                                        lam))


@with_precision
def polar(A: Arr, iters: int = 30):
    """Polar decomposition A = Q·P by Newton's iteration
    Q ← (Q + Q⁻ᴴ)/2 from A/‖A‖_F (reference ``Polar``)."""
    a = as_array(A)
    x = a / torch.linalg.norm(a)
    for _ in range(iters):
        x = (x + _adj(torch.linalg.inv(x))) / 2
    p = _adj(x) @ a
    return x, (p + _adj(p)) / 2


def secular_evd(d: torch.Tensor, rho, z: torch.Tensor, iters: int = 50):
    """Eigenvalues of diag(d) + ρ·zzᵀ (ρ > 0) by bisection on the secular
    equation 1 + ρ·Σ z_j²/(d_j − λ) = 0, one root in each (d_i, d_{i+1})
    and the last in (d_n, d_n + ρ‖z‖²) (reference ``SecularEVD``)."""
    order = torch.argsort(d)
    d = d[order]
    z = z[order]
    znorm2 = torch.sum(z ** 2)
    lo = d + 1e-12
    hi = torch.cat([d[1:], (d[-1] + rho * znorm2)[None]]) - 1e-12
    for _ in range(iters):
        mid = (lo + hi) / 2
        f = 1.0 + rho * torch.sum(
            z[None, :] ** 2 / (d[None, :] - mid[:, None]), dim=-1)
        # f increases on each interval: f(mid) > 0 puts the root left of mid
        pos = f > 0
        lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
    return (lo + hi) / 2


def lanczos(n, apply_a, basis_size: int = 20, v0=None,
            dtype=torch.float64, *, device=None):
    """Lanczos tridiagonalization of a Hermitian operator given only its
    matvec (reference ``Lanczos.hpp:34``): the real symmetric tridiagonal
    T of a fixed ``basis_size``-step recurrence."""
    return lanczos_decomp(n, apply_a, basis_size, v0, dtype,
                          device=device)[1]


def lanczos_decomp(n, apply_a, basis_size: int = 20, v0=None,
                   dtype=torch.float64, *, device=None):
    """Lanczos decomposition A·V ≈ V·T + β·v·e_kᵀ (reference
    ``Lanczos.hpp:102``): ``(V, T, v, beta)``, V n×k orthonormal, T k×k
    tridiagonal.  Without ``v0`` the start is a ``core.random_`` Gaussian
    on ``device``; with it, v0's device."""
    k = int(min(n, basis_size))
    if v0 is None:
        if device is None:
            raise ValueError("lanczos_decomp: give v0 or a device")
        from ..core import random_ as rng
        v0 = rng.gaussian((n,), dtype, device=device)
    v0 = torch.as_tensor(v0).to(dtype=dtype)
    v0 = v0 / torch.linalg.vector_norm(v0)
    rdt = v0.real.dtype
    eps = torch.finfo(rdt).eps
    zero = torch.zeros((), dtype=rdt, device=v0.device)
    v_km1, v_k, beta_km1 = torch.zeros_like(v0), v0, zero
    alive = torch.ones((), dtype=torch.bool, device=v0.device)
    Vs, alphas, betas = [], [], []
    for _ in range(k):
        w = apply_a(v_k)
        alpha = torch.real(torch.vdot(v_k, w))
        w = w - alpha * v_k - beta_km1 * v_km1
        beta = torch.linalg.vector_norm(w)
        ok = (beta > eps) & alive
        v_next = torch.where(ok, w / torch.where(beta == 0,
                                                 torch.ones_like(beta), beta),
                             torch.zeros_like(w))
        Vs.append(v_k)
        alphas.append(torch.where(alive, alpha, zero))
        betas.append(torch.where(ok, beta, zero))
        v_km1, v_k, beta_km1, alive = v_k, v_next, betas[-1], ok
    alphas, betas = torch.stack(alphas), torch.stack(betas)
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    return torch.stack(Vs, 1), T, v_k, beta_km1


def _operator(A, dtype, device):
    """(m, n, A·x, Aᴴ·x, device) of a dense matrix or a matvec operator,
    the adjoint from ``rmatvec``, ``transpose().matvec`` or the swapped
    row/column triplets of a ``CSRDevice``."""
    if hasattr(A, "device_csr") and not hasattr(A, "matvec"):
        # a host SparseMatrix → its device CSR operator
        A = A.device_csr(device="cuda" if device is None else device,
                         dtype=dtype)
    if hasattr(A, "matvec"):
        av = A.matvec
        ah = getattr(A, "rmatvec", None)
        if ah is None and hasattr(A, "transpose"):
            AH = A.transpose()

            def ah(x):
                return AH.matvec(x.conj()).conj()
        if ah is None and hasattr(A, "rows") and hasattr(A, "colind"):
            # the adjoint from the swapped device triplets
            AH = dataclasses.replace(A, height=A.width, width=A.height,
                                     rows=A.colind, colind=A.rows,
                                     vals=A.vals.conj())
            ah = AH.matvec
        if ah is None:
            raise ValueError("operator must provide an adjoint application")
        vals = getattr(A, "vals", None)
        dev = vals.device if isinstance(vals, torch.Tensor) else device
        return A.height, A.width, av, ah, dev
    A = as_array(A)
    Ah = _adj(A)
    return (A.shape[0], A.shape[1], lambda x: _mm(A, x),
            lambda x: _mm(Ah, x), A.device)


@with_precision
def product_lanczos(A, basis_size: int = 20, dtype=torch.float64, *,
                    v0=None, device=None):
    """Lanczos on the Gram operator AᴴA (m ≥ n) or AAᴴ (reference
    ``ProductLanczos.hpp``; the two-norm and condition estimator).  ``A``
    is a dense tensor, a host ``SparseMatrix`` (moved to ``device`` as a
    ``CSRDevice``, the card when None), a ``CSRDevice``, or any object
    with ``matvec`` and ``rmatvec`` or ``transpose``."""
    m, n, av, ah, dev = _operator(A, dtype, device)
    if m >= n:
        return lanczos(n, lambda x: ah(av(x)), basis_size, v0, dtype,
                       device=dev)
    return lanczos(m, lambda x: av(ah(x)), basis_size, v0, dtype,
                   device=dev)


def extremal_singular_value_estimates(A, basis_size: int = 20,
                                      dtype=torch.float64, *, v0=None,
                                      device=None):
    """(σ_min, σ_max) estimates from the product-Lanczos Ritz values."""
    T = product_lanczos(A, basis_size, dtype, v0=v0, device=device)
    ritz = torch.clamp(torch.linalg.eigvalsh(T), min=0.0)
    return torch.sqrt(ritz[0]), torch.sqrt(ritz[-1])
