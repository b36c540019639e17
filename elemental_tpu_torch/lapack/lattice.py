"""Lattice reduction: LLL and its applications (counterpart of
``elemental_tpu/lapack/lattice.py``, the port's own copy of the same NumPy
code; reference spec from ``examples/interface/{LLL,LLLSingular,
LatticeImageAndKernel,ZDependenceSearch,AlgebraicRelationSearch,LCF}.py``;
API mirrors ``U, R, info = El.LLL(B, mode, ctrl)``).

Host-side NumPy by design, as in the JAX package: lattice reduction is a
sequential, data-dependent integer algorithm.  Floating-point Gram–Schmidt
in f64 with exact integer basis updates (entries exact up to 2⁵³).  A
torch tensor argument is read into NumPy first (from any device); the
results are NumPy arrays, bit-equal to the JAX package's on the same
input.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..core.distmatrix import as_numpy


@dataclasses.dataclass
class LLLInfo:
    """Reduction certificate (reference ``LLLInfo``: delta, eta, rank,
    nullity, numSwaps)."""
    delta: float
    eta: float
    rank: int
    nullity: int
    num_swaps: int


def _gram_schmidt(B):
    """Classical GS of the columns: B = Q diag(|b*|) with mu factors.
    Returns (mu, norms2) where mu is unit-lower-triangular (columns)."""
    m, n = B.shape
    mu = np.eye(n)
    bstar = np.zeros((m, n))
    norms2 = np.zeros(n)
    for j in range(n):
        v = B[:, j].astype(np.float64).copy()
        for i in range(j):
            if norms2[i] > 0:
                mu[j, i] = (B[:, j] @ bstar[:, i]) / norms2[i]
                v -= mu[j, i] * bstar[:, i]
            else:
                mu[j, i] = 0.0
        bstar[:, j] = v
        norms2[j] = v @ v
    return mu, bstar, norms2


def lll(B, delta: float = 0.75, eta: float = 0.51,
        variant: str = "normal", presort: bool = False,
        smallest_first: bool = False,
        max_swaps: Optional[int] = None):
    """LLL-reduce the columns of integer basis ``B``.

    Returns ``(B_reduced, U, R, info)`` with ``B_reduced = B @ U``
    (U unimodular), R the Gram–Schmidt upper-triangular factor of the
    reduced basis, matching the reference driver's ``El.LLL(B, LLL_FULL)``.

    ``variant``: 'weak' (size-reduce against the previous column only),
    'normal' (full size reduction, Lovász swaps), or 'deep' (deep
    insertions).  ``presort``/``smallest_first``: Wubben et al.'s
    norm-sorting preprocessing (reference ``QRCtrl.smallestFirst``)."""
    B = np.array(as_numpy(B), np.float64)
    m, n = B.shape
    U = np.eye(n)
    if presort and n > 1:
        order = np.argsort(np.linalg.norm(B, axis=0))
        if not smallest_first:
            order = order[::-1]
        B = B[:, order]
        U = U[:, order]
    num_swaps = 0
    cap = max_swaps if max_swaps is not None else 10000 * n * n
    deep = variant.lower().startswith("deep")
    weak = variant.lower() == "weak"

    mu, bstar, norms2 = _gram_schmidt(B)
    k = 1
    while k < n and num_swaps < cap:
        # size-reduce column k
        lo = k - 1 if weak else 0
        for j in range(k - 1, lo - 1, -1):
            q = np.round(mu[k, j])
            if abs(mu[k, j]) > eta and q != 0:
                B[:, k] -= q * B[:, j]
                U[:, k] -= q * U[:, j]
                mu[k, :j + 1] -= q * mu[j, :j + 1]
        if deep:
            # deep insertion: move b_k before the first i where the Lovász
            # test fails against the projected norm
            c = float(B[:, k] @ B[:, k])
            ins = k
            for i in range(k):
                if delta * norms2[i] > c:
                    ins = i
                    break
                c -= float(mu[k, i]) ** 2 * norms2[i]
            if ins < k:
                Bk, Uk = B[:, k].copy(), U[:, k].copy()
                B[:, ins + 1:k + 1] = B[:, ins:k]
                U[:, ins + 1:k + 1] = U[:, ins:k]
                B[:, ins], U[:, ins] = Bk, Uk
                mu, bstar, norms2 = _gram_schmidt(B)
                num_swaps += 1
                k = max(ins, 1)
                continue
            k += 1
            continue
        # Lovász condition
        if norms2[k] >= (delta - mu[k, k - 1] ** 2) * norms2[k - 1]:
            k += 1
        else:
            B[:, [k - 1, k]] = B[:, [k, k - 1]]
            U[:, [k - 1, k]] = U[:, [k, k - 1]]
            mu, bstar, norms2 = _gram_schmidt(B)
            num_swaps += 1
            k = max(k - 1, 1)

    mu, bstar, norms2 = _gram_schmidt(B)
    # R factor: R[i,j] = mu[j,i]*||b*_i||  (upper triangular)
    nrm = np.sqrt(np.maximum(norms2, 0.0))
    R = mu.T * nrm[:, None]
    zero = nrm <= 1e-9 * max(1.0, nrm.max() if n else 1.0)
    nullity = int(zero.sum())
    # achieved delta/eta diagnostics
    ach_eta = float(np.abs(np.tril(mu, -1)).max()) if n > 1 else 0.0
    ach_delta = 1.0
    for i in range(1, n):
        if norms2[i - 1] > 0:
            ach_delta = min(ach_delta,
                            (norms2[i] + mu[i, i - 1] ** 2 * norms2[i - 1])
                            / norms2[i - 1])
    info = LLLInfo(delta=float(ach_delta), eta=ach_eta,
                   rank=n - nullity, nullity=nullity, num_swaps=num_swaps)
    return B, U, R, info


def lattice_image_and_kernel(B, delta: float = 0.75):
    """Split a lattice basis into (image basis, integer kernel basis) via
    LLL (reference ``examples/interface/LatticeImageAndKernel.py``): zero
    reduced columns certify kernel vectors (their U columns)."""
    Bred, U, R, info = lll(B, delta)
    nrm = np.linalg.norm(Bred, axis=0)
    tol = 1e-9 * max(1.0, nrm.max() if nrm.size else 1.0)
    kerm = nrm <= tol
    image = Bred[:, ~kerm]
    kernel = U[:, kerm]
    return image, kernel, info


def z_dependence_search(z, n_sqrt: float = 1e6, delta: float = 0.75):
    """Find a small integer relation a with aᵀz ≈ 0 (reference
    ``examples/interface/ZDependenceSearch.py``; HJLS/PSLQ-style embedding):
    LLL-reduce [[I],[√N·Re z],[√N·Im z]] and read the relation off the first
    reduced column.  Returns ``(a, residual, info)``."""
    z = as_numpy(z)
    n = z.shape[0]
    rows = [np.eye(n)]
    rows.append(n_sqrt * np.real(z)[None, :])
    if np.iscomplexobj(z) and np.abs(np.imag(z)).max() > 0:
        rows.append(n_sqrt * np.imag(z)[None, :])
    B = np.concatenate(rows, axis=0)
    Bred, U, R, info = lll(B, delta)
    a = np.round(Bred[:n, 0]).astype(np.int64)
    residual = abs(np.sum(a * z))
    return a, float(residual), info


def algebraic_relation_search(alpha, degree: int, n_sqrt: float = 1e6,
                              delta: float = 0.75):
    """Search for an integer polynomial of ``degree`` with root ≈ ``alpha``
    (reference ``examples/interface/AlgebraicRelationSearch.py``): integer
    relation among the powers (1, α, …, α^d)."""
    if hasattr(alpha, "detach"):        # a torch tensor
        alpha = alpha.item()
    powers = np.array([alpha ** k for k in range(degree + 1)])
    coeffs, residual, info = z_dependence_search(powers, n_sqrt, delta)
    return coeffs, float(residual), info
