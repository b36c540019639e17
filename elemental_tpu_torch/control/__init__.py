"""Control-theoretic solvers (counterpart of ``elemental_tpu/control``;
reference ``src/control`` and ``include/El/control.hpp:17-60``: Lyapunov,
Sylvester, Riccati through the matrix sign function's spectral
disection), on :func:`..lapack.funcs.sign`."""

from __future__ import annotations

from typing import Union

import torch

from ..core.distmatrix import DistMatrix, as_array, like
from ..lapack.funcs import sign as matrix_sign

Arr = Union[torch.Tensor, DistMatrix]


def _adj(x: torch.Tensor) -> torch.Tensor:
    return x.mH.resolve_conj()


def sylvester(A: Arr, B: Arr, C: Arr) -> Arr:
    """Solve A·X + X·B = C (reference ``Sylvester``): with W = [[A, −C],
    [0, −B]], sign(W) = [[I, −2X], [0, −I]].  The spectra of A and −B must
    lie on opposite sides of the imaginary axis."""
    a, b, c = as_array(A), as_array(B), as_array(C)
    m, n = a.shape[0], b.shape[0]
    zero = torch.zeros((n, m), dtype=a.dtype, device=a.device)
    W = torch.cat([torch.cat([a, -c], 1), torch.cat([zero, -b], 1)], 0)
    S = as_array(matrix_sign(W))
    return like(C, -S[:m, m:] / 2)


def lyapunov(A: Arr, C: Arr) -> Arr:
    """Solve A·X + X·Aᴴ = C (reference ``Lyapunov``): Sylvester with
    B = Aᴴ."""
    return sylvester(A, _adj(as_array(A)), C)


def _symmetrize(M: torch.Tensor, uplo: str) -> torch.Tensor:
    """The Hermitian matrix whose ``uplo`` triangle M holds."""
    if uplo.upper() == "L":
        return torch.tril(M) + _adj(torch.tril(M, -1))
    return torch.triu(M) + _adj(torch.triu(M, 1))


def ricatti(*args) -> Arr:
    """Reference ``Riccati`` (``include/El/control.hpp:34-58``), both
    overloads:

    * ``ricatti(W)`` — W is the 2n×2n Hamiltonian [[A, −L], [−K, −Aᴴ]];
    * ``ricatti(uplo, A, K, L)`` — K, L Hermitian, stored in the ``uplo``
      triangle; solves the CARE AᴴX + XA + K − X·L·X = 0.

    Returns the stabilizing solution X from the sign function's stable
    invariant subspace."""
    if len(args) == 1:
        W = as_array(args[0])
        n = W.shape[0] // 2
        return ricatti_hamiltonian(W[:n, :n], -W[n:, :n], -W[:n, n:])
    uplo, A, K, L = args
    return ricatti_hamiltonian(A, like(A, _symmetrize(as_array(K), uplo)),
                               like(A, _symmetrize(as_array(L), uplo)))


def ricatti_hamiltonian(A: Arr, K: Arr, L: Arr) -> Arr:
    """Solve AᴴX + XA + K − X·L·X = 0 (CARE; reference ``Ricatti``): S =
    sign([[A, −L], [−K, −Aᴴ]]); [I; X] spans the kernel of S + I, so X
    solves [[S12], [S22 + I]]·X = −[[S11 + I], [S21]] in least squares.

    That 2n×n system has full column rank at a stabilizing solution.  On the
    host it is solved by LAPACK's SVD-based ``gelsd`` (the JAX package's
    ``lstsq`` is SVD-based too); on the card ``torch.linalg.lstsq`` has
    only ``gels`` (QR, which assumes full column rank): the same solution
    for a full-rank system."""
    a, k, l = as_array(A), as_array(K), as_array(L)
    n = a.shape[0]
    W = torch.cat([torch.cat([a, -l], 1), torch.cat([-k, -_adj(a)], 1)], 0)
    S = as_array(matrix_sign(W))
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    M = torch.cat([S[:n, n:], S[n:, n:] + eye], 0)
    R = -torch.cat([S[:n, :n] + eye, S[n:, :n]], 0)
    driver = "gels" if M.is_cuda else "gelsd"
    return like(A, torch.linalg.lstsq(M, R, driver=driver).solution)
