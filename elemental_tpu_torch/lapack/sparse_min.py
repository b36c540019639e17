"""Sparse Euclidean minimization (counterpart of
``elemental_tpu/lapack/sparse_min.py``; reference sparse ``LeastSquares`` /
``LinearSolve`` / ``LSE``, called by
``examples/interface/Sequential{LeastSquares,LinearSolve,LSE}.py``).

The reference solves sparse LS through a regularized quasi-definite
AUGMENTED system factored by the sparse LDL; here the same embedding runs
through the multifrontal :class:`..sparse_direct.SparseLDLFactorization` on
``device`` in ``dtype``, with iterative refinement against the
UNregularized augmented operator, so the δ regularization only shapes the
factor.  Each refinement step costs one tree solve and one sparse matvec.

δ defaults as in the JAX package, √eps·max(1, ‖A‖_max) (eps of ``dtype``),
with one deliberate difference: float32 least squares takes
√eps·max(1, ‖A‖_max)², the same for ‖A‖_max ≤ 1.  The (2,2) block
multiplies x in Aᵀr − δx = 0, so δ scales as ‖A‖²; with the JAX package's
δ the float32 refinement of the extended Laplacian driver at a 60×60 grid
(‖A‖_max ≈ 1.5e4) diverges and misses the driver's gate, which this one
meets (``tests/test_torch_solvers.py``).  Float64 meets it with the JAX
package's δ and keeps it.

``perm`` (keyword-only, a port addition) hands a precomputed fill ordering
of the augmented system to the factorization, as ``LPCtrl.ordering`` does
for the KKT engines.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.policy import real_working_dtype
from ..sparse.csr import SparseMatrix
from ..sparse_direct import SparseLDLFactorization


def _augmented(blocks, N):
    """Assemble a symmetric sparse matrix from COO block list
    [(rows, cols, vals), ...]."""
    rows = np.concatenate([b[0] for b in blocks])
    cols = np.concatenate([b[1] for b in blocks])
    vals = np.concatenate([b[2] for b in blocks])
    return SparseMatrix.from_coo(N, N, rows, cols, vals)


def _coo(A: SparseMatrix):
    return A.row_ids(), A.colind, A.vals


def _ls_system(A: SparseMatrix, delta: float) -> SparseMatrix:
    """[[I, A], [Aᵀ, −δI]] of min‖Ax − b‖, for A m×n."""
    m, n = A.shape
    N = m + n
    ar, ac, av = _coo(A)
    return _augmented([
        (np.arange(m), np.arange(m), np.ones(m)),
        (ar, ac + m, av),
        (ac + m, ar, av),
        (np.arange(m, N), np.arange(m, N), np.full(n, -delta)),
    ], N)


def _lse_system(A: SparseMatrix, B: SparseMatrix,
                delta: float) -> SparseMatrix:
    """[[I, 0, A], [0, −δI, B], [Aᵀ, Bᵀ, −δI]] of min‖Ax − c‖ s.t. Bx = d,
    for A m×n and B p×n."""
    m, n = A.shape
    p = B.shape[0]
    N = m + p + n
    ar, ac, av = _coo(A)
    br, bc, bv = _coo(B)
    return _augmented([
        (np.arange(m), np.arange(m), np.ones(m)),
        (ar, ac + m + p, av),
        (ac + m + p, ar, av),
        (br + m, bc + m + p, bv),
        (bc + m + p, br + m, bv),
        (np.arange(m, m + p), np.arange(m, m + p), np.full(p, -delta)),
        (np.arange(m + p, N), np.arange(m + p, N), np.full(n, -delta)),
    ], N)


def _default_delta(dtype: torch.dtype, *mats: SparseMatrix,
                   power: int = 1) -> float:
    """√eps(dtype) · max(1, max|entry| over the non-empty ``mats``)^power."""
    eps = float(torch.finfo(dtype).eps)
    return float(np.sqrt(eps)) * max(
        [1.0] + [float(np.abs(M.vals).max()) for M in mats if M.nnz]) ** power


def sparse_least_squares(A: SparseMatrix, b, delta: Optional[float] = None,
                         refine: int = 8, *, device, dtype,
                         perm: Optional[np.ndarray] = None) -> torch.Tensor:
    """min‖Ax − b‖₂ for sparse A (m ≥ n or square; for square nonsingular
    A this is the sparse ``LinearSolve``), on ``device`` in ``dtype``;
    returns x on ``device``.

    The embedding keeps the residual variable UNSCALED,
    [[I, A], [Aᵀ, −δI]]·[r; x] = [b; 0], so refinement against the δ-free
    operator contracts at O(δ·κ).  (The classical r/α scaling with
    α ≈ √eps·‖A‖ diverged ×3/iteration on the ExtendedLaplacian driver in
    the JAX package: the 1e5-scaled residual variable mixes magnitudes the
    refinement cannot survive.)"""
    dtype = real_working_dtype(dtype)
    m, n = A.shape
    if delta is None:
        delta = _default_delta(
            dtype, A, power=2 if dtype == torch.float32 else 1)
    f = SparseLDLFactorization(device=device, dtype=dtype)
    f.initialize(_ls_system(A, delta), perm=perm)
    f.factor()
    Ad = A.device_csr(device=device, dtype=dtype)
    Atd = A.transpose().device_csr(device=device, dtype=dtype)
    bj = torch.as_tensor(b).to(device, dtype)
    rhs = torch.cat([bj, torch.zeros(n, dtype=dtype, device=bj.device)])
    sol = f.solve(rhs)

    def k0(v):
        u, x = v[:m], v[m:]
        return torch.cat([u + Ad.matvec(x), Atd.matvec(u)])

    for _ in range(refine):
        sol = sol + f.solve(rhs - k0(sol))
    return sol[m:]


def sparse_linear_solve(A: SparseMatrix, b, **kw) -> torch.Tensor:
    """Square sparse solve (reference sparse ``LinearSolve``) via the
    same augmented embedding (exact for nonsingular A)."""
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"square systems only, got {A.shape}")
    return sparse_least_squares(A, b, **kw)


def sparse_lse(A: SparseMatrix, B: SparseMatrix, c, d,
               delta: Optional[float] = None, refine: int = 6, *, device,
               dtype, perm: Optional[np.ndarray] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equality-constrained sparse LS: min‖Ax − c‖ s.t. Bx = d (reference
    ``SequentialLSE.py``) on ``device`` in ``dtype``.  Augmented
    quasi-definite system [[I, 0, A], [0, −δI, B], [Aᵀ, Bᵀ, −δI]]·[r; λ; x]
    = [c; d; 0] with refinement against the δ-free KKT; the (1,1) block
    stays UNIT so the multiplier λ is O(1) and refinement contracts at
    O(δ·κ).  Returns (x, ‖Ax−c‖) on ``device``."""
    dtype = real_working_dtype(dtype)
    m, n = A.shape
    p = B.shape[0]
    if delta is None:
        delta = _default_delta(dtype, A, B)
    f = SparseLDLFactorization(device=device, dtype=dtype)
    f.initialize(_lse_system(A, B, delta), perm=perm)
    f.factor()
    Ad, Atd = (M.device_csr(device=device, dtype=dtype)
               for M in (A, A.transpose()))
    Bd, Btd = (M.device_csr(device=device, dtype=dtype)
               for M in (B, B.transpose()))
    cj = torch.as_tensor(c).to(device, dtype)
    dj = torch.as_tensor(d).to(device, dtype)
    rhs = torch.cat([cj, dj, torch.zeros(n, dtype=dtype, device=cj.device)])
    sol = f.solve(rhs)

    def k0(v):
        r, y, x = v[:m], v[m:m + p], v[m + p:]
        return torch.cat([r + Ad.matvec(x), Bd.matvec(x),
                          Atd.matvec(r) + Btd.matvec(y)])

    for _ in range(refine):
        sol = sol + f.solve(rhs - k0(sol))
    x = sol[m + p:]
    return x, torch.linalg.norm(Ad.matvec(x) - cj)
