"""Plain reference of the ``lap3d`` configuration: the 3-D 7-point Laplacian
of Elemental's ``tests/lapack_like/SparseLDL.cpp`` (unscaled: 6 on the
diagonal, −1 to each neighbour, Dirichlet boundaries), variable-coefficient
value sets on its pattern, and conjugate gradients in plain PyTorch for the
reference solutions.

Imports nothing of the program."""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch


def laplacian(side: int) -> sp.csr_matrix:
    """The unscaled 7-point Laplacian on a side³ grid, sorted CSR."""
    n = side ** 3
    idx = np.arange(n).reshape(side, side, side)
    rows, cols = [np.arange(n)], [np.arange(n)]
    vals = [np.full(n, 6.0)]
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis], hi[axis] = slice(0, -1), slice(1, None)
        a, b = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        rows += [a, b]
        cols += [b, a]
        vals += [np.full(a.size, -1.0)] * 2
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    A.sum_duplicates()
    A.sort_indices()
    return A


def diffusion_values(pattern: sp.csr_matrix, rng: np.random.Generator,
                     low: float, high: float) -> np.ndarray:
    """Values of a variable-coefficient diffusion on ``pattern``'s sorted
    CSR: each edge weight w drawn from [low, high), −w on both of its
    entries, and on the diagonal the row's absolute sum + 1, so the matrix
    is symmetric positive definite."""
    upper = sp.triu(pattern, 1).tocoo()
    w = rng.uniform(low, high, upper.nnz)
    W = sp.coo_matrix((w, (upper.row, upper.col)), shape=pattern.shape)
    W = (W + W.T).tocsr()
    M = (sp.diags(np.asarray(W.sum(axis=1)).ravel() + 1.0) - W).tocsr()
    M.sum_duplicates()
    M.sort_indices()
    if not (np.array_equal(M.indptr, pattern.indptr)
            and np.array_equal(M.indices, pattern.indices)):
        raise ValueError("value set does not lie on the pattern")
    return M.data


def to_torch(A: sp.csr_matrix, device, dtype) -> torch.Tensor:
    with warnings.catch_warnings():      # "beta" and invariant notices
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(A.indptr, dtype=torch.int64),
            torch.as_tensor(A.indices, dtype=torch.int64),
            torch.as_tensor(A.data), size=A.shape,
            check_invariants=True).to(device, dtype)


def cg(A: torch.Tensor, B: torch.Tensor, rtol: float,
       max_iters: int) -> torch.Tensor:
    """Conjugate gradients on the columns of B at once (each its own
    steps), until every relative residual is below ``rtol``."""
    X = torch.zeros_like(B)
    R = B.clone()
    P = R.clone()
    rr = (R * R).sum(0)
    stop = (rtol * torch.linalg.norm(B, dim=0)) ** 2
    for _ in range(max_iters):
        if bool((rr <= stop).all()):
            break
        AP = A @ P
        alpha = rr / torch.where(rr > stop, (P * AP).sum(0),
                                 torch.ones_like(rr))
        alpha = torch.where(rr > stop, alpha, torch.zeros_like(alpha))
        X += alpha * P
        R -= alpha * AP
        rr_new = (R * R).sum(0)
        P = R + (rr_new / torch.where(rr > 0, rr, torch.ones_like(rr))) * P
        rr = rr_new
    return X


def solve(A: sp.csr_matrix, B: np.ndarray, device, dtype=torch.float64,
          rtol: float = 1e-14, max_iters: int = 5000) -> np.ndarray:
    """Reference solutions of A·X = B (columns), by CG in ``dtype``."""
    At = to_torch(A, device, dtype)
    Bt = torch.as_tensor(B).to(device, dtype)
    return cg(At, Bt, rtol, max_iters).double().cpu().numpy()


def forward_error(got: np.ndarray, ref: np.ndarray) -> float:
    """max over columns of ‖x − x_ref‖ / ‖x_ref‖."""
    got = np.asarray(got, np.float64).reshape(ref.shape)
    return float(np.max(np.linalg.norm(got - ref, axis=0)
                        / np.linalg.norm(ref, axis=0)))
