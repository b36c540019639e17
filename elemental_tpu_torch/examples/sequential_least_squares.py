"""Sparse least squares (counterpart of
``examples/sequential_least_squares.py``; mirror of the reference's
``examples/interface/SequentialLeastSquares.py``): the extended 2-D
Laplacian (2n×n) solved through the regularized augmented system and the
multifrontal LDL (``lapack/sparse_min.py``).

    python -m elemental_tpu_torch.examples.sequential_least_squares --n0 12 --n1 12
"""

import numpy as np

from ..core.environment import Args, output
from ..core.policy import residual_bound
from ..lapack import sparse_least_squares
from ..sparse import SparseMatrix
from . import device_and_dtype


def extended_laplacian(n0, n1):
    """Reference ``ExtendedLaplacian``: the 5-point Laplacian stacked on a
    scaled identity block (2n×n)."""
    n = n0 * n1
    s = np.arange(n)
    x, y = s % n0, s // n0
    hx = float(n0 + 1) ** 2
    hy = float(n1 + 1) ** 2
    rows = [s, s + n]
    cols = [s, s]
    vals = [np.full(n, 2 * (hx + hy)), np.full(n, 2 * (hx + hy))]
    for mask, col, v in [(x > 0, s - 1, -hx), (x < n0 - 1, s + 1, -hx),
                         (y > 0, s - n0, -hy), (y < n1 - 1, s + n0, -hy)]:
        rows.append(s[mask])
        cols.append(col[mask])
        vals.append(np.full(int(mask.sum()), v))
    return SparseMatrix.from_coo(2 * n, n, np.concatenate(rows),
                                 np.concatenate(cols),
                                 np.concatenate(vals))


def main():
    args = Args()
    args.input("n0", "x grid", 12)
    args.input("n1", "y grid", 12)
    where = device_and_dtype(args)
    args.process_input()
    device, dtype = where()
    A = extended_laplacian(args["n0"], args["n1"])
    m, n = A.shape
    rng = np.random.default_rng(4)
    b = rng.standard_normal(m)
    x = sparse_least_squares(A, b, device=device, dtype=dtype) \
        .double().cpu().numpy()
    As = A.to_scipy()
    # optimality: Aᵀ(b − Ax) = 0
    g = np.abs(As.T @ (b - As @ x)).max()
    scale = np.abs(As.data).max() * np.linalg.norm(b)
    bound = residual_bound(dtype, n) * scale
    if not g < bound:
        raise AssertionError((g, bound))
    output(f"sparse LS ({m}x{n}, {dtype} on {device}): ‖Aᵀr‖∞ = {g:.3e} "
           f"(residual {np.linalg.norm(As @ x - b):.4g})")
    return g, bound


if __name__ == "__main__":
    main()
