"""Sparse equality-constrained least squares (counterpart of
``examples/sequential_lse.py``; mirror of the reference's
``examples/interface/SequentialLSE.py``): min ‖Ax − c‖ s.t. Bx = d on a
2-D finite-difference operator with a dense last column.

    python -m elemental_tpu_torch.examples.sequential_lse --n0 10 --n1 10 --p 5
"""

import numpy as np

from ..core.environment import Args, output
from ..core.policy import residual_bound
from ..lapack import sparse_lse
from ..sparse import SparseMatrix
from . import check, device_and_dtype


def fd2d(n0, n1):
    n = n0 * n1
    s = np.arange(n)
    x, y = s % n0, s // n0
    rows = [s]
    cols = [s]
    vals = [np.full(n, 11.0)]
    for mask, col, v in [(x > 0, s - 1, -1.0), (x < n0 - 1, s + 1, 2.0),
                         (y > 0, s - n0, -3.0), (y < n1 - 1, s + n0, 4.0)]:
        rows.append(s[mask])
        cols.append(col[mask])
        vals.append(np.full(int(mask.sum()), v))
    rows.append(s)
    cols.append(np.full(n, n - 1))
    vals.append(np.full(n, -10.0 / n))
    return SparseMatrix.from_coo(n, n, np.concatenate(rows),
                                 np.concatenate(cols),
                                 np.concatenate(vals))


def main():
    args = Args()
    args.input("n0", "x grid", 10)
    args.input("n1", "y grid", 10)
    args.input("p", "constraint rows", 5)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    A = fd2d(args["n0"], args["n1"])
    n = A.shape[1]
    p = args["p"]
    rng = np.random.default_rng(6)
    B = SparseMatrix.from_dense(rng.uniform(0, 1, (p, n)))
    c = rng.standard_normal(n)
    d = rng.standard_normal(p)
    x, resid = sparse_lse(A, B, c, d, device=device, dtype=dtype)
    x = x.double().cpu().numpy()
    cons = np.abs(B.to_dense() @ x - d).max()
    bound = residual_bound(dtype, n) * (1 + np.abs(d).max())
    check(cons < bound, f"constraint error {cons} above {bound}")
    # optimality: Aᵀr ∈ range(Bᵀ) — the projection on ker(Bᵀ) vanishes
    As = A.to_scipy()
    g = As.T @ (c - As @ x)
    Bd = B.to_dense()
    coef = np.linalg.lstsq(Bd.T, g, rcond=None)[0]
    perp = np.abs(g - Bd.T @ coef).max()
    scale = np.abs(As.data).max() * np.linalg.norm(c) + 1
    check(perp < residual_bound(dtype, n) * scale,
          f"‖P_ker(Bᵀ)·Aᵀr‖∞ = {perp}")
    output(f"sparse LSE ({dtype} on {device}): constraint err {cons:.3e}, "
           f"‖P_ker(Bᵀ)·Aᵀr‖∞ {perp:.3e}, residual {float(resid):.4g}")
    return cons, perp


if __name__ == "__main__":
    main()
