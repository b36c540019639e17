"""Sparse linear solve with a dense last column (counterpart of
``examples/sequential_linear_solve.py``; mirror of the reference's
``examples/interface/SequentialLinearSolve.py``), through the regularized
augmented system and the multifrontal LDL.

    python -m elemental_tpu_torch.examples.sequential_linear_solve --n 300
"""

import numpy as np

from ..core.environment import Args, output
from ..core.policy import residual_bound
from ..lapack import sparse_linear_solve
from ..sparse import SparseMatrix
from . import check, device_and_dtype


def rectang_square(n):
    s = np.arange(n)
    rows = [s, s[1:], s[:-1]]
    cols = [s, s[:-1], s[1:]]
    vals = [np.full(n, 11.0), np.full(n - 1, -1.0), np.full(n - 1, 2.0)]
    # the dense last column (reference: A.QueueUpdate(s, width-1, -5/height))
    rows.append(s)
    cols.append(np.full(n, n - 1))
    vals.append(np.full(n, -5.0 / n))
    return SparseMatrix.from_coo(n, n, np.concatenate(rows),
                                 np.concatenate(cols),
                                 np.concatenate(vals))


def main():
    args = Args()
    args.input("n", "system size", 300)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    A = rectang_square(n)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n)
    x = sparse_linear_solve(A, b, device=device, dtype=dtype) \
        .double().cpu().numpy()
    r = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
    bound = residual_bound(dtype, n)
    check(r < bound, f"relative residual {r} above {bound}")
    output(f"sparse linear solve (n={n}, dense last column, {dtype} on "
           f"{device}): rel residual {r:.3e}")
    return r, bound


if __name__ == "__main__":
    main()
