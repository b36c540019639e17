"""Sparse ``Multiply`` in every form (counterpart of
``examples/multiply_ex.py``; mirror of the reference's
``examples/interface/Multiply.py``): y = αAx + βy, y = αAᵀx + βy, the
multi-right-hand-side product and the pattern-only ``Graph``, on the
stacked 2-D finite-difference operator.

    python -m elemental_tpu_torch.examples.multiply_ex --n0 16 --n1 16
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..sparse import Graph, SparseMatrix, multiply
from . import check, device_and_dtype


def stacked_fd2d(n0, n1):
    height, width = 2 * n0 * n1, n0 * n1
    rows, cols, vals = [], [], []
    s = np.arange(n0 * n1)
    x0, x1 = s % n0, s // n0
    for base, diag, offs in [
            (0, 11.1, [(x0 > 0, -1, -1.2), (x0 < n0 - 1, 1, 2.3),
                       (x1 > 0, -n0, -3.4), (x1 < n1 - 1, n0, 4.5)]),
            (n0 * n1, -2.0, [(x0 > 0, -1, -1.0), (x0 < n0 - 1, 1, -2.0),
                             (x1 > 0, -n0, -3.0), (x1 < n1 - 1, n0, 3.0)])]:
        rows.append(s + base)
        cols.append(s)
        vals.append(np.full(s.size, diag))
        for mask, off, v in offs:
            rows.append(s[mask] + base)
            cols.append(s[mask] + off)
            vals.append(np.full(int(mask.sum()), v))
    return SparseMatrix.from_coo(height, width, np.concatenate(rows),
                                 np.concatenate(cols),
                                 np.concatenate(vals))


def main():
    args = Args()
    args.input("n0", "x grid", 16)
    args.input("n1", "y grid", 16)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    A = stacked_fd2d(args["n0"], args["n1"])
    m, n = A.shape
    rng = np.random.default_rng(10)
    x = rng.standard_normal(n)
    y0 = rng.standard_normal(m)
    As = A.to_scipy()

    def on(a):
        return torch.from_numpy(a).to(device, dtype)

    def host(t):
        return t.double().cpu().numpy()

    y = host(multiply("N", 2.0, A, on(x), -0.5, on(y0)))
    check(np.abs(y - (2.0 * As @ x + -0.5 * y0)).max() < 1e-4, "N")

    w0 = rng.standard_normal(n)
    w = host(multiply("T", 1.5, A, on(y0), 0.25, on(w0)))
    check(np.abs(w - (1.5 * As.T @ y0 + 0.25 * w0)).max() < 1e-4, "T")

    # SpMM (multiple right-hand sides)
    X = rng.standard_normal((n, 3))
    Y = host(multiply("N", 1.0, A, on(X), 0.0, on(np.zeros((m, 3)))))
    check(np.abs(Y - As @ X).max() < 1e-4, "SpMM")

    # Graph (pattern-only) agreement: Multiply.cpp:35-43 cross-check
    G = Graph.from_edges(m, n, np.repeat(np.arange(m), A.row_nnz()),
                         A.colind)
    yg = host(multiply("N", 1.0, G.to_sparse(), on(x), 0.0,
                       on(np.zeros(m))))
    ones = SparseMatrix(m, n, A.rowptr.copy(), A.colind.copy(),
                        np.ones(A.nnz))
    check(np.abs(yg - ones.to_scipy() @ x).max() < 1e-4, "Graph")
    output(f"Multiply: N/T/SpMM/Graph agree on {m}x{n}, nnz={A.nnz} "
           f"({dtype} on {device})")
    return y, w, Y, yg


if __name__ == "__main__":
    main()
