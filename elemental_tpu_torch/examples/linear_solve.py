"""Distributed linear and symmetric solve (counterpart of
``examples/linear_solve.py``; mirror of the reference's
``examples/interface/LinearSolve.py`` and ``SymmetricSolve.py``) on a 2×4
grid that repeats ``--device``.

    python -m elemental_tpu_torch.examples.linear_solve --n 96
"""

import numpy as np
import torch

from ..core import MC, MR, Grid, as_array, distribute
from ..core.environment import Args, output
from ..lapack import linear_solve, symmetric_solve
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("n", "system size", 96)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    tol = tolerance(dtype, 1e-8)
    rng = np.random.default_rng(14)
    grid = Grid(devices=[device] * 8, height=2)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 2))
    A = distribute(torch.from_numpy(a).to(dtype), MC, MR, grid)
    B = distribute(torch.from_numpy(b).to(dtype), MC, MR, grid)
    X = linear_solve(A, B)
    r = np.abs(a @ as_array(X).double().cpu().numpy() - b).max()
    s = (a + a.T) / 2 + n * np.eye(n)
    S = distribute(torch.from_numpy(s).to(dtype), MC, MR, grid)
    Xs = symmetric_solve(S, B)
    rs = np.abs(s @ as_array(Xs).double().cpu().numpy() - b).max()
    output(f"linear_solve residual {r:.2e}; symmetric_solve {rs:.2e} "
           f"({dtype} on a 2x4 grid of {device})")
    check(r < tol and rs < tol, f"residuals {r:.2e}, {rs:.2e} over {tol}")


if __name__ == "__main__":
    main()
