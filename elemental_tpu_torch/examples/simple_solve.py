"""Smallest end-to-end driver (counterpart of ``examples/simple_solve.py``;
mirror of the reference's ``examples/interface/Simple.py``): a distributed
matrix on a 2×2 grid that repeats ``--device``, a linear solve, a check.

    python -m elemental_tpu_torch.examples.simple_solve --n 64
"""

import numpy as np
import torch

from ..core import MC, MR, Grid, as_array, distribute
from ..core.environment import Args, output
from ..lapack import linear_solve
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "size", 64)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    rng = np.random.default_rng(14)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 2))
    g = Grid(devices=[device] * 4, height=2)
    A = distribute(torch.from_numpy(a).to(dtype), MC, MR, g)
    B = distribute(torch.from_numpy(b).to(dtype), MC, MR, g)
    X = as_array(linear_solve(A, B)).double().cpu().numpy()
    r = np.linalg.norm(a @ X - b) / np.linalg.norm(b)
    output(f"simple: dist linear solve residual {r:.2e} on a "
           f"{g.height}x{g.width} grid of {device} ({dtype})")
    check(r < 1e-5, f"relative residual {r:.2e} over 1e-5")


if __name__ == "__main__":
    main()
