"""Tikhonov-regularized least squares (counterpart of
``examples/tikhonov_ex.py``; mirror of the reference's
``examples/interface/Tikhonov.py``): min ‖Ax − b‖² + ‖Γx‖².

    python -m elemental_tpu_torch.examples.tikhonov_ex --m 50 --n 30
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack import ridge, tikhonov
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("m", "rows", 50)
    args.input("n", "cols", 30)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    tol = tolerance(dtype, 1e-8)
    rng = np.random.default_rng(6)
    A = rng.standard_normal((args["m"], n))
    b = rng.standard_normal(args["m"])
    G = 0.5 * rng.standard_normal((n, n))
    At, bt, Gt = (torch.from_numpy(v).to(device, dtype) for v in (A, b, G))
    x = tikhonov("N", At, bt[:, None], Gt)[:, 0].double().cpu().numpy()
    xr = np.linalg.solve(A.T @ A + G.T @ G, A.T @ b)
    output(f"Tikhonov: ||x - x_normal_eq|| = {np.linalg.norm(x - xr):.2e} "
           f"({dtype} on {device})")
    check(np.allclose(x, xr, atol=tol), "tikhonov differs from the normal "
          "equations")
    xg = ridge("N", At, bt[:, None], 0.7)[:, 0].double().cpu().numpy()
    xrr = np.linalg.solve(A.T @ A + 0.49 * np.eye(n), A.T @ b)
    check(np.allclose(xg, xrr, atol=tol), "ridge differs from the normal "
          "equations")


if __name__ == "__main__":
    main()
