"""Least squares, ridge and Tikhonov (counterpart of
``examples/least_squares.py``; mirror of the reference's
``examples/interface/LeastSquares.py`` and ``Tikhonov.py``).

    python -m elemental_tpu_torch.examples.least_squares --m 120 --n 40
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack.euclidean_min import least_squares, ridge, tikhonov
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("m", "rows", 120)
    args.input("n", "cols", 40)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    m, n = args["m"], args["n"]
    tol = tolerance(dtype, 1e-8)
    rng = np.random.default_rng(13)
    a = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    A = torch.from_numpy(a).to(device, dtype)
    B = torch.from_numpy(b).to(device, dtype)
    x = least_squares("N", A, B).double().cpu().numpy()
    ref = np.linalg.lstsq(a, b, rcond=None)[0]
    check(np.abs(x - ref).max() < tol, "least_squares differs from lstsq")
    xr = ridge("N", A, B, 0.7).double().cpu().numpy()
    refr = np.linalg.solve(a.T @ a + 0.49 * np.eye(n), a.T @ b)
    check(np.abs(xr - refr).max() < tol, "ridge differs from the normal "
          "equations")
    G = 0.7 * torch.eye(n, dtype=dtype, device=device)
    xt = tikhonov("N", A, B, G).double().cpu().numpy()
    check(np.abs(xt - refr).max() < tol, "tikhonov with G = 0.7·I differs "
          "from ridge's solution")
    output(f"least_squares/ridge/tikhonov OK ({dtype} on {device}; "
           f"residual {np.linalg.norm(a @ x - b):.4g})")


if __name__ == "__main__":
    main()
