"""Equality-constrained least squares (counterpart of ``examples/lse.py``;
mirror of the reference's ``examples/interface/LSE.py``): min ‖A·x − c‖₂
s.t. B·x = d.

    python -m elemental_tpu_torch.examples.lse --m 70 --n 40 --p 12
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack import lse
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("m", "A rows", 70)
    args.input("n", "cols", 40)
    args.input("p", "constraints", 12)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(5)
    A = rng.standard_normal((args["m"], args["n"]))
    B = rng.standard_normal((args["p"], args["n"]))
    c = rng.standard_normal(args["m"])
    d = rng.standard_normal(args["p"])
    x = lse(*(torch.from_numpy(v).to(device, dtype) for v in (A, B, c, d)))
    x = x.double().cpu().numpy()
    cons = np.linalg.norm(B @ x - d) / (1 + np.linalg.norm(d))
    # optimality: the residual's gradient is orthogonal to null(B)
    g = A.T @ (A @ x - c)
    Pg = g - B.T @ np.linalg.lstsq(B.T, g, rcond=None)[0]
    output(f"LSE: constraint {cons:.2e}, projected gradient "
           f"{np.linalg.norm(Pg):.2e} ({dtype} on {device})")
    check(cons < tolerance(dtype, 1e-8), f"constraint residual {cons:.2e}")
    check(np.linalg.norm(Pg) < tolerance(dtype, 1e-6),
          f"projected gradient {np.linalg.norm(Pg):.2e}")


if __name__ == "__main__":
    main()
