"""General (Gauss-Markov) linear model (counterpart of ``examples/glm.py``;
mirror of the reference's ``examples/interface/GLM.py``): min ‖y‖₂ s.t.
d = A·x + B·y.

    python -m elemental_tpu_torch.examples.glm --m 60 --n 25 --p 70
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack import glm
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("m", "rows", 60)
    args.input("n", "x cols", 25)
    args.input("p", "y cols", 70)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(4)
    A = rng.standard_normal((args["m"], args["n"]))
    B = rng.standard_normal((args["m"], args["p"]))
    d = rng.standard_normal(args["m"])
    x, y = glm(*(torch.from_numpy(v).to(device, dtype) for v in (A, B, d)))
    x, y = x.double().cpu().numpy(), y.double().cpu().numpy()
    res = np.linalg.norm(A @ x + B @ y - d) / (1 + np.linalg.norm(d))
    output(f"GLM: constraint residual {res:.2e}, ||y|| = "
           f"{np.linalg.norm(y):.6g} ({dtype} on {device})")
    check(res < tolerance(dtype, 1e-8), f"constraint residual {res:.2e}")
    # KKT optimality: y = Bᵀλ with Aᵀλ = 0
    lam = np.linalg.lstsq(B.T, y, rcond=None)[0]
    opt = np.linalg.norm(A.T @ lam) / (1 + np.linalg.norm(lam))
    check(opt < tolerance(dtype, 1e-6), f"optimality {opt:.2e}")


if __name__ == "__main__":
    main()
