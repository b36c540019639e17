"""Dantzig selector (counterpart of ``examples/ds.py``; mirror of the
reference's ``examples/interface/DS.py``): min ‖x‖₁ s.t.
‖Aᵀ(Ax − b)‖∞ ≤ λ.

    python -m elemental_tpu_torch.examples.ds --m 25 --n 40 --lam 1.0
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import dantzig_selector
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 25)
    args.input("n", "cols", 40)
    args.input("lam", "residual bound", 1.0)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(4)
    A = rng.standard_normal((args["m"], args["n"]))
    x0 = np.zeros(args["n"])
    x0[:3] = [3.0, -2.0, 1.5]
    b = A @ x0
    x = dantzig_selector(A, b, args["lam"], device=device, dtype=dtype)
    viol = np.abs(A.T @ (A @ x - b)).max()
    output(f"DS: ||x||_1 = {np.abs(x).sum():.6g}, constraint {viol:.4g} "
           f"<= {args['lam']}")
    check(viol <= args["lam"] * (1 + 1e-4), f"constraint {viol}")
    return x


if __name__ == "__main__":
    main()
