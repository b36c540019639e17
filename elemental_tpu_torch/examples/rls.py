"""Robust least squares (counterpart of ``examples/rls.py``; mirror of the
reference's ``examples/interface/RLS.py``): min ‖Ax − b‖₂ + ρ‖x‖₂.

    python -m elemental_tpu_torch.examples.rls --m 30 --n 10 --rho 0.5
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import robust_least_squares
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 30)
    args.input("n", "cols", 10)
    args.input("rho", "regularization", 0.5)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(7)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    rho = args["rho"]
    x = robust_least_squares(A, b, rho, device=device, dtype=dtype)
    obj = np.linalg.norm(A @ x - b) + rho * np.linalg.norm(x)
    xls = np.linalg.lstsq(A, b, rcond=None)[0]
    ols = np.linalg.norm(A @ xls - b) + rho * np.linalg.norm(xls)
    output(f"RLS: objective {obj:.6g} (LS point {ols:.6g})")
    check(obj <= ols + 1e-6, f"objective {obj} above the LS point's {ols}")
    return x


if __name__ == "__main__":
    main()
