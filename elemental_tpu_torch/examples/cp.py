"""Chebyshev point (counterpart of ``examples/cp.py``; mirror of the
reference's ``examples/interface/CP.py``): min ‖Ax − b‖∞.

    python -m elemental_tpu_torch.examples.cp --m 40 --n 8
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import LPCtrl, chebyshev_point
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 40)
    args.input("n", "cols", 8)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(3)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    x = chebyshev_point(A, b, LPCtrl(tol=1e-9), device=device, dtype=dtype)
    linf = np.abs(A @ x - b).max()
    lsq = np.abs(A @ np.linalg.lstsq(A, b, rcond=None)[0] - b).max()
    output(f"CP: inf-norm {linf:.6g} (LS point gives {lsq:.6g})")
    check(linf <= lsq + 1e-8, f"inf-norm {linf} above the LS point's {lsq}")
    return x


if __name__ == "__main__":
    main()
