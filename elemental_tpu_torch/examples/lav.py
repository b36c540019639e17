"""Least absolute value regression (counterpart of ``examples/lav.py``;
mirror of the reference's ``examples/interface/LAV.py``): min ‖Ax − b‖₁.

    python -m elemental_tpu_torch.examples.lav --m 40 --n 8
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import LPCtrl, lav
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 40)
    args.input("n", "cols", 8)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(2)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    x = lav(A, b, LPCtrl(tol=1e-9), device=device, dtype=dtype)
    l1 = np.abs(A @ x - b).sum()
    l2 = np.abs(A @ np.linalg.lstsq(A, b, rcond=None)[0] - b).sum()
    output(f"LAV: l1 objective {l1:.6g} (LS point gives {l2:.6g})")
    check(l1 <= l2 + 1e-8, f"l1 objective {l1} above the LS point's {l2}")
    return x


if __name__ == "__main__":
    main()
