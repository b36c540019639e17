"""Dense least absolute value regression (counterpart of
``examples/lav_dense.py``; mirror of the reference's
``examples/interface/LAVDense.py``).

    python -m elemental_tpu_torch.examples.lav_dense --m 25 --n 8
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import lav
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 25)
    args.input("n", "cols", 8)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(26)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    x = lav(A, b, device=device, dtype=dtype)
    obj = np.abs(A @ x - b).sum()
    xls = np.linalg.lstsq(A, b, rcond=None)[0]
    check(obj <= np.abs(A @ xls - b).sum() + 1e-5,
          f"l1 residual {obj} above the LS point's")
    output(f"dense LAV: l1 residual {obj:.6g}")
    return x


if __name__ == "__main__":
    main()
