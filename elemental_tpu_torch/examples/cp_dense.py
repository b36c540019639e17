"""Dense Chebyshev point (counterpart of ``examples/cp_dense.py``; mirror
of the reference's ``examples/interface/CPDense.py``).

    python -m elemental_tpu_torch.examples.cp_dense --m 20 --n 8
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import chebyshev_point
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 20)
    args.input("n", "cols", 8)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(23)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    x = chebyshev_point(A, b, device=device, dtype=dtype)
    obj = np.abs(A @ x - b).max()
    xls = np.linalg.lstsq(A, b, rcond=None)[0]
    check(obj <= np.abs(A @ xls - b).max() + 1e-5,
          f"linf residual {obj} above the LS point's")
    output(f"dense CP: linf residual {obj:.6g}")
    return x


if __name__ == "__main__":
    main()
