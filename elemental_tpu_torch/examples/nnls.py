"""Non-negative least squares (counterpart of ``examples/nnls.py``; mirror
of the reference's ``examples/interface/NNLS.py``), held against scipy.

    python -m elemental_tpu_torch.examples.nnls --m 40 --n 20
"""

import numpy as np
import scipy.optimize as so

from ..core.environment import Args, output
from ..optimization import nnls
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 40)
    args.input("n", "cols", 20)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(6)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    x = nnls(A, b, device=device, dtype=dtype)
    ref, _ = so.nnls(A, b)
    output(f"NNLS: ours {np.linalg.norm(A @ x - b):.8g} vs scipy "
           f"{np.linalg.norm(A @ ref - b):.8g}")
    check(x.min() > -1e-8, f"min(x) = {x.min()}")
    check(np.linalg.norm(A @ x - b) <= np.linalg.norm(A @ ref - b) + 1e-5,
          "residual above scipy's")
    return x


if __name__ == "__main__":
    main()
