"""Dense Dantzig selector (counterpart of ``examples/ds_dense.py``; mirror
of the reference's ``examples/interface/DSDense.py``).

    python -m elemental_tpu_torch.examples.ds_dense --m 15 --n 10 --lam 2.0
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import dantzig_selector
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 15)
    args.input("n", "cols", 10)
    args.input("lam", "correlation bound", 2.0)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(24)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    lam = args["lam"]
    x = dantzig_selector(A, b, lam, device=device, dtype=dtype)
    corr = np.abs(A.T @ (A @ x - b)).max()
    check(corr <= lam * (1 + 1e-3), f"correlation {corr}")
    output(f"dense DS: ‖Aᵀ(Ax−b)‖∞ {corr:.6g} ≤ λ={lam}, "
           f"‖x‖₁ {np.abs(x).sum():.6g}")
    return x


if __name__ == "__main__":
    main()
