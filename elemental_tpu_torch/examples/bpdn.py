"""Basis pursuit denoising (counterpart of ``examples/bpdn.py``; mirror of
the reference's ``examples/interface/BPDN.py``): min ½‖Ax − b‖² + λ‖x‖₁.

    python -m elemental_tpu_torch.examples.bpdn --m 30 --n 60 --lam 0.5
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import bpdn
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 30)
    args.input("n", "cols", 60)
    args.input("lam", "l1 weight", 0.5)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(1)
    A = rng.standard_normal((args["m"], args["n"]))
    x0 = np.zeros(args["n"])
    x0[:4] = rng.standard_normal(4) * 3
    b = A @ x0 + 0.01 * rng.standard_normal(args["m"])
    x = bpdn(A, b, args["lam"], device=device, dtype=dtype)
    obj = 0.5 * np.sum((A @ x - b) ** 2) + args["lam"] * np.abs(x).sum()
    output(f"BPDN: objective = {obj:.6g}, "
           f"nnz(x>1e-4) = {(np.abs(x) > 1e-4).sum()}")
    check(np.isfinite(obj), "BPDN objective not finite")
    return x


if __name__ == "__main__":
    main()
