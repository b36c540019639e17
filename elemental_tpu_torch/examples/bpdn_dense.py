"""Dense basis pursuit denoising (counterpart of
``examples/bpdn_dense.py``; mirror of the reference's
``examples/interface/BPDNDense.py``).

    python -m elemental_tpu_torch.examples.bpdn_dense --m 15 --n 30 --lam 0.3
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import bpdn
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 15)
    args.input("n", "cols", 30)
    args.input("lam", "l1 weight", 0.3)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(22)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    lam = args["lam"]
    x = bpdn(A, b, lam, device=device, dtype=dtype)
    obj = 0.5 * np.linalg.norm(A @ x - b) ** 2 + lam * np.abs(x).sum()
    obj0 = 0.5 * np.linalg.norm(b) ** 2                 # x = 0 point
    check(obj <= obj0 + 1e-8, f"objective {obj} above the zero point's")
    output(f"dense BPDN: objective {obj:.6g} (zero point {obj0:.6g})")
    return x


if __name__ == "__main__":
    main()
