"""Total-variation denoising (counterpart of ``examples/tv.py``; mirror of
the reference's ``examples/interface/TV.py``).

    python -m elemental_tpu_torch.examples.tv --n 60 --lam 2.0
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import total_variation
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "signal length", 60)
    args.input("lam", "TV weight", 2.0)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(8)
    truth = np.repeat([0.0, 2.0, -1.0], args["n"] // 3 + 1)[:args["n"]]
    b = truth + 0.2 * rng.standard_normal(args["n"])
    x = total_variation(b, args["lam"], device=device, dtype=dtype)
    tv_x = np.abs(np.diff(x)).sum()
    tv_b = np.abs(np.diff(b)).sum()
    output(f"TV: total variation {tv_b:.4g} -> {tv_x:.4g}")
    check(tv_x < tv_b, f"total variation {tv_x} not below {tv_b}")
    return x


if __name__ == "__main__":
    main()
