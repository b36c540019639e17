"""Dense elastic net (counterpart of ``examples/en_dense.py``; mirror of
the reference's ``examples/interface/ENDense.py``).

    python -m elemental_tpu_torch.examples.en_dense --m 15 --n 25
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import elastic_net
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 15)
    args.input("n", "cols", 25)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(25)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    lam1, lam2 = 0.4, 0.2
    x = elastic_net(A, b, lam1, lam2, device=device, dtype=dtype)
    obj = (0.5 * np.linalg.norm(A @ x - b) ** 2
           + lam1 * np.abs(x).sum() + 0.5 * lam2 * x @ x)
    check(obj <= 0.5 * np.linalg.norm(b) ** 2 + 1e-8,
          f"objective {obj} above the zero point's")
    output(f"dense EN: objective {obj:.6g}")
    return x


if __name__ == "__main__":
    main()
