"""Dense non-negative least squares (counterpart of
``examples/nnls_dense.py``; mirror of the reference's
``examples/interface/NNLSDense.py``).

    python -m elemental_tpu_torch.examples.nnls_dense --m 20 --n 10
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import nnls
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 20)
    args.input("n", "cols", 10)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(29)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    x = nnls(A, b, device=device, dtype=dtype)
    check(x.min() > -1e-6, f"min(x) = {x.min()}")
    r = np.linalg.norm(A @ x - b)
    # projected-gradient stationarity: grad ≥ 0 where x = 0
    g = A.T @ (A @ x - b)
    active = x < 1e-6
    check(g[active].min() > -1e-3 if active.any() else True,
          "gradient negative on an active bound")
    output(f"dense NNLS: residual {r:.6g}, actives {active.sum()}")
    return x


if __name__ == "__main__":
    main()
