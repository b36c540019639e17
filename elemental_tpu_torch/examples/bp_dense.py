"""Dense basis pursuit (counterpart of ``examples/bp_dense.py``; mirror of
the reference's ``examples/interface/BPDense.py``): ``El.BP`` on a dense
matrix — the model of ``bp``, dense input.

    python -m elemental_tpu_torch.examples.bp_dense --m 12 --n 40
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import basis_pursuit
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 12)
    args.input("n", "cols", 40)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    m, n = args["m"], args["n"]
    rng = np.random.default_rng(21)
    A = rng.standard_normal((m, n)) / np.sqrt(m)       # dense Matrix input
    x_true = np.zeros(n)
    x_true[rng.choice(n, 3, replace=False)] = rng.standard_normal(3)
    b = A @ x_true
    x = basis_pursuit(A, b, device=device, dtype=dtype)
    check(np.linalg.norm(A @ x - b) < 1e-3 * (1 + np.linalg.norm(b)),
          "dense BP residual")
    check(np.abs(x).sum() <= np.abs(x_true).sum() * (1 + 1e-2),
          "dense BP l1 above the generator's")
    output(f"dense BP: l1 {np.abs(x).sum():.6g} "
           f"(generator {np.abs(x_true).sum():.6g})")
    return x


if __name__ == "__main__":
    main()
