"""Robust non-negative least squares (counterpart of
``examples/rnnls_ex.py``; mirror of the reference's
``examples/interface/RNNLS.py``) on its 5-diagonal rectangular stencil.

    python -m elemental_tpu_torch.examples.rnnls_ex --m 40 --n 20 --rho 2.0
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import nnls, rnnls
from ..sparse import SparseMatrix
from . import check, device_and_dtype


def rectang(height, width):
    """The reference's 5-diagonal rectangular stencil (``RNNLS.py``
    ``Rectang``)."""
    s = np.arange(height)
    rows = np.concatenate([s] * 5)
    cols = np.concatenate([s % width, (s - 1) % width, (s + 1) % width,
                           (s - height) % width, (s + height) % width])
    vals = np.concatenate([np.full(height, 11.0), np.full(height, -1.0),
                           np.full(height, 2.0), np.full(height, -3.0),
                           np.full(height, 4.0)])
    return SparseMatrix.from_coo(height, width, rows, cols, vals)


def main():
    args = Args()
    args.input("m", "rows", 40)
    args.input("n", "cols", 20)
    args.input("rho", "robustness weight", 2.0)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    m, n, rho = args["m"], args["n"], args["rho"]
    A = rectang(m, n)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(m)
    Ad = A.to_dense()

    x = rnnls(A, b, rho, device=device, dtype=dtype)
    check(x.min() > -1e-5, f"min(x) = {x.min()}")       # nonnegative
    obj = np.linalg.norm(Ad @ x - b) + rho * np.linalg.norm(x)
    x_nnls = nnls(A, b, device=device, dtype=dtype)
    obj_nnls = (np.linalg.norm(Ad @ x_nnls - b)
                + rho * np.linalg.norm(x_nnls))
    # RNNLS optimizes exactly this objective over the same feasible set
    check(obj <= obj_nnls + 1e-4 * (1 + obj_nnls),
          f"objective {obj} above the NNLS point's {obj_nnls}")
    xls = np.linalg.lstsq(Ad, b, rcond=None)[0]
    output(f"RNNLS: obj {obj:.6g} (NNLS point {obj_nnls:.6g}, "
           f"LS residual {np.linalg.norm(Ad @ xls - b):.3g})")
    return x


if __name__ == "__main__":
    main()
