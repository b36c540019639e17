"""Dense direct-form LP (counterpart of ``examples/lp_direct_dense.py``;
mirror of the reference's ``examples/interface/LPDirectDense.py``):
min cᵀx s.t. Ax = b, x ≥ 0.

    python -m elemental_tpu_torch.examples.lp_direct_dense --m 10 --n 24
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import LPCtrl, lp_direct
from ..sparse import SparseMatrix
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 10)
    args.input("n", "cols", 24)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(27)
    A = np.abs(rng.standard_normal((args["m"], args["n"]))) + 0.1
    x0 = np.abs(rng.standard_normal(args["n"])) + 0.2
    b = A @ x0
    c = np.abs(rng.standard_normal(args["n"])) + 0.5
    res = lp_direct(SparseMatrix.from_dense(A), b, c,
                    LPCtrl(tol=1e-8, max_iters=60), device=device,
                    dtype=dtype)
    check(res.converged, "not converged")
    check(res.objective <= c @ x0 + 1e-4 * (1 + abs(c @ x0)),
          f"objective {res.objective} above the feasible point's")
    output(f"dense LPDirect: obj {res.objective:.6g} "
           f"(feasible point {c @ x0:.6g}), its={res.iterations}")
    return res


if __name__ == "__main__":
    main()
