"""Dense direct-form QP (counterpart of ``examples/qp_direct_dense.py``;
mirror of the reference's ``examples/interface/QPDirectDense.py``):
min ½xᵀQx + cᵀx s.t. Ax = b, x ≥ 0.

    python -m elemental_tpu_torch.examples.qp_direct_dense --m 5 --n 12
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import LPCtrl, qp_direct
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 5)
    args.input("n", "cols", 12)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    m, n = args["m"], args["n"]
    rng = np.random.default_rng(30)
    M = rng.standard_normal((n, n))
    Q = M @ M.T + n * np.eye(n)
    A = np.abs(rng.standard_normal((m, n))) + 0.1
    x0 = np.abs(rng.standard_normal(n)) + 0.2
    b = A @ x0
    c = rng.standard_normal(n)
    res = qp_direct(Q, A, b, c, LPCtrl(tol=1e-8), device=device, dtype=dtype)
    x = res.x
    check(np.linalg.norm(A @ x - b) < 1e-3 * (1 + np.linalg.norm(b)),
          "equality violated")
    check(x.min() > -1e-5, f"min(x) = {x.min()}")
    obj0 = 0.5 * x0 @ Q @ x0 + c @ x0
    check(res.objective <= obj0 + 1e-4 * (1 + abs(obj0)),
          f"objective {res.objective} above the feasible point's")
    output(f"dense QPDirect: obj {res.objective:.6g} "
           f"(feasible point {obj0:.6g})")
    return res


if __name__ == "__main__":
    main()
