"""Direct-form QP (counterpart of ``examples/qp_direct_ex.py``; mirror of
the reference's ``examples/interface/QPDirect.py``).

    python -m elemental_tpu_torch.examples.qp_direct_ex --m 5 --n 15
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import LPCtrl, qp_direct
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 5)
    args.input("n", "vars", 15)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(10)
    m, n = args["m"], args["n"]
    Q0 = rng.standard_normal((n, n))
    Q = Q0 @ Q0.T + np.eye(n)
    A = rng.standard_normal((m, n))
    b = A @ np.abs(rng.standard_normal(n))
    c = rng.standard_normal(n)
    res = qp_direct(Q, A, b, c, LPCtrl(tol=1e-9), device=device, dtype=dtype)
    r = np.linalg.norm(A @ res.x - b)
    output(f"QPDirect: obj {res.objective:.8g}, ||Ax-b|| {r:.2e}")
    check(res.converged and r < 1e-6 * (1 + np.linalg.norm(b)),
          f"converged={res.converged}, ||Ax-b|| {r:.3e}")
    check(res.x.min() > -1e-8, f"min(x) = {res.x.min()}")
    return res


if __name__ == "__main__":
    main()
