"""Affine-form QP (counterpart of ``examples/qp_affine_ex.py``; mirror of
the reference's ``examples/interface/QPAffine.py``): a box-constrained QP
with equalities, whose answer must beat random feasible points.

    python -m elemental_tpu_torch.examples.qp_affine_ex --n 12 --m 3
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import LPCtrl, qp_affine
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "variables", 12)
    args.input("m", "equalities", 3)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n, m = args["n"], args["m"]
    rng = np.random.default_rng(5)
    M = rng.standard_normal((n, n))
    Q = M @ M.T + n * np.eye(n)
    c = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    x_feas = rng.uniform(-0.4, 0.4, n)
    b = A @ x_feas
    # box |x| ≤ 1 as Gx + s = h, s ≥ 0
    G = np.concatenate([np.eye(n), -np.eye(n)])
    h = np.ones(2 * n)

    res = qp_affine(Q, A, b, G, h, c, LPCtrl(tol=1e-8), device=device,
                    dtype=dtype)
    x = res.x
    check(np.linalg.norm(A @ x - b) / (1 + np.linalg.norm(b)) < 1e-3,
          "equality violated")
    check(np.abs(x).max() <= 1.0 + 1e-4, "box violated")
    obj = 0.5 * x @ Q @ x + c @ x
    # the solution must beat every random feasible point (convexity check)
    for _ in range(20):
        xr = rng.uniform(-1, 1, n)
        # project onto Ax=b affinely
        corr = np.linalg.lstsq(A, b - A @ xr, rcond=None)[0]
        xr = np.clip(xr + corr, -1, 1)
        if np.linalg.norm(A @ xr - b) > 1e-8 * (1 + np.linalg.norm(b)):
            continue
        objr = 0.5 * xr @ Q @ xr + c @ xr
        check(obj <= objr + 1e-5 * (1 + abs(objr)),
              f"objective {obj} above a feasible point's {objr}")
    output(f"QP affine: objective {obj:.6g}, converged={res.converged}, "
           f"its={res.iterations}")
    return res


if __name__ == "__main__":
    main()
