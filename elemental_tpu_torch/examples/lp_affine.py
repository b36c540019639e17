"""Affine-form LP (counterpart of ``examples/lp_affine.py``; mirror of the
reference's ``examples/interface/LPAffine.py``): min cᵀx s.t. Ax = b,
Gx ≤ h, x free, held against HiGHS.

    python -m elemental_tpu_torch.examples.lp_affine --m 6 --n 20 --k 30
"""

import numpy as np
import scipy.optimize as so

from ..core.environment import Args, output
from ..optimization import LPCtrl, lp_affine
from ..sparse import SparseMatrix
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "equality rows", 6)
    args.input("n", "variables", 20)
    args.input("k", "inequality rows", 30)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(9)
    m, n, k = args["m"], args["n"], args["k"]
    A = rng.standard_normal((m, n))
    G = rng.standard_normal((k, n))
    xf = rng.standard_normal(n)
    b = A @ xf
    h = G @ xf + np.abs(rng.standard_normal(k)) + 0.5
    c = rng.standard_normal(n)
    res = lp_affine(SparseMatrix.from_dense(A), b,
                    SparseMatrix.from_dense(G), h, c, LPCtrl(tol=1e-9),
                    device=device, dtype=dtype)
    ref = so.linprog(c, A_ub=G, b_ub=h, A_eq=A, b_eq=b,
                     bounds=(None, None), method="highs")
    output(f"LPAffine: obj {res.objective:.8g} vs HiGHS {ref.fun:.8g}")
    check(abs(res.objective - ref.fun) < 1e-5 * (1 + abs(ref.fun)),
          f"objective {res.objective} vs HiGHS {ref.fun}")
    return res


if __name__ == "__main__":
    main()
