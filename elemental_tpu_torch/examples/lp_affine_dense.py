"""Dense affine-form LP (counterpart of ``examples/lp_affine_dense.py``;
mirror of the reference's ``examples/interface/LPAffineDense.py``):
min cᵀx s.t. |x| ≤ 1 elementwise and one equality.

    python -m elemental_tpu_torch.examples.lp_affine_dense --n 10
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import LPCtrl, lp_affine
from ..sparse import SparseMatrix
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "cols", 10)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    rng = np.random.default_rng(28)
    A = rng.standard_normal((1, n))
    x_f = rng.uniform(-0.3, 0.3, n)
    b = A @ x_f
    G = np.concatenate([np.eye(n), -np.eye(n)])
    h = np.ones(2 * n)
    c = rng.standard_normal(n)
    res = lp_affine(SparseMatrix.from_dense(A), b,
                    SparseMatrix.from_dense(G), h, c, LPCtrl(tol=1e-8),
                    device=device, dtype=dtype)
    x = res.x
    check(np.abs(A @ x - b).max() < 1e-4, "equality violated")
    check(np.abs(x).max() <= 1 + 1e-4, "box violated")
    output(f"dense LPAffine: obj {c @ x:.6g}, its={res.iterations}")
    return res


if __name__ == "__main__":
    main()
