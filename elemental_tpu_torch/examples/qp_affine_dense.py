"""Dense affine-form QP (counterpart of ``examples/qp_affine_dense.py``;
mirror of the reference's ``examples/interface/QPAffineDense.py``):
min ½xᵀQx + cᵀx s.t. Ax = b, |x| ≤ 1.

    python -m elemental_tpu_torch.examples.qp_affine_dense --n 8
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import LPCtrl, qp_affine
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "cols", 8)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    rng = np.random.default_rng(31)
    M = rng.standard_normal((n, n))
    Q = M @ M.T + n * np.eye(n)
    c = rng.standard_normal(n)
    A = rng.standard_normal((2, n))
    b = A @ rng.uniform(-0.3, 0.3, n)
    G = np.concatenate([np.eye(n), -np.eye(n)])
    h = np.ones(2 * n)
    res = qp_affine(Q, A, b, G, h, c, LPCtrl(tol=1e-8), device=device,
                    dtype=dtype)
    x = res.x
    check(np.linalg.norm(A @ x - b) < 1e-3 * (1 + np.linalg.norm(b)),
          "equality violated")
    check(np.abs(x).max() <= 1 + 1e-4, "box violated")
    output(f"dense QPAffine: obj {res.objective:.6g}, "
           f"its={res.iterations}")
    return res


if __name__ == "__main__":
    main()
