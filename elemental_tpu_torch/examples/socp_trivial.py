"""A trivial SOCP (counterpart of ``examples/socp_trivial.py``): min t s.t.
(t, x − x0) in the second-order cone, so t* = 0 and x = x0.

    python -m elemental_tpu_torch.examples.socp_trivial
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import Cones, LPCtrl, socp_affine
from . import check, device_and_dtype


def main():
    args = Args()
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(11)
    n = 5
    x0 = rng.standard_normal(n)
    nv = n + 1
    G = np.zeros((n + 1, nv))
    h = np.zeros(n + 1)
    G[0, n] = -1.0
    G[1:, :n] = -np.eye(n)
    h[1:] = -x0
    c = np.zeros(nv)
    c[n] = 1.0
    res = socp_affine(np.zeros((0, nv)), np.zeros(0), G, h, c,
                      Cones([n + 1]), LPCtrl(tol=1e-9), device=device,
                      dtype=dtype)
    err = np.linalg.norm(res.x[:n] - x0)
    output(f"SOCP_trivial: t* = {res.objective:.2e}, ||x - x0|| = {err:.2e}")
    check(abs(res.objective) < 1e-6 and err < 1e-5,
          f"t* = {res.objective}, ||x - x0|| = {err}")
    return res


if __name__ == "__main__":
    main()
