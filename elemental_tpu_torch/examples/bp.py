"""Basis pursuit on the reference's ConcatFD2D sparse operator (counterpart
of ``examples/bp.py``; mirror of the reference's
``examples/interface/BP.py``): min ‖x‖₁ s.t. Ax = b with A two 2-D
finite-difference blocks side by side.

    python -m elemental_tpu_torch.examples.bp --n0 8 --n1 8
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import LPCtrl, basis_pursuit
from ..sparse import SparseBuilder
from . import check, device_and_dtype


def concat_fd_2d(n0, n1):
    """The reference's ``ConcatFD2D``, queued entry by entry."""
    b = SparseBuilder(n0 * n1, 2 * n0 * n1)
    for s in range(n0 * n1):
        x0, x1 = s % n0, s // n0
        srel = s + n0 * n1
        b.queue_update(s, s, 11.0)
        b.queue_update(s, srel, -20.0)
        if x0 > 0:
            b.queue_update(s, s - 1, -1.0)
            b.queue_update(s, srel - 1, -17.0)
        if x0 + 1 < n0:
            b.queue_update(s, s + 1, 2.0)
            b.queue_update(s, srel + 1, -20.0)
        if x1 > 0:
            b.queue_update(s, s - n0, -30.0)
            b.queue_update(s, srel - n0, -3.0)
        if x1 + 1 < n1:
            b.queue_update(s, s + n0, 4.0)
            b.queue_update(s, srel + n0, 3.0)
    return b.process_queues()


def main():
    args = Args()
    args.input("n0", "first grid dimension", 8)
    args.input("n1", "second grid dimension", 8)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    A = concat_fd_2d(args["n0"], args["n1"])
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.height)
    x = basis_pursuit(A, b, LPCtrl(tol=1e-8), device=device, dtype=dtype)
    r = np.linalg.norm(A.to_dense() @ x - b)
    output(f"BP: ||x||_1 = {np.abs(x).sum():.6g}, ||Ax-b|| = {r:.2e}")
    check(r < 1e-5 * (1 + np.linalg.norm(b)), f"BP residual {r:.3e}")
    return x


if __name__ == "__main__":
    main()
