"""Remote assembly of a distributed sparse matrix (counterpart of
``examples/remote_dist_sparse.py``; mirror of the reference's
``examples/interface/RemoteDistSparse.py``): every position queues the rows
s ≡ r (mod p) of the stacked 2-D finite-difference operator — most of them
another position's — then a distributed SpMV on a 2×2 grid of
``--device`` positions.

    python -m elemental_tpu_torch.examples.remote_dist_sparse --n0 12 --n1 12
"""

import numpy as np
import torch

from ..core import Grid
from ..core.environment import Args, output
from ..sparse import DistSparseMatrix, SparseBuilder
from . import check, device_and_dtype


def remote_stacked_fd2d(n0, n1, nranks):
    """The reference's RemoteStackedFD2D: each rank r queues the rows
    s ≡ r (mod nranks) — all remote except ~1/nranks of them."""
    height, width = 2 * n0 * n1, n0 * n1
    kb = SparseBuilder(height, width)
    for r in range(nranks):
        for s in range(r, height, nranks):
            if s < n0 * n1:
                x0, x1 = s % n0, s // n0
                kb.queue_update(s, s, 1.0)
                if x0 > 0:
                    kb.queue_update(s, s - 1, -1.0)
                if x0 + 1 < n0:
                    kb.queue_update(s, s + 1, 2.0)
                if x1 > 0:
                    kb.queue_update(s, s - n0, -3.0)
                if x1 + 1 < n1:
                    kb.queue_update(s, s + n0, 4.0)
            else:
                sr = s - n0 * n1
                x0, x1 = sr % n0, sr // n0
                kb.queue_update(s, sr, -2.0)
                if x0 > 0:
                    kb.queue_update(s, sr - 1, -1.0)
                if x0 + 1 < n0:
                    kb.queue_update(s, sr + 1, -2.0)
                if x1 > 0:
                    kb.queue_update(s, sr - n0, -3.0)
                if x1 + 1 < n1:
                    kb.queue_update(s, sr + n0, 3.0)
    return kb.process_queues()


def main():
    args = Args()
    args.input("n0", "x grid", 12)
    args.input("n1", "y grid", 12)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n0, n1 = args["n0"], args["n1"]
    g = Grid(devices=[device] * 4, height=2)
    A = remote_stacked_fd2d(n0, n1, g.size)
    dA = DistSparseMatrix.from_sparse(A, g, dtype=dtype)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(A.shape[1])
    y = dA.matvec(torch.from_numpy(x).to(device, dtype)).double().cpu() \
        .numpy()
    expect = A.to_scipy() @ x
    err = np.abs(y - expect).max() / np.abs(expect).max()
    check(err < 1e-5, f"SpMV error {err}")
    output(f"remote dist-sparse assembly: {A.nnz} entries queued across "
           f"{g.size} owners, SpMV err {err:.2e} ({dtype} on {device})")
    return err


if __name__ == "__main__":
    main()
