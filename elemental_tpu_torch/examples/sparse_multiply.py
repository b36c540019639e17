"""Sparse multiply cross-checks (counterpart of
``examples/sparse_multiply.py``): the 12² Laplacian against its dense
form, its pattern as a matrix of ones, and the distributed product on a
2×4 grid of ``--device`` positions.

    python -m elemental_tpu_torch.examples.sparse_multiply
"""

import numpy as np
import torch

from ..core import Grid
from ..core.environment import Args, output
from ..matrices import sparse_laplacian_2d
from ..sparse import DistSparseMatrix, multiply
from . import check, device_and_dtype


def main():
    args = Args()
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    A = sparse_laplacian_2d(12, 12)
    rng = np.random.default_rng(17)
    x = rng.standard_normal(A.width)
    xt = torch.from_numpy(x).to(device, dtype)
    dense = A.to_dense()
    y1 = multiply("N", 1.0, A, xt).double().cpu().numpy()
    y2 = multiply("N", 1.0, A.graph().to_sparse(), xt).double().cpu().numpy()
    sx = dense @ x
    pattern = (dense != 0) @ x
    # the JAX driver's float64 thresholds, scaled by eps for another dtype
    scale = float(torch.finfo(dtype).eps) / float(np.finfo(np.float64).eps)
    check(np.abs(y1 - sx).max() < 1e-12 * scale,
          "SpMV against the dense product")
    check(np.abs(y2 - pattern).max() < 1e-12 * scale, "pattern SpMV")
    grid = Grid(devices=[device] * 8, height=2)
    dA = DistSparseMatrix.from_sparse(A, grid, dtype=dtype)
    y3 = multiply("N", 1.0, dA, xt).double().cpu().numpy()
    check(np.abs(y3 - sx).max() < 1e-10 * scale, "distributed SpMV")
    output(f"sparse multiply cross-checks OK ({dtype} on {device}, "
           f"{grid.height}×{grid.width} grid)")
    return y1, y2, y3


if __name__ == "__main__":
    main()
