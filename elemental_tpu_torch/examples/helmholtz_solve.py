"""Sparse Helmholtz solve (counterpart of ``examples/helmholtz_solve.py``;
mirror of the reference's ``examples/lapack_like/Helmholtz.cpp``): build a
2-D Helmholtz operator, factor with the multifrontal LDL, solve, report the
error.

    python -m elemental_tpu_torch.examples.helmholtz_solve --n1 20 --n2 20 --shift 20.0
"""

import numpy as np
import torch

from ..core.environment import Args, Timer, output
from ..matrices import sparse_helmholtz_2d
from ..sparse_direct import SparseLDLFactorization
from . import device_and_dtype


def main():
    args = Args()
    args.input("n1", "grid points in x", 20)
    args.input("n2", "grid points in y", 20)
    args.input("shift", "Helmholtz shift omega^2", 20.0)
    args.input("rhs", "number of right-hand sides", 3)
    where = device_and_dtype(args)
    args.process_input()
    args.print_report()
    device, dtype = where()

    A = sparse_helmholtz_2d(args["n1"], args["n2"], args["shift"])
    n = A.height
    output(f"A: {n}x{n}, nnz={A.nnz}")

    t = Timer("factor")
    t.start()
    f = SparseLDLFactorization(device=device, dtype=dtype).initialize(A) \
        .factor()
    output(f"symbolic+numeric factor: {t.stop():.3f}s, "
           f"factor nnz={f.factor_nnz()}, "
           f"~{f.factor_gflops():.3f} GFLOP")

    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, args["rhs"]))
    B = A.to_dense() @ X
    t.start()
    Xs = f.solve(torch.from_numpy(B).to(device, dtype)).double().cpu() \
        .numpy()
    output(f"solve: {t.stop():.3f}s")
    rel = [np.linalg.norm(Xs[:, j] - X[:, j]) / np.linalg.norm(X[:, j])
           for j in range(args["rhs"])]
    for j, r in enumerate(rel):
        output(f"  rhs {j}: relative error {r:.3e}")
    return rel


if __name__ == "__main__":
    main()
