"""Symmetric and complex-symmetric indefinite solve (counterpart of
``examples/symmetric_solve_ex.py``; mirror of the reference's
``examples/interface/SymmetricSolve.py``): the LDLᵀ solve on an indefinite
matrix, real and complex.

    python -m elemental_tpu_torch.examples.symmetric_solve_ex --n 40 --k 3
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..core.types import complex_type
from ..lapack import symmetric_solve
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("n", "size", 40)
    args.input("k", "rhs", 3)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n, k = args["n"], args["k"]
    tol = tolerance(dtype, 1e-8, 1e-3)
    rng = np.random.default_rng(12)
    for cplx in (False, True):
        A = rng.standard_normal((n, n))
        if cplx:
            A = A + 1j * rng.standard_normal((n, n))
        A = (A + A.T) / 2          # complex-SYMMETRIC (not Hermitian)
        B = rng.standard_normal((n, k)).astype(A.dtype)
        dt = complex_type(dtype) if cplx else dtype
        X = symmetric_solve(torch.from_numpy(A).to(device, dt),
                            torch.from_numpy(B).to(device, dt))
        X = X.cpu().resolve_conj().numpy().astype(A.dtype)
        r = np.linalg.norm(A @ X - B) / np.linalg.norm(B)
        check(r < tol, f"complex={cplx}: relative residual {r:.2e}")
    output(f"symmetric_solve: real + complex-symmetric residuals < {tol:g} "
           f"({dtype} on {device})")


if __name__ == "__main__":
    main()
