"""Triangular eigenvector solve (counterpart of ``examples/
triang_eig_ex.py``; mirror of the reference's ``examples/interface/
TriangEig.py``): the eigenvectors of a complex Schur factor.

    python -m elemental_tpu_torch.examples.triang_eig_ex --n 40
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..core.types import complex_type
from ..lapack import triang_eig
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("n", "size", 40)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    dtype = complex_type(dtype)          # the complex of that precision
    n = args["n"]
    rng = np.random.default_rng(10)
    T = np.triu(rng.standard_normal((n, n))
                + 1j * rng.standard_normal((n, n)))
    T += np.diag(np.arange(n))           # well-separated eigenvalues
    X = triang_eig(torch.from_numpy(T).to(device, dtype))
    X = X.cpu().numpy().astype(np.complex128)
    R = T @ X - X @ np.diag(np.diagonal(T))
    rel = np.abs(R).max() / np.abs(T).max()
    output(f"triang_eig: max residual {rel:.2e} ({dtype} on {device})")
    check(rel < tolerance(dtype, 1e-10, 1e-4), f"residual {rel:.2e}")
    return rel


if __name__ == "__main__":
    main()
