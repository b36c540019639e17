"""Hermitian eigensolver driver (counterpart of ``examples/eig.py``; mirror
of the reference's ``examples/interface/Eig.py``).

    python -m elemental_tpu_torch.examples.eig --n 120
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack.spectral import hermitian_eig
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("n", "matrix size", 120)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    rng = np.random.default_rng(15)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    w, v = hermitian_eig("L", torch.from_numpy(a).to(device, dtype))
    w, v = w.double().cpu().numpy(), v.double().cpu().numpy()
    err = np.abs(a @ v - v * w[None, :]).max()
    ref = np.linalg.eigvalsh(a)
    output(f"eig: residual {err:.2e}, lambda range [{w.min():.4g}, "
           f"{w.max():.4g}] ({dtype} on {device})")
    werr = np.abs(np.sort(w) - ref).max()
    check(err < tolerance(dtype, 1e-10, 1e-5) * n
          and werr < tolerance(dtype, 1e-9, 1e-5) * n,
          f"eigenpairs off: residual {err:.2e}, eigenvalues {werr:.2e}")
    return w


if __name__ == "__main__":
    main()
