"""HPD inversion (counterpart of ``examples/inv_pos.py``; mirror of the
reference's ``examples/interface/InvPos.py``): the inverse of a complex
Hermitian positive-definite matrix via Cholesky.

    python -m elemental_tpu_torch.examples.inv_pos --n 40
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..core.types import complex_type
from ..lapack import hpd_inverse
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("n", "size", 40)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    dtype = complex_type(dtype)          # the complex of that precision
    n = args["n"]
    rng = np.random.default_rng(13)
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = B @ B.conj().T + n * np.eye(n)
    Ainv = hpd_inverse("L", torch.from_numpy(A).to(device, dtype))
    r = np.abs(A @ Ainv.cpu().numpy().astype(np.complex128)
               - np.eye(n)).max()
    output(f"hpd_inverse: ||A·A⁻¹ − I||_max = {r:.2e} ({dtype} on {device})")
    check(r < tolerance(dtype, 1e-8, 1e-4), f"||A·A⁻¹ − I|| = {r:.2e}")
    return r


if __name__ == "__main__":
    main()
