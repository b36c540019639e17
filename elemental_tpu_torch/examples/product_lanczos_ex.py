"""Product Lanczos driver (counterpart of ``examples/
product_lanczos_ex.py``; mirror of the reference's ``examples/interface/
ProductLanczos.py``): the two-norm estimate from Lanczos on AᴴA.

    python -m elemental_tpu_torch.examples.product_lanczos_ex --m 80 --n 50
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack import product_lanczos
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("m", "rows", 80)
    args.input("n", "cols", 50)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(16)
    A = rng.standard_normal((args["m"], args["n"]))
    T = product_lanczos(torch.from_numpy(A).to(device, dtype), basis_size=30,
                        dtype=dtype)
    ritz = np.linalg.eigvalsh(T.double().cpu().numpy())
    s1 = np.linalg.svd(A, compute_uv=False)[0]
    est = np.sqrt(ritz.max())
    output(f"product-Lanczos two-norm estimate {est:.6g} vs SVD {s1:.6g} "
           f"({dtype} on {device})")
    check(abs(est - s1) / s1 < tolerance(dtype, 1e-6, 1e-4),
          f"estimate {est} against {s1}")
    return est


if __name__ == "__main__":
    main()
