"""Fox–Li pseudospectral portrait (counterpart of ``examples/fox_li.py``;
mirror of the reference's ``examples/interface/FoxLi.py``): σ_min(A − σI)
of the Fox–Li operator over a 6×6 grid of shifts.

    python -m elemental_tpu_torch.examples.fox_li --n 64 --omega 16
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..core.types import complex_type
from ..lapack.spectral import pseudospectra
from ..matrices import fox_li
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "discretization size", 64)
    args.input("omega", "Fresnel number", 16.0)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    dtype = complex_type(dtype)          # the complex of that precision
    A = fox_li(args["n"], args["omega"], dtype, device=device)
    re = np.linspace(-1.1, 1.1, 6)
    im = np.linspace(-1.1, 1.1, 6)
    shifts = (re[:, None] + 1j * im[None, :]).reshape(-1)
    sigma_min = pseudospectra(A, torch.from_numpy(shifts),
                              iters=24).cpu().numpy().reshape(6, 6)
    output(f"fox_li portrait: min sigma_min {sigma_min.min():.3e}, "
           f"max {sigma_min.max():.3e} ({dtype} on {device})")
    check(np.isfinite(sigma_min).all() and sigma_min.min() >= 0,
          "portrait not finite and non-negative")
    return sigma_min


if __name__ == "__main__":
    main()
