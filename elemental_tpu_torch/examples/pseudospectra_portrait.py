"""ε-pseudospectrum portrait (counterpart of
``examples/pseudospectra_portrait.py``; mirror of the reference's
``ChunkedPseudospectra.cpp`` / ``Pseudospectra`` drivers): σ_min(A − zI)
over a grid of shifts around the Fox–Li operator's spectrum, through the
Schur-form multishift inverse-power path (``lapack.pseudospectra``), five
grid points checked against a dense SVD.

    python -m elemental_tpu_torch.examples.pseudospectra_portrait --g 8
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..core.types import complex_type
from ..lapack import pseudospectra
from ..matrices import fox_li
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "matrix size", 48)
    args.input("g", "portrait grid side", 8)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    dtype = complex_type(dtype)          # the complex of that precision
    n, g = args["n"], args["g"]
    A = fox_li(n, -0.18, dtype, device=device)
    re = np.linspace(-1.2, 1.2, g)
    im = np.linspace(-1.2, 1.2, g)
    Z = (re[None, :] + 1j * im[:, None]).ravel()
    sig = pseudospectra(A, torch.from_numpy(Z), iters=60).cpu().numpy()
    a = A.cpu().numpy().astype(np.complex128)
    rng = np.random.default_rng(0)
    for idx in rng.choice(g * g, 5, replace=False):
        z = Z[idx]
        true = np.linalg.svd(a - z * np.eye(n), compute_uv=False)[-1]
        check(abs(sig[idx] - true) / max(true, 1e-12) < 0.05,
              f"sigma_min at {z}: {sig[idx]} against the SVD's {true}")
    sig = sig.reshape(g, g)
    output(f"pseudospectra portrait {g}x{g}: sigma_min in "
           f"[{sig.min():.3e}, {sig.max():.3e}] — 5 samples verified vs SVD "
           f"({dtype} on {device})")
    return sig


if __name__ == "__main__":
    main()
