"""Matrix norms (counterpart of ``examples/pnorm.py``; mirror of the
reference's ``examples/interface/PNorm.py``): one, infinity, Frobenius,
max and the two-norm estimate of a random matrix against NumPy.

The estimate is a power iteration on AᴴA from ``two_norm_estimate``'s
fixed start, which in the port is torch's seed-0 draw, not JAX's
``PRNGKey(0)``: on this matrix (σ₂/σ₁ = 0.96) that start lies near σ₁'s
orthogonal complement and 20 steps reach 4.7 % (JAX's 0.03 %), so the
driver takes 100 steps, as ``test_spectral_solve.py``'s estimate does,
and keeps the 1 % check.

    python -m elemental_tpu_torch.examples.pnorm --m 60 --n 45
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack import (frobenius_norm, infinity_norm, max_norm, one_norm,
                      two_norm_estimate)
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 60)
    args.input("n", "cols", 45)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(11)
    A = rng.standard_normal((args["m"], args["n"]))
    At = torch.from_numpy(A).to(device, dtype)
    rtol = 1e-5 if dtype == torch.float64 else 1e-4
    for name, got, want in (
            ("one", one_norm(At), np.abs(A).sum(0).max()),
            ("infinity", infinity_norm(At), np.abs(A).sum(1).max()),
            ("Frobenius", frobenius_norm(At), np.linalg.norm(A)),
            ("max", max_norm(At), np.abs(A).max())):
        check(np.isclose(float(got), want, rtol=rtol),
              f"{name} norm {float(got)} against NumPy's {want}")
    t2 = float(two_norm_estimate(At, iters=100))
    s1 = np.linalg.svd(A, compute_uv=False)[0]
    check(abs(t2 - s1) / s1 < 1e-2, f"two-norm estimate {t2} against {s1}")
    output(f"norms: one/inf/fro/max exact, two-estimate within 1% "
           f"({t2:.6g} vs {s1:.6g}; {dtype} on {device})")
    return t2


if __name__ == "__main__":
    main()
