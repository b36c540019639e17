"""Control-theory solvers (counterpart of ``examples/control_ex.py``;
mirror of the reference's ``src/control`` tier): Sylvester, Lyapunov and
the continuous algebraic Riccati equation through the matrix sign
function, each held to its equation's relative residual.

    python -m elemental_tpu_torch.examples.control_ex --n 24
"""

import numpy as np
import torch

from ..control import lyapunov, ricatti, sylvester
from ..core.environment import Args, output
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "size", 24)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    rng = np.random.default_rng(9)

    def dev(x):
        return torch.from_numpy(x).to(device, dtype)

    def host(x):
        return x.double().cpu().numpy()

    # Sylvester: spectra separated by the imaginary axis
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    B = rng.standard_normal((n, n)) + n * np.eye(n)
    C = rng.standard_normal((n, n))
    X = host(sylvester(dev(A), dev(B), dev(C)))
    r1 = np.linalg.norm(A @ X + X @ B - C) / np.linalg.norm(C)
    # Lyapunov
    Q = rng.standard_normal((n, n))
    Cs = -(Q @ Q.T) - np.eye(n)
    As = rng.standard_normal((n, n)) + 1.5 * n * np.eye(n)
    Xl = host(lyapunov(dev(As), dev(Cs)))
    r2 = np.linalg.norm(As @ Xl + Xl @ As.T - Cs) / np.linalg.norm(Cs)
    # the continuous algebraic Riccati equation AᵀX + XA − XKX + L = 0:
    # ricatti(uplo, A, K, L) solves AᴴX + XA + K − X·L·X = 0, so the
    # constant is L and the quadratic K
    Astab = rng.standard_normal((n, n)) - 2 * n * np.eye(n)
    Bk = rng.standard_normal((n, n // 2))
    K = Bk @ Bk.T
    Lq = rng.standard_normal((n, n))
    L = Lq @ Lq.T + np.eye(n)
    Xr = host(ricatti("L", dev(Astab), dev(L), dev(K)))
    r3 = np.linalg.norm(Astab.T @ Xr + Xr @ Astab - Xr @ K @ Xr + L) \
        / np.linalg.norm(L)
    output(f"sylvester {r1:.2e}, lyapunov {r2:.2e}, riccati {r3:.2e} "
           f"({dtype} on {device})")
    # the JAX driver's dtype-aware bounds (the sign iterations carry
    # ~1e3·eps)
    eps = float(torch.finfo(dtype).eps)
    b1 = max(1e-8, 3e3 * eps)
    b3 = max(1e-6, 3e4 * eps)
    check(r1 < b1 and r2 < b1 and r3 < b3, f"residuals {r1:.2e}, {r2:.2e}, "
          f"{r3:.2e} over {b1:.1e} / {b3:.1e}")
    return r1, r2, r3


if __name__ == "__main__":
    main()
