"""Classic matrix drivers (counterpart of ``examples/matrix_zoo.py``;
mirrors of the reference's ``examples/interface/Fourier.py``,
``JordanCholesky.py`` and ``DruinskyToledo.py``): construct, factor and
verify the defining identities, on ``--device``.

    python -m elemental_tpu_torch.examples.matrix_zoo --n 24
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack import cholesky
from ..lapack.ldl import ldl_pivoted, solve_after_pivoted
from ..matrices import druinsky_toledo, fourier, jordan_cholesky
from . import check, device_and_dtype, tolerance


def main():
    args = Args()
    args.input("n", "size", 24)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    tol = tolerance(dtype, 1e-10, 1e-5)
    # Fourier: the unitary DFT matrix
    F = fourier(n, device=device)
    eye = torch.eye(n, dtype=F.dtype, device=device)
    uerr = float((F.mH @ F - eye).abs().max())
    check(uerr < tol, f"Fourier matrix not unitary: {uerr:.2e}")
    # JordanCholesky: the Cholesky factor is the scaled Jordan block
    L = torch.tril(cholesky("L", jordan_cholesky(n, dtype, device=device)))
    J = torch.eye(n, dtype=dtype, device=device) \
        + 2.0 * torch.diag(torch.ones(n - 1, dtype=dtype, device=device), -1)
    jerr = float((L - J).abs().max())
    check(jerr < tol, f"Jordan-Cholesky factor differs: {jerr:.2e}")
    # DruinskyToledo: the Bunch-Kaufman growth counterexample still solves
    G = druinsky_toledo(n // 2, dtype, device=device)
    b = np.random.default_rng(0).standard_normal(G.shape[0])
    x = solve_after_pivoted(ldl_pivoted(G), torch.from_numpy(b).to(
        device, dtype))
    g = G.double().cpu().numpy()
    rerr = (np.linalg.norm(g @ x.double().cpu().numpy() - b)
            / np.linalg.norm(b))
    check(rerr < max(1e-6, 100 * tol), f"Druinsky-Toledo BK solve residual "
          f"{rerr:.2e}")
    output(f"fourier unitary {uerr:.1e}; Jordan-Cholesky match {jerr:.1e}; "
           f"Druinsky-Toledo BK solve residual {rerr:.1e} ({dtype} on "
           f"{device})")


if __name__ == "__main__":
    main()
