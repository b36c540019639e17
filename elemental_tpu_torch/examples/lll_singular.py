"""LLL on a singular basis (counterpart of ``examples/lll_singular.py``;
mirror of the reference's ``examples/interface/LLLSingular.py``): the
reference's rank-2 4×4 integer matrix reduced across variant × presort ×
δ; a correct LLL exposes the rank deficiency as zero columns while
keeping B·U = B_red with U unimodular.  The lattice tier runs on the host;
the basis is handed over as a tensor on ``--device``.

    python -m elemental_tpu_torch.examples.lll_singular
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack import lll
from . import check, device_and_dtype


def main():
    args = Args()
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    B = np.array([[-6, 9, -15, -18],
                  [4, -6, 10, 12],
                  [10, -15, 18, 35],
                  [-24, 36, -46, -82]], float)
    rank = np.linalg.matrix_rank(B)
    check(rank == 2, f"rank {rank}")
    Bt = torch.from_numpy(B).to(device, dtype)
    tried = 0
    for variant in ("weak", "normal", "deep"):
        for presort, smallest in ((True, True), (True, False),
                                  (False, False)):
            for delta in (0.5, 0.75, 0.95, 0.98):
                Br, U, R, info = lll(Bt, delta=delta, variant=variant,
                                     presort=presort,
                                     smallest_first=smallest)
                what = f"{variant}, presort {presort}, δ {delta}"
                check(np.allclose(B @ U, Br, atol=1e-8),
                      f"{what}: B·U ≠ B_red")
                check(abs(abs(np.linalg.det(U)) - 1.0) < 1e-6,
                      f"{what}: U not unimodular")
                zero_cols = int((np.abs(Br).max(axis=0) < 1e-8).sum())
                check(zero_cols >= B.shape[1] - rank,
                      f"{what}: {zero_cols} zero columns")
                tried += 1
    output(f"LLL singular: {tried} (variant, presort, δ) combinations — "
           f"rank-{rank} input always reduces with ≥{B.shape[1] - rank} "
           f"zero columns, U unimodular")
    return tried


if __name__ == "__main__":
    main()
