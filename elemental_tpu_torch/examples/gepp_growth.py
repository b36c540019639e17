"""GEPP growth driver (counterpart of ``examples/gepp_growth.py``; mirror of
the reference's ``examples/interface/GEPPGrowth.py``): Wilkinson's matrix
attains 2^{n-1} growth under partial pivoting when every tie takes the
first row, as LAPACK's ``getrf`` does.  On the card it also names the
library ``lu`` ran (``torch.backends.cuda.preferred_linalg_library()``).

    python -m elemental_tpu_torch.examples.gepp_growth --n 16
"""

import torch

from ..core.environment import Args, output
from ..lapack import lu
from ..matrices import gepp_growth
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "size", 16)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n = args["n"]
    A = gepp_growth(n, dtype, device=device)
    fact = lu(A)
    growth = float(torch.triu(fact.lu).abs().max() / A.abs().max())
    lib = (f", linalg library {torch.backends.cuda.preferred_linalg_library()}"
           if device.type == "cuda" else "")
    output(f"GEPP growth on Wilkinson({n}): {growth:.1f} (theory 2^{n - 1} "
           f"= {2 ** (n - 1)}; {dtype} on {device}{lib})")
    check(abs(growth - 2 ** (n - 1)) / 2 ** (n - 1) < 1e-10,
          f"growth {growth} is not 2^{n - 1}: a tie took another row")
    return growth


if __name__ == "__main__":
    main()
