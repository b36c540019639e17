"""LLL lattice reduction (counterpart of ``examples/lll_reduction.py``;
mirror of the reference's ``examples/interface/{LLL,ZDependenceSearch,
AlgebraicRelationSearch}.py``): a 50×50 integer basis reduced by each
variant, a hidden integer relation, the minimal polynomial of √2.  The
lattice tier runs on the host; the basis is handed over as a tensor on
``--device``.

    python -m elemental_tpu_torch.examples.lll_reduction
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack import algebraic_relation_search, lll, z_dependence_search
from . import check, device_and_dtype


def main():
    args = Args()
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(0)
    B = np.round(rng.uniform(0.0, 10.0, (50, 50)))
    Bt = torch.from_numpy(B).to(device, dtype)
    # one presort setting and one delta keep the demo quick, as in the JAX
    # driver; the inner loop mirrors the reference driver
    for variant in ("weak", "normal", "deep"):
        Br, U, R, info = lll(Bt, 0.5, variant=variant, presort=True,
                             smallest_first=False)
        check(np.abs(Br - B @ U).max() < 1e-6, f"{variant}: B·U ≠ B_red")
        output(f"variant={variant:6s} presort=True smallest1st=False "
               f"delta=0.5: achieved delta={info.delta:.3f} "
               f"eta={info.eta:.3f} nullity={info.nullity} "
               f"swaps={info.num_swaps} |b1|={np.linalg.norm(Br[:, 0]):.2f}")
    # a hidden integer relation (ZDependenceSearch.py)
    n = 20
    z = rng.uniform(10.0, 15.0, n)
    a_hidden = np.round(rng.uniform(-5.0, 5.0, n - 1))
    z[-1] = a_hidden @ z[:-1]
    a, res, _ = z_dependence_search(torch.from_numpy(z).to(device, dtype),
                                    n_sqrt=1e8)
    output(f"integer relation residual: {res}")
    # the minimal polynomial of sqrt(2) (AlgebraicRelationSearch.py)
    c, res2, _ = algebraic_relation_search(np.sqrt(2.0), 2, n_sqrt=1e8)
    output(f"minpoly of sqrt(2): {c} residual {res2}")
    check(res2 < 1e-6, f"sqrt(2) relation residual {res2}")
    return res


if __name__ == "__main__":
    main()
