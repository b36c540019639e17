"""Lattice toolbox (counterpart of ``examples/lattice_tools.py``; mirror of
the reference's ``examples/interface/LatticeImageAndKernel.py``,
``ZDependenceSearch.py`` and ``AlgebraicRelationSearch.py``): LLL-based
image and kernel, integer relations, algebraic relation search.  The
lattice tier runs on the host; the basis is handed over as a tensor on
``--device``.

    python -m elemental_tpu_torch.examples.lattice_tools
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..lapack import (algebraic_relation_search, lattice_image_and_kernel,
                      z_dependence_search)
from . import check, device_and_dtype


def main():
    args = Args()
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    # image and kernel of an integer matrix with a known rank deficiency
    B = np.array([[2, 4, 6, 1], [1, 2, 3, 0], [0, 0, 0, 5]], float).T
    M, K, _ = lattice_image_and_kernel(torch.from_numpy(B).to(device, dtype))
    check(np.allclose(B @ K, 0, atol=1e-8), "kernel vectors not in the kernel")
    check(np.linalg.matrix_rank(M) == np.linalg.matrix_rank(B),
          "the image lost rank")
    # integer relation: z = (1, φ, φ²) satisfies z·(−1, −1, 1) = 0
    phi = (1 + np.sqrt(5)) / 2
    z = np.array([1.0, phi, phi * phi])
    a, _, _ = z_dependence_search(torch.from_numpy(z).to(device, dtype))
    a = np.rint(a).astype(int)
    rel = abs(a @ z)
    check(rel < 1e-4 and np.abs(a).max() > 0, f"relation {a}: {rel:.2e}")
    # algebraic relation: √2 is a root of x² − 2
    p, _, _ = algebraic_relation_search(np.sqrt(2.0), 2)
    p = np.rint(p)
    val = sum(c * np.sqrt(2.0) ** k for k, c in enumerate(p))
    check(abs(val) < 1e-6 and np.abs(p).max() > 0, f"polynomial {p}")
    output(f"lattice: kernel dim {K.shape[1]}, phi relation {a.tolist()}, "
           f"sqrt2 poly {p.astype(int).tolist()} (basis from {device})")
    return K


if __name__ == "__main__":
    main()
