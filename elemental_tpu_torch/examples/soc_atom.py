"""Second-order cone atoms (counterpart of ``examples/soc_atom.py``; mirror
of the reference's ``examples/interface/SOCAtom.py``): identity,
membership, determinants, inverse, minimum eigenvalue and the largest step
into the cone.  The atoms are host NumPy, as in the JAX package; the
device options are accepted for the drivers' common interface.

    python -m elemental_tpu_torch.examples.soc_atom
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization.socp import (Cones, in_cone, max_step, soc_apply,
                                 soc_dets, soc_identity, soc_inverse,
                                 soc_min_eig)
from . import check, device_and_dtype


def main():
    args = Args()
    device_and_dtype(args, "float64")
    args.process_input()
    cones = Cones([3, 4, 2])
    rng = np.random.default_rng(8)
    e = soc_identity(cones)
    check(in_cone(e, cones), "identity outside the cone")
    # a strictly interior point: identity + small perturbation
    s = e * 2.0
    for o, st in zip([3, 4, 2], [0, 3, 7]):
        s[st + 1:st + o] = 0.3 * rng.standard_normal(o - 1)
    check(in_cone(s, cones), "interior point outside the cone")
    dets = soc_dets(s, cones)
    check((dets > 0).all(), "non-positive determinant")
    inv = soc_inverse(s, cones)
    prod = soc_apply(s, inv, cones)
    check(np.allclose(prod, e, atol=1e-10), "s∘s⁻¹ ≠ e")
    lam = soc_min_eig(s, cones)
    check(lam > 0, "non-positive minimum eigenvalue")
    ds = -e
    alpha = max_step(s, ds, cones)
    edge = s + 0.999 * alpha * ds
    check(in_cone(edge, cones, margin=-1e-9), "step left the cone")
    output(f"SOC atoms: dets {np.round(dets, 3)}, min-eig {lam:.4f}, "
           f"max step {alpha:.4f} — all identities hold")
    return alpha


if __name__ == "__main__":
    main()
