"""Second-order cone membership (counterpart of
``examples/soc_members.py``; mirror of the reference's
``examples/interface/SOCMembers.py``): shift members onto the cone and
check the Jordan identities.  Host NumPy atoms, as in the JAX package; the
device options are accepted for the drivers' common interface.

    python -m elemental_tpu_torch.examples.soc_members --m 10
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import (Cones, in_cone, soc_apply, soc_dets,
                            soc_identity, soc_inverse, soc_min_eig)
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "cone order", 10)
    device_and_dtype(args, "float64")
    args.process_input()
    m = args["m"]
    cones = Cones([m, m, m])
    rng = np.random.default_rng(2)
    rad = 1.0 / np.sqrt(m)
    s = rng.uniform(-rad, rad, 3 * m)
    s[[0, m, 2 * m]] = [2.0, 3.0, 4.0]          # reference's head values
    z = rng.uniform(-rad, rad, 3 * m)
    z[[0, m, 2 * m]] = [5.0, 6.0, 7.0]

    s_dets = soc_dets(s, cones)
    z_dets = soc_dets(z, cones)
    output(f"dets(s) = {s_dets}, dets(z) = {z_dets}")
    non_pos = int((s_dets <= 0).sum() + (z_dets <= 0).sum())
    output(f"non-positive members before shift: {non_pos}")

    # shift each member onto the cone: s += (margin − λmin(s))·e
    e = soc_identity(cones)
    for v in (s, z):
        lam = soc_min_eig(v, cones)
        if lam <= 0:
            v += (0.1 - lam) * e
    check(in_cone(s, cones) and in_cone(z, cones), "shift left a member out")
    check((soc_dets(s, cones) > 0).all(), "non-positive determinant")

    # Jordan identities: s ∘ s⁻¹ = e;  det(s⁻¹) = 1/det(s)
    sinv = soc_inverse(s, cones)
    check(np.allclose(soc_apply(s, sinv, cones), e, atol=1e-10), "s∘s⁻¹ ≠ e")
    check(np.allclose(soc_dets(sinv, cones), 1.0 / soc_dets(s, cones),
                      atol=1e-10), "det(s⁻¹) ≠ 1/det(s)")
    output("SOC atoms verified: shift-to-cone, s∘s⁻¹=e, det(s⁻¹)=1/det(s)")
    return s, z


if __name__ == "__main__":
    main()
