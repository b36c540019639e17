"""Complex basis pursuit (counterpart of ``examples/bp_complex.py``; mirror
of the reference's ``examples/interface/BPComplex.py``): min ‖x‖₁ s.t.
Ax = b over ℂ, realified into an SOCP with order-3 cones.

    python -m elemental_tpu_torch.examples.bp_complex --m 12 --n 30 --k 3
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import basis_pursuit_complex
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 12)
    args.input("n", "cols", 30)
    args.input("k", "true sparsity", 3)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    m, n, k = args["m"], args["n"], args["k"]
    rng = np.random.default_rng(11)
    A = (rng.standard_normal((m, n))
         + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    x_true = np.zeros(n, complex)
    sup = rng.choice(n, k, replace=False)
    x_true[sup] = rng.standard_normal(k) + 1j * rng.standard_normal(k)
    b = A @ x_true

    x = basis_pursuit_complex(A, b, device=device, dtype=dtype)
    feas = np.linalg.norm(A @ x - b) / (1 + np.linalg.norm(b))
    check(feas < 1e-3, f"feasibility {feas:.3e}")
    # BP recovers the sparse generator for k ≪ m (ℓ1 certificate): the
    # recovered ℓ1 norm can never exceed the generator's
    l1 = np.abs(x).sum()
    l1_true = np.abs(x_true).sum()
    check(l1 <= l1_true * (1 + 1e-2), f"l1 {l1} above the generator's "
          f"{l1_true}")
    output(f"complex BP: ‖x‖₁ {l1:.6g} (generator {l1_true:.6g}), "
           f"feasibility {feas:.2e}")
    return x


if __name__ == "__main__":
    main()
