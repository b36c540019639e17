"""Elastic net (counterpart of ``examples/en.py``; mirror of the
reference's ``examples/interface/EN.py``): min ½‖Ax − b‖² + λ₁‖x‖₁ +
½λ₂‖x‖².

    python -m elemental_tpu_torch.examples.en --m 30 --n 50
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import elastic_net
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "rows", 30)
    args.input("n", "cols", 50)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(5)
    A = rng.standard_normal((args["m"], args["n"]))
    b = rng.standard_normal(args["m"])
    x = elastic_net(A, b, 0.3, 0.1, device=device, dtype=dtype)
    obj = (0.5 * np.sum((A @ x - b) ** 2) + 0.3 * np.abs(x).sum()
           + 0.05 * np.sum(x ** 2))
    output(f"EN: objective = {obj:.6g}")
    check(np.isfinite(obj), "EN objective not finite")
    return x


if __name__ == "__main__":
    main()
