"""Long-only portfolio (counterpart of ``examples/long_only_portfolio.py``;
mirror of the reference's ``examples/interface/LongOnlyPortfolio.py``):
min γ·xᵀΣx − μᵀx s.t. Σx = 1, x ≥ 0.

    python -m elemental_tpu_torch.examples.long_only_portfolio --n 12
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import portfolio
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "assets", 12)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(12)
    F = rng.standard_normal((args["n"], 4))
    Sigma = F @ F.T + 0.1 * np.eye(args["n"])
    mu = rng.standard_normal(args["n"]) * 0.1
    x = portfolio(Sigma, mu, gamma=1.0, device=device, dtype=dtype)
    output(f"portfolio: sum(x) = {x.sum():.6f}, min(x) = {x.min():.2e}, "
           f"risk = {x @ Sigma @ x:.4g}")
    check(abs(x.sum() - 1) < 1e-6 and x.min() > -1e-7,
          f"sum {x.sum()}, min {x.min()}")
    return x


if __name__ == "__main__":
    main()
