"""Soft-margin support vector machine (counterpart of ``examples/svm.py``;
mirror of the reference's ``examples/interface/SVM.py``).

    python -m elemental_tpu_torch.examples.svm --m 60 --n 4
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import svm
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "samples", 60)
    args.input("n", "features", 4)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(7)
    w_true = rng.standard_normal(args["n"])
    X = rng.standard_normal((args["m"], args["n"]))
    y = np.sign(X @ w_true + 0.1 * rng.standard_normal(args["m"]))
    wb = svm(X, y, lam=0.1, device=device, dtype=dtype)
    pred = np.sign(X @ wb[:-1] + wb[-1])
    acc = (pred == y).mean()
    output(f"SVM: training accuracy {acc:.3f}")
    check(acc > 0.85, f"training accuracy {acc}")
    return wb


if __name__ == "__main__":
    main()
