"""Dense support vector machine (counterpart of ``examples/svm_dense.py``;
mirror of the reference's ``examples/interface/SVMDense.py``).

    python -m elemental_tpu_torch.examples.svm_dense --m 30 --n 4
"""

import numpy as np

from ..core.environment import Args, output
from ..optimization import svm
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("m", "samples", 30)
    args.input("n", "features", 4)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    rng = np.random.default_rng(32)
    m, n = args["m"], args["n"]
    w_true = rng.standard_normal(n)
    X = rng.standard_normal((m, n))
    labels = np.sign(X @ w_true + 0.1 * rng.standard_normal(m))
    wb = svm(X, labels, lam=0.1, device=device, dtype=dtype)
    w, beta = wb[:n], wb[n]
    acc = (np.sign(X @ w + beta) == labels).mean()
    check(acc >= 0.8, f"training accuracy {acc}")
    output(f"dense SVM: training accuracy {acc:.3f}")
    return wb


if __name__ == "__main__":
    main()
