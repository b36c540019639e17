"""Dynamic regularization count (counterpart of
``examples/dynamic_reg_counter.py``; mirror of the reference's
``examples/lapack_like/DynamicRegCounter.cpp``): factor a nearly singular
quasi-definite KKT with signed pivot floors and count the pivots the
floors moved.

    python -m elemental_tpu_torch.examples.dynamic_reg_counter --n 60 --m 40
"""

import numpy as np
import scipy.sparse as sp
import torch

from ..core.environment import Args, output
from ..sparse import SparseMatrix
from ..sparse_direct import analyze, build_ea_plan, factor, nested_dissection
from . import check, device_and_dtype


def main():
    args = Args()
    args.input("n", "primal size", 60)
    args.input("m", "dual size", 40)
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    n, m = args["n"], args["m"]
    rng = np.random.default_rng(17)
    Ad = sp.random(m, n, density=0.2, format="csr", random_state=2)
    Ad.data += 0.5
    g = 1e-8
    K = sp.bmat([[g * sp.eye(n), Ad.T], [Ad, -g * sp.eye(m)]],
                format="csr")
    A = SparseMatrix.from_scipy(K)
    host = analyze(A, perm=nested_dissection(A, cutoff=16))
    symb = host.to(device)
    floor = 1e-6
    pf = torch.cat([torch.full((n,), floor, dtype=dtype, device=device),
                    torch.full((m,), -floor, dtype=dtype, device=device)])
    num = factor(symb, A.vals, ea_plan=build_ea_plan(host).to(device),
                 dtype=dtype, pivot_floor=pf)
    d = num.d.cpu().numpy()
    clamped = int((np.abs(np.abs(d) - floor) < 1e-12).sum())
    output(f"dynamic regularization touched {clamped}/{n + m} pivots "
           f"(floor {floor:g})")
    # the nearly singular system (static reg 1e-8) would blow the
    # unregularized solve up; with floors the solve stays finite and
    # bounded — the count is the reference driver's observable
    b = rng.standard_normal(n + m)
    x = num.solve(torch.from_numpy(b).to(device, dtype)).cpu().numpy()
    check(np.isfinite(x).all(), "regularized solve not finite")
    check(clamped >= 1, "no pivot was floored")  # the -g block forces one
    output(f"regularized solve finite, ||x|| = {np.linalg.norm(x):.3g}")
    return clamped


if __name__ == "__main__":
    main()
