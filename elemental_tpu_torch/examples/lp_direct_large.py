"""At-scale sparse IPM (counterpart of ``examples/lp_direct_large.py``; mirror
of the reference's ``examples/interface/LPDirect.py:70-115`` on the
ConcatFD2D operator).

Solves  min cᵀx  s.t.  A·x = b, x ≥ 0  where A = [FD₁ FD₂] stacks two 2-D
finite-difference blocks (m = n1², n = 2·n1² variables); every IPM iteration
refactors the fixed-pattern KKT with the multifrontal LDL.

    python -m elemental_tpu_torch.examples.lp_direct_large --n1 224

Reports seconds per IPM iteration and the factor's GFlop estimate
(reference ``LocalFactorGFlops``, ``SparseLDL.cpp:143-169``).
"""

import time

import numpy as np
import torch

from ..core.environment import Args, output
from ..matrices import concat_fd_2d
from ..optimization import LPCtrl, lp_direct
from ..optimization.lp import _build_lp_kkt
from ..sparse import SparseMatrix
from . import device_and_dtype


def kkt_factor_gflops(A: SparseMatrix, gamma=1e-9, delta=1e-9) -> float:
    """Flop estimate of one multifrontal KKT factorization (host
    analysis only)."""
    kkt, _ = _build_lp_kkt(A, gamma, delta, None, device="cpu",
                           dtype=torch.float64)
    total = 0.0
    for sn in kkt.symb.supernodes:
        ns = sn.cols[1] - sn.cols[0]
        sfull = ns + len(sn.struct)
        for k in range(ns):
            total += 2.0 * (sfull - k) ** 2
    return total / 1e9


def main():
    args = Args()
    args.input("n1", "FD grid dimension (n = 2*n1^2 variables)", 24)
    args.input("tol", "convergence tolerance", 1e-8)
    where = device_and_dtype(args)
    args.process_input()
    device, dtype = where()
    n1 = args["n1"]
    A = concat_fd_2d(n1, n1)
    m, n = A.shape
    rng = np.random.default_rng(0)
    x0 = np.abs(rng.standard_normal(n)) + 0.1
    b = A.to_scipy() @ x0
    c = np.abs(rng.standard_normal(n)) + 0.5

    gf = kkt_factor_gflops(A)
    output(f"LP: m={m} rows, n={n} vars, nnz(A)={A.nnz}, "
           f"KKT factor ≈ {gf:.3f} GFlop; {dtype} on {device}")

    t0 = time.time()
    res = lp_direct(A, b, c, LPCtrl(tol=args["tol"], max_iters=100),
                    device=device, dtype=dtype)
    wall = time.time() - t0
    per_it = wall / max(res.iterations, 1)
    output(f"objective = {res.objective:.8g} in {res.iterations} iterations "
           f"({wall:.1f}s wall, {per_it:.2f}s/it, "
           f"~{gf / per_it:.2f} GFlop/s factor-bound)")
    r = np.linalg.norm(A.to_scipy() @ res.x - b) / (1 + np.linalg.norm(b))
    output(f"primal residual {r:.2e}, min(x) = {res.x.min():.2e}, "
           f"converged={res.converged}")
    # the reference driver's dtype-aware expectations: converged to the
    # classical bound in float64 or at small sizes; float32 at scale to
    # ~1e-6 relative primal feasibility and a metric within ~1e-4
    eps = float(torch.finfo(dtype).eps)
    if not (np.isfinite(r) and res.x.min() > -1e-6):
        raise AssertionError((r, res.x.min()))
    if dtype == torch.float64 or n1 <= 32:
        bound = max(1e-6, 2000.0 * eps)
        if not r < bound:
            raise AssertionError((r, bound))
    elif not (r < 1e-5 * (1 + np.sqrt(n1)) and res.metric is not None
              and res.metric < 2e-4):
        raise AssertionError((r, res.metric))


if __name__ == "__main__":
    main()
