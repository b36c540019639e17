"""2-D Laplacian solved by CG through the stencil SpMV (counterpart of
``examples/cg_laplacian.py``, the minimum end-to-end slice of SURVEY §7).

    python -m elemental_tpu_torch.examples.cg_laplacian --n1 256
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..kernels.spmv import stencil_spmv, stencil_spmv_from_csr
from ..lapack import cg
from ..matrices import sparse_laplacian_2d
from . import device_and_dtype


def main():
    args = Args()
    args.input("n1", "grid side", 256)
    where = device_and_dtype(args)
    args.process_input()
    device, dtype = where()
    n1 = args["n1"]

    A = sparse_laplacian_2d(n1, n1, scaled=False)
    plan = stencil_spmv_from_csr(A, cols=min(1024, n1 * n1)) \
        .to(device, dtype)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.height)) \
        .to(device, dtype)

    res = cg(lambda v: stencil_spmv(plan, v), b, tol=1e-6, max_iters=5000)
    output(f"CG: {int(res.iterations)} iterations, "
           f"residual {float(res.residual):.3e}")
    x = res.x.double().cpu().numpy()
    check = np.linalg.norm(A.to_scipy() @ x - b.double().cpu().numpy())
    output(f"host-verified residual: {check:.3e}")
    return res, check


if __name__ == "__main__":
    main()
