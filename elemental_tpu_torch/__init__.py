"""elemental_tpu_torch: the PyTorch + CUDA port of ``elemental_tpu``.

Ported so far, each slice with its TPU kernels written by hand for Hopper:

* the sparse-direct interior-point tier: ``lp_direct``, ``lp_affine``,
  the MPS front end (``sparse.read_mps``, ``solve_mps``), ``qp_direct``,
  ``qp_box``, ``qp_affine``, ``socp_affine``, the application solvers of
  ``optimization/solvers.py`` and the sparse least squares of
  ``lapack/sparse_min.py``, all factoring through the multifrontal
  extend-add K1 (``kernels/extend_add.py``, ``csrc/extend_add.cu``);
* the complex sparse-direct solves: ``sparse_direct.SparseLDLFactorization``
  on complex-symmetric (LDLᵀ) and Hermitian (LDLᴴ, or HPD Cholesky) input
  in complex64 and complex128, K1 on complex pools, with the grid ordering
  ``natural_nested_dissection``, the BSR containers and the Helmholtz,
  PML and dense PDE generators of ``matrices``;
* the SpMV planner (``sparse.plan_spmv``: DIA, RCM reordering, CSR) and the
  Krylov solvers that drive it (``lapack.cg``, ``gmres``, ``fgmres``,
  ``lgmres``, ``refined_solve``), with the stencil SpMV K3
  (``kernels/spmv.py``, ``csrc/stencil_spmv.cu``) and the CSR SpMV K2
  (``kernels/unstructured.py``, ``csrc/csr_spmv.cu``).

* the dense core and the BLAS tier: ``Grid`` (an h×w array of torch
  devices), ``DistMatrix`` in the reference's 14 distributions (one block
  per grid position), redistribution, and ``ops``: level 1-3, the SUMMA
  variants and the 3-D GEMM, all plain torch;
* the dense LAPACK tier (``lapack``: Cholesky, LU, LDL and Bunch-Kaufman,
  QR and TSQR, their solves, props, equilibration, the Euclidean
  minimizations), the matrix generators (``matrices``) and double-word and
  quad-double arithmetic (``extended``), plain torch.

Every public entry point takes an explicit ``device`` and ``dtype``, or
builds a host plan that ``.to(device, dtype)`` moves; a grid names its
devices, and the default grid is every CUDA device.  The package imports
no JAX.
"""

from . import core
from .core import (CIRC, MC, MD, MR, STAR, VC, VR, Dist, DistMatrix, Grid,
                   distribute, finalize, initialize)
from . import (kernels, lapack, matrices, ops, optimization, sparse,
               sparse_direct)

__all__ = ["CIRC", "MC", "MD", "MR", "STAR", "VC", "VR", "Dist",
           "DistMatrix", "Grid", "core", "distribute", "finalize",
           "initialize", "kernels", "lapack", "matrices", "ops",
           "optimization", "sparse", "sparse_direct"]
