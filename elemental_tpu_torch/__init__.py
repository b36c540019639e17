"""elemental_tpu_torch: the PyTorch + CUDA port of ``elemental_tpu``.

Ported so far, each slice with its TPU kernels written by hand for Hopper:

* the sparse-direct interior-point LP path (``lp_direct``), with the
  multifrontal extend-add K1 (``kernels/extend_add.py``,
  ``csrc/extend_add.cu``);
* the SpMV planner (``sparse.plan_spmv``: DIA, RCM reordering, CSR) and the
  Krylov solvers that drive it (``lapack.cg``, ``gmres``, ``fgmres``,
  ``lgmres``, ``refined_solve``), with the stencil SpMV K3
  (``kernels/spmv.py``, ``csrc/stencil_spmv.cu``) and the CSR SpMV K2
  (``kernels/unstructured.py``, ``csrc/csr_spmv.cu``).

Every public entry point takes an explicit ``device`` and ``dtype``, or
builds a host plan that ``.to(device, dtype)`` moves.  The package imports
no JAX.
"""

from . import (core, kernels, lapack, matrices, optimization, sparse,
               sparse_direct)

__all__ = ["core", "kernels", "lapack", "matrices", "optimization",
           "sparse", "sparse_direct"]
