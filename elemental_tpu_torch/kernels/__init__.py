"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``extend_add`` (K1, the multifrontal extend-add), ``unstructured`` (K2, the
CSR SpMV) and ``spmv`` (K3, the stencil SpMV)."""

from . import extend_add, spmv, unstructured
