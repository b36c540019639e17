"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``extend_add`` (K1, the multifrontal extend-add), ``unstructured`` (K2, the
CSR SpMV, and the bridged tier: the stream gather and the bucketed combine
K7), ``spmv`` (K3, the stencil SpMV), ``matmul`` (K4, the tiled product, and
K5, the masked rank-k update) and ``elementwise`` (K6: axpy, scale,
hadamard, copy, fill, transpose)."""

from . import elementwise, extend_add, matmul, spmv, unstructured
