"""Sparse matrix generators."""

from .pde import concat_fd_2d, sparse_laplacian_3d
