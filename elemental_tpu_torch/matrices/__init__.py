"""Sparse matrix generators."""

from .pde import (concat_fd_2d, sparse_helmholtz_2d, sparse_helmholtz_3d,
                  sparse_laplacian_1d, sparse_laplacian_2d,
                  sparse_laplacian_3d)
