"""PDE matrix generators: sparse overloads on the host, dense overloads on
a device."""

from .pde import (concat_fd_2d, helmholtz_1d, helmholtz_2d, helmholtz_3d,
                  helmholtz_pml_2d, laplacian_1d, laplacian_2d, laplacian_3d,
                  sparse_helmholtz_2d, sparse_helmholtz_3d,
                  sparse_laplacian_1d, sparse_laplacian_2d,
                  sparse_laplacian_3d)
