"""Matrix generators (counterpart of ``elemental_tpu/matrices``): the
deterministic and random generators on a keyword-only ``device``, the PDE
operators' sparse overloads on the host and dense overloads on a device."""

from .deterministic import (bulls_head, cauchy, cauchy_like, circulant,
                            demmel, diagonal, druinsky_toledo,
                            dynamic_regularization_counter,
                            egorov, ehrenfest, extended_kahan, fiedler,
                            forsythe, fourier, fox_li,
                            gcd_matrix, gear, gepp_growth, gkms, gks, grcar,
                            hankel, hanowa, hilbert, identity, jordan,
                            jordan_cholesky, kahan, kms, lauchli,
                            legendre, lehmer, lotkin, minij, ones, onetwoone,
                            parter, pei, redheffer, riemann, riffle,
                            riffle_decay, riffle_stationary, ris, toeplitz,
                            tri_w, triangle, trefethen_embree, walsh,
                            whale, wilkinson, zeros)
from .pde import (concat_fd_2d, helmholtz_1d, helmholtz_2d, helmholtz_3d,
                  helmholtz_pml_2d, laplacian_1d, laplacian_2d, laplacian_3d,
                  sparse_helmholtz_2d, sparse_helmholtz_3d,
                  sparse_laplacian_1d, sparse_laplacian_2d,
                  sparse_laplacian_3d)
from .random_gen import (ajtai_type_basis, bernoulli, gaussian, haar,
                         hatano_nelson, hermitian_uniform_spectrum,
                         knapsack_type_basis, normal_uniform_spectrum,
                         rademacher, three_valued, uniform,
                         uniform_helmholtz_greens, wigner)
