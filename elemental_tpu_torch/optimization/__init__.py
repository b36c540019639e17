"""Conic optimization: the interior-point LP, QP and SOCP engines on the
fixed-pattern KKT, the MPS front end, and the application solvers."""

from .lp import (Approach, LPCtrl, LPResult, lp_affine, lp_direct,
                 mps_to_standard, solve_mps, sparse_ruiz)
from .kkt import KKTBuilder, KKTFactor, KKTSystem
from .qp import qp_affine, qp_box, qp_direct
from .socp import (Cones, ConeOps, SOCPResult, in_cone, max_step, soc_apply,
                   soc_dets, soc_identity, soc_inverse, soc_min_eig,
                   socp_affine)
from .solvers import (basis_pursuit, basis_pursuit_complex, bpdn,
                      chebyshev_point, dantzig_selector, elastic_net,
                      lasso, lav, nnls, portfolio, rnnls,
                      robust_least_squares, svm, total_variation)
