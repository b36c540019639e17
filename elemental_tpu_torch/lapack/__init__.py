"""Dense-algebra tier of the port (counterpart of ``elemental_tpu/lapack``):
the dense factorizations (Cholesky, LU, LDL, QR) and their solves,
permutations, reflectors, properties, equilibration, the Euclidean
minimizations, the dense and Krylov solvers, the sparse Euclidean
minimizations on the multifrontal LDL, and the spectral tier: the
condensed forms, the tridiagonal and Hermitian eigensolvers, the SVD,
Schur, pseudospectra, the Lanczos family, the matrix functions and
lattice reduction.

:func:`from_reference` carries a JAX factorization or decomposition
across, so that the port's ``solve_after*`` (or its tridiagonal
eigensolver, its back-transforms) can run on the JAX package's own."""

import numpy as np
import torch

from .cholesky import (PivotedCholesky, cholesky, cholesky_mod, hpd_solve,
                       pivoted_cholesky, reverse_cholesky)
from .cholesky import solve_after as cholesky_solve_after
from .lu import (LU, LUFull, determinant, linear_solve, lu, lu_full, lu_mod,
                 solve_after_full)
from .lu import solve_after as lu_solve_after
from .qr import (QR, QRPivoted, apply_q, cholesky_qr, explicit_qr, lq, qr,
                 qr_householder, qr_pivoted, rq, tsqr)
from .ldl import LDL, LDLPivoted, ldl, regularized_ldl, solve_after_refined
from .ldl import solve_after as ldl_solve_after
from .ldl import inertia as ldl_inertia
from .solve import (KrylovResult, cg, fgmres, gmres, hermitian_solve, lgmres,
                    multishift_hess_solve, refined_solve, sqsd_solve,
                    symmetric_solve)
from .condense import (Bidiag, Hess, Tridiag, bidiag, hermitian_tridiag,
                       hessenberg)
from .spectral import (EigPair, SVD, Schur, eig, hermitian_eig,
                       lanczos, lanczos_decomp, product_lanczos,
                       extremal_singular_value_estimates,
                       hermitian_tridiag_eig, hermitian_tridiag_eig_estimate,
                       polar, pseudospectra, schur, secular_evd,
                       singular_values, skew_hermitian_eig, svd, triang_eig)
from .props import (condition, entrywise_norm, frobenius_norm, hpd_determinant,
                    inertia, infinity_norm, log_det, max_norm, norm,
                    nuclear_norm, one_norm, schatten_norm, trace, two_norm,
                    two_norm_estimate)
from .euclidean_min import glm, least_squares, lse, ridge, tikhonov
from .sparse_min import sparse_least_squares, sparse_linear_solve, sparse_lse
from .equilibrate import (Equilibrated, geom_equil, ruiz_equil,
                          symmetric_diagonal_equil, symmetric_ruiz_equil)
from .funcs import (hermitian_function, hpd_inverse, hpd_square_root, inverse,
                    pseudoinverse, sign, square_root, symmetric_inverse,
                    triangular_inverse)
from .perm import Permutation, permutation_to_pivots, pivots_to_permutation
from .reflect import (apply_packed_reflectors, expand_packed_reflectors,
                      householder, hyperbolic_reflector)
from .util import median, pivot_parity, sort, tagged_sort
from .tridiag_eig import tridiag_eig, tridiag_eigvalsh
from .lattice import (LLLInfo, algebraic_relation_search,
                      lattice_image_and_kernel, lll, z_dependence_search)

_FACTORS = {cls.__name__: cls for cls in (
    LU, LUFull, LDL, LDLPivoted, PivotedCholesky, QR, QRPivoted,
    Tridiag, Bidiag, Hess, EigPair, SVD, Schur)}


def from_reference(fact, *, device):
    """The port's factorization or decomposition of the same name (``LU``,
    ``LUFull``, ``LDL``, ``LDLPivoted``, ``PivotedCholesky``, ``QR``,
    ``QRPivoted``, ``Tridiag``, ``Bidiag``, ``Hess``, ``EigPair``, ``SVD``,
    ``Schur``) holding ``fact``'s fields, each read with ``np.asarray`` (a
    JAX NamedTuple, or any object with those fields), on ``device``; a
    field that is None stays None.  Pivots and permutations keep their
    meaning (0-based); integer fields become int64."""
    cls = _FACTORS[type(fact).__name__]
    fields = []
    for name in cls._fields:
        if getattr(fact, name) is None:
            fields.append(None)
            continue
        v = np.array(getattr(fact, name))
        t = torch.as_tensor(v, device=device)
        fields.append(t.long() if v.dtype.kind in "iu" else t)
    return cls(*fields)
