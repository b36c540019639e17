"""Dense-algebra tier of the port; so far the Krylov solvers and the sparse
Euclidean minimizations on the multifrontal LDL."""

from .solve import KrylovResult, cg, fgmres, gmres, lgmres, refined_solve
from .sparse_min import sparse_least_squares, sparse_linear_solve, sparse_lse
