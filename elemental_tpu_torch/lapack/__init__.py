"""Dense-algebra tier of the port; so far the Krylov solvers."""

from .solve import KrylovResult, cg, fgmres, gmres, lgmres, refined_solve
