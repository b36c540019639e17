"""Sparse-direct tier: fill-reducing orderings, symbolic analysis, the
extend-add plan and the supernodal multifrontal LDL."""

from .ordering import (bisect, minimum_degree, natural_nested_dissection,
                       nested_dissection, reverse_cuthill_mckee)
from .symbolic import (LevelPlan, Supernode, SymbolicFactorization, analyze,
                       from_reference)
from .ea_plan import EALevel, EAPlan, build_ea_plan
from .numeric import LDLFactorization, factor
from .facade import SparseLDLFactorization
