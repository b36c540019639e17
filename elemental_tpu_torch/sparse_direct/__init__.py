"""Sparse-direct tier: fill-reducing orderings, symbolic analysis, the
extend-add plan, the supernodal multifrontal LDL and its distributed
tiers on a grid (``dist_front.py``, ``numeric.factor(grid=...)``)."""

from .ordering import (bisect, minimum_degree, natural_nested_dissection,
                       nested_dissection, reverse_cuthill_mckee)
from .symbolic import (LevelPlan, Supernode, SymbolicFactorization, analyze,
                       column_structures, etree, find_supernodes,
                       from_reference, postorder)
from .ea_plan import EALevel, EAPlan, build_ea_plan
from .numeric import LDLFactorization, factor
from .facade import DistSparseLDLFactorization, SparseLDLFactorization
