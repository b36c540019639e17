"""Sparse containers, the DIA format and the SpMV planner."""

from .csr import CSRDevice, ELLMatrix, Graph, SparseBuilder, SparseMatrix
from .dia import DIAMatrix, best_device_format, to_dia
from .auto_plan import SpMVPlan, plan_spmv
