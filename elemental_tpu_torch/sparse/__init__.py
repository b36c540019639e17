"""Sparse containers, the DIA format, the SpMV planner and sparse IO."""

from .csr import (BSRDevice, BSRMatrix, CSRDevice, ELLMatrix, Graph,
                  SparseBuilder, SparseMatrix)
from .dia import DIAMatrix, best_device_format, to_dia
from .auto_plan import SpMVPlan, plan_spmv
from .io import MPSData, read_matrix_market, read_mps, write_matrix_market
