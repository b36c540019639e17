"""Sparse containers, the distributed containers, the sparse products, the
DIA format, the SpMV planner and sparse IO."""

from .csr import (BSRDevice, BSRMatrix, CSRDevice, ELLMatrix, Graph,
                  SparseBuilder, SparseMatrix)
from .distsparse import DistGraph, DistMap, DistMultiVec, DistSparseMatrix
from .matmul import (DistSpGEMMPlan, GalerkinPlan, SpGEMMPlan,
                     dist_galerkin, dist_spgemm, dist_spgemm_plan,
                     galerkin_plan, multiply, spgemm, spgemm_plan,
                     syrk_sparse)
from .dia import DIAMatrix, best_device_format, to_dia
from .auto_plan import SpMVPlan, plan_spmv
from .io import MPSData, read_matrix_market, read_mps, write_matrix_market
