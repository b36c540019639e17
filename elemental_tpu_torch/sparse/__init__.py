"""Sparse containers."""

from .csr import CSRDevice, ELLMatrix, Graph, SparseBuilder, SparseMatrix
