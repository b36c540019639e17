"""Sparse-direct facade (counterpart of ``elemental_tpu/sparse_direct/
facade.py``; reference ``DistSparseLDLFactorization.cpp:53-268``: Initialize
/ Factor / Solve / SolveWithIterativeRefinement / ChangeNonzeroValues)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.policy import residual_bound, working_dtype
from ..sparse.csr import SparseMatrix
from .ea_plan import EAPlan, build_ea_plan
from .numeric import LDLFactorization, factor
from .symbolic import SymbolicFactorization, analyze


class SparseLDLFactorization:
    """Supernodal multifrontal LDLᵀ solver on one device.

        f = SparseLDLFactorization(device="cuda", dtype=torch.float32)
        f.initialize(A)                    # ordering + symbolic (host)
        f.factor()                         # numeric (device, level by level)
        x = f.solve(b)
        f.change_nonzero_values(new_vals)  # reuse symbolic; refactor

    ``spd``: use the Cholesky front kernel (A must be positive definite).
    Complex matrices are not ported yet (``NotImplementedError``).
    """

    def __init__(self, *, device, dtype, spd: bool = False):
        self.device = torch.device(device)
        self.dtype = working_dtype(dtype)
        self.spd = spd
        self.A: Optional[SparseMatrix] = None
        self.symb: Optional[SymbolicFactorization] = None
        self.ea_plan: Optional[EAPlan] = None
        self.numeric: Optional[LDLFactorization] = None
        self._reg = None

    def initialize(self, A: SparseMatrix, perm: Optional[np.ndarray] = None,
                   relax: int = 8, cutoff: int = 64,
                   size_bucket: float = 0.0) -> "SparseLDLFactorization":
        """Ordering + symbolic analysis on the host, then the plans move to
        the device (reference ``Initialize``)."""
        if np.iscomplexobj(A.vals):
            raise NotImplementedError(
                "complex sparse factorizations are not ported to "
                "elemental_tpu_torch yet; see ROADMAP.md (queue 1)")
        self.A = A
        if perm is None:
            from .ordering import nested_dissection
            perm = nested_dissection(A, cutoff=cutoff)
        host = analyze(A, perm=perm, relax=relax, size_bucket=size_bucket)
        self.symb = host.to(self.device)
        self.ea_plan = build_ea_plan(host).to(self.device)
        self.numeric = None
        return self

    def factor(self, reg=None) -> "SparseLDLFactorization":
        """Numeric factorization (reference ``Factor``; ``reg`` enables the
        RegularizedLDL path: A + diag(reg) is factored)."""
        if self.symb is None:
            raise RuntimeError("call initialize() first")
        self._reg = reg
        self.numeric = factor(self.symb, self.A.vals, ea_plan=self.ea_plan,
                              dtype=self.dtype, reg=reg, spd=self.spd)
        return self

    def change_nonzero_values(self, new_vals) -> "SparseLDLFactorization":
        """Same structure, new values: refactor reusing the symbolic plan
        (reference ``ChangeNonzeroValues``)."""
        if self.A is None:
            raise RuntimeError("call initialize() first")
        self.A = self.A.change_nonzero_values(np.asarray(new_vals))
        if self.numeric is not None:
            self.factor(self._reg)
        return self

    def _numeric(self) -> LDLFactorization:
        if self.numeric is None:
            raise RuntimeError("call factor() first")
        return self.numeric

    def solve(self, b) -> torch.Tensor:
        return self._numeric().solve(b)

    def solve_with_iterative_refinement(self, b, iters: int = 6):
        dev = self.A.device_csr(device=self.device, dtype=self.dtype)
        apply_a = (lambda x: dev.matmat(x) if x.dim() > 1  # noqa: E731
                   else dev.matvec(x))
        return self._numeric().solve_with_iterative_refinement(apply_a, b,
                                                               iters)

    def multiply_with_l(self, x, adjoint: bool = False) -> torch.Tensor:
        return self._numeric().multiply_with_l(x, adjoint)

    def inertia(self):
        return self._numeric().inertia()

    def residual_bound(self, factor: float = 100.0) -> float:
        """Acceptable relative residual for solve-after-factor on this
        matrix: ``factor · eps(dtype) · n`` (reference
        ``Cholesky.cpp:41-44``)."""
        if self.A is None:
            raise RuntimeError("call initialize() first")
        return residual_bound(self.dtype, self.A.height, factor)

    def factor_gflops(self) -> float:
        """Flop estimate of the factorization (reference
        ``LocalFactorGFlops`` accounting, ``SparseLDL.cpp:143-169``)."""
        if self.symb is None:
            raise RuntimeError("call initialize() first")
        total = 0.0
        for sn in self.symb.supernodes:
            ns = sn.cols[1] - sn.cols[0]
            s = ns + len(sn.struct)
            for k in range(ns):
                total += 2.0 * (s - k) ** 2
        return total / 1e9
