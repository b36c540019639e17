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
from .numeric import DIST_FRONT_MIN, LDLFactorization, factor
from .symbolic import SymbolicFactorization, analyze


class SparseLDLFactorization:
    """Supernodal multifrontal LDLᵀ/LDLᴴ solver on one device.

        f = SparseLDLFactorization(device="cuda", dtype=torch.complex64)
        f.initialize(A, hermitian=False)   # ordering + symbolic (host)
        f.factor()                         # numeric (device, level by level)
        x = f.solve(b)
        f.change_nonzero_values(new_vals)  # reuse symbolic; refactor

    ``dtype``: float32, float64, complex64 or complex128; a complex A needs
    a complex dtype, a real A is promoted to a complex one.  ``spd``: use
    the Cholesky front kernel (A must be positive definite, or Hermitian
    positive definite with ``hermitian=True``).

    ``grid``: optional ``core.Grid`` (the JAX ``mesh``): the factor splits
    its big levels' batches over the positions of ``tree_axis`` and
    factors the few top fronts of order ≥ ``dist_front_min`` over every
    position (``numeric.factor``); the pool stays on ``device``.
    """

    def __init__(self, *, device, dtype, spd: bool = False, grid=None,
                 tree_axis=None, dist_front_min: int = DIST_FRONT_MIN):
        self.device = None if device is None else torch.device(device)
        self.dtype = working_dtype(dtype)
        self.spd = spd
        self.grid = grid
        self.tree_axis = tree_axis
        self.dist_front_min = dist_front_min
        self.A: Optional[SparseMatrix] = None
        self.hermitian = False
        self.symb: Optional[SymbolicFactorization] = None
        self.ea_plan: Optional[EAPlan] = None
        self.numeric: Optional[LDLFactorization] = None
        self._reg = None

    def initialize(self, A: SparseMatrix, hermitian: bool = False,
                   perm: Optional[np.ndarray] = None, relax: int = 8,
                   cutoff: int = 64,
                   size_bucket: float = 0.0) -> "SparseLDLFactorization":
        """Ordering + symbolic analysis on the host, then the plans move to
        the device (reference ``Initialize``).  ``hermitian``: factor A as
        L·D·Lᴴ; otherwise a complex A is complex-symmetric, L·D·Lᵀ."""
        if np.iscomplexobj(A.vals) and not self.dtype.is_complex:
            raise TypeError(f"a complex matrix needs a complex working "
                            f"dtype, not {self.dtype}: the imaginary part "
                            f"would be dropped")
        if self.device is None:
            if self.grid is None:
                raise ValueError("no device: pass one, or a grid")
            self.device = self.grid.device(0, 0)
        self.A = A
        self.hermitian = hermitian
        if perm is None:
            from .ordering import nested_dissection
            perm = nested_dissection(A, cutoff=cutoff)
        host = analyze(A, perm=perm, relax=relax, size_bucket=size_bucket)
        self.symb = host.to(self.device)
        self.ea_plan = build_ea_plan(host).to(self.device)
        self.numeric = None
        return self

    @property
    def initialized(self) -> bool:
        return self.symb is not None

    @property
    def factored(self) -> bool:
        return self.numeric is not None

    def factor(self, reg=None) -> "SparseLDLFactorization":
        """Numeric factorization (reference ``Factor``; ``reg`` enables the
        RegularizedLDL path: A + diag(reg) is factored)."""
        if self.symb is None:
            raise RuntimeError("call initialize() first")
        self._reg = reg
        self.numeric = factor(self.symb, self.A.vals, ea_plan=self.ea_plan,
                              dtype=self.dtype, conjugate=self.hermitian,
                              reg=reg, spd=self.spd, grid=self.grid,
                              tree_axis=self.tree_axis,
                              dist_front_min=self.dist_front_min)
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

    def diagonal(self) -> torch.Tensor:
        """The pivots D, in permuted order."""
        return self._numeric().d

    def inertia(self):
        return self._numeric().inertia()

    def residual_bound(self, factor: float = 100.0) -> float:
        """Acceptable relative residual for solve-after-factor on this
        matrix: ``factor · eps(dtype) · n`` (reference
        ``Cholesky.cpp:41-44``)."""
        if self.A is None:
            raise RuntimeError("call initialize() first")
        return residual_bound(self.dtype, self.A.height, factor)

    def factor_nnz(self) -> int:
        if self.symb is None:
            raise RuntimeError("call initialize() first")
        return self.symb.nnz_factor

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


class DistSparseLDLFactorization(SparseLDLFactorization):
    """Distributed facade (reference ``DistSparseLDLFactorization.cpp:
    53-268``): ``initialize`` takes a ``sparse.DistSparseMatrix``, and the
    numeric factor runs on its grid, the level batches split over every
    axis (subtree-to-subteam mapping, ``Process.hpp:150-275``) and the top
    fronts factored over every position (``dist_front.py``).

        f = DistSparseLDLFactorization(dtype=torch.float64, spd=True)
        f.initialize(dA, cutoff=64)   # dA: a DistSparseMatrix on a grid
        f.factor()

    The symbolic phase reads the replicated host structure (``A.host``);
    the pool lives on ``device``, by default the grid's first position's
    device."""

    def __init__(self, *, dtype, device=None, spd: bool = False, grid=None,
                 tree_axis=None, dist_front_min: int = DIST_FRONT_MIN):
        super().__init__(device=device, dtype=dtype, spd=spd, grid=grid,
                         tree_axis=tree_axis, dist_front_min=dist_front_min)

    def initialize(self, A, hermitian: bool = False,
                   perm: Optional[np.ndarray] = None, relax: int = 8,
                   cutoff: int = 64, size_bucket: float = 0.0
                   ) -> "DistSparseLDLFactorization":
        from ..sparse.distsparse import DistSparseMatrix
        if isinstance(A, DistSparseMatrix):
            if self.grid is None:
                self.grid = A.grid
                if self.tree_axis is None:
                    self.tree_axis = ("mc", "mr")
            if A.host is None:
                raise ValueError("DistSparseMatrix built without host "
                                 "structure: the symbolic phase needs the "
                                 "replicated pattern")
            A = A.host
        return super().initialize(A, hermitian=hermitian, perm=perm,
                                  relax=relax, cutoff=cutoff,
                                  size_bucket=size_bucket)
