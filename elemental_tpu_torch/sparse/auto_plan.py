"""Automatic SpMV planning: pick the execution form for a CSR matrix
(counterpart of ``elemental_tpu/sparse/auto_plan.py``; the dispatch tier of
the reference's sparse ``Multiply``, ``tests/blas_like/Multiply.cpp:19-46``).

Tiers, in dispatch order (``plan_spmv``), each with the same choice rule as
the JAX package, so that one matrix gets the same ``kind`` and ``perm`` in
both:

* ``stencil``: few diagonals cover A (DIA); the stencil kernel K3
  (``kernels/spmv.py``).
* ``stencil_rcm``: the same after a reverse Cuthill-McKee reordering, for
  scrambled banded matrices; ``matvec`` then computes P·A·Pᵀ.
* ``gather_csr``: anything else; the CSR kernel K2
  (``kernels/unstructured.py``).
* ``csr`` (``pallas_gather=False``): plain torch ``index_select`` +
  ``index_add_`` (``CSRDevice.matvec``), as the JAX package computes it in
  XLA with no Pallas.

``kind='bridged'`` (opt-in, never chosen by 'auto', as in the reference)
plans the bridged tier instead: a stream gather into bucket-major slots,
then the bucketed combine K7 (``kernels/unstructured.py``,
:class:`~..kernels.unstructured.BridgedPlan`, held in ``gather``).  Its y is
float32 whatever the plan's dtype, as the reference's is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core.policy import effective_dtype
from ..kernels.spmv import StencilPlan, plan_stencil_spmv, stencil_spmv
from ..kernels.unstructured import (BridgedPlan, GatherPlan,
                                   plan_bridged_spmv, plan_gather_spmv)
from .csr import CSRDevice, SparseMatrix
from .dia import to_dia


@dataclasses.dataclass
class SpMVPlan:
    """Executable SpMV plan.  ``matvec`` operates in *plan space*: when
    ``perm`` is set, the operator computed is P·A·Pᵀ; use
    ``to_plan_space``/``from_plan_space`` at the boundary (one gather each,
    once per solve, never in the hot loop).  Built on the host; move it
    with :meth:`to`."""

    # 'stencil' | 'stencil_rcm' | 'gather_csr' | 'csr' | 'bridged'
    kind: str
    height: int
    width: int
    nnz: int
    stencil: Optional[StencilPlan] = None
    csr: Optional[CSRDevice] = None
    gather: Optional[Union[GatherPlan, BridgedPlan]] = None
    perm: Optional[np.ndarray] = None      # plan index -> original index
    iperm: Optional[np.ndarray] = None

    def to(self, device=None, dtype=None) -> "SpMVPlan":
        """A copy on ``device`` with values in ``dtype`` (either kept when
        None); every part, ``GatherPlan`` or ``BridgedPlan`` alike, moves
        with its own ``.to``."""
        moved = {f: getattr(self, f).to(device, dtype)
                 for f in ("stencil", "csr", "gather")
                 if getattr(self, f) is not None}
        return dataclasses.replace(self, **moved)

    # -- permutation boundary (one-off per solve) -------------------------
    def to_plan_space(self, x):
        """x (NumPy array or tensor) in plan order."""
        return _permute(x, self.perm)

    def from_plan_space(self, y):
        """y (NumPy array or tensor) back in the original order."""
        return _permute(y, self.iperm)

    # -- execution ---------------------------------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.stencil is not None:
            return stencil_spmv(self.stencil, x)
        if self.gather is not None:
            return self.gather.matvec(x)
        return self.csr.matvec(x)

    @property
    def stream_bytes(self) -> int:
        """Device-memory bytes one product streams, for the port's own
        layouts: DIA (S+2)·n·itemsize; CSR nnz·(itemsize + index size) +
        (n+1)·index size + 2·n·itemsize; the row-id ``csr`` tier reads two
        index arrays per entry; the bridged tier slots·(itemsize + index
        size + 4 for ``lr``) + the float32 y of nbuckets·bucket rows."""
        n = self.height
        if self.stencil is not None:
            st = self.stencil
            return (len(st.offsets) + 2) * n * st.weights.element_size()
        if isinstance(self.gather, BridgedPlan):
            g = self.gather
            return (g.slots * (g.vals_b.element_size()
                               + g.cols_b.element_size() + 4)
                    + 4 * g.nbuckets * g.bucket)
        if self.gather is not None:
            g = self.gather
            item, idx = g.vals.element_size(), g.rowptr.element_size()
            return self.nnz * (item + idx) + (n + 1) * idx + 2 * n * item
        c = self.csr
        item = c.vals.element_size()
        return (self.nnz * (item + c.rows.element_size()
                            + c.colind.element_size()) + 2 * n * item)


def _permute(v, p: Optional[np.ndarray]):
    if p is None:
        return v
    if isinstance(v, torch.Tensor):
        return v[torch.as_tensor(p, device=v.device)]
    return np.asarray(v)[p]


def _permuted(A: SparseMatrix, p: np.ndarray) -> SparseMatrix:
    sp = A.to_scipy().tocsr()
    return SparseMatrix.from_scipy(sp[p][:, p])


def plan_spmv(A: SparseMatrix, cols: int = 1024, try_rcm: bool = True,
              max_stream_ratio: float = 16.0, max_halo: int = 256,
              pallas_gather: bool = True, kind: str = "auto") -> SpMVPlan:
    """Plan y = A·x (see the module docstring for the tiers).  The plan is
    built on the host, with A's values in their dtype; ``.to(device,
    dtype)`` moves it.  ``cols`` and ``max_halo`` only decide, as in the
    reference, when a banded matrix counts as a stencil;
    ``pallas_gather=False`` picks the plain ``csr`` tier over K2;
    ``kind='bridged'`` plans the bridged tier."""
    if kind == "bridged":
        return SpMVPlan("bridged", A.height, A.width, A.nnz,
                        gather=plan_bridged_spmv(A))
    if kind != "auto":
        raise ValueError(f"plan_spmv: unknown kind {kind!r}")

    n = A.height
    max_diags = max(8, int(max_stream_ratio * A.nnz / max(n, 1)))

    def try_stencil(M: SparseMatrix):
        dia = to_dia(M, max_diags=max_diags)
        if dia is None:
            return None
        return plan_stencil_spmv(dia.offsets, dia.diags, M.height, cols=cols,
                                 max_halo=max_halo, width=M.width)

    st = try_stencil(A)
    if st is not None:
        return SpMVPlan("stencil", A.height, A.width, A.nnz, stencil=st)

    if try_rcm and A.height == A.width and n > 1:
        from ..sparse_direct.ordering import reverse_cuthill_mckee
        p = reverse_cuthill_mckee(A)
        st = try_stencil(_permuted(A, p))
        if st is not None:
            ip = np.empty_like(p)
            ip[p] = np.arange(n)
            return SpMVPlan("stencil_rcm", A.height, A.width, A.nnz,
                            stencil=st, perm=p, iperm=ip)

    if pallas_gather:
        return SpMVPlan("gather_csr", A.height, A.width, A.nnz,
                        gather=plan_gather_spmv(A))
    return SpMVPlan("csr", A.height, A.width, A.nnz,
                    csr=A.device_csr(device="cpu",
                                     dtype=effective_dtype(A.vals.dtype)))
