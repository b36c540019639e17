"""Sparse products: ``multiply``, SpGEMM, the Galerkin product A·D·Aᵀ and
their distributed forms (counterpart of ``elemental_tpu/sparse/matmul.py``;
the reference's ``Multiply(NORMAL, α, A, X, β, Y)``, spec'd by
``tests/blas_like/Multiply.cpp:19-46``, and the SpGEMM of the IPM's
Galerkin A·D·Aᵀ).

  * SpMV/SpMM — the device CSR form (``CSRDevice.matvec``: a gather and
    ``index_add_``), or the distributed product of :mod:`.distsparse`.
  * SpGEMM — the symbolic phase is host NumPy (irregular, once per
    structure), the JAX package's code; the numeric phase is a *plan* of
    (a_idx, b_idx → c_idx) triples run on the device as one gather,
    product and ``index_add_``, so fixed-structure products (every IPM
    iteration) stay on the device.

Products of values are elementwise: no matmul runs here, so TF32 cannot
enter.  ``index_add_`` on a CUDA float tensor sums with atomics in no fixed
order, so the last bits of a sum may differ from run to run.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.grid import Grid
from ..core.policy import effective_dtype
from .csr import CSRDevice, ELLMatrix, Graph, SparseMatrix
from .distsparse import (DistMultiVec, DistSparseMatrix, _all_to_all,
                         _cut_rows, _flat_devices)


def _value_dtype(host_dtype, x_dtype: torch.dtype) -> torch.dtype:
    """X's dtype, made complex where A is complex and X is not."""
    if np.dtype(host_dtype).kind == "c" and not x_dtype.is_complex:
        return torch.complex128 if x_dtype == torch.float64 else \
            torch.complex64
    return x_dtype


def _axpby(alpha, prod: DistMultiVec, beta, Y) -> DistMultiVec:
    """α·prod + β·Y block by block, Y (a DistMultiVec, or a tensor) cut
    to the product's row blocks."""
    if Y is None:
        return dataclasses.replace(prod, blocks=[alpha * b
                                                 for b in prod.blocks])
    size = prod.blocks[0].shape[0]
    yb = (Y.row_blocks(size) if isinstance(Y, DistMultiVec) else
          _cut_rows(torch.as_tensor(Y), size, _flat_devices(prod.grid)))
    return dataclasses.replace(
        prod, blocks=[alpha * b + beta * y.to(b.device)
                      for b, y in zip(prod.blocks, yb)])


def multiply(orientation: str, alpha, A, X, beta=0.0, Y=None):
    """Y := α·op(A)·X + β·Y for sparse A (reference ``Multiply``,
    ``tests/blas_like/Multiply.cpp:19-46``).  A is a ``SparseMatrix``,
    ``Graph``, ``ELLMatrix``, ``CSRDevice`` or ``DistSparseMatrix``; X a
    tensor (or array) or a ``DistMultiVec``.  The device and dtype come
    from X.  A distributed A with a ``DistMultiVec`` X gives a
    ``DistMultiVec``, nothing assembled; otherwise a tensor."""
    if isinstance(A, Graph):
        A = A.to_sparse()
    o = orientation.upper()[0]
    if isinstance(A, SparseMatrix):
        if o == "T":
            A = A.transpose()
        elif o in ("C", "A"):
            A = A.transpose().conj()
        xv = X.assemble() if isinstance(X, DistMultiVec) else \
            torch.as_tensor(X)
        dev = A.device_csr(device=xv.device,
                           dtype=_value_dtype(A.vals.dtype, xv.dtype))
        prod = dev.matvec(xv) if xv.ndim == 1 else dev.matmat(xv)
    elif isinstance(A, DistSparseMatrix):
        xv = X if isinstance(X, DistMultiVec) else torch.as_tensor(X)
        if o == "N":
            prod = A.matvec(xv) if xv.ndim == 1 else A.matmat(xv)
        else:
            # the distributed transpose: the reversed halo exchange
            # (reference Multiply(TRANSPOSE, DistSparseMatrix, ...))
            if o in ("C", "A"):
                if A.host is None:
                    raise ValueError(
                        "adjoint DistSparse multiply requires the host CSR "
                        "(matrix was built/updated host-stripped)")
                A = A.change_nonzero_values(np.conj(A.host.vals))
            prod = (A.matvec_transpose(xv) if xv.ndim == 1
                    else A.matmat_transpose(xv))
    elif isinstance(A, (ELLMatrix, CSRDevice)):
        xv = X.assemble() if isinstance(X, DistMultiVec) else \
            torch.as_tensor(X)
        prod = A.matvec(xv) if xv.ndim == 1 else A.matmat(xv)
    else:
        raise TypeError(f"unsupported sparse type {type(A)}")
    if isinstance(prod, DistMultiVec):
        return _axpby(alpha, prod, beta, Y)
    out = alpha * prod
    if Y is not None:
        yv = Y.assemble() if isinstance(Y, DistMultiVec) else \
            torch.as_tensor(Y)
        out = out + beta * yv.to(out.device)
    return out


# --------------------------------------------------------------------------
# SpGEMM
# --------------------------------------------------------------------------

def _gather_sum(n: int, idx: torch.Tensor, prod: torch.Tensor
                ) -> torch.Tensor:
    return prod.new_zeros(n).index_add_(0, idx, prod)


@dataclasses.dataclass
class SpGEMMPlan:
    """Plan of a fixed-structure product C = A·B: one gather, product and
    ``index_add_``.  Built on the host (CPU tensors); :meth:`to` moves it."""

    c_struct: SparseMatrix      # structure of C (vals are from plan build)
    a_idx: torch.Tensor         # (nmul,) int64 indices into A.vals
    b_idx: torch.Tensor         # (nmul,) int64 indices into B.vals
    c_idx: torch.Tensor         # (nmul,) int64 indices into C.vals
    c_nnz: int

    def to(self, device) -> "SpGEMMPlan":
        return dataclasses.replace(self, a_idx=self.a_idx.to(device),
                                   b_idx=self.b_idx.to(device),
                                   c_idx=self.c_idx.to(device))

    def numeric(self, a_vals, b_vals) -> torch.Tensor:
        """C's values (in C's CSR order) from A's and B's, on the plan's
        device."""
        dev = self.a_idx.device
        a = torch.as_tensor(a_vals).to(dev)
        b = torch.as_tensor(b_vals).to(dev)
        prod = a.index_select(0, self.a_idx) * b.index_select(0, self.b_idx)
        return _gather_sum(self.c_nnz, self.c_idx, prod)


def spgemm_plan(A: SparseMatrix, B: SparseMatrix) -> SpGEMMPlan:
    """Symbolic SpGEMM (host): enumerate every scalar multiplication
    a_ik·b_kj and its destination c_ij, destinations deduplicated."""
    if A.width != B.height:
        raise ValueError(f"inner dimensions differ: {A.shape} @ {B.shape}")
    a_rows = np.repeat(np.arange(A.height), A.row_nnz())
    # expand: each A entry (i,k) pairs with every B entry of row k
    b_rownnz = np.diff(B.rowptr)
    counts = b_rownnz[A.colind]               # multiplications per A entry
    nmul = int(counts.sum())
    a_idx = np.repeat(np.arange(A.nnz), counts)
    # B positions: for A entry t with k = A.colind[t],
    # B.rowptr[k] + 0..counts[t]-1
    starts = B.rowptr[A.colind]
    offsets = np.arange(nmul) - np.repeat(np.cumsum(counts) - counts, counts)
    b_idx = np.repeat(starts, counts) + offsets
    ci = a_rows[a_idx]
    cj = B.colind[b_idx]
    key = ci * B.width + cj
    uniq, inv = np.unique(key, return_inverse=True)
    c_rows = (uniq // B.width).astype(np.int64)
    c_cols = (uniq % B.width).astype(np.int64)
    c_struct = SparseMatrix.from_coo(A.height, B.width, c_rows, c_cols,
                                     np.zeros(uniq.shape[0], A.vals.dtype),
                                     sum_duplicates=False)
    # from_coo sorted (rows, cols): the unique keys are in that order
    return SpGEMMPlan(c_struct, torch.from_numpy(a_idx.astype(np.int64)),
                      torch.from_numpy(b_idx.astype(np.int64)),
                      torch.from_numpy(inv.reshape(-1).astype(np.int64)),
                      int(uniq.shape[0]))


def _host_dtype(*mats: SparseMatrix, dtype=None) -> torch.dtype:
    if dtype is not None:
        return effective_dtype(dtype)
    return effective_dtype(np.result_type(*(M.vals for M in mats)))


def _host_values(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().resolve_conj().numpy()


def spgemm(A: SparseMatrix, B: SparseMatrix, *, device="cuda",
           dtype=None) -> SparseMatrix:
    """C = A·B: host symbolic phase, numeric on ``device`` in ``dtype``
    (default: A's and B's)."""
    dtype = _host_dtype(A, B, dtype=dtype)
    plan = spgemm_plan(A, B).to(device)
    c_vals = plan.numeric(torch.from_numpy(A.vals).to(device, dtype),
                          torch.from_numpy(B.vals).to(device, dtype))
    return plan.c_struct.change_nonzero_values(_host_values(c_vals))


@dataclasses.dataclass
class GalerkinPlan:
    """Fixed-structure A·diag(d)·Aᵀ (the IPM normal-equations product,
    BASELINE config #3 'Galerkin A·Aᵀ'): the structure once, each numeric
    one gather, product and ``index_add_`` on the device."""

    c_struct: SparseMatrix
    a_idx: torch.Tensor      # left factor entry (int64)
    at_idx: torch.Tensor     # right factor entry (index into A.vals)
    d_idx: torch.Tensor      # inner (column) index → diag entry
    c_idx: torch.Tensor
    c_nnz: int

    def to(self, device) -> "GalerkinPlan":
        return dataclasses.replace(
            self, a_idx=self.a_idx.to(device), at_idx=self.at_idx.to(device),
            d_idx=self.d_idx.to(device), c_idx=self.c_idx.to(device))

    def numeric(self, a_vals, d) -> torch.Tensor:
        dev = self.a_idx.device
        a = torch.as_tensor(a_vals).to(dev)
        d = torch.as_tensor(d).to(dev)
        prod = (a.index_select(0, self.a_idx) * d.index_select(0, self.d_idx)
                * a.index_select(0, self.at_idx))
        return _gather_sum(self.c_nnz, self.c_idx, prod)


def galerkin_plan(A: SparseMatrix) -> GalerkinPlan:
    """Plan C = A·diag(d)·Aᵀ: every pair of entries that share a column k,
    rows r_i and r_j, contributes to (r_i, r_j)."""
    At = A.transpose()  # CSR of Aᵀ: rows = columns of A
    col_nnz = At.row_nnz()
    a_rows = np.repeat(np.arange(A.height), A.row_nnz())
    order = np.lexsort((a_rows, A.colind))     # A's entries by (col, row)
    ent_row = a_rows[order]
    ent_aidx = order                           # index into A.vals
    # pairs within each column
    counts = col_nnz                           # entries per column
    pair_counts = counts * counts
    npair = int(pair_counts.sum())
    col_starts = np.cumsum(counts) - counts
    pk = np.repeat(np.arange(A.width), pair_counts)           # column id
    base = np.repeat(np.cumsum(pair_counts) - pair_counts, pair_counts)
    local = np.arange(npair) - base
    ccount = counts[pk]
    li = local // np.maximum(ccount, 1)
    lj = local % np.maximum(ccount, 1)
    left = ent_aidx[col_starts[pk] + li]
    right = ent_aidx[col_starts[pk] + lj]
    ci = ent_row[col_starts[pk] + li]
    cj = ent_row[col_starts[pk] + lj]
    key = ci * A.height + cj
    uniq, inv = np.unique(key, return_inverse=True)
    c_rows = (uniq // A.height).astype(np.int64)
    c_cols = (uniq % A.height).astype(np.int64)
    c_struct = SparseMatrix.from_coo(A.height, A.height, c_rows, c_cols,
                                     np.zeros(uniq.shape[0], A.vals.dtype),
                                     sum_duplicates=False)

    def t(a):
        return torch.from_numpy(np.asarray(a).reshape(-1).astype(np.int64))

    return GalerkinPlan(c_struct, t(left), t(right), t(pk), t(inv),
                        int(uniq.shape[0]))


def syrk_sparse(A: SparseMatrix, d: Optional[np.ndarray] = None, *,
                device="cuda", dtype=None) -> SparseMatrix:
    """C = A·diag(d)·Aᵀ through the Galerkin plan (d defaults to ones), the
    numeric on ``device`` in ``dtype`` (default: A's)."""
    dtype = _host_dtype(A, dtype=dtype)
    plan = galerkin_plan(A).to(device)
    dv = np.asarray(d) if d is not None else np.ones(A.width, A.vals.dtype)
    vals = plan.numeric(torch.from_numpy(A.vals).to(device, dtype),
                        torch.from_numpy(dv).to(device, dtype))
    return plan.c_struct.change_nonzero_values(_host_values(vals))


# --------------------------------------------------------------------------
# Distributed SpGEMM (reference ``SparseAllToAll`` row exchange,
# ``src/core/imports/mpi_collectives.hpp``)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistSpGEMMPlan:
    """Fixed-structure distributed product C = A·B over the grid's flat
    positions.

    Both operands are 1-D row-partitioned (:class:`DistSparseMatrix`).  The
    symbolic phase (host, once) compresses the reference's row exchange to
    ENTRY granularity: position i receives exactly the B values its A
    columns touch, through one padded all-to-all (never a whole-matrix
    gather); each position's numeric is one gather, product and
    ``index_add_``.  Running it again with new values (the IPM's Galerkin
    product) is device code only.  Per-position lists are indexed by the
    flat position, each tensor on that position's device.
    """

    grid: Grid
    c_host: SparseMatrix          # global structure of C (vals = zeros)
    c_template: DistSparseMatrix  # distributed C (structure; lvals slots)
    halo: int                     # H: padded all-to-all width
    emul: int                     # padded multiplications per position
    send_idx: List[torch.Tensor]  # p × (p, H) int32 into the owner's B slots
    a_idx: List[torch.Tensor]     # p × (Em,) int32 into local A slots
    w_idx: List[torch.Tensor]     # p × (Em,) int32 into [own B | halo]
    c_idx: List[torch.Tensor]     # p × (Em,) int32 local C slot (ec ⇒ drop)
    ec: int                       # slots per position in C's lvals

    def numeric(self, a_lvals: List[torch.Tensor],
                b_lvals: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each position's C values (ec,) from each position's A and B
        values; the exchange of B's values is one ``all-to-all`` record a
        receiving position."""
        devs = _flat_devices(self.grid)
        p, H, Ec = len(devs), self.halo, self.ec
        send = [b_lvals[j].index_select(0, self.send_idx[j].reshape(-1))
                .reshape(p, H) for j in range(p)]
        recv = _all_to_all(send, devs)
        out = []
        for q in range(p):
            w = torch.cat([b_lvals[q], recv[q].reshape(-1)])
            prod = (a_lvals[q].index_select(0, self.a_idx[q])
                    * w.index_select(0, self.w_idx[q]))
            out.append(_gather_sum(Ec + 1, self.c_idx[q], prod)[:Ec])
        return out

    def product(self, A: DistSparseMatrix, B: DistSparseMatrix
                ) -> DistSparseMatrix:
        """C = A·B as a DistSparseMatrix of C's structure, with the host
        CSR of its values."""
        lvals = self.numeric(A.lvals, B.lvals)
        host = None
        if self.c_template.host is not None:
            flat = np.concatenate([_host_values(v) for v in lvals])
            host = self.c_template.host.change_nonzero_values(
                flat[self.c_template.val_slot])
        return dataclasses.replace(self.c_template, lvals=lvals, host=host)


def dist_spgemm_plan(A: DistSparseMatrix, B: DistSparseMatrix
                     ) -> DistSpGEMMPlan:
    """Symbolic distributed SpGEMM (host, once per structure)."""
    if A.host is None or B.host is None:
        raise ValueError("dist_spgemm_plan requires host CSR structure")
    Ah, Bh = A.host, B.host
    grid = A.grid
    p = grid.size
    rs_a = A.rs

    # global multiplication enumeration (as spgemm_plan)
    a_rows = np.repeat(np.arange(Ah.height), Ah.row_nnz())
    b_rownnz = np.diff(Bh.rowptr)
    counts = b_rownnz[Ah.colind]
    nmul = int(counts.sum())
    a_ent = np.repeat(np.arange(Ah.nnz), counts)
    starts = Bh.rowptr[Ah.colind]
    offs = np.arange(nmul) - np.repeat(np.cumsum(counts) - counts, counts)
    b_ent = np.repeat(starts, counts) + offs
    ci = a_rows[a_ent]
    cj = Bh.colind[b_ent]

    # global C structure + distributed template
    key = ci * Bh.width + cj
    uniq, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    c_rows = (uniq // Bh.width).astype(np.int64)
    c_cols = (uniq % Bh.width).astype(np.int64)
    c_host = SparseMatrix.from_coo(Ah.height, Bh.width, c_rows, c_cols,
                                   np.zeros(uniq.shape[0], Ah.vals.dtype),
                                   sum_duplicates=False)
    c_tmpl = DistSparseMatrix.from_sparse(
        c_host, grid, dtype=torch.promote_types(A.dtype, B.dtype))
    ec = c_tmpl.slots

    # each multiplication's position: that of the C row it lands in (A's)
    shard = (ci // rs_a).astype(np.int64)
    # owner of each needed B entry = B's row partition
    b_rows_of = np.repeat(np.arange(Bh.height), b_rownnz)
    owner = (b_rows_of[b_ent] // B.rs).astype(np.int64)
    eb = B.slots                          # own-value block width
    # val_slot is the GLOBAL padded slot (owner·Eb + local); localize it
    b_slot = B.val_slot[b_ent] - owner * eb

    # halo footprint: unique (reader position, owner, owner-local slot)
    off = shard != owner
    fkey = shard[off] * (p * eb) + owner[off] * eb + b_slot[off]
    funiq = np.unique(fkey)
    f_i = funiq // (p * eb)
    f_j = (funiq // eb) % p
    f_s = funiq % eb
    hcounts = np.zeros((p, p), np.int64)
    np.add.at(hcounts, (f_i, f_j), 1)
    H = max(1, int(hcounts.max()) if hcounts.size else 1)
    send_idx = np.zeros((p, p, H), np.int32)
    blk_key = f_i * p + f_j
    blk_start = np.searchsorted(blk_key, np.arange(p * p))
    pos_in_blk = np.arange(funiq.size) - blk_start[blk_key]
    send_idx[f_j, f_i, pos_in_blk] = f_s.astype(np.int32)

    # workspace index per multiplication
    widx = np.where(off, 0, b_slot).astype(np.int64)
    if off.any():
        pos = np.searchsorted(funiq, fkey)
        widx[off] = eb + f_j[pos] * H + pos_in_blk[pos]

    # pack per-position multiplication triples, padded to Em
    per = np.zeros(p, np.int64)
    np.add.at(per, shard, 1)
    Em = max(1, int(per.max()))
    a_idx = np.zeros((p, Em), np.int32)
    w_idx = np.zeros((p, Em), np.int32)
    c_idx = np.full((p, Em), ec, np.int32)   # padding ⇒ dropped by the sum
    order = np.argsort(shard, kind="stable")
    sh_sorted = shard[order]
    starts_s = np.searchsorted(sh_sorted, np.arange(p))
    slot_of = np.arange(nmul) - starts_s[sh_sorted]
    ea = A.slots
    a_idx[sh_sorted, slot_of] = (A.val_slot[a_ent[order]]
                                 - shard[order] * ea).astype(np.int32)
    w_idx[sh_sorted, slot_of] = widx[order].astype(np.int32)
    # C destination: position-local padded slot of the C entry
    c_slot_local = (c_tmpl.val_slot[inv] - shard * ec)
    c_idx[sh_sorted, slot_of] = c_slot_local[order].astype(np.int32)

    devs = _flat_devices(grid)

    def put(arr):
        return [torch.from_numpy(np.ascontiguousarray(arr[q])).to(devs[q])
                for q in range(p)]

    return DistSpGEMMPlan(grid, c_host, c_tmpl, H, Em, put(send_idx),
                          put(a_idx), put(w_idx), put(c_idx), ec)


def dist_spgemm(A: DistSparseMatrix, B: DistSparseMatrix
                ) -> DistSparseMatrix:
    """C = A·B, both 1-D row-partitioned, entry-compressed halo exchange."""
    return dist_spgemm_plan(A, B).product(A, B)


def dist_galerkin(A: DistSparseMatrix, d=None) -> DistSparseMatrix:
    """Distributed C = A·diag(d)·Aᵀ (the IPM normal-equations product): d
    is folded into Aᵀ's row-partitioned values on the host, then the
    fixed-structure distributed SpGEMM runs.  In a loop, build the plan
    once (``dist_spgemm_plan(A, At)``) and call ``numeric`` with the
    rescaled values."""
    if A.host is None:
        raise ValueError("dist_galerkin requires host CSR structure")
    At_host = A.host.transpose()
    if d is not None:
        d = np.asarray(d)
        rows_t = np.repeat(np.arange(At_host.height), At_host.row_nnz())
        At_host = At_host.change_nonzero_values(At_host.vals * d[rows_t])
    At = DistSparseMatrix.from_sparse(At_host, A.grid, dtype=A.dtype)
    return dist_spgemm(A, At)


__all__ = ["DistSpGEMMPlan", "GalerkinPlan", "SpGEMMPlan", "dist_galerkin",
           "dist_spgemm", "dist_spgemm_plan", "galerkin_plan", "multiply",
           "spgemm", "spgemm_plan", "syrk_sparse"]
