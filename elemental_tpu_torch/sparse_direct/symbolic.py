"""Symbolic analysis (reference ``src/lapack_like/factor/LDL/sparse/symbolic``:
``Separator``/``NodeInfo`` trees, ``Analysis.cpp``, elimination structures).

Host-side NumPy, ported unchanged from ``elemental_tpu/sparse_direct/
symbolic.py``: elimination tree (Liu), postorder, per-column structures,
fundamental supernodes with relaxed amalgamation, and the level-bucketed
front plan consumed by the numeric phase as flat scatter maps.
:meth:`SymbolicFactorization.to` moves the plan's index arrays onto a
device; :func:`from_reference` takes a plan made by the JAX package, so both
packages can compute from identical plans.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.policy import index_dtype
from ..sparse.csr import SparseMatrix


def etree(A: SparseMatrix) -> np.ndarray:
    """Elimination tree of a symmetric matrix given by its lower (or full)
    pattern (Liu's algorithm with path compression)."""
    n = A.height
    parent = np.full(n, -1, np.int64)
    ancestor = np.full(n, -1, np.int64)
    rows = np.repeat(np.arange(n), A.row_nnz())
    for i, j in zip(rows, A.colind):
        if j >= i:
            continue
        # walk from j up to the root of its current subtree
        k = j
        while True:
            a = ancestor[k]
            ancestor[k] = i
            if a == -1:
                if parent[k] == -1 and k != i:
                    parent[k] = i
                break
            if a == i:
                break
            k = a
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Post-ordering of a forest given parent pointers."""
    n = parent.shape[0]
    children: List[List[int]] = [[] for _ in range(n)]
    roots = []
    for v in range(n):
        p = parent[v]
        if p == -1:
            roots.append(v)
        else:
            children[p].append(v)
    out = np.empty(n, np.int64)
    idx = 0
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        v, done = stack.pop()
        if done:
            out[idx] = v
            idx += 1
        else:
            stack.append((v, True))
            for c in reversed(children[v]):
                stack.append((c, False))
    return out


def column_structures(A: SparseMatrix, parent: np.ndarray
                      ) -> List[np.ndarray]:
    """Full symbolic factor structure: struct(j) = rows of L below the
    diagonal in column j = A-pattern(j) ∪ (∪_children struct(c) \\ {j})."""
    n = A.height
    children: List[List[int]] = [[] for _ in range(n)]
    for v in range(n):
        if parent[v] != -1:
            children[parent[v]].append(v)
    rows = np.repeat(np.arange(n), A.row_nnz())
    a_cols: List[List[int]] = [[] for _ in range(n)]
    for i, j in zip(rows, A.colind):
        if i > j:
            a_cols[j].append(int(i))
        elif j > i:
            a_cols[i].append(int(j))
    struct: List[np.ndarray] = [None] * n  # type: ignore
    for j in postorder(parent):
        parts = [np.asarray(a_cols[j], np.int64)]
        parts += [struct[c] for c in children[j]]
        s = np.unique(np.concatenate(parts)) if len(parts) > 1 \
            else np.unique(parts[0])
        struct[j] = s[s > j]
    return struct


@dataclasses.dataclass
class Supernode:
    cols: Tuple[int, int]          # [start, end)
    struct: np.ndarray             # rows below the supernode (sorted)
    parent: int = -1               # parent supernode id
    children: Tuple[int, ...] = ()
    height: int = 0


def find_supernodes(parent: np.ndarray, struct: List[np.ndarray],
                    relax: int = 8) -> List[Supernode]:
    """Fundamental supernodes (parent[j]=j+1 and struct(j)\\{j+1} ==
    struct(j+1)) with relaxed amalgamation of small supernodes into their
    parent when the extra fill is bounded (reference front amalgamation)."""
    n = parent.shape[0]
    # fundamental supernode starts
    starts = [0]
    for j in range(1, n):
        prev = j - 1
        fused = (parent[prev] == j
                 and len(struct[prev]) == len(struct[j]) + 1
                 and struct[prev][0] == j
                 and np.array_equal(struct[prev][1:], struct[j]))
        if not fused:
            starts.append(j)
    starts.append(n)

    sns: List[Supernode] = []
    col2sn = np.empty(n, np.int64)
    for s in range(len(starts) - 1):
        a, b = starts[s], starts[s + 1]
        sns.append(Supernode((a, b), struct[b - 1]))
        col2sn[a:b] = s

    # parents
    for i, sn in enumerate(sns):
        a, b = sn.cols
        p = parent[b - 1]
        sn.parent = int(col2sn[p]) if p != -1 else -1

    # relaxed amalgamation: merge a supernode into its parent when small
    if relax > 0:
        merged = _amalgamate(sns, relax)
    else:
        merged = sns

    # children + heights (single pass)
    kids: List[List[int]] = [[] for _ in merged]
    for j, c in enumerate(merged):
        if c.parent != -1:
            kids[c.parent].append(j)
    for i, sn in enumerate(merged):
        sn.children = tuple(kids[i])
    # heights in post-order: every child is done before its parent
    for i in _sn_postorder(merged):
        sn = merged[i]
        sn.height = 1 + max((merged[c].height for c in sn.children),
                            default=-1)
    return merged


def _sn_postorder(sns: List[Supernode]) -> List[int]:
    roots = [i for i, s in enumerate(sns) if s.parent == -1]
    children: List[List[int]] = [[] for _ in sns]
    for i, s in enumerate(sns):
        if s.parent != -1:
            children[s.parent].append(i)
    out: List[int] = []
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        v, done = stack.pop()
        if done:
            out.append(v)
        else:
            stack.append((v, True))
            for c in reversed(children[v]):
                stack.append((c, False))
    return out


def _amalgamate(sns: List[Supernode], relax: int) -> List[Supernode]:
    """Merge supernodes of width < relax into their parent when the child's
    struct is 'almost' the parent's panel (bounded padding)."""
    n_sn = len(sns)
    alive = [True] * n_sn
    target = list(range(n_sn))

    def find(i):
        while target[i] != i:
            target[i] = target[target[i]]
            i = target[i]
        return i

    for i in range(n_sn):
        sn = sns[i]
        p = sn.parent
        if p == -1:
            continue
        p = find(p)
        width = sn.cols[1] - sn.cols[0]
        par = sns[p]
        # merge only when child's columns are contiguous with the parent's
        if width <= relax and sn.cols[1] == par.cols[0]:
            extra = len(sn.struct) - (par.cols[1] - par.cols[0]
                                      + len(par.struct))
            if extra <= relax:
                merged_struct = np.array(
                    sorted(set(sn.struct.tolist()) - set(
                        range(par.cols[0], par.cols[1]))
                        | set(par.struct.tolist())), np.int64)
                sns[p] = Supernode((sn.cols[0], par.cols[1]), merged_struct,
                                   par.parent)
                alive[i] = False
                target[i] = p

    remap = {}
    out: List[Supernode] = []
    for i in range(n_sn):
        if alive[i]:
            remap[i] = len(out)
            out.append(sns[i])
    for sn in out:
        if sn.parent != -1:
            sn.parent = remap[find(sn.parent)]
    return out


@dataclasses.dataclass
class LevelPlan:
    """All fronts at one tree height, padded to a common size.  After
    :meth:`SymbolicFactorization.to` the fields in ``LEVEL_ARRAY_FIELDS``
    are tensors; ``sn_ids`` and ``ns`` stay NumPy on the host."""
    sn_ids: np.ndarray             # (nf,)
    ns: np.ndarray                 # (nf,) supernode widths
    front_size: int                # padded S (cols+struct ≤ S)
    offset: int                    # flat offset into the front pool
    front_rows: np.ndarray         # (nf, S) permuted row ids; pad → n
    asm_dst: np.ndarray            # assembly from A: pool flat indices
    asm_src: np.ndarray            # indices into permuted A.vals
    child_dst: np.ndarray          # extend-add: pool flat dst
    child_src: np.ndarray          # extend-add: pool flat src (child Schur)
    diag_dst: np.ndarray           # (Σ ns,) pool flat of eliminated diag
    diag_cols: np.ndarray          # (Σ ns,) global permuted column ids


LEVEL_ARRAY_FIELDS = ("front_rows", "asm_dst", "asm_src", "child_dst",
                      "child_src", "diag_dst", "diag_cols")


@dataclasses.dataclass
class SymbolicFactorization:
    n: int
    perm: np.ndarray
    iperm: np.ndarray
    supernodes: List[Supernode]
    levels: List[LevelPlan]
    pool_size: int
    a_perm_src: np.ndarray         # map pool assembly → original A.vals index
    nnz_factor: int

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def to(self, device) -> "SymbolicFactorization":
        """A copy whose big index arrays (and ``perm``/``iperm``) are
        tensors on ``device``: int32 while ``pool_size < 2**31 - 1``,
        int64 otherwise."""
        idt = index_dtype(self.pool_size)

        def conv(a):
            return torch.from_numpy(np.array(a, dtype=idt)).to(device)

        levels = [dataclasses.replace(
            lev, **{f: conv(getattr(lev, f)) for f in LEVEL_ARRAY_FIELDS})
            for lev in self.levels]
        return dataclasses.replace(self, levels=levels,
                                   perm=conv(self.perm),
                                   iperm=conv(self.iperm))


def from_reference(obj) -> SymbolicFactorization:
    """Host copy of a symbolic plan made by another implementation with the
    same fields (the JAX package's ``SymbolicFactorization``, on host or
    device): every array becomes an int64 NumPy array."""
    i64 = lambda a: np.asarray(a).astype(np.int64)  # noqa: E731
    sns = [Supernode((int(s.cols[0]), int(s.cols[1])), i64(s.struct),
                     int(s.parent), tuple(int(c) for c in s.children),
                     int(s.height)) for s in obj.supernodes]
    levels = [LevelPlan(i64(lev.sn_ids), i64(lev.ns), int(lev.front_size),
                        int(lev.offset),
                        **{f: i64(getattr(lev, f))
                           for f in LEVEL_ARRAY_FIELDS})
              for lev in obj.levels]
    return SymbolicFactorization(int(obj.n), i64(obj.perm), i64(obj.iperm),
                                 sns, levels, int(obj.pool_size),
                                 i64(obj.a_perm_src), int(obj.nnz_factor))


def analyze(A: SparseMatrix, perm: Optional[np.ndarray] = None,
            relax: int = 8, pad_to: int = 8,
            size_bucket: float = 0.0) -> SymbolicFactorization:
    """Full symbolic pipeline: permute → etree → structures → supernodes →
    level-bucketed front plans with flat scatter maps.

    ``size_bucket``: when > 1, each height level is SPLIT into sub-buckets
    of similar front size (new bucket when a front exceeds ``size_bucket``×
    the bucket's smallest) — same-height supernodes are independent
    siblings, so any split is sound.  Cuts the pad-to-level-max waste that
    dominates pool memory and front flops at scale, at the cost of more
    level plans (more launches per factor)."""
    n = A.height
    if perm is None:
        from .ordering import nested_dissection
        perm = nested_dissection(A)
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)

    # permuted pattern + value map: entry t of A at (i,j) → (pi, pj)
    rows = np.repeat(np.arange(n), A.row_nnz())
    pi = iperm[rows]
    pj = iperm[A.colind]
    # keep lower triangle of the permuted matrix (incl. diagonal); a
    # symmetric pair (i,j)/(j,i) maps to the same lower entry — keep one.
    swap = pi < pj
    li = np.where(swap, pj, pi)
    lj = np.where(swap, pi, pj)
    key = li * n + lj
    uniq, first = np.unique(key, return_index=True)
    li = (uniq // n).astype(np.int64)
    lj = (uniq % n).astype(np.int64)
    rowptr = np.zeros(n + 1, np.int64)
    np.add.at(rowptr, li + 1, 1)
    Ap = SparseMatrix(n, n, np.cumsum(rowptr), lj,
                      np.zeros(uniq.shape[0], A.vals.dtype))
    val_map = first.astype(np.int64)  # permuted entry → original A.vals idx

    parent = etree(Ap)
    struct = column_structures(Ap, parent)
    sns = find_supernodes(parent, struct, relax)

    # group by height
    by_height: Dict[int, List[int]] = {}
    for i, sn in enumerate(sns):
        by_height.setdefault(sn.height, []).append(i)

    # front geometry
    sn_rows: List[np.ndarray] = []
    sn_level: Dict[int, Tuple[int, int]] = {}  # sn → (level idx, slot)
    for sn in sns:
        a, b = sn.cols
        sn_rows.append(np.concatenate([np.arange(a, b), sn.struct]))

    # optional size sub-bucketing: same-height supernodes are independent
    # siblings, so a height level may be split into buckets of similar
    # front size, cutting pad-to-level-max waste (see docstring)
    groups: List[List[int]] = []
    for h in sorted(by_height):
        ids = by_height[h]
        if size_bucket and size_bucket > 1 and len(ids) > 1:
            ids = sorted(ids, key=lambda i: len(sn_rows[i]))
            cur: List[int] = []
            base = 0
            for i in ids:
                s = len(sn_rows[i])
                if cur and s > max(size_bucket * base, base + 2 * pad_to):
                    groups.append(cur)
                    cur, base = [i], s
                else:
                    if not cur:
                        base = s
                    cur.append(i)
            if cur:
                groups.append(cur)
        else:
            groups.append(list(ids))

    levels: List[LevelPlan] = []
    offset = 0
    for ids in groups:
        S = max(len(sn_rows[i]) for i in ids)
        S = -(-S // pad_to) * pad_to
        nf = len(ids)
        front_rows = np.full((nf, S), n, np.int64)
        ns = np.zeros(nf, np.int64)
        for slot, i in enumerate(ids):
            r = sn_rows[i]
            front_rows[slot, :len(r)] = r
            ns[slot] = sns[i].cols[1] - sns[i].cols[0]
            sn_level[i] = (len(levels), slot)
        levels.append(LevelPlan(np.asarray(ids, np.int64), ns, S, offset,
                                front_rows, None, None, None, None, None,
                                None))
        offset += nf * S * S
    pool_size = offset

    def flat(lev: LevelPlan, slot: int, i: int, j: int) -> int:
        return lev.offset + (slot * lev.front_size + i) * lev.front_size + j

    # column → supernode
    col2sn = np.empty(n, np.int64)
    for i, sn in enumerate(sns):
        col2sn[sn.cols[0]:sn.cols[1]] = i

    # per-supernode flat geometry arrays (vectorized `flat`/`rowpos`)
    n_sn = len(sns)
    sn_lev = np.empty(n_sn, np.int64)
    sn_slot = np.empty(n_sn, np.int64)
    sn_off = np.empty(n_sn, np.int64)       # flat offset of the slot
    sn_S = np.empty(n_sn, np.int64)
    sn_a = np.empty(n_sn, np.int64)         # first column
    for i, sn in enumerate(sns):
        lev_i, slot = sn_level[i]
        lev = levels[lev_i]
        sn_lev[i], sn_slot[i] = lev_i, slot
        sn_S[i] = lev.front_size
        sn_off[i] = lev.offset + slot * lev.front_size * lev.front_size
        sn_a[i] = sn.cols[0]

    # assembly from A (lower permuted entries) — fully vectorized: the row
    # position inside front s is searchsorted into sn_rows[s] (sorted)
    prow = np.repeat(np.arange(n), Ap.row_nnz())
    pcol = np.asarray(Ap.colind, np.int64)
    s_of = col2sn[pcol]
    asm_dst = np.empty(Ap.nnz, np.int64)
    order = np.argsort(s_of, kind="stable")
    bounds = np.searchsorted(s_of[order], np.arange(n_sn + 1))
    for s in range(n_sn):
        sel = order[bounds[s]:bounds[s + 1]]
        if sel.size == 0:
            continue
        rp = np.searchsorted(sn_rows[s], prow[sel])
        asm_dst[sel] = sn_off[s] + rp * sn_S[s] + (pcol[sel] - sn_a[s])
    asm_lev = sn_lev[s_of]
    asm_dst_all = [asm_dst[asm_lev == li] for li in range(len(levels))]
    asm_src_all = [val_map[asm_lev == li] for li in range(len(levels))]

    # extend-add child → parent: per child one vectorized lower-triangle
    # index grid (reference `childRelInds`, NodeInfo.hpp:27-110)
    child_dst_all: List[List[np.ndarray]] = [[] for _ in levels]
    child_src_all: List[List[np.ndarray]] = [[] for _ in levels]
    tril_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for ci, sn in enumerate(sns):
        p = sn.parent
        nr = len(sn.struct)
        if p == -1 or nr == 0:
            continue
        plev_i = int(sn_lev[p])
        nsc = sn.cols[1] - sn.cols[0]
        rel = np.searchsorted(sn_rows[p], sn.struct)
        if nr not in tril_cache:
            tril_cache[nr] = np.tril_indices(nr)
        ai, bi = tril_cache[nr]
        Sc, Sp_ = int(sn_S[ci]), int(sn_S[p])
        child_src_all[plev_i].append(
            sn_off[ci] + (nsc + ai) * Sc + (nsc + bi))
        child_dst_all[plev_i].append(
            sn_off[p] + rel[ai] * Sp_ + rel[bi])

    # diagonal extraction
    nnz_factor = 0
    for lev_i, lev in enumerate(levels):
        diag_dst, diag_cols = [], []
        for slot, i in enumerate(lev.sn_ids):
            sn = sns[int(i)]
            a, b = sn.cols
            for k in range(b - a):
                diag_dst.append(flat(lev, slot, k, k))
                diag_cols.append(a + k)
            nnz_factor += (b - a) * (b - a + 1) // 2 \
                + (b - a) * len(sn.struct)
        lev.asm_dst = np.asarray(asm_dst_all[lev_i], np.int64)
        lev.asm_src = np.asarray(asm_src_all[lev_i], np.int64)
        lev.child_dst = (np.concatenate(child_dst_all[lev_i])
                         if child_dst_all[lev_i]
                         else np.empty(0, np.int64))
        lev.child_src = (np.concatenate(child_src_all[lev_i])
                         if child_src_all[lev_i]
                         else np.empty(0, np.int64))
        lev.diag_dst = np.asarray(diag_dst, np.int64)
        lev.diag_cols = np.asarray(diag_cols, np.int64)

    return SymbolicFactorization(n, perm, iperm, sns, levels, pool_size,
                                 val_map, nnz_factor)
