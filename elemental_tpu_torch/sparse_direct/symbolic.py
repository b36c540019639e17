"""Symbolic analysis (reference ``src/lapack_like/factor/LDL/sparse/symbolic``:
``Separator``/``NodeInfo`` trees, ``Analysis.cpp``, elimination structures).

Host-side NumPy, ported from ``elemental_tpu/sparse_direct/symbolic.py``
with the same plans: elimination tree (Liu), per-column structures,
fundamental supernodes with relaxed amalgamation, and the level-bucketed
front plan consumed by the numeric phase as flat scatter maps.  Where the
reference loops in Python over every column or entry (the column patterns,
the supernode starts, the assembly and diagonal maps, the child rows'
positions in their parents' fronts), the port uses array operations.
:meth:`SymbolicFactorization.to` moves the plan's index arrays onto a
device; :func:`from_reference` takes a plan made by the JAX package, so both
packages can compute from identical plans.

Hermitian value map.  Each lower entry of the permuted matrix is assembled
from one of the pair (i,j)/(j,i), the first in CSR order, as in the JAX
package.  Where that occurrence lies above the permuted diagonal, a
Hermitian factor needs its conjugate: ``LevelPlan.asm_conj`` marks those
entries and ``numeric.factor`` conjugates them when ``conjugate`` is set.
The JAX package does not, so its LDLᴴ factors a wrong matrix under every
ordering that puts such an entry first (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.policy import index_dtype
from ..core.profiling import profiled
from ..sparse.csr import SparseMatrix
from .solve_plan import SolvePlan, build_solve_plan


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
    """Post-ordering of a forest given parent pointers: each subtree's
    nodes, children in ascending order, then its root; the roots in
    ascending order."""
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
            stack.extend((c, False) for c in reversed(children[v]))
    return out


def column_structures(A: SparseMatrix, parent: np.ndarray
                      ) -> List[np.ndarray]:
    """Full symbolic factor structure: struct(j) = rows of L below the
    diagonal in column j = A-pattern(j) ∪ (∪_children struct(c) \\ {j}),
    each sorted and unique.  ``parent``: the elimination tree, whose
    parents follow their children (parent[j] > j), so the columns are
    taken in ascending order."""
    n = A.height
    # A's off-diagonal pattern by column: a_rows[a_ptr[j]:a_ptr[j + 1]]
    # holds the rows i > j, sorted and unique
    rows = np.repeat(np.arange(n), A.row_nnz())
    cols = np.asarray(A.colind, np.int64)
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    key = np.unique((lo * n + hi)[lo != hi])
    a_rows = key % n
    a_ptr = np.searchsorted(key // n, np.arange(n + 1)).tolist()
    # children by parent: kids[c_ptr[j]:c_ptr[j + 1]]
    child = np.nonzero(parent != -1)[0]
    kids = child[np.argsort(parent[child], kind="stable")].tolist()
    c_ptr = np.searchsorted(np.sort(parent[child]), np.arange(n + 1)
                            ).tolist()
    struct: List[np.ndarray] = [None] * n  # type: ignore
    for j in range(n):
        own = a_rows[a_ptr[j]:a_ptr[j + 1]]
        c0, c1 = c_ptr[j], c_ptr[j + 1]
        if c0 == c1:
            struct[j] = own
            continue
        parts = [own] + [struct[c] for c in kids[c0:c1]]
        s = np.concatenate(parts)
        s = s[s > j]
        s.sort()
        struct[j] = s[np.concatenate(([True], s[1:] != s[:-1]))] \
            if s.size else s
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
    # fundamental supernode starts: j starts one unless column j - 1 fuses
    # into it; the cheap tests first, over all columns at once
    lens = np.fromiter((len(st) for st in struct), np.int64, n)
    cand = np.nonzero((parent[:-1] == np.arange(1, n))
                      & (lens[:-1] == lens[1:] + 1))[0] + 1
    fused = np.zeros(n, bool)
    for j in cand.tolist():
        prev = struct[j - 1]
        fused[j] = prev[0] == j and np.array_equal(prev[1:], struct[j])
    fused[0] = False
    starts = np.nonzero(~fused)[0].tolist() + [n]

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
                st = sn.struct
                merged_struct = np.union1d(
                    st[(st < par.cols[0]) | (st >= par.cols[1])],
                    par.struct).astype(np.int64)
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
    # (len(asm_src),) bool: the assembled occurrence lay above the permuted
    # diagonal, so a Hermitian factor takes its conjugate; None when the
    # plan came without its matrix (from_reference without A)
    asm_conj: Optional[np.ndarray] = None


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
    # the tree solve's scatter plan, on the plan's device; set by :meth:`to`
    solve_plan: Optional[SolvePlan] = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def to(self, device) -> "SymbolicFactorization":
        """A copy whose big index arrays (and ``perm``/``iperm``) are
        tensors on ``device``: int32 while ``pool_size < 2**31 - 1``,
        int64 otherwise; with the tree solve's scatter plan
        (``solve_plan.build_solve_plan``), built here once for every solve
        against every factor of the pattern."""
        idt = index_dtype(self.pool_size)

        def conv(a):
            return torch.from_numpy(np.array(a, dtype=idt)).to(device)

        def mask(a):
            return None if a is None else torch.from_numpy(
                np.asarray(a, bool)).to(device)

        levels = [dataclasses.replace(
            lev, asm_conj=mask(lev.asm_conj),
            **{f: conv(getattr(lev, f)) for f in LEVEL_ARRAY_FIELDS})
            for lev in self.levels]
        return dataclasses.replace(
            self, levels=levels, perm=conv(self.perm), iperm=conv(self.iperm),
            solve_plan=build_solve_plan(self).to(device))


def from_reference(obj, A: Optional[SparseMatrix] = None
                   ) -> SymbolicFactorization:
    """Host copy of a symbolic plan made by another implementation with the
    same fields (the JAX package's ``SymbolicFactorization``, on host or
    device): every array becomes an int64 NumPy array.  With the plan's
    matrix ``A``, the Hermitian value map (``LevelPlan.asm_conj``) is
    derived too; without it the copy cannot make a Hermitian factor."""
    i64 = lambda a: np.asarray(a).astype(np.int64)  # noqa: E731
    sns = [Supernode((int(s.cols[0]), int(s.cols[1])), i64(s.struct),
                     int(s.parent), tuple(int(c) for c in s.children),
                     int(s.height)) for s in obj.supernodes]
    iperm = i64(obj.iperm)
    # each stored entry of A: does it lie above the permuted diagonal?
    above = None if A is None else iperm[A.row_ids()] < iperm[A.colind]
    levels = [LevelPlan(i64(lev.sn_ids), i64(lev.ns), int(lev.front_size),
                        int(lev.offset),
                        asm_conj=(None if above is None
                                  else above[i64(lev.asm_src)]),
                        **{f: i64(getattr(lev, f))
                           for f in LEVEL_ARRAY_FIELDS})
              for lev in obj.levels]
    return SymbolicFactorization(int(obj.n), i64(obj.perm), iperm,
                                 sns, levels, int(obj.pool_size),
                                 i64(obj.a_perm_src), int(obj.nnz_factor))


@profiled("el.symbolic.analyze")
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
    # symmetric pair (i,j)/(j,i) maps to the same lower entry — keep one
    # (the first; where it lies above the diagonal, asm_conj says so)
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
    # every front's rows in one sorted key array: supernode·(n+1) + row
    sn_len = np.fromiter((len(r) for r in sn_rows), np.int64, n_sn)
    sn_start = np.cumsum(sn_len) - sn_len
    row_keys = (np.repeat(np.arange(n_sn), sn_len) * (n + 1)
                + np.concatenate(sn_rows))
    rp = np.searchsorted(row_keys, s_of * (n + 1) + prow) - sn_start[s_of]
    asm_dst = sn_off[s_of] + rp * sn_S[s_of] + (pcol - sn_a[s_of])
    asm_lev = sn_lev[s_of]
    asm_dst_all = [asm_dst[asm_lev == li] for li in range(len(levels))]
    asm_src_all = [val_map[asm_lev == li] for li in range(len(levels))]

    # extend-add child → parent: per child one vectorized lower-triangle
    # index grid (reference `childRelInds`, NodeInfo.hpp:27-110); the
    # positions of every child's rows in its parent's front in one search
    sn_par = np.fromiter((sn.parent for sn in sns), np.int64, n_sn)
    sn_ns = np.fromiter((sn.cols[1] - sn.cols[0] for sn in sns), np.int64,
                        n_sn)
    owner = np.repeat(np.arange(n_sn), sn_len)
    host = np.where(sn_par[owner] == -1, owner, sn_par[owner])
    rel_all = (np.searchsorted(row_keys, host * (n + 1) + row_keys % (n + 1))
               - sn_start[host])
    child_dst_all: List[List[np.ndarray]] = [[] for _ in levels]
    child_src_all: List[List[np.ndarray]] = [[] for _ in levels]
    tril_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    grid_cache: Dict[Tuple[int, int], np.ndarray] = {}
    for p, nsc, start, ln, Sc, off_c in zip(
            sn_par.tolist(), sn_ns.tolist(), sn_start.tolist(),
            sn_len.tolist(), sn_S.tolist(), sn_off.tolist()):
        nr = ln - nsc
        if p == -1 or nr == 0:
            continue
        if nr not in tril_cache:
            tril_cache[nr] = np.tril_indices(nr)
        ai, bi = tril_cache[nr]
        if (nr, Sc) not in grid_cache:
            grid_cache[nr, Sc] = ai * Sc + bi
        rel = rel_all[start + nsc:start + ln]
        Sp_ = int(sn_S[p])
        plev_i = int(sn_lev[p])
        child_src_all[plev_i].append(
            grid_cache[nr, Sc] + (off_c + nsc * (Sc + 1)))
        dst = (rel * Sp_)[ai]
        dst += rel[bi]
        dst += int(sn_off[p])
        child_dst_all[plev_i].append(dst)

    # diagonal extraction: column k of the front in slot f sits at
    # offset + (f·S + k)·S + k
    nnz_factor = 0
    for lev_i, lev in enumerate(levels):
        ns = lev.ns
        slot = np.repeat(np.arange(ns.size), ns)
        k = np.arange(int(ns.sum())) - np.repeat(np.cumsum(ns) - ns, ns)
        S = lev.front_size
        diag_dst = lev.offset + (slot * S + k) * S + k
        diag_cols = sn_a[lev.sn_ids][slot] + k
        nnz_factor += int((ns * (ns + 1) // 2
                           + ns * (sn_len[lev.sn_ids] - ns)).sum())
        lev.asm_dst = np.asarray(asm_dst_all[lev_i], np.int64)
        lev.asm_src = np.asarray(asm_src_all[lev_i], np.int64)
        lev.asm_conj = swap[lev.asm_src]
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
