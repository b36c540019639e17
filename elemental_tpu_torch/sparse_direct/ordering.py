"""Fill-reducing orderings (reference ``src/lapack_like/factor/LDL/sparse/
symbolic/NestedDissection.cpp``: recursive graph bisection with minimum-degree
leaves, ``:17-56``).

Host-side NumPy plus the native minimum-degree and reverse Cuthill-McKee
kernels, ported as they are from ``elemental_tpu/sparse_direct/ordering.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..sparse.csr import Graph, SparseMatrix


def _adjacency(A) -> List[np.ndarray]:
    """Symmetrized adjacency lists without self-loops."""
    if isinstance(A, SparseMatrix):
        g = A.graph()
    else:
        g = A
    g = g.symmetrize()
    n = g.num_sources
    adj = []
    for i in range(n):
        nb = g.neighbors(i)
        adj.append(nb[nb != i])
    return adj


def minimum_degree(A) -> np.ndarray:
    """Minimum-degree ordering (quotient-graph, native C++)."""
    from . import native
    return native.minimum_degree(_adjacency(A))


def _sym_pattern_csr(A) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetrized CSR pattern, no self loops (native-kernel input form)."""
    import scipy.sparse as sp
    g = A.graph() if isinstance(A, SparseMatrix) else A
    pat = sp.csr_matrix(
        (np.ones(g.num_edges, np.int8), g.colind, g.rowptr),
        shape=(g.num_sources, g.num_targets))
    pat = (pat + pat.T).tocsr()
    pat.setdiag(0)
    pat.eliminate_zeros()
    return pat.indptr.astype(np.int64), pat.indices.astype(np.int64)


def reverse_cuthill_mckee(A) -> np.ndarray:
    """RCM band-reducing ordering (bandwidth → DIA-kernel friendliness), by
    the native C++ kernel (``el_rcm``); there is no Python fallback."""
    from . import native
    return native.rcm(*_sym_pattern_csr(A))


def _pseudo_peripheral(adj: List[np.ndarray], nodes: np.ndarray) -> int:
    """BFS-based pseudo-peripheral node within the ``nodes`` subgraph."""
    inset = np.zeros(len(adj), bool)
    inset[nodes] = True
    start = int(nodes[0])
    for _ in range(3):
        # BFS from start
        dist = {start: 0}
        frontier = [start]
        last = start
        while frontier:
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if inset[v] and v not in dist:
                        dist[v] = dist[u] + 1
                        nxt.append(int(v))
            if nxt:
                last = nxt[-1]
            frontier = nxt
        if last == start:
            break
        start = last
    return start


def bisect(adj: List[np.ndarray], nodes: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a subgraph into (left, right, separator) by BFS level sets from
    a pseudo-peripheral node (the reference's graph-bisection step)."""
    inset = np.zeros(len(adj), bool)
    inset[nodes] = True
    src = _pseudo_peripheral(adj, nodes)
    # level sets
    level = {src: 0}
    frontier = [src]
    order = [src]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if inset[v] and v not in level:
                    level[v] = level[u] + 1
                    nxt.append(int(v))
                    order.append(int(v))
        frontier = nxt
    # disconnected remainder: put in left half
    unreached = [int(v) for v in nodes if int(v) not in level]
    half = (len(order) + len(unreached)) // 2
    left = order[:half]
    # separator = boundary of left inside right
    leftset = set(left)
    right = [v for v in order[half:]]
    sep = []
    keep_right = []
    for v in right:
        if any((u in leftset) for u in adj[v] if inset[u]):
            sep.append(v)
        else:
            keep_right.append(v)
    left.extend(unreached)
    return (np.array(left, np.int64), np.array(keep_right, np.int64),
            np.array(sep, np.int64))


def nested_dissection(A, cutoff: int = 64) -> np.ndarray:
    """Recursive nested dissection (reference ``NestedDissection.cpp:79``):
    bisect until subgraphs are below ``cutoff``, order leaves by minimum
    degree, separators last.  Returns a permutation (new ← old)."""
    adj = _adjacency(A)
    n = len(adj)
    perm_out: List[int] = []

    def sub_md(nodes: np.ndarray) -> List[int]:
        if len(nodes) <= 1:
            return [int(v) for v in nodes]
        # restrict to the subgraph and run minimum degree
        loc = {int(v): i for i, v in enumerate(nodes)}
        sub = [np.array([loc[int(u)] for u in adj[int(v)]
                         if int(u) in loc], np.int64) for v in nodes]
        sub_adj_graph = Graph.from_edges(
            len(nodes), len(nodes),
            np.concatenate([np.full(len(s), i) for i, s in enumerate(sub)])
            if any(len(s) for s in sub) else np.array([], np.int64),
            np.concatenate(sub) if any(len(s) for s in sub)
            else np.array([], np.int64))
        p = minimum_degree(sub_adj_graph)
        return [int(nodes[i]) for i in p]

    def recurse(nodes: np.ndarray) -> List[int]:
        if len(nodes) <= cutoff:
            return sub_md(nodes)
        left, right, sep = bisect(adj, nodes)
        if len(sep) == 0 or len(left) == 0 or len(right) == 0:
            return sub_md(nodes)
        return recurse(left) + recurse(right) + [int(v) for v in sep]

    perm_out = recurse(np.arange(n))
    return np.asarray(perm_out, np.int64)
