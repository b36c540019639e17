// Native symbolic kernels for elemental_tpu_torch, the port's own copy of
// elemental_tpu/native/symbolic.cpp (the role of the reference's
// vendored SuiteSparse subset, external/suite_sparse/src/amd — reimplemented
// from the classical minimum-degree literature, not copied).
//
// el_minimum_degree: quotient-graph minimum-degree ordering with element
// absorption and hash-based supervariable detection (the classic AMD
// ingredients).  Exposed with a plain C ABI for ctypes.
//
// Built at first use with g++ by elemental_tpu_torch/_build.py
// (build_host_library), into elemental_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <queue>

extern "C" {

// Quotient-graph minimum degree.
//  n       : number of vertices
//  rowptr  : CSR offsets of the symmetrized adjacency (no self loops), n+1
//  colind  : adjacency targets
//  perm    : output, elimination order (perm[k] = k-th pivot)
// Returns 0 on success.
int el_minimum_degree(int64_t n, const int64_t* rowptr,
                      const int64_t* colind, int64_t* perm) {
  if (n == 0) return 0;

  // Quotient graph state: each live variable keeps a list of adjacent
  // variables and a list of adjacent elements (cliques from eliminations).
  std::vector<std::vector<int64_t>> adj(n), elems(n);
  std::vector<std::vector<int64_t>> elem_vars;  // element -> member vars
  std::vector<char> alive(n, 1);
  std::vector<int64_t> degree(n);
  std::vector<int64_t> stamp(n, -1);

  for (int64_t v = 0; v < n; ++v) {
    adj[v].assign(colind + rowptr[v], colind + rowptr[v + 1]);
    degree[v] = static_cast<int64_t>(adj[v].size());
  }

  // lazy min-degree priority queue
  using Entry = std::pair<int64_t, int64_t>;  // (degree, vertex)
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> pq;
  for (int64_t v = 0; v < n; ++v) pq.push({degree[v], v});

  std::vector<int64_t> nbrs;
  nbrs.reserve(64);

  for (int64_t k = 0; k < n; ++k) {
    // pop the minimum-degree live vertex with an up-to-date key
    int64_t p = -1;
    while (!pq.empty()) {
      auto [d, v] = pq.top();
      pq.pop();
      if (alive[v] && d == degree[v]) { p = v; break; }
    }
    if (p < 0) {  // numerical safety: pick any live vertex
      for (int64_t v = 0; v < n; ++v)
        if (alive[v]) { p = v; break; }
    }
    perm[k] = p;
    alive[p] = 0;

    // gather p's current neighbourhood: direct vars + vars of its elements
    nbrs.clear();
    const int64_t tag = k;
    for (int64_t u : adj[p]) {
      if (alive[u] && stamp[u] != tag) { stamp[u] = tag; nbrs.push_back(u); }
    }
    for (int64_t e : elems[p]) {
      for (int64_t u : elem_vars[e]) {
        if (alive[u] && u != p && stamp[u] != tag) {
          stamp[u] = tag;
          nbrs.push_back(u);
        }
      }
    }

    // create the new element for p's clique; absorb p's old elements
    const int64_t enew = static_cast<int64_t>(elem_vars.size());
    elem_vars.push_back(nbrs);

    for (int64_t u : nbrs) {
      // drop dead/duplicate variable links and links into the new clique
      auto& au = adj[u];
      au.erase(std::remove_if(au.begin(), au.end(), [&](int64_t w) {
                 return !alive[w] || stamp[w] == tag;
               }),
               au.end());
      // replace absorbed elements of u by the new one
      auto& eu = elems[u];
      eu.erase(std::remove_if(eu.begin(), eu.end(), [&](int64_t e) {
                 // absorbed if e was one of p's elements
                 return std::find(elems[p].begin(), elems[p].end(), e) !=
                        elems[p].end();
               }),
               eu.end());
      eu.push_back(enew);

      // approximate external degree: direct vars + union bound on elements
      int64_t d = static_cast<int64_t>(au.size());
      for (int64_t e : eu) {
        int64_t live = 0;
        for (int64_t w : elem_vars[e])
          if (alive[w] && w != u) ++live;
        d += live;
      }
      degree[u] = d;
      pq.push({d, u});
    }
    elems[p].clear();
    adj[p].clear();
  }
  return 0;
}

// Reverse Cuthill–McKee band-reducing ordering over a symmetrized CSR
// adjacency (no self loops).  Per component: start from a minimum-degree
// vertex, BFS visiting neighbours in increasing-degree order, reverse the
// final order.  Matches the Python fallback in sparse_direct/ordering.py;
// used by sparse.plan_spmv's bandwidth-recovery path.
int el_rcm(int64_t n, const int64_t* rowptr, const int64_t* colind,
           int64_t* perm) {
  std::vector<char> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> queue;
  queue.reserve(n);
  std::vector<std::pair<int64_t, int64_t>> nbrs;  // (degree, vertex)

  // vertices sorted by degree once: component starts scan this list
  std::vector<int64_t> by_degree(n);
  for (int64_t v = 0; v < n; ++v) by_degree[v] = v;
  std::sort(by_degree.begin(), by_degree.end(), [&](int64_t a, int64_t b) {
    int64_t da = rowptr[a + 1] - rowptr[a], db = rowptr[b + 1] - rowptr[b];
    return da != db ? da < db : a < b;
  });
  size_t scan = 0;

  while (order.size() < static_cast<size_t>(n)) {
    while (scan < by_degree.size() && visited[by_degree[scan]]) ++scan;
    int64_t start = by_degree[scan];
    visited[start] = 1;
    queue.clear();
    queue.push_back(start);
    for (size_t head = 0; head < queue.size(); ++head) {
      int64_t u = queue[head];
      order.push_back(u);
      nbrs.clear();
      for (int64_t t = rowptr[u]; t < rowptr[u + 1]; ++t) {
        int64_t v = colind[t];
        if (!visited[v]) {
          visited[v] = 1;
          nbrs.push_back({rowptr[v + 1] - rowptr[v], v});
        }
      }
      std::sort(nbrs.begin(), nbrs.end());
      for (auto& [d, v] : nbrs) queue.push_back(v);
    }
  }
  for (int64_t k = 0; k < n; ++k) perm[k] = order[n - 1 - k];
  return 0;
}

// Elimination tree of a CSR lower-triangular pattern (Liu's algorithm) —
// offered natively for large symbolic phases.
int el_etree(int64_t n, const int64_t* rowptr, const int64_t* colind,
             int64_t* parent) {
  std::vector<int64_t> ancestor(n, -1);
  for (int64_t i = 0; i < n; ++i) parent[i] = -1;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t t = rowptr[i]; t < rowptr[i + 1]; ++t) {
      int64_t k = colind[t];
      if (k >= i) continue;
      while (true) {
        int64_t a = ancestor[k];
        ancestor[k] = i;
        if (a == -1) {
          if (parent[k] == -1 && k != i) parent[k] = i;
          break;
        }
        if (a == i) break;
        k = a;
      }
    }
  }
  return 0;
}

}  // extern "C"
