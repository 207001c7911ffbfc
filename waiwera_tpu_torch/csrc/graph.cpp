// Graph routines of the partitioner (counterpart of the graph half of
// waiwera_tpu/native/topology.cpp): reverse Cuthill-McKee ordering and
// the greedy graph-growing partitioner with one refinement sweep.
//
// Both are sequential host algorithms whose results depend on their
// tie-breaks (degree then index in the RCM neighbour sort, the seed
// search from next_seed, the strict gain > best_gain test), so this
// file keeps the reference's loops statement for statement: the port's
// plans then equal the JAX package's element for element. Compiled
// with g++ into a shared library at first use and called through
// ctypes (parallel/graph.py).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <queue>
#include <vector>

extern "C" {

// Reverse Cuthill-McKee ordering of an undirected CSR graph.
// perm[i] = old index of new position i.
void ww_rcm(int64_t n, const int64_t* indptr, const int64_t* indices,
            int64_t* perm) {
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];
  std::vector<char> seen(n, 0);
  std::vector<int64_t> out;
  out.reserve(n);
  std::vector<int64_t> nbrs;
  for (;;) {
    // lowest-degree unseen vertex seeds the next component
    int64_t seed = -1, best = INT64_MAX;
    for (int64_t i = 0; i < n; ++i)
      if (!seen[i] && deg[i] < best) { best = deg[i]; seed = i; }
    if (seed < 0) break;
    seen[seed] = 1;
    std::queue<int64_t> q;
    q.push(seed);
    while (!q.empty()) {
      int64_t u = q.front(); q.pop();
      out.push_back(u);
      nbrs.clear();
      for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
        int64_t v = indices[p];
        if (!seen[v]) { seen[v] = 1; nbrs.push_back(v); }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return deg[a] < deg[b] || (deg[a] == deg[b] && a < b);
      });
      for (int64_t v : nbrs) q.push(v);
    }
  }
  for (int64_t i = 0; i < n; ++i) perm[i] = out[n - 1 - i];
}

// Greedy graph-growing partition: nparts parts grown by BFS from
// minimum-degree seeds, each capped at ceil(n / nparts) vertices;
// leftovers go to the smallest part; then one boundary sweep moves a
// vertex to the neighbouring part of largest positive edge-cut gain
// where that part has room. part[i] in [0, nparts).
void ww_partition_graph(int64_t n, const int64_t* indptr,
                        const int64_t* indices, int64_t nparts,
                        int64_t* part) {
  const int64_t cap = (n + nparts - 1) / nparts;
  std::fill(part, part + n, int64_t(-1));
  std::vector<int64_t> size(nparts, 0);
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];

  int64_t next_seed = 0;
  for (int64_t p = 0; p < nparts; ++p) {
    while (next_seed < n && part[next_seed] >= 0) ++next_seed;
    int64_t seed = -1, best = INT64_MAX;
    for (int64_t i = next_seed; i < n; ++i)
      if (part[i] < 0 && deg[i] < best) { best = deg[i]; seed = i; }
    if (seed < 0) break;
    std::queue<int64_t> q;
    q.push(seed);
    part[seed] = p;
    ++size[p];
    while (!q.empty() && size[p] < cap) {
      int64_t u = q.front(); q.pop();
      for (int64_t e = indptr[u]; e < indptr[u + 1] && size[p] < cap;
           ++e) {
        int64_t v = indices[e];
        if (part[v] < 0) { part[v] = p; ++size[p]; q.push(v); }
      }
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    if (part[i] < 0) {
      int64_t p = int64_t(
          std::min_element(size.begin(), size.end()) - size.begin());
      part[i] = p;
      ++size[p];
    }
  }
  for (int64_t u = 0; u < n; ++u) {
    int64_t pu = part[u];
    if (size[pu] <= 1) continue;
    int64_t best_p = pu, best_gain = 0;
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      int64_t pv = part[indices[e]];
      if (pv == pu) continue;
      if (size[pv] >= cap) continue;
      int64_t gain = 0;
      for (int64_t e2 = indptr[u]; e2 < indptr[u + 1]; ++e2) {
        int64_t pw = part[indices[e2]];
        if (pw == pv) ++gain;
        else if (pw == pu) --gain;
      }
      if (gain > best_gain) { best_gain = gain; best_p = pv; }
    }
    if (best_p != pu) {
      --size[pu];
      ++size[best_p];
      part[u] = best_p;
    }
  }
}

}  // extern "C"
