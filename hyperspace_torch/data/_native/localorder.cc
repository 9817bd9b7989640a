// BFS locality relabeling: native twin of
// hyperspace_torch.data.graphs._locality_order_python (same traversal
// and tie-breaking; tests/test_torch_native_prep.py asserts exact
// equality).  Real citation graphs arrive with random ids; this one-time
// host pass turns community structure into (receiver-block x
// sender-block) locality for the cluster kernels, and the Python BFS is
// the slowest host-prep stage at arxiv scale.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// edges: [n_edges, 2] int32 (u, v) pairs, undirected semantics.
// order_out: [num_nodes] int64, order_out[rank] = old id.
void locality_order(const int32_t* edges, int64_t n_edges,
                    int32_t num_nodes, int64_t* order_out) {
  const int64_t n = num_nodes;
  // Stable source-major adjacency of the doubled edge list [e; e_rev]:
  // all forward edges of u (ascending index) precede all reversed ones
  // — exactly the order np.argsort(e[:, 0], kind="stable") yields.
  std::vector<int64_t> indptr(n + 1, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    ++indptr[edges[2 * i] + 1];
    ++indptr[edges[2 * i + 1] + 1];
  }
  std::partial_sum(indptr.begin(), indptr.end(), indptr.begin());
  std::vector<int32_t> nbr(indptr[n]);
  std::vector<int64_t> fill(indptr.begin(), indptr.end() - 1);
  for (int64_t i = 0; i < n_edges; ++i)
    nbr[fill[edges[2 * i]]++] = edges[2 * i + 1];
  for (int64_t i = 0; i < n_edges; ++i)
    nbr[fill[edges[2 * i + 1]]++] = edges[2 * i];

  // Seeds: degree descending, ties by node id — np.argsort(-deg, stable).
  std::vector<int32_t> seeds(n);
  std::iota(seeds.begin(), seeds.end(), 0);
  std::stable_sort(seeds.begin(), seeds.end(), [&](int32_t a, int32_t b) {
    return indptr[a + 1] - indptr[a] > indptr[b + 1] - indptr[b];
  });

  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> queue;
  queue.reserve(n);
  int64_t pos = 0, qhead = 0, si = 0;
  while (pos < n) {
    while (si < n && visited[seeds[si]]) ++si;
    const int32_t root = seeds[si];
    visited[root] = 1;
    queue.push_back(root);
    while (qhead < static_cast<int64_t>(queue.size())) {
      const int32_t u = queue[qhead++];
      order_out[pos++] = u;
      for (int64_t j = indptr[u]; j < indptr[u + 1]; ++j) {
        const int32_t v = nbr[j];
        if (!visited[v]) {
          visited[v] = 1;
          queue.push_back(v);
        }
      }
    }
  }
}

}  // extern "C"
