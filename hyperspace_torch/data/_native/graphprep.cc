// Native graph preparation: the host side of
// hyperspace_torch.data.graphs.prepare (symmetrize, self-loops, dedupe,
// receiver-major sort, pad, reverse-edge involution, in-degree) for
// arxiv-scale edge lists.  The numpy implementation stays as the
// fallback and the parity oracle (tests/test_torch_native_prep.py).
//
// Plain C ABI for ctypes (hyperspace_torch/data/native.py); the caller
// owns numpy buffers and we copy into them.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct PreparedGraph {
  std::vector<int32_t> senders, receivers, rev_perm;
  std::vector<uint8_t> mask;
  std::vector<float> deg;
  int64_t e_pad = 0;
};

// Builds the padded, receiver-sorted symmetric edge layout.
// edges: [n_edges, 2] int32 (sender, receiver) pairs.
// Returns an opaque handle; *out_e_pad receives the padded edge count.
void* graph_prepare(const int32_t* edges, int64_t n_edges, int32_t num_nodes,
                    int32_t symmetrize, int32_t self_loops,
                    int64_t pad_multiple, int64_t* out_e_pad) {
  const int64_t n = num_nodes;
  std::vector<int64_t> keys;  // receiver-major flat key: r * n + s
  keys.reserve((symmetrize ? 2 * n_edges : n_edges) +
               (self_loops ? n : 0));
  for (int64_t i = 0; i < n_edges; ++i) {
    const int64_t s = edges[2 * i], r = edges[2 * i + 1];
    keys.push_back(r * n + s);
    if (symmetrize) keys.push_back(s * n + r);
  }
  if (self_loops)
    for (int64_t v = 0; v < n; ++v) keys.push_back(v * n + v);
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());

  const int64_t e = static_cast<int64_t>(keys.size());
  const int64_t m = pad_multiple > 0 ? pad_multiple : 1;
  const int64_t e_pad = ((std::max<int64_t>(e, 1) + m - 1) / m) * m;

  auto* out = new PreparedGraph();
  out->e_pad = e_pad;
  out->senders.assign(e_pad, num_nodes - 1);   // padding: (N-1, N-1)
  out->receivers.assign(e_pad, num_nodes - 1);
  out->mask.assign(e_pad, 0);
  out->rev_perm.resize(e_pad);
  out->deg.assign(n, 0.0f);
  for (int64_t i = 0; i < e_pad; ++i)
    out->rev_perm[i] = static_cast<int32_t>(i);  // padding maps to itself
  for (int64_t i = 0; i < e; ++i) {
    const int64_t r = keys[i] / n, s = keys[i] % n;
    out->senders[i] = static_cast<int32_t>(s);
    out->receivers[i] = static_cast<int32_t>(r);
    out->mask[i] = 1;
    out->deg[r] += 1.0f;
    if (symmetrize) {
      // reverse of (s, r) has key s*n + r; keys are sorted & complete
      const int64_t rev = std::lower_bound(keys.begin(), keys.end(),
                                           s * n + r) - keys.begin();
      out->rev_perm[i] = static_cast<int32_t>(rev);
    }
  }
  *out_e_pad = e_pad;
  return out;
}

void graph_prepare_copy(void* handle, int32_t* senders, int32_t* receivers,
                        uint8_t* mask, int32_t* rev_perm, float* deg,
                        int32_t num_nodes) {
  auto* g = static_cast<PreparedGraph*>(handle);
  std::memcpy(senders, g->senders.data(), g->e_pad * sizeof(int32_t));
  std::memcpy(receivers, g->receivers.data(), g->e_pad * sizeof(int32_t));
  std::memcpy(mask, g->mask.data(), g->e_pad * sizeof(uint8_t));
  std::memcpy(rev_perm, g->rev_perm.data(), g->e_pad * sizeof(int32_t));
  std::memcpy(deg, g->deg.data(), num_nodes * sizeof(float));
}

void graph_prepare_free(void* handle) {
  delete static_cast<PreparedGraph*>(handle);
}

}  // extern "C"
