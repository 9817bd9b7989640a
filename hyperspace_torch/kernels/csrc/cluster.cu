// Cluster-pair aggregation over the clustered edges, for sm_90a: the
// mean path's weighted sum and the attention arm's forward and backward.
//
// Replaces three Pallas kernels of hyperspace_tpu/kernels/cluster.py:
//   - `cluster_aggregate` (built by `_body`): out[r] = Σ_e w_e · h[s_e];
//   - `cluster_att_fwd` (`_att_fwd_body`): the unnormalised attention
//     partials out[r] = Σ_e w_e · [h[s_e] | 1], with the weight computed
//     in the tile from the two scores, w_e = exp(B·tanh(leaky(α_s[s_e] +
//     α_r[r_e]) / B));
//   - `cluster_att_bwd` (`_att_bwd_body`): from the cotangent g = (d_num |
//     d_den), dh, dα_s and dα_r, each indexed by receiver through the
//     edge involution (the clustered set is closed under reversal):
//         dh[i]   = Σ_{e: r_e = i} w_rev(e) · d_num[s_e]
//         dα_r[i] = Σ_{e: r_e = i} dpre_e
//         dα_s[i] = Σ_{e: r_e = i} dpre_rev(e)
//     with w_rev(e) = f(α_s[r_e] + α_r[s_e]) the reverse edge's weight,
//     dw_e = <d_num[r_e], h[s_e]> + d_den[r_e], dpre_e = dw_e · f'(pre_e).
// The TPU kernels walk (receiver block, sender block) plan items and turn
// each 128-edge sub-chunk into one-hot matrix products, so that no [E, F]
// array is written: the TPU has no atomics and no fast scatter.  Here a
// row's sum has one owner that gathers sender rows directly; no [E, F]
// array is written either.
//
// What bounds them on an H100: bytes — h read once, a sender and a weight
// an edge, a row pointer a row, the outputs written once (0.029 ms at h
// [169,343, 128] bf16 for the aggregation).  What stands between the
// kernels and that bound is the gather of one sender row an edge (5.6
// edges a row, so h is read about six times over, from L2): the design
// keeps those reads in flight and spends little else an edge.
//   1. The three kernels read a row plan built once per graph
//      (kernels/cluster.py `ClusterRows`); nothing is sorted at a launch,
//      and the step keeps its edges and weights in the plan's row order.
//      A unit of G lanes (a lane group) takes a span of whole rows with
//      about equal edges (`unit_span`); there are as many units as the
//      card holds threads at once (the occupancy API; four times as many
//      for the backward past 64 columns).  A unit walks its slots D at a
//      time, the next step's index entries loading while this step's rows
//      arrive; each lane holds V columns (16-byte loads where the pitch
//      and the pointer allow: V = 8 bf16 or 4 f32; else 8-byte bf16
//      loads, V = 4), G fitted to the width (bf16 h: 4 lanes a row at F =
//      32 and 16 at 128 in the aggregation and the forward; the backward
//      keeps V = 4, 8 and 32 lanes); a row is written when its last slot
//      is summed, and its empty rows as 0.
//   2. The aggregation and the attention forward are one walk
//      (`agg_rows_kernel`): the forward computes each slot's weight from
//      the two scores (the sender's α_s prefetched with the step's ids,
//      one bounded-logit weight a lane a step, shared in the group by
//      shuffles) and sums the weights into den beside the columns.
//   3. The backward reduces each slot's dot inside its lane group, the D
//      slots of a step together (`group_reduce`), and takes dα_r through
//      the involution: at slot j it computes only the reverse edge's dpre
//      from the d_num row that dh needs anyway (one bounded-logit weight
//      a slot, not two), adds it to dα_s and writes it to an [E] scratch
//      at rev(j); `row_sum_kernel` sums the scratch by row into dα_r.
//   A row has one owner and sums its edges in arrival order: no atomics,
//   and the results are deterministic (the aggregation's and the
//   forward's bits are those of the ranking kernel they replaced: the
//   same products in the same order).

// bf16 mode, as the TPU kernels' (`fast_bf16`): a bf16 h takes its
// weights rounded to bf16 before the product (the aggregation's w, the
// attention forward's w, the backward's w_rev), and the backward rounds
// the cotangent rows to bf16 before every use; products of two bf16
// values are exact in f32.  The scores and the backward's f'(pre) stay
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int ROW_THREADS = 256;  // the row-plan kernels' blocks
constexpr int ROW_DEPTH = 4;      // slots whose rows a group reads at once
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bounded-logit softmax weight w = exp(B·tanh(leaky(pre)/B)) and its
// derivative w·(1 − tanh²)·leaky'(pre), in the TPU kernel's order
// (`_att_squash`), explicitly rounded.
__device__ __forceinline__ float squash(float pre, float bound, float slope,
                                        float* dfac) {
  const bool pos = pre >= 0.0f;
  const float lam = pos ? pre : __fmul_rn(slope, pre);
  const float th = tanhf(__fdiv_rn(lam, bound));
  const float w = expf(__fmul_rn(bound, th));
  if (dfac != nullptr)
    *dfac = __fmul_rn(__fmul_rn(w, __fsub_rn(1.0f, __fmul_rn(th, th))),
                      pos ? 1.0f : slope);
  return w;
}

// --- the row plan: the aggregation and the attention backward ---------------
//
// The plan (built once per graph, kernels/cluster.py `ClusterRows`) gives
// the clustered edges in row order, each row's edges in arrival order:
// row_ptr [n + 1], and for each slot j its receiver recv[j] (ascending),
// its sender send[j] and the slot rev[j] of its reverse edge.  The step
// keeps its weights in the same order (nn/scatter.py `ClusterAgg`).

// Lane groups: G lanes own a row at a time; lane q of a group holds the V
// columns from c0 + V·(q + G·k), k < NV, of that row (V = 4 when the rows
// allow 8- or 16-byte loads, else 1).
template <int G, int V>
__device__ __forceinline__ int lane_col(int c0, int q, int k) {
  return c0 + V * (q + G * k);
}

// V columns of T as one load brings them, kept packed until summed.
template <typename T, int V>
struct Cols;
template <>
struct Cols<float, 4> {
  using raw = float4;
};
template <>
struct Cols<float, 1> {
  using raw = float;
};
template <>
struct Cols<__nv_bfloat16, 4> {
  using raw = uint2;
};
template <>
struct Cols<__nv_bfloat16, 8> {
  using raw = uint4;
};
template <>
struct Cols<__nv_bfloat16, 1> {
  using raw = unsigned short;
};
template <typename T, int V>
using Raw = typename Cols<T, V>::raw;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  return __ldg(reinterpret_cast<const Raw<T, V>*>(p));
}
__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void unpack(float4 v, float* x) {
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void unpack(float v, float* x) { x[0] = v; }
__device__ __forceinline__ void unpack(uint2 v, float* x) {
  x[0] = bf16_lo(v.x), x[1] = bf16_hi(v.x);
  x[2] = bf16_lo(v.y), x[3] = bf16_hi(v.y);
}
__device__ __forceinline__ void unpack(uint4 v, float* x) {
  x[0] = bf16_lo(v.x), x[1] = bf16_hi(v.x);
  x[2] = bf16_lo(v.y), x[3] = bf16_hi(v.y);
  x[4] = bf16_lo(v.z), x[5] = bf16_hi(v.z);
  x[6] = bf16_lo(v.w), x[7] = bf16_hi(v.w);
}
__device__ __forceinline__ void unpack(unsigned short v, float* x) {
  x[0] = bf16_lo(v);
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <int V>
__device__ __forceinline__ void store_cols(float* p, const float* x) {
  if (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    p[0] = x[0];
}
template <int V>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p, const float* x) {
  if (V == 8)
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_bits(x[0]) | bf16_bits(x[1]) << 16,
                   bf16_bits(x[2]) | bf16_bits(x[3]) << 16,
                   bf16_bits(x[4]) | bf16_bits(x[5]) << 16,
                   bf16_bits(x[6]) | bf16_bits(x[7]) << 16);
  else if (V == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_bits(x[0]) | bf16_bits(x[1]) << 16,
                   bf16_bits(x[2]) | bf16_bits(x[3]) << 16);
  else
    p[0] = __float2bfloat16_rn(x[0]);
}

// D partial sums a lane, over a group of G lanes (D ≤ G, both powers of
// 2): halving exchanges, then a butterfly.  Returns the total of edge
// q / (G / D) (lane q of the group): D − 1 + log2(G / D) shuffles for the
// D edges, not D·log2(G).
template <int G, int D>
__device__ __forceinline__ float group_reduce(float (&p)[D], int q) {
#pragma unroll
  for (int half = D / 2, off = G / 2; half >= 1; half >>= 1, off >>= 1) {
    const bool upper = (q & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float give = upper ? p[i] : p[i + half];
      const float keep = upper ? p[i + half] : p[i];
      p[i] = keep + __shfl_xor_sync(FULL, give, off);
    }
  }
  float v = p[0];
#pragma unroll
  for (int off = G / (2 * D); off >= 1; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The rows unit u of `units` owns: those whose first slot lies in
// [u·e/units, (u+1)·e/units), the last unit also those that start at e
// (empty rows at the end); and their slots [j0, j1).  Units get about
// equal slots, whole rows each: a row has one owner.
__device__ __forceinline__ void unit_span(int u, int units, int e, int n,
                                          const int* __restrict__ recv,
                                          const int* __restrict__ row_ptr,
                                          int& r_lo, int& r_hi, int& j0,
                                          int& j1) {
  const long long b0 = (long long)u * e / units;
  const long long b1 = (long long)(u + 1) * e / units;
  r_lo = b0 == 0 ? 0 : __ldg(recv + b0 - 1) + 1;
  r_hi = u + 1 == units ? n : (b1 == 0 ? 0 : __ldg(recv + b1 - 1) + 1);
  j0 = __ldg(row_ptr + r_lo);
  j1 = __ldg(row_ptr + r_hi);
}

// The output of a row walk: T (the aggregation) or f32 (the attention
// forward's num | den).
template <typename T, bool ATT>
using Out = std::conditional_t<ATT, float, T>;

// out[i] = Σ_{j in row i} w_j · h[send[j]], in slot order; grid.y tiles
// the columns by V·G·NV.  ATT false (the aggregation): w_j = w[j] (in
// slot order), out [n, f] of T.  ATT true (the attention forward): w_j =
// squash(α_s[send[j]] + α_r[i]) from the scores, out [n, f + 1] f32 with
// Σ w_j in column f.  Lane q of a group computes the weight of the
// step's slot q / (G / D) and the group shares it by shuffles: one
// squash a lane a step, not D.  The attention output's pitch (f + 1
// floats) leaves its rows past the first off 16-byte boundaries, so it
// takes 4-byte stores (coalesced across the group); its h loads keep V.
template <typename T, int G, int V, int NV, bool ATT>
__global__ void __launch_bounds__(ROW_THREADS)
agg_rows_kernel(const T* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ a_s, const float* __restrict__ a_r,
                const int* __restrict__ row_ptr, const int* __restrict__ recv,
                const int* __restrict__ send, Out<T, ATT>* __restrict__ out,
                int n, int f, int e, float bound, float slope) {
  constexpr int D = ROW_DEPTH;
  static_assert(D <= G, "a step's weights are computed inside one group");
  constexpr int SUB = G / D;  // lanes that compute one slot's weight
  const bool bf16 = sizeof(T) == 2;
  const int q = threadIdx.x & (G - 1);
  const int mine = q / SUB;
  const int c0 = blockIdx.y * (V * G * NV);
  const int pitch = ATT ? f + 1 : f;
  const bool den_lane = ATT && q == 0 && blockIdx.y == 0;
  int col[NV];
  bool live[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    col[k] = lane_col<G, V>(c0, q, k);
    live[k] = col[k] < f;
  }
  int r_lo, r_hi, j, j1;
  unit_span(blockIdx.x * (ROW_THREADS / G) + threadIdx.x / G,
            gridDim.x * (ROW_THREADS / G), e, n, recv, row_ptr, r_lo, r_hi,
            j, j1);
  // row r's columns of this tile, and its den (ATT)
  auto put = [&](int r, const float (&x)[NV][V], float den) {
    Out<T, ATT>* o = out + (size_t)r * pitch;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!live[k]) continue;
      if constexpr (ATT) {
#pragma unroll
        for (int i = 0; i < V; ++i) o[col[k] + i] = x[k][i];
      } else {
        store_cols<V>(o + col[k], x[k]);
      }
    }
    if constexpr (ATT) {
      if (den_lane) o[f] = den;
    }
  };
  const float zero[NV][V] = {};
  auto zero_rows = [&](int a, int b) {
    for (int r = a; r < b; ++r) put(r, zero, 0.0f);
  };
  zero_rows(r_lo, j < j1 ? __ldg(recv + j) : r_hi);

  // every lane of the warp walks the same number of steps (groups past
  // their end idle), D slots a step; a slot past j1 reads as row r_hi
  const int steps = __reduce_max_sync(FULL, (unsigned)(j1 - j + D - 1) / D);
  int s_n[D], r_n[D];
  float w_n[D] = {};              // the slots' weights (the aggregation)
  float as_n = 0.0f, ar_n = 0.0f;  // this lane's slot's scores (ATT)
  auto meta = [&](int jb) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const bool ok = jb + d < j1;
      s_n[d] = ok ? __ldg(send + jb + d) : 0;
      r_n[d] = ok ? __ldg(recv + jb + d) : r_hi;
      if (!ATT) w_n[d] = ok ? __ldg(w + jb + d) : 0.0f;
    }
    if (ATT) {
      int sm = 0, rm = r_hi;
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (d == mine) sm = s_n[d], rm = r_n[d];
      const bool ok = rm < r_hi;
      as_n = ok ? __ldg(a_s + sm) : 0.0f;
      ar_n = ok ? __ldg(a_r + rm) : 0.0f;
    }
  };
  meta(j);
  float acc[NV][V] = {};
  float den = 0.0f;
  for (int it = 0; it < steps; ++it, j += D) {
    int r[D];
    float wt[D];
    Raw<T, V> v[D][NV];
    const float pre = __fadd_rn(as_n, ar_n);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      r[d] = r_n[d];
      wt[d] = w_n[d];
      const bool ok = r[d] < r_hi;
      const T* row = h + (size_t)s_n[d] * f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
        v[d][k] = ok && live[k] ? load_raw<T, V>(row + col[k]) : Raw<T, V>{};
    }
    meta(j + D);  // the next step's slots load while this one sums
    float wm = 0.0f;
    if (ATT) {
      wm = squash(pre, bound, slope, nullptr);
      if (bf16) wm = round_bf16(wm);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float wd = ATT ? __shfl_sync(FULL, wm, d * SUB, G)
                           : (bf16 ? round_bf16(wt[d]) : wt[d]);
      if (r[d] >= r_hi) continue;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        float x[V];
        unpack(v[d][k], x);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[k][i] = fmaf(wd, x[i], acc[k][i]);
      }
      if (ATT) den = __fadd_rn(den, wd);
      const int next = d + 1 < D ? r[d + 1] : r_n[0];
      if (next != r[d]) {  // row r[d] ends here
        put(r[d], acc, den);
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int i = 0; i < V; ++i) acc[k][i] = 0.0f;
        den = 0.0f;
        zero_rows(r[d] + 1, next);
      }
    }
  }
}

// g [n, f + 1] f32 (d_num | d_den), h [n, f]; writes dh [n, f], das [n]
// and the per-slot terms scratch [e], all f32.  Slot j of row i with
// sender s: w_rev = f(α_s[i] + α_r[s]) (the reverse edge's weight) and
// t = (<d_num[s], h[i]> + d_den[s]) · f'(α_s[i] + α_r[s]), the reverse
// edge's dpre; dh[i] = Σ w_rev · d_num[s], das[i] = Σ t, and t is dα_r's
// term of the reverse slot: scratch[rev(j)] = t, which `row_sum_kernel`
// sums by row.  Columns past V·G·NV (TAIL) are read and summed in dh in
// place.
template <typename T, int G, int V, int NV, bool TAIL>
__global__ void __launch_bounds__(ROW_THREADS)
att_bwd_rows_kernel(const float* __restrict__ g, const T* __restrict__ h,
                    const float* __restrict__ a_s,
                    const float* __restrict__ a_r,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ recv,
                    const int* __restrict__ send, const int* __restrict__ rev,
                    float* __restrict__ dh, float* __restrict__ das,
                    float* __restrict__ scratch, int n, int f, int e,
                    float bound, float slope) {
  constexpr int D = ROW_DEPTH;
  static_assert(D <= G, "a step's slots reduce inside one lane group");
  constexpr int SUB = G / D;  // lanes that end up holding one slot's dot
  constexpr int CT = V * G * NV;
  const bool bf16 = sizeof(T) == 2;
  auto gv = [&](float x) { return bf16 ? round_bf16(x) : x; };
  const int g1 = f + 1;
  const int q = threadIdx.x & (G - 1);
  const int mine = q / SUB;  // the slot of a step whose scalars lane q takes
  int col[NV];
  bool live[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    col[k] = lane_col<G, V>(0, q, k);
    live[k] = col[k] < f;
  }
  int r_lo, r_hi, j, j1;
  unit_span(blockIdx.x * (ROW_THREADS / G) + threadIdx.x / G,
            gridDim.x * (ROW_THREADS / G), e, n, recv, row_ptr, r_lo, r_hi,
            j, j1);
  if (TAIL)
    for (int r = r_lo; r < r_hi; ++r)
      for (int c = CT + q; c < f; c += G) dh[(size_t)r * f + c] = 0.0f;
  const float zero[V] = {};
  auto zero_rows = [&](int a, int b) {
    for (int r = a; r < b; ++r) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (live[k]) store_cols<V>(dh + (size_t)r * f + col[k], zero);
      if (q == 0) das[r] = 0.0f;
    }
  };
  zero_rows(r_lo, j < j1 ? __ldg(recv + j) : r_hi);

  const int steps = __reduce_max_sync(FULL, (unsigned)(j1 - j + D - 1) / D);
  int s_n[D], r_n[D];
  auto meta = [&](int jb) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const bool ok = jb + d < j1;
      s_n[d] = ok ? __ldg(send + jb + d) : 0;
      r_n[d] = ok ? __ldg(recv + jb + d) : r_hi;
    }
  };
  meta(j);
  float acc[NV][V] = {};
  float da_s = 0.0f;
  for (int it = 0; it < steps; ++it, j += D) {
    int s[D], r[D];
    int sm = 0, rm = 0;  // this lane's slot: the scalars it computes
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s[d] = s_n[d], r[d] = r_n[d];
      if (d == mine) sm = s[d], rm = r[d];
    }
    const bool okm = rm < r_hi;
    if (!okm) sm = rm = 0;
    float dfac;
    float wr = squash(__ldg(a_s + rm) + __ldg(a_r + sm), bound, slope, &dfac);
    if (bf16) wr = round_bf16(wr);
    const float gden = gv(__ldg(g + (size_t)sm * g1 + f));
    // the rows: d_num[s] and h[i]
    float gs[D][NV][V], p[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const bool ok = r[d] < r_hi;
      const float* gsr = g + (size_t)s[d] * g1;
      const T* hr = h + (size_t)r[d] * f;
      p[d] = 0.0f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        // selects, not branches: every row load of the step issues first
        float hv[V];
        unpack(ok && live[k] ? load_raw<T, V>(hr + col[k]) : Raw<T, V>{}, hv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          gs[d][k][i] = ok && live[k] ? gv(__ldg(gsr + col[k] + i)) : 0.0f;
          p[d] = fmaf(gs[d][k][i], hv[i], p[d]);
        }
      }
      if (TAIL && ok)
        for (int c = CT + q; c < f; c += G)
          p[d] = fmaf(gv(gsr[c]), to_f32(hr[c]), p[d]);
    }
    meta(j + D);
    const float t = __fmul_rn(__fadd_rn(group_reduce<G, D>(p, q), gden), dfac);
    if (okm && q % SUB == 0) scratch[__ldg(rev + j + mine)] = t;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float wr_d = __shfl_sync(FULL, wr, d * SUB, G);
      const float t_d = __shfl_sync(FULL, t, d * SUB, G);
      if (r[d] >= r_hi) continue;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[k][i] = fmaf(wr_d, gs[d][k][i], acc[k][i]);
      if (TAIL) {
        const float* gsr = g + (size_t)s[d] * g1;
        float* dr = dh + (size_t)r[d] * f;
        for (int c = CT + q; c < f; c += G) dr[c] = fmaf(wr_d, gv(gsr[c]), dr[c]);
      }
      da_s += t_d;
      const int next = d + 1 < D ? r[d + 1] : r_n[0];
      if (next != r[d]) {
        float* o = dh + (size_t)r[d] * f;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          if (live[k]) store_cols<V>(o + col[k], acc[k]);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[k][i] = 0.0f;
        }
        if (q == 0) das[r[d]] = da_s;
        da_s = 0.0f;
        zero_rows(r[d] + 1, next);
      }
    }
  }
}

// out[i] = Σ_{j in row i} x[j], in slot order: dα_r from the backward's
// per-slot terms.
__global__ void row_sum_kernel(const float* __restrict__ x,
                               const int* __restrict__ row_ptr,
                               float* __restrict__ out, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float s = 0.0f;
  for (int j = row_ptr[r], b = row_ptr[r + 1]; j < b; ++j) s += x[j];
  out[r] = s;
}

// Resident blocks of a row-plan kernel on the current card (ROW_THREADS
// threads, no shared memory: L1 takes it all), asked once a card.
template <typename K>
cudaError_t row_grid(K kernel, int (&slots_of)[MAX_DEVICES], int& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (slots_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          ROW_THREADS, 0);
    if (err != cudaSuccess) return err;
    slots_of[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  grid = slots_of[dev];
  return cudaSuccess;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct AggArgs {
  const void* h;
  const float *w, *a_s, *a_r;
  const int *row_ptr, *recv, *send;
  void* out;
  int e, n, f;
  float bound, slope;
};

template <typename T, int G, int V, int NV, bool ATT>
int launch_agg(const AggArgs& a, cudaStream_t s) {
  static int slots_of[MAX_DEVICES];
  auto kern = agg_rows_kernel<T, G, V, NV, ATT>;
  int grid = 0;
  const cudaError_t err = row_grid(kern, slots_of, grid);
  if (err != cudaSuccess) return (int)err;
  constexpr int ct = V * G * NV;
  kern<<<dim3(grid, (a.f + ct - 1) / ct), ROW_THREADS, 0, s>>>(
      (const T*)a.h, a.w, a.a_s, a.a_r, a.row_ptr, a.recv, a.send,
      (Out<T, ATT>*)a.out, a.n, a.f, a.e, a.bound, a.slope);
  return (int)cudaGetLastError();
}

// The lane group that fits the width: 16-byte loads of 8 bf16 columns
// when f is a multiple of 8 and h's rows (and the aggregation's output
// rows) are aligned to them, 4–16 lanes to cover f (against 8-byte loads,
// 0.081 → 0.063 ms for the aggregation at F = 128 on the H100, PERF.md
// §6); else V = 4 (8- or 16-byte loads) when f is a multiple of 4 and the
// rows are aligned to them, 8–32 lanes; else one column a load, 32 lanes
// on up to 128 columns.
template <typename T, bool ATT>
int fit_agg(const AggArgs& a, cudaStream_t s) {
  const int f = a.f;
  if constexpr (sizeof(T) == 2) {
    if (f % 8 == 0 && aligned(a.h, 16) && (ATT || aligned(a.out, 16))) {
      if (f <= 32) return launch_agg<T, 4, 8, 1, ATT>(a, s);
      if (f <= 64) return launch_agg<T, 8, 8, 1, ATT>(a, s);
      return launch_agg<T, 16, 8, 1, ATT>(a, s);
    }
  }
  if (f % 4 == 0 && aligned(a.h, 4 * sizeof(T)) &&
      (ATT || aligned(a.out, 4 * sizeof(T)))) {
    if (f <= 32) return launch_agg<T, 8, 4, 1, ATT>(a, s);
    if (f <= 64) return launch_agg<T, 16, 4, 1, ATT>(a, s);
    return launch_agg<T, 32, 4, 1, ATT>(a, s);
  }
  if (f <= 32) return launch_agg<T, 32, 1, 1, ATT>(a, s);
  if (f <= 64) return launch_agg<T, 32, 1, 2, ATT>(a, s);
  return launch_agg<T, 32, 1, 4, ATT>(a, s);
}

struct BwdArgs {
  const float* g;
  const void* h;
  const float *a_s, *a_r;
  const int *row_ptr, *recv, *send, *rev;
  float *dh, *das, *dar, *scratch;
  int e, n, f;
  float bound, slope;
};

// Past 64 columns a backward unit's slots take long enough that the
// units finish far apart: four blocks a resident slot, shorter spans, let
// the block scheduler even them out (0.214 → 0.181 ms at F = 128); at 32
// columns the shorter spans' fixed costs lose (0.068 → 0.090).
constexpr int WIDE_BWD_WAVES = 4;

template <typename T, int G, int V, int NV, bool TAIL>
int launch_bwd(const BwdArgs& a, cudaStream_t s) {
  static int slots_of[MAX_DEVICES];
  auto kern = att_bwd_rows_kernel<T, G, V, NV, TAIL>;
  int grid = 0;
  const cudaError_t err = row_grid(kern, slots_of, grid);
  if (err != cudaSuccess) return (int)err;
  if (a.f > 64) grid *= WIDE_BWD_WAVES;
  kern<<<grid, ROW_THREADS, 0, s>>>(a.g, (const T*)a.h, a.a_s, a.a_r,
                                    a.row_ptr, a.recv, a.send, a.rev, a.dh,
                                    a.das, a.scratch, a.n, a.f, a.e, a.bound,
                                    a.slope);
  row_sum_kernel<<<(a.n + 255) / 256, 256, 0, s>>>(a.scratch, a.row_ptr,
                                                   a.dar, a.n);
  return (int)cudaGetLastError();
}

// As fit_agg, on h; the cotangent (pitch f + 1) is read a value a load.
template <typename T>
int fit_bwd(const BwdArgs& a, cudaStream_t s) {
  const int f = a.f;
  if (f % 4 == 0 && aligned(a.h, 4 * sizeof(T)) && aligned(a.dh, 16)) {
    if (f <= 32) return launch_bwd<T, 8, 4, 1, false>(a, s);
    if (f <= 64) return launch_bwd<T, 16, 4, 1, false>(a, s);
    if (f <= 128) return launch_bwd<T, 32, 4, 1, false>(a, s);
    return launch_bwd<T, 32, 4, 1, true>(a, s);
  }
  if (f <= 32) return launch_bwd<T, 32, 1, 1, false>(a, s);
  if (f <= 64) return launch_bwd<T, 32, 1, 2, false>(a, s);
  if (f <= 128) return launch_bwd<T, 32, 1, 4, false>(a, s);
  return launch_bwd<T, 32, 1, 4, true>(a, s);
}

}  // namespace

// h [n, f] (bf16 when `bf16` is non-zero, else f32); the row plan:
// row_ptr [n + 1], and for each slot in row order its receiver and sender
// (recv, send [e] int32) and weight (w [e] f32); out [n, f] of h's type.
extern "C" int hs_cluster_aggregate(const void* h, const float* w,
                                    const int* row_ptr, const int* recv,
                                    const int* send, void* out, int e, int n,
                                    int f, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && f > 0) {
    const AggArgs a{h, w, nullptr, nullptr, row_ptr, recv, send, out,
                    e, n,  f, 0.0f,    0.0f};
    const int err =
        bf16 ? fit_agg<__nv_bfloat16, false>(a, s) : fit_agg<float, false>(a, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// h [n, f] (bf16 when `bf16` is non-zero, else f32), a_s and a_r [n] f32;
// the row plan: row_ptr [n + 1], recv and send [e] int32 in row order;
// out [n, f + 1] f32 (num | den).
extern "C" int hs_cluster_att_fwd(const void* h, const float* a_s,
                                  const float* a_r, const int* row_ptr,
                                  const int* recv, const int* send,
                                  float* out, int e, int n, int f, int bf16,
                                  float bound, float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && f > 0) {
    const AggArgs a{h, nullptr, a_s, a_r, row_ptr, recv, send, out,
                    e, n,       f,   bound, slope};
    const int err =
        bf16 ? fit_agg<__nv_bfloat16, true>(a, s) : fit_agg<float, true>(a, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// g [n, f + 1] f32 (d_num | d_den), h [n, f] (bf16 when `bf16` is
// non-zero, else f32), a_s and a_r [n] f32; the row plan of an edge set
// closed under reversal: row_ptr [n + 1], recv, send and rev [e] int32
// (rev: the slot of each slot's reverse edge); scratch [e] f32; writes dh
// [n, f], das and dar [n], f32.
extern "C" int hs_cluster_att_bwd(const float* g, const void* h,
                                  const float* a_s, const float* a_r,
                                  const int* row_ptr, const int* recv,
                                  const int* send, const int* rev, float* dh,
                                  float* das, float* dar, float* scratch,
                                  int e, int n, int f, int bf16, float bound,
                                  float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && f > 0) {
    const BwdArgs a{g,   h,   a_s,     a_r, row_ptr, recv, send,  rev,  dh,
                    das, dar, scratch, e,   n,       f,    bound, slope};
    const int err = bf16 ? fit_bwd<__nv_bfloat16>(a, s) : fit_bwd<float>(a, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
