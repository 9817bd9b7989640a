// Sorted segment sum out[r] = Σ_{e: recv_e = r} vals_e, bf16 or f32
// values, f32 accumulation, for sm_90a.
//
// Replaces hyperspace_tpu/kernels/segment.py `csr_segment_sum` (the
// Pallas kernel `_pallas_csr`), which turns the scatter into one-hot
// matrix products over a host-built (node block × edge chunk) plan
// because the TPU has no atomics and a slow scatter.  On Hopper neither
// trick is needed: the receivers are sorted, so each row's edges are one
// contiguous range, and a warp can own a row outright.
//
// What bounds it on an H100: bytes.  Every value is read once, each
// receiver once (to build the row pointer) and each output row written
// once: E·F·size(in) + 4E + N·F·size(out) over 3.35 TB/s — about
// 0.13 ms at [1,467,392, 128] bf16.  The design:
//   1. `rowptr_kernel`: one thread per edge boundary writes the CSR row
//      pointer of the sorted receivers (rows with no edge get an empty
//      range, so they come out 0);
//   2. `segsum_kernel`: one warp per receiver row walks the row's edges
//      in order with the lanes on feature columns (4 columns per lane,
//      two edges' loads in flight), summing in f32 registers and
//      writing the row once, rounded to the values' type.  A row is
//      owned by one warp: no atomics, and the sum is taken in edge order,
//      so the result is deterministic.  Any F works: a warp covers 128
//      columns per pass and masks the tail.

//
// The same file holds the two scalar passes of the attention arm:
//   3. `reduce1d_kernel` (replaces `csr_segment_reduce_1d`, whose TPU
//      kernel keeps a [bn, 128] lane-partial accumulator per node block
//      and combines the lanes in XLA): sum, or max from the TPU kernel's
//      fill -3e38 (so an empty row reads -3e38), in one pass over the
//      edges with no row pointer.  The mean row holds about 8.5 edges, so
//      a warp a row would leave most lanes idle; instead a block takes a
//      tile of 1024 consecutive edges (4 a thread, read with 16-byte loads
//      when both arrays are 16-byte aligned), reduces runs of equal
//      receivers in registers and combines runs across threads by a
//      segmented scan (shuffles with head flags in a warp, shared memory
//      across warps).  A row belongs to the tile that holds its first
//      edge: a tile skips its leading edges whose receiver is that of the
//      edge before it, and when its last row runs past the tile, the
//      whole block walks the row's further edges (4096 a step, one
//      block-wide sum at the end), so a hub row is read by a block, never
//      split between owners, and needs no fix-up pass.  The thread that
//      holds the edge after a gap of receivers fills the empty rows
//      between, or queues a gap of more than 64 rows for the whole block
//      to fill; with no edge at all every row is filled.
//      Bytes: 8 B an edge and 4 B a row, about 0.004 ms at 1.4 M edges.
//   4. `att_bwd_edges_kernel` (replaces `csr_att_bwd_edges`, which picks
//      the receivers' (d_num | d_den) rows by one-hot products from a
//      VMEM block), on the row pointer: a warp per receiver row holds
//      the row's d_num in registers (4 columns a lane; wider rows read
//      the rest from memory), streams the row's residual sender rows,
//      takes each dot with a butterfly reduction, and writes
//          dpre_e = (<d_num[r], h_e> + d_den[r]) · w_e · (1 − (lm_e/B)²)
//                   · (lm_e ≥ 0 ? 1 : slope)
//      for each edge and the row's Σ dpre (d_alpha_r) once.  It reads the
//      [E, F] residual rows and adds the d_den term itself, so no
//      ones-column copy of them is made.  Bytes: E·(F·size(h) + 16) +
//      N·(4(F+1) + 4), about 0.12 ms at 1.4 M bf16 rows of 128.
//   Neither uses atomics: each row has one owner and sums in a fixed
//   order, so both are deterministic.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS_PER_BLOCK = 4;   // warps per block, one row each
constexpr int COLS_PER_LANE = 4;    // a warp covers 128 columns per pass
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_FILL = -3.0e38f;  // the TPU kernel's max fill

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// rowptr[r] = the first edge whose receiver is >= r, for r in [0, n];
// thread i fills the rows between receivers i-1 and i.
__global__ void rowptr_kernel(const int* __restrict__ recv, int e, int n,
                              int* __restrict__ rowptr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > e) return;
  const int lo = i == 0 ? 0 : max(recv[i - 1] + 1, 0);
  const int hi = i == e ? n : min(recv[i], n);
  for (int r = lo; r <= hi; ++r) rowptr[r] = i;
}

template <typename T>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
segsum_kernel(const T* __restrict__ vals, const int* __restrict__ rowptr,
              T* __restrict__ out, int n, int f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n) return;
  const int e0 = rowptr[row], e1 = rowptr[row + 1];
  for (int c0 = 0; c0 < f; c0 += 32 * COLS_PER_LANE) {
    float acc[COLS_PER_LANE];
    bool live[COLS_PER_LANE];
#pragma unroll
    for (int k = 0; k < COLS_PER_LANE; ++k) {
      acc[k] = 0.0f;
      live[k] = c0 + lane + 32 * k < f;
    }
    int e = e0;
    for (; e + 1 < e1; e += 2) {
      const T* a = vals + (size_t)e * f + c0 + lane;
      const T* b = a + f;
      float va[COLS_PER_LANE], vb[COLS_PER_LANE];
#pragma unroll
      for (int k = 0; k < COLS_PER_LANE; ++k) {
        va[k] = live[k] ? to_f32(a[32 * k]) : 0.0f;
        vb[k] = live[k] ? to_f32(b[32 * k]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < COLS_PER_LANE; ++k) {
        acc[k] += va[k];
        acc[k] += vb[k];
      }
    }
    if (e < e1) {
      const T* a = vals + (size_t)e * f + c0 + lane;
#pragma unroll
      for (int k = 0; k < COLS_PER_LANE; ++k)
        if (live[k]) acc[k] += to_f32(a[32 * k]);
    }
    T* o = out + (size_t)row * f + c0 + lane;
#pragma unroll
    for (int k = 0; k < COLS_PER_LANE; ++k)
      if (live[k]) store(o + 32 * k, acc[k]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

constexpr int R1D_THREADS = 256;
constexpr int R1D_EDGES = 4;                         // edges a thread
constexpr int R1D_TILE = R1D_THREADS * R1D_EDGES;    // edges a block owns
constexpr int R1D_WALK = 4 * R1D_TILE;               // edges a walk step
constexpr int NO_ROW = INT_MAX;                      // past the last edge
constexpr int R1D_GAP = 64;       // a longer run of empty rows is queued
constexpr int R1D_GAPQ = 32;      // gaps a block queues; the rest are
                                  // filled by the thread that found them

template <bool MAX>
__device__ __forceinline__ float r1d_op(float a, float b) {
  return MAX ? fmaxf(a, b) : a + b;
}

// edges [i, i + 4) of (vals, recv); past `e` a key of NO_ROW and `fill`
__device__ __forceinline__ void load4(const float* __restrict__ vals,
                                      const int* __restrict__ recv, int i,
                                      int e, bool vec, float fill,
                                      float (&v)[R1D_EDGES],
                                      int (&k)[R1D_EDGES]) {
  if (vec && i + R1D_EDGES <= e) {
    const float4 a = *reinterpret_cast<const float4*>(vals + i);
    const int4 b = *reinterpret_cast<const int4*>(recv + i);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    k[0] = b.x; k[1] = b.y; k[2] = b.z; k[3] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < R1D_EDGES; ++u) {
      const bool in = i + u < e;
      v[u] = in ? vals[i + u] : fill;
      k[u] = in ? recv[i + u] : NO_ROW;
    }
  }
}

// fills the empty rows [lo, hi): a long run goes to the block's queue
// while it has room, the rest the calling thread writes itself
__device__ __forceinline__ void fill_rows(float* __restrict__ out, int lo,
                                          int hi, float fill, int* n_gap,
                                          int2* gaps) {
  if (hi - lo > R1D_GAP) {
    const int q = atomicAdd(n_gap, 1);
    if (q < R1D_GAPQ) {
      gaps[q] = make_int2(lo, hi);
      return;
    }
  }
  for (int r = lo; r < hi; ++r) out[r] = fill;
}

template <bool MAX>
__global__ void __launch_bounds__(R1D_THREADS)
reduce1d_kernel(const float* __restrict__ vals, const int* __restrict__ recv,
                float* __restrict__ out, int e, int n) {
  __shared__ float w_agg[R1D_THREADS / 32];
  __shared__ int w_head[R1D_THREADS / 32];
  __shared__ int walk_key;
  __shared__ float walk_val;
  __shared__ int2 gaps[R1D_GAPQ];
  __shared__ int n_gap;
  const float fill = MAX ? NEG_FILL : 0.0f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (e == 0) {                          // no edge: every row is empty
    const int r = blockIdx.x * R1D_THREADS + tid;
    if (r < n) out[r] = fill;
    return;
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(recv)) & 15) == 0;
  const int s0 = blockIdx.x * R1D_TILE, end = min(s0 + R1D_TILE, e);
  const int skip = s0 > 0 ? recv[s0 - 1] : -1;  // an earlier tile's row
  const int i0 = s0 + R1D_EDGES * tid;
  float v[R1D_EDGES];
  int k[R1D_EDGES];
  load4(vals, recv, i0, end, vec, fill, v, k);
  const int before = i0 == 0 ? -1 : (i0 < end ? recv[i0 - 1] : NO_ROW);
  const int after = i0 + R1D_EDGES < e ? recv[i0 + R1D_EDGES] : NO_ROW;
  if (tid == 0) {
    walk_key = -1;
    n_gap = 0;
  }

  // the thread's trailing run (from its last head) and whether it has one
  float tail = fill;
  bool head = false;
#pragma unroll
  for (int u = 0; u < R1D_EDGES; ++u) {
    const bool h = k[u] != (u == 0 ? before : k[u - 1]);
    tail = r1d_op<MAX>(h ? fill : tail, v[u]);
    head = head || h;
  }
  // segmented inclusive scan over the warp, then the exclusive carry
  float agg = tail;
  bool flag = head;
#pragma unroll
  for (int dd = 1; dd < 32; dd <<= 1) {
    const float ao = __shfl_up_sync(FULL, agg, dd);
    const bool fo = __shfl_up_sync(FULL, flag, dd);
    if (lane >= dd) {
      if (!flag) agg = r1d_op<MAX>(ao, agg);
      flag = flag || fo;
    }
  }
  if (lane == 31) {
    w_agg[warp] = agg;
    w_head[warp] = flag;
  }
  float carry = __shfl_up_sync(FULL, agg, 1);
  bool carry_head = __shfl_up_sync(FULL, flag, 1);
  if (lane == 0) {
    carry = fill;
    carry_head = false;
  }
  __syncthreads();
  if (!carry_head) {                    // the run reaches into earlier warps
    float wc = fill;
    for (int w = 0; w < warp; ++w)
      wc = w_head[w] ? w_agg[w] : r1d_op<MAX>(wc, w_agg[w]);
    carry = r1d_op<MAX>(wc, carry);
  }

  // write each owned run that ends here; fill the empty rows before each
  // edge (and after the last one)
  float run = carry;
#pragma unroll
  for (int u = 0; u < R1D_EDGES; ++u) {
    const int i = i0 + u;
    if (i >= end) break;
    const int prev = u == 0 ? before : k[u - 1];
    fill_rows(out, max(prev + 1, 0), min(k[u], n), fill, &n_gap, gaps);
    if (i == e - 1) fill_rows(out, max(k[u] + 1, 0), n, fill, &n_gap, gaps);
    run = r1d_op<MAX>(k[u] != prev ? fill : run, v[u]);
    const int next = u + 1 < R1D_EDGES ? k[u + 1] : after;
    if (k[u] == skip || (next == k[u] && i + 1 < end)) continue;
    if (next == k[u]) {                 // the tile's last row runs on
      walk_key = k[u];
      walk_val = run;
    } else {
      out[k[u]] = run;
    }
  }
  __syncthreads();
  for (int g = 0; g < min(n_gap, R1D_GAPQ); ++g)   // the queued gaps
    for (int r = gaps[g].x + tid; r < gaps[g].y; r += R1D_THREADS)
      out[r] = fill;
  const int wk = walk_key;
  if (wk < 0) return;
  // the block walks the rest of its last row, 4096 edges a step, and
  // sums once at the end in a fixed order
  float acc = fill;
  for (int p = end; p < e; p += R1D_WALK) {
#pragma unroll
    for (int c = 0; c < R1D_WALK / R1D_TILE; ++c) {
      load4(vals, recv, p + c * R1D_TILE + R1D_EDGES * tid, e, vec, fill, v,
            k);
#pragma unroll
      for (int u = 0; u < R1D_EDGES; ++u)
        if (k[u] == wk) acc = r1d_op<MAX>(acc, v[u]);
    }
    if (recv[min(p + R1D_WALK, e) - 1] != wk) break;
  }
#pragma unroll
  for (int dd = 16; dd > 0; dd >>= 1)
    acc = r1d_op<MAX>(acc, __shfl_xor_sync(FULL, acc, dd));
  if (lane == 0) w_agg[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = walk_val;
    for (int w = 0; w < R1D_THREADS / 32; ++w)
      total = r1d_op<MAX>(total, w_agg[w]);
    out[wk] = total;
  }
}

// dpre of one edge from its dot <d_num[r], h_e> (warp-reduced), computed
// in the TPU kernel's order with explicitly rounded operations.
__device__ __forceinline__ float edge_dpre(float dot, float dden, float w,
                                           float lm, float bound,
                                           float slope) {
  const float q = __fdiv_rn(lm, bound);
  const float dw = __fadd_rn(dot, dden);
  const float t = __fmul_rn(__fmul_rn(dw, w),
                            __fsub_rn(1.0f, __fmul_rn(q, q)));
  return __fmul_rn(t, lm >= 0.0f ? 1.0f : slope);
}

template <typename T>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
att_bwd_edges_kernel(const float* __restrict__ dn, const T* __restrict__ h,
                     const float* __restrict__ w,
                     const float* __restrict__ lm,
                     const int* __restrict__ rowptr,
                     float* __restrict__ dpre, float* __restrict__ dar,
                     int n, int f, float bound, float slope) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n) return;
  const float* dr = dn + (size_t)row * (f + 1);
  float d[COLS_PER_LANE];
  bool live[COLS_PER_LANE];
#pragma unroll
  for (int k = 0; k < COLS_PER_LANE; ++k) {
    live[k] = lane + 32 * k < f;
    d[k] = live[k] ? dr[lane + 32 * k] : 0.0f;
  }
  const float dden = dr[f];
  const int e1 = rowptr[row + 1];
  float sum = 0.0f;
  int e = rowptr[row];
  for (; e + 1 < e1; e += 2) {  // two sender rows in flight
    const T* a = h + (size_t)e * f;
    const T* b = a + f;
    float pa = 0.0f, pb = 0.0f;
#pragma unroll
    for (int k = 0; k < COLS_PER_LANE; ++k) {
      const float va = live[k] ? to_f32(a[lane + 32 * k]) : 0.0f;
      const float vb = live[k] ? to_f32(b[lane + 32 * k]) : 0.0f;
      pa = fmaf(d[k], va, pa);
      pb = fmaf(d[k], vb, pb);
    }
    for (int c = 32 * COLS_PER_LANE + lane; c < f; c += 32) {
      pa = fmaf(dr[c], to_f32(a[c]), pa);
      pb = fmaf(dr[c], to_f32(b[c]), pb);
    }
    pa = warp_sum(pa);
    pb = warp_sum(pb);
    const float qa = edge_dpre(pa, dden, w[e], lm[e], bound, slope);
    const float qb = edge_dpre(pb, dden, w[e + 1], lm[e + 1], bound, slope);
    if (lane == 0) {
      dpre[e] = qa;
      dpre[e + 1] = qb;
    }
    sum += qa;
    sum += qb;
  }
  if (e < e1) {
    const T* a = h + (size_t)e * f;
    float pa = 0.0f;
#pragma unroll
    for (int k = 0; k < COLS_PER_LANE; ++k)
      if (live[k]) pa = fmaf(d[k], to_f32(a[lane + 32 * k]), pa);
    for (int c = 32 * COLS_PER_LANE + lane; c < f; c += 32)
      pa = fmaf(dr[c], to_f32(a[c]), pa);
    pa = warp_sum(pa);
    const float qa = edge_dpre(pa, dden, w[e], lm[e], bound, slope);
    if (lane == 0) dpre[e] = qa;
    sum += qa;
  }
  if (lane == 0) dar[row] = sum;
}

}  // namespace

// vals [e, f] (bf16 when `bf16` is non-zero, else f32), recv [e] int32
// ascending in [0, n), rowptr [n + 1] int32 scratch, out [n, f] of the
// values' type.
extern "C" int hs_csr_segment_sum(const void* vals, const int* recv,
                                  int* rowptr, void* out, int e, int f,
                                  int n, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    rowptr_kernel<<<(e + 1 + 255) / 256, 256, 0, s>>>(recv, e, n, rowptr);
    if (f > 0) {
      const int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
      if (bf16)
        segsum_kernel<__nv_bfloat16><<<blocks, 32 * ROWS_PER_BLOCK, 0, s>>>(
            (const __nv_bfloat16*)vals, rowptr, (__nv_bfloat16*)out, n, f);
      else
        segsum_kernel<float><<<blocks, 32 * ROWS_PER_BLOCK, 0, s>>>(
            (const float*)vals, rowptr, (float*)out, n, f);
    }
  }
  return (int)cudaGetLastError();
}

// vals [e] f32, recv [e] int32 ascending in [0, n), out [n] f32; `max`
// non-zero for the maximum, else the sum.  One launch, no scratch.
extern "C" int hs_csr_segment_reduce_1d(const float* vals, const int* recv,
                                        float* out, int e, int n, int max,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const int blocks = e > 0 ? (e + R1D_TILE - 1) / R1D_TILE
                             : (n + R1D_THREADS - 1) / R1D_THREADS;
    if (max)
      reduce1d_kernel<true><<<blocks, R1D_THREADS, 0, s>>>(vals, recv, out,
                                                           e, n);
    else
      reduce1d_kernel<false><<<blocks, R1D_THREADS, 0, s>>>(vals, recv, out,
                                                            e, n);
  }
  return (int)cudaGetLastError();
}

// dn [n, f + 1] f32 (d_num | d_den), h [e, f] residual sender rows (bf16
// when `bf16` is non-zero, else f32), w and lm [e] f32, recv [e] int32
// ascending in [0, n), rowptr [n + 1] int32 scratch; writes dpre [e] and
// dar [n], both f32.
extern "C" int hs_csr_att_bwd_edges(const float* dn, const void* h,
                                    const float* w, const float* lm,
                                    const int* recv, int* rowptr,
                                    float* dpre, float* dar, int e, int f,
                                    int n, int bf16, float bound,
                                    float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    rowptr_kernel<<<(e + 1 + 255) / 256, 256, 0, s>>>(recv, e, n, rowptr);
    const int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    if (bf16)
      att_bwd_edges_kernel<__nv_bfloat16>
          <<<blocks, 32 * ROWS_PER_BLOCK, 0, s>>>(
              dn, (const __nv_bfloat16*)h, w, lm, rowptr, dpre, dar, n, f,
              bound, slope);
    else
      att_bwd_edges_kernel<float><<<blocks, 32 * ROWS_PER_BLOCK, 0, s>>>(
          dn, (const float*)h, w, lm, rowptr, dpre, dar, n, f, bound,
          slope);
  }
  return (int)cudaGetLastError();
}
