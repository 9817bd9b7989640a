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
// The same file holds the two scalar passes of the attention arm, which
// reuse the row pointer and the warp-per-row walk:
//   3. `reduce1d_kernel` (replaces `csr_segment_reduce_1d`, whose TPU
//      kernel keeps a [bn, 128] lane-partial accumulator per node block
//      and combines the lanes in XLA): a warp per receiver row, the lanes
//      striding over the row's edges, a butterfly reduction; sum, or max
//      from the TPU kernel's fill -3e38 (so an empty row reads -3e38).
//      Bytes: 8 B an edge and 4 B a row, about 0.005 ms at 1.4 M edges.
//   4. `att_bwd_edges_kernel` (replaces `csr_att_bwd_edges`, which picks
//      the receivers' (d_num | d_den) rows by one-hot products from a
//      VMEM block): a warp per receiver row holds the row's d_num in
//      registers (4 columns a lane; wider rows read the rest from
//      memory), streams the row's residual sender rows, takes each dot
//      with a butterfly reduction, and writes
//          dpre_e = (<d_num[r], h_e> + d_den[r]) · w_e · (1 − (lm_e/B)²)
//                   · (lm_e ≥ 0 ? 1 : slope)
//      for each edge and the row's Σ dpre (d_alpha_r) once.  It reads the
//      [E, F] residual rows and adds the d_den term itself, so no
//      ones-column copy of them is made.  Bytes: E·(F·size(h) + 16) +
//      N·(4(F+1) + 4), about 0.12 ms at 1.4 M bf16 rows of 128.
//   Neither uses atomics: each row has one owner and sums in a fixed
//   order, so both are deterministic.

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

template <bool MAX>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
reduce1d_kernel(const float* __restrict__ vals,
                const int* __restrict__ rowptr, float* __restrict__ out,
                int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n) return;
  const int e1 = rowptr[row + 1];
  float acc = MAX ? NEG_FILL : 0.0f;
  for (int e = rowptr[row] + lane; e < e1; e += 32)
    acc = MAX ? fmaxf(acc, vals[e]) : acc + vals[e];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float o = __shfl_xor_sync(FULL, acc, d);
    acc = MAX ? fmaxf(acc, o) : acc + o;
  }
  if (lane == 0) out[row] = acc;
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

// vals [e] f32, recv [e] int32 ascending in [0, n), rowptr [n + 1] int32
// scratch, out [n] f32; `max` non-zero for the maximum, else the sum.
extern "C" int hs_csr_segment_reduce_1d(const float* vals, const int* recv,
                                        int* rowptr, float* out, int e,
                                        int n, int max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    rowptr_kernel<<<(e + 1 + 255) / 256, 256, 0, s>>>(recv, e, n, rowptr);
    const int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    if (max)
      reduce1d_kernel<true><<<blocks, 32 * ROWS_PER_BLOCK, 0, s>>>(
          vals, rowptr, out, n);
    else
      reduce1d_kernel<false><<<blocks, 32 * ROWS_PER_BLOCK, 0, s>>>(
          vals, rowptr, out, n);
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
