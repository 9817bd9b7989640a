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
// thread block owns a receiver block's rows and gathers sender rows
// directly; no [E]-long array is written either.
//
// What bounds them on an H100: bytes — h read once, 8–12 B per edge, the
// outputs written once (about 0.03 ms at h [169,343, 128] bf16 for the
// aggregation).  What stands between the kernels and that bound is the
// latency of the random sender-row reads, so the design keeps many
// independent row reads in flight:
//   1. `block_ptr_kernel`: the edges arrive sorted by (receiver block,
//      sender block), so each 256-row receiver block's edges are one
//      contiguous range; one thread per edge boundary writes the range
//      pointers.
//   2. A thread block per receiver block stages its edges 2,048 at a time
//      in shared memory and sorts them by row with a stable counting sort
//      (`rank_by_row`: warp 0 ranks each edge within its row in arrival
//      order with __match_any_sync, then a scan gives each row's range),
//      carrying each edge's sender and its per-edge scalars.  The
//      attention kernels compute those scalars here: the receiver
//      block's scores sit in shared memory, a sender's are read once per
//      edge (the edges of a pair share one 1 KB span of them).
//   3. `cluster_kernel` (aggregation and attention forward): a block per
//      (receiver block, 128-column tile), 32 warps; warp w owns rows w,
//      w + 32, … and keeps their f32 sums in registers (the attention
//      forward also the row's Σ w, written by the first column tile).
//      Each warp walks its rows' edges with the lanes on feature columns
//      (4 a lane), two sender rows in flight.
//   4. `att_bwd_kernel`: a block per receiver block, 16 warps, a warp on
//      one row at a time: the row's g and h in registers, then for each
//      edge the sender's g and h rows, two dots by butterfly reduction,
//      and w_rev · d_num[s] added to the row's dh.  Columns past 128 are
//      read from memory and summed into dh in place.  A block with more
//      than 2,048 edges adds each later chunk's partial row into its
//      earlier one.
//   A row has one owner and sums its edges in list order: no atomics, and
//   the results are deterministic.
//
// bf16 mode, as the TPU kernels' (`fast_bf16`): a bf16 h takes its
// weights rounded to bf16 before the product (the aggregation's w, the
// attention forward's w, the backward's w_rev), and the backward rounds
// the cotangent rows to bf16 before every use; products of two bf16
// values are exact in f32.  The scores and the backward's f'(pre) stay
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int BN = 256;     // receiver rows per block (the TPU kernel's _BN)
constexpr int WARPS = 32;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_WARP = BN / WARPS;
constexpr int CPL = 4;      // feature columns per lane
constexpr int FT = 32 * CPL;  // columns per block; grid.y tiles wider h
constexpr int CAP = 2048;   // edges staged in shared memory per step
constexpr int BWD_WARPS = 16;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
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

// ptr[b] = the first edge whose receiver block (recv / BN) is >= b, for
// b in [0, nb].
__global__ void block_ptr_kernel(const int* __restrict__ recv, int e,
                                 int nb, int* __restrict__ ptr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > e) return;
  const int lo = i == 0 ? 0 : max(recv[i - 1] / BN + 1, 0);
  const int hi = i == e ? nb : min(recv[i] / BN, nb);
  for (int b = lo; b <= hi; ++b) ptr[b] = i;
}

// Ranks the edges [base, base + m) of receiver block rb by row: s_row[i]
// is edge i's row in the block (-1 for another block's edge), s_pos[i]
// its rank among its row's edges in arrival order, and off[0..BN] the
// rows' ranges once sorted; edge i goes to off[s_row[i]] + s_pos[i].
// Starts and ends with the block synchronised.
__device__ void rank_by_row(const int* __restrict__ recv, int base, int m,
                            int rb, int* s_row, int* s_pos, int* cnt,
                            int* off) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the last chunk is consumed
  for (int i = threadIdx.x; i < BN; i += blockDim.x) cnt[i] = 0;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int r = recv[base + i] - rb * BN;
    s_row[i] = (r >= 0 && r < BN) ? r : -1;
  }
  __syncthreads();
  if (warp == 0) {
    for (int j = 0; j < m; j += 32) {
      const int i = j + lane;
      const int r = i < m ? s_row[i] : -1;
      const unsigned grp = __match_any_sync(FULL, r);
      const int rank = __popc(grp & ((1u << lane) - 1u));
      const int before = r >= 0 ? cnt[r] : 0;
      __syncwarp();
      if (r >= 0) {
        s_pos[i] = before + rank;
        if (rank == 0) cnt[r] = before + __popc(grp);
      }
      __syncwarp();
    }
    // exclusive scan of the counts: 8 rows per lane
    int local[BN / 32], sum = 0;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      local[q] = cnt[lane * (BN / 32) + q];
      sum += local[q];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += t;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      off[lane * (BN / 32) + q] = run;
      run += local[q];
    }
    if (lane == 31) off[BN] = incl;
  }
  __syncthreads();
}

// ATT false: out [n, f] of T = Σ w_e h[s_e] (w given).  ATT true: out
// [n, f + 1] f32 = Σ w_e [h[s_e] | 1], w_e from the scores.
template <typename T, bool ATT>
__global__ void __launch_bounds__(THREADS)
cluster_kernel(const T* __restrict__ h, const float* __restrict__ w,
               const float* __restrict__ a_s, const float* __restrict__ a_r,
               const int* __restrict__ recv, const int* __restrict__ send,
               const int* __restrict__ ptr,
               std::conditional_t<ATT, float, T>* __restrict__ out, int n,
               int f, float bound, float slope) {
  extern __shared__ int smem[];
  int* s_row = smem;                        // [CAP] staged, arrival order
  int* s_pos = s_row + CAP;                 // rank within its row
  int* o_snd = s_pos + CAP;                 // [CAP] sorted by row
  float* o_w = (float*)(o_snd + CAP);
  int* cnt = (int*)(o_w + CAP);             // [BN] edges per row
  int* off = cnt + BN;                      // [BN + 1] row ranges
  float* sh_ar = (float*)(off + BN + 1);    // [BN] receivers' α_r (ATT)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = blockIdx.x;
  const int c0 = blockIdx.y * FT;
  const bool bf16 = sizeof(T) == 2;
  const int ostride = ATT ? f + 1 : f;

  if (ATT)
    for (int i = threadIdx.x; i < BN; i += THREADS)
      sh_ar[i] = rb * BN + i < n ? a_r[rb * BN + i] : 0.0f;
  bool live[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) live[k] = c0 + lane + 32 * k < f;
  float acc[ROWS_PER_WARP][CPL];
  float den[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    den[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[q][k] = 0.0f;
  }

  const int e0 = ptr[rb], e1 = ptr[rb + 1];
  for (int base = e0; base < e1; base += CAP) {
    const int m = min(CAP, e1 - base);
    rank_by_row(recv, base, m, rb, s_row, s_pos, cnt, off);
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const int r = s_row[i];
      if (r < 0) continue;
      const int d = off[r] + s_pos[i];
      const int s = send[base + i];
      o_snd[d] = s;
      const float wi = ATT ? squash(a_s[s] + sh_ar[r], bound, slope, nullptr)
                           : w[base + i];
      o_w[d] = bf16 ? round_bf16(wi) : wi;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const int r = warp + q * WARPS;
      const int b = off[r + 1];
      int e = off[r];
      for (; e + 1 < b; e += 2) {
        const T* p0 = h + (size_t)o_snd[e] * f + c0 + lane;
        const T* p1 = h + (size_t)o_snd[e + 1] * f + c0 + lane;
        const float w0 = o_w[e], w1 = o_w[e + 1];
        float v0[CPL], v1[CPL];
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          v0[k] = live[k] ? to_f32(p0[32 * k]) : 0.0f;
          v1[k] = live[k] ? to_f32(p1[32 * k]) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          acc[q][k] += w0 * v0[k];
          acc[q][k] += w1 * v1[k];
        }
        if (ATT) {
          den[q] += w0;
          den[q] += w1;
        }
      }
      if (e < b) {
        const T* p0 = h + (size_t)o_snd[e] * f + c0 + lane;
        const float w0 = o_w[e];
#pragma unroll
        for (int k = 0; k < CPL; ++k)
          if (live[k]) acc[q][k] += w0 * to_f32(p0[32 * k]);
        if (ATT) den[q] += w0;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int gr = rb * BN + warp + q * WARPS;
    if (gr >= n) continue;
    auto* o = out + (size_t)gr * ostride + c0 + lane;
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (live[k]) store(o + 32 * k, acc[q][k]);
    if (ATT && blockIdx.y == 0 && lane == 0)
      out[(size_t)gr * ostride + f] = den[q];
  }
}

// g [n, f + 1] f32 cotangent (d_num | d_den), h [n, f]; writes dh [n, f],
// das, dar [n], all f32.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
att_bwd_kernel(const float* __restrict__ g, const T* __restrict__ h,
               const float* __restrict__ a_s, const float* __restrict__ a_r,
               const int* __restrict__ recv, const int* __restrict__ send,
               const int* __restrict__ ptr, float* __restrict__ dh,
               float* __restrict__ das, float* __restrict__ dar, int n,
               int f, float bound, float slope) {
  extern __shared__ int smem[];
  int* s_row = smem;
  int* s_pos = s_row + CAP;
  int* o_snd = s_pos + CAP;
  float* o_wrev = (float*)(o_snd + CAP);    // w of the reverse edge
  float* o_dfac = o_wrev + CAP;             // f'(pre_e)
  float* o_dfacr = o_dfac + CAP;            // f'(pre_rev(e))
  int* cnt = (int*)(o_dfacr + CAP);
  int* off = cnt + BN;
  float* sh_as = (float*)(off + BN + 1);    // [BN] receivers' α_s
  float* sh_ar = sh_as + BN;                // [BN] receivers' α_r
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = blockIdx.x;
  const bool bf16 = sizeof(T) == 2;
  const int g1 = f + 1;
  auto gv = [&](float v) { return bf16 ? round_bf16(v) : v; };

  for (int i = threadIdx.x; i < BN; i += BWD_THREADS) {
    const bool in = rb * BN + i < n;
    sh_as[i] = in ? a_s[rb * BN + i] : 0.0f;
    sh_ar[i] = in ? a_r[rb * BN + i] : 0.0f;
  }
  bool live[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) live[k] = lane + 32 * k < f;

  const int e0 = ptr[rb], e1 = ptr[rb + 1];
  bool first = true;
  for (int base = e0; first || base < e1; base += CAP, first = false) {
    const int m = max(0, min(CAP, e1 - base));
    rank_by_row(recv, base, m, rb, s_row, s_pos, cnt, off);
    for (int i = threadIdx.x; i < m; i += BWD_THREADS) {
      const int r = s_row[i];
      if (r < 0) continue;
      const int d = off[r] + s_pos[i];
      const int s = send[base + i];
      o_snd[d] = s;
      float dfac, dfacr;
      squash(a_s[s] + sh_ar[r], bound, slope, &dfac);
      const float wrev = squash(sh_as[r] + a_r[s], bound, slope, &dfacr);
      o_wrev[d] = bf16 ? round_bf16(wrev) : wrev;
      o_dfac[d] = dfac;
      o_dfacr[d] = dfacr;
    }
    __syncthreads();
    for (int r = warp; r < BN; r += BWD_WARPS) {
      const int gr = rb * BN + r;
      if (gr >= n) break;
      const float* gr_row = g + (size_t)gr * g1;
      const T* hr_row = h + (size_t)gr * f;
      float* dh_row = dh + (size_t)gr * f;
      float g_r[CPL], h_r[CPL], acc[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        g_r[k] = live[k] ? gv(gr_row[c]) : 0.0f;
        h_r[k] = live[k] ? to_f32(hr_row[c]) : 0.0f;
        acc[k] = live[k] && !first ? dh_row[c] : 0.0f;
      }
      if (first)
        for (int c = 32 * CPL + lane; c < f; c += 32) dh_row[c] = 0.0f;
      const float gden_r = gv(gr_row[f]);
      float da_r = first ? 0.0f : dar[gr];
      float da_s = first ? 0.0f : das[gr];
      const int b = off[r + 1];
      for (int e = off[r]; e < b; ++e) {
        const int s = o_snd[e];
        const float* gs_row = g + (size_t)s * g1;
        const T* hs_row = h + (size_t)s * f;
        float g_s[CPL], p1 = 0.0f, p2 = 0.0f;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = lane + 32 * k;
          g_s[k] = live[k] ? gv(gs_row[c]) : 0.0f;
          const float h_s = live[k] ? to_f32(hs_row[c]) : 0.0f;
          p1 = fmaf(g_r[k], h_s, p1);
          p2 = fmaf(g_s[k], h_r[k], p2);
        }
        const float wrev = o_wrev[e];
        for (int c = 32 * CPL + lane; c < f; c += 32) {
          const float gs_c = gv(gs_row[c]);
          p1 = fmaf(gv(gr_row[c]), to_f32(hs_row[c]), p1);
          p2 = fmaf(gs_c, to_f32(hr_row[c]), p2);
          dh_row[c] = fmaf(wrev, gs_c, dh_row[c]);
        }
        const float gden_s = gv(gs_row[f]);
        p1 = warp_sum(p1);
        p2 = warp_sum(p2);
        da_r += __fmul_rn(__fadd_rn(p1, gden_r), o_dfac[e]);
        da_s += __fmul_rn(__fadd_rn(p2, gden_s), o_dfacr[e]);
#pragma unroll
        for (int k = 0; k < CPL; ++k) acc[k] = fmaf(wrev, g_s[k], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (live[k]) dh_row[lane + 32 * k] = acc[k];
      if (lane == 0) {
        dar[gr] = da_r;
        das[gr] = da_s;
      }
    }
  }
}

template <typename T, bool ATT>
int launch_cluster(const void* h, const float* w, const float* a_s,
                   const float* a_r, const int* recv, const int* send,
                   const int* ptr, void* out, int n, int f, float bound,
                   float slope, cudaStream_t s) {
  using Out = std::conditional_t<ATT, float, T>;
  const int nb = (n + BN - 1) / BN;
  const size_t smem = sizeof(int) * (4 * CAP + 3 * BN + 1);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel<T, ATT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, (f + FT - 1) / FT);
  cluster_kernel<T, ATT><<<grid, THREADS, smem, s>>>(
      (const T*)h, w, a_s, a_r, recv, send, ptr, (Out*)out, n, f, bound,
      slope);
  return 0;
}

template <typename T>
int launch_bwd(const float* g, const void* h, const float* a_s,
               const float* a_r, const int* recv, const int* send,
               const int* ptr, float* dh, float* das, float* dar, int n,
               int f, float bound, float slope, cudaStream_t s) {
  const int nb = (n + BN - 1) / BN;
  const size_t smem = sizeof(int) * (6 * CAP + 4 * BN + 1);
  cudaError_t err = cudaFuncSetAttribute(
      att_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  att_bwd_kernel<T><<<nb, BWD_THREADS, smem, s>>>(
      g, (const T*)h, a_s, a_r, recv, send, ptr, dh, das, dar, n, f, bound,
      slope);
  return 0;
}

int block_ptr(const int* recv, int e, int n, int* ptr, cudaStream_t s) {
  const int nb = (n + BN - 1) / BN;
  block_ptr_kernel<<<(e + 1 + 255) / 256, 256, 0, s>>>(recv, e, nb, ptr);
  return 0;
}

}  // namespace

// h [n, f] (bf16 when `bf16` is non-zero, else f32), w [e] f32, recv and
// send [e] int32 sorted by (recv / 256, send / 256), ptr [ceil(n/256)+1]
// int32 scratch, out [n, f] of h's type.
extern "C" int hs_cluster_aggregate(const void* h, const float* w,
                                    const int* recv, const int* send,
                                    int* ptr, void* out, int e, int n,
                                    int f, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && f > 0) {
    block_ptr(recv, e, n, ptr, s);
    const int err =
        bf16 ? launch_cluster<__nv_bfloat16, false>(
                   h, w, nullptr, nullptr, recv, send, ptr, out, n, f, 0.0f,
                   0.0f, s)
             : launch_cluster<float, false>(h, w, nullptr, nullptr, recv,
                                            send, ptr, out, n, f, 0.0f, 0.0f,
                                            s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// h [n, f] (bf16 when `bf16` is non-zero, else f32), a_s and a_r [n] f32,
// recv and send [e] int32 sorted by (recv / 256, send / 256), ptr
// [ceil(n/256)+1] int32 scratch, out [n, f + 1] f32 (num | den).
extern "C" int hs_cluster_att_fwd(const void* h, const float* a_s,
                                  const float* a_r, const int* recv,
                                  const int* send, int* ptr, float* out,
                                  int e, int n, int f, int bf16, float bound,
                                  float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && f > 0) {
    block_ptr(recv, e, n, ptr, s);
    const int err =
        bf16 ? launch_cluster<__nv_bfloat16, true>(h, nullptr, a_s, a_r,
                                                   recv, send, ptr, out, n,
                                                   f, bound, slope, s)
             : launch_cluster<float, true>(h, nullptr, a_s, a_r, recv, send,
                                           ptr, out, n, f, bound, slope, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// g [n, f + 1] f32 (d_num | d_den), h [n, f] (bf16 when `bf16` is
// non-zero, else f32), a_s and a_r [n] f32, recv and send [e] int32 sorted
// by (recv / 256, send / 256) and closed under reversal, ptr
// [ceil(n/256)+1] int32 scratch; writes dh [n, f], das and dar [n], f32.
extern "C" int hs_cluster_att_bwd(const float* g, const void* h,
                                  const float* a_s, const float* a_r,
                                  const int* recv, const int* send, int* ptr,
                                  float* dh, float* das, float* dar, int e,
                                  int n, int f, int bf16, float bound,
                                  float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && f > 0) {
    block_ptr(recv, e, n, ptr, s);
    const int err =
        bf16 ? launch_bwd<__nv_bfloat16>(g, h, a_s, a_r, recv, send, ptr, dh,
                                         das, dar, n, f, bound, slope, s)
             : launch_bwd<float>(g, h, a_s, a_r, recv, send, ptr, dh, das,
                                 dar, n, f, bound, slope, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
