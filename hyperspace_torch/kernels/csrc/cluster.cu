// Cluster-pair aggregation out[r] = Σ_e w_e · h[s_e] over the clustered
// edges, bf16 or f32 h, f32 accumulation, for sm_90a.
//
// Replaces hyperspace_tpu/kernels/cluster.py `cluster_aggregate` (the
// Pallas kernel built by `_body`), which walks (receiver block, sender
// block) plan items and turns each 128-edge sub-chunk into two one-hot
// matrix products, so that no [E, F] message array is ever written.
// That form exists because the TPU has no atomics and no fast scatter;
// here a block owns its receiver rows and gathers sender rows directly.
//
// What bounds it on an H100: bytes — h read once (N·F·size(h)), 12 B per
// edge (receiver, sender, weight) and the output written once, about
// 0.03 ms at h [169,343, 128] bf16.  What stands between the kernel and
// that bound is the latency of the random sender-row reads, so the
// design keeps many independent row reads in flight:
//   1. `block_ptr_kernel`: the edges arrive sorted by (receiver block,
//      sender block), so each 256-row receiver block's edges are one
//      contiguous range; one thread per edge boundary writes the range
//      pointers.
//   2. `cluster_kernel`: one thread block per (receiver block, 128-column
//      tile), 32 warps; warp w owns rows w, w + 32, … of the block and
//      keeps their f32 sums in registers.  The block stages its edges
//      2,048 at a time in shared memory and sorts them by row with a
//      stable counting sort (warp 0 ranks each edge within its row in
//      arrival order with __match_any_sync, then a scan gives each row's
//      range).  Each warp then walks its rows' edges with the lanes on
//      feature columns (4 per lane), two sender rows in flight, adding
//      w·h[s] in f32.  A row has one owner, so there are no atomics, and
//      it sums its edges in list order: the result is deterministic.
//   As the TPU kernel does in its bf16 mode, a bf16 h takes its weights
//   rounded to bf16 before the product; the products of two bf16 values
//   are exact in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 256;     // receiver rows per block (the TPU kernel's _BN)
constexpr int WARPS = 32;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_WARP = BN / WARPS;
constexpr int CPL = 4;      // feature columns per lane
constexpr int FT = 32 * CPL;  // columns per block; grid.y tiles wider h
constexpr int CAP = 2048;   // edges staged in shared memory per step
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
cluster_kernel(const T* __restrict__ h, const float* __restrict__ w,
               const int* __restrict__ recv, const int* __restrict__ send,
               const int* __restrict__ ptr, T* __restrict__ out, int n,
               int f) {
  extern __shared__ int smem[];
  int* s_row = smem;                        // [CAP] staged, arrival order
  int* s_snd = s_row + CAP;
  float* s_w = (float*)(s_snd + CAP);
  int* s_pos = (int*)(s_w + CAP);           // rank within its row
  int* o_snd = s_pos + CAP;                 // [CAP] sorted by row
  float* o_w = (float*)(o_snd + CAP);
  int* cnt = (int*)(o_w + CAP);             // [BN] edges per row
  int* off = cnt + BN;                      // [BN + 1] row ranges
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = blockIdx.x;
  const int c0 = blockIdx.y * FT;
  const bool bf16 = sizeof(T) == 2;

  bool live[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) live[k] = c0 + lane + 32 * k < f;
  float acc[ROWS_PER_WARP][CPL];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q)
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[q][k] = 0.0f;

  const int e0 = ptr[rb], e1 = ptr[rb + 1];
  for (int base = e0; base < e1; base += CAP) {
    const int m = min(CAP, e1 - base);
    __syncthreads();  // the last chunk is consumed
    for (int i = threadIdx.x; i < BN; i += THREADS) cnt[i] = 0;
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const int r = recv[base + i] - rb * BN;
      s_row[i] = (r >= 0 && r < BN) ? r : -1;
      s_snd[i] = send[base + i];
      const float wi = w[base + i];
      s_w[i] = bf16 ? __bfloat162float(__float2bfloat16_rn(wi)) : wi;
    }
    __syncthreads();
    if (warp == 0) {  // stable rank of each edge within its row
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
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const int r = s_row[i];
      if (r < 0) continue;
      const int d = off[r] + s_pos[i];
      o_snd[d] = s_snd[i];
      o_w[d] = s_w[i];
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
      }
      if (e < b) {
        const T* p0 = h + (size_t)o_snd[e] * f + c0 + lane;
        const float w0 = o_w[e];
#pragma unroll
        for (int k = 0; k < CPL; ++k)
          if (live[k]) acc[q][k] += w0 * to_f32(p0[32 * k]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int gr = rb * BN + warp + q * WARPS;
    if (gr >= n) continue;
    T* o = out + (size_t)gr * f + c0 + lane;
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (live[k]) store(o + 32 * k, acc[q][k]);
  }
}

template <typename T>
int launch(const void* h, const float* w, const int* recv, const int* send,
           const int* ptr, void* out, int n, int f, cudaStream_t s) {
  const int nb = (n + BN - 1) / BN;
  const size_t smem = sizeof(int) * (6 * CAP + 2 * BN + 1);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb, (f + FT - 1) / FT);
  cluster_kernel<T><<<grid, THREADS, smem, s>>>(
      (const T*)h, w, recv, send, ptr, (T*)out, n, f);
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
    const int nb = (n + BN - 1) / BN;
    block_ptr_kernel<<<(e + 1 + 255) / 256, 256, 0, s>>>(recv, e, nb, ptr);
    const int err = bf16 ? launch<__nv_bfloat16>(h, w, recv, send, ptr, out,
                                                 n, f, s)
                         : launch<float>(h, w, recv, send, ptr, out, n, f,
                                         s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
