// Streaming k-NN scans (k <= 256), float32, for sm_90a.  Three entries
// share the warp's sorted top-k list (`insert`) and the split merge:
//
//  - hs_scan_topk: the exact scan over a table slab (below);
//  - hs_scan_topk_cand: per-query candidate rows, the IVF probing
//    scorer (after the merge kernel);
//  - hs_scan_topk_pq: ADC over a PQ-coded slab (after that).
//
// hs_scan_topk replaces hyperspace_tpu/kernels/scan_topk.py `_slab_body`
// (launched by `_launch_slab`), with the tile math of `_slab_tile`, the
// running top-k of `_merge` and the threshold test of `_prune`.
//
// Contract (identical to the Pallas kernel's): for each query row b,
// the k smallest distances to slab rows, ascending, with global ids
// col0 + local row; rows at global id >= n are masked, and so is the
// query's own row under exclude_self; unreachable slots are (+inf, -1);
// ties go to the lowest global column.
//
// What bounds it on an H100: the distance math.  Each of the B·M
// distances costs ~2D multiply-adds plus log1p and sqrt, while the
// bytes are one read of the table per query block plus 2·B·k·4 result
// bytes — at D = 10 the table is 3.3 MB and lives in the 50 MB L2.
// The design keeps the [B, M] distance matrix out of memory entirely:
//  - one warp per query row, WARPS query rows per block; the block
//    stages a tile of table rows in shared memory once for all of them;
//  - each lane computes one table row's distance per step, so a warp
//    tests 32 candidates at a time against its running k-th distance
//    (the threshold prune: once the list is full almost every
//    candidate fails that one comparison and costs nothing more);
//  - the running top-k is a sorted list in shared memory; the rare
//    candidate that beats the k-th is inserted by the whole warp (a
//    counted position, then a shift of at most k/32 entries a lane).
//    Candidates are visited in column order and an equal distance
//    never displaces an earlier entry, which is the lowest-column rule;
//  - the table is split over blockIdx.y so that small batches still
//    fill the card; each split keeps its own top-k and a second kernel
//    merges the splits, preferring the lower split (lower columns) on
//    equal distances.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int KMAX = 256;
constexpr int KREG = KMAX / 32;
constexpr int MAX_SPLITS = 64;
constexpr unsigned FULL = 0xffffffffu;

enum Kind { POINCARE = 0, LORENTZ = 1, EUCLIDEAN = 2 };

__device__ __forceinline__ float arcosh1p(float u) {
  u = fmaxf(u, 0.0f);
  return log1pf(u + sqrtf(fmaxf(u * (u + 2.0f), 0.0f)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Insert (d, id) into the warp's sorted list, after every entry <= d.
__device__ __forceinline__ void insert(float* ld, int* li, int k, int lane,
                                       float d, int id) {
  int cnt = 0;
  for (int i = lane; i < k; i += 32) cnt += (ld[i] <= d);
  const int pos = warp_sum(cnt);
  float rd[KREG];
  int ri[KREG];
#pragma unroll
  for (int t = 0; t < KREG; ++t) {
    const int i = pos + lane + 32 * t;
    if (i < k - 1) { rd[t] = ld[i]; ri[t] = li[i]; }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KREG; ++t) {
    const int i = pos + lane + 32 * t;
    if (i < k - 1) { ld[i + 1] = rd[t]; li[i + 1] = ri[t]; }
  }
  __syncwarp();
  if (lane == 0) { ld[pos] = d; li[pos] = id; }
  __syncwarp();
}

__global__ void __launch_bounds__(WARPS * 32)
scan_topk_kernel(const float* __restrict__ slab, const float* __restrict__ q,
                 const int* __restrict__ q_idx, float* __restrict__ out_d,
                 int* __restrict__ out_i, int B, int M, int D, int ds, int k,
                 int col0, int n, int exclude_self, float c, int kind,
                 int rows_per_split, int tm) {
  extern __shared__ float smem[];
  float* tile = smem;                                  // [tm][ds]
  float* qs = tile + (size_t)tm * ds;                  // [WARPS][D]
  float* lds = qs + (size_t)WARPS * D;                 // [WARPS][k]
  int* lis = reinterpret_cast<int*>(lds + (size_t)WARPS * k);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  const bool active = b < B;
  const int split = blockIdx.y, splits = gridDim.y;
  const int lo = split * rows_per_split;
  const int hi = min(M, lo + rows_per_split);
  float* qv = qs + (size_t)warp * D;
  float* ld = lds + (size_t)warp * k;
  int* li = lis + (size_t)warp * k;

  float xx = 0.0f;
  int qi = -1;
  if (active) {
    float s = 0.0f;
    for (int kk = lane; kk < D; kk += 32) {
      const float v = q[(size_t)b * D + kk];
      s = fmaf(v, v, s);
      qv[kk] = (kind == LORENTZ && kk == 0) ? -v : v;  // Minkowski signature
    }
    xx = warp_sum(s);
    qi = q_idx[b];
    for (int i = lane; i < k; i += 32) { ld[i] = INFINITY; li[i] = -1; }
  }
  __syncwarp();
  float kth = INFINITY;
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), 1e-12f);
  const float xm = 1.0f - c * xx;

  for (int t0 = lo; t0 < hi; t0 += tm) {
    const int rows = min(tm, hi - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += WARPS * 32) {
      const int r = i / D, kk = i % D;
      tile[r * ds + kk] = slab[(size_t)(t0 + r) * D + kk];
    }
    __syncthreads();
    if (!active) continue;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      const int gcol = col0 + t0 + r;
      float d = INFINITY;
      if (r < rows && gcol < n && !(exclude_self && gcol == qi)) {
        const float* row = tile + r * ds;
        float g = 0.0f, yy = 0.0f;
        for (int kk = 0; kk < D; ++kk) {
          const float yv = row[kk];
          g = fmaf(qv[kk], yv, g);
          yy = fmaf(yv, yv, yy);
        }
        if (kind == LORENTZ) {
          d = arcosh1p(fmaxf(-c * g - 1.0f, 0.0f)) / sc;
        } else {
          const float d2 = fmaxf(xx - 2.0f * g + yy, 0.0f);
          if (kind == EUCLIDEAN) {
            d = sqrtf(d2);
          } else {
            const float den = xm * (1.0f - c * yy);
            d = arcosh1p(2.0f * c * d2 / fmaxf(den, 1e-7f)) / sc;
          }
        }
      }
      unsigned hit = __ballot_sync(FULL, d < kth);
      while (hit) {
        const int src = __ffs(hit) - 1;
        hit &= hit - 1;
        const float dc = __shfl_sync(FULL, d, src);
        if (dc < kth) {
          insert(ld, li, k, lane, dc, col0 + t0 + r0 + src);
          kth = ld[k - 1];
        }
      }
    }
  }
  if (active) {
    const size_t base = ((size_t)b * splits + split) * k;
    for (int i = lane; i < k; i += 32) {
      out_d[base + i] = ld[i];
      out_i[base + i] = li[i];
    }
  }
}

// Merge each query row's per-split sorted lists ([B, S, k]) into [B, k].
__global__ void merge_splits_kernel(const float* __restrict__ pd,
                                    const int* __restrict__ pi,
                                    float* __restrict__ od,
                                    int* __restrict__ oi, int B, int S,
                                    int k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int head[MAX_SPLITS];
  for (int s = 0; s < S; ++s) head[s] = 0;
  for (int j = 0; j < k; ++j) {
    float best = INFINITY;
    int bs = -1;
    for (int s = 0; s < S; ++s) {
      if (head[s] < k) {
        const float v = pd[((size_t)b * S + s) * k + head[s]];
        if (v < best) { best = v; bs = s; }
      }
    }
    if (bs < 0) {
      od[(size_t)b * k + j] = INFINITY;
      oi[(size_t)b * k + j] = -1;
    } else {
      od[(size_t)b * k + j] = best;
      oi[(size_t)b * k + j] = pi[((size_t)b * S + bs) * k + head[bs]];
      ++head[bs];
    }
  }
}

// --- per-query candidate scan (the IVF probing scorer) --------------------
//
// Replaces hyperspace_tpu/kernels/scan_topk.py `_cand_body` (launched by
// `_launch_cand`), with the tile math of `_cand_tile`/`_pair_dist_b`.
// Contract: query row b scores the table rows whose ids stand in
// cand[b, 0..C) (-1 = padding, anywhere in the list); its own row is
// masked under exclude_self; ties go to the earlier candidate position;
// slots beyond the reachable candidates are (+inf, -1).
//
// What bounds it on an H100: the gathers.  Each candidate costs one
// random row read of D floats (the 3.3 MB table of the serving path sits
// in the 50 MB L2) and ~2D multiply-adds.  The TPU kernel streams a
// pre-gathered [B, C, 128-lane] block; this one gathers each row by id
// straight from the table, so no [B, C, D] copy is ever written:
//  - one warp per query row; each lane takes one candidate position a
//    step, reads its id and its row, and computes the closed form;
//  - the warp tests the 32 distances against its running k-th and
//    inserts the rare winners in position order (`insert` puts an equal
//    distance after the earlier entry);
//  - the positions are split over blockIdx.y when the batch is small,
//    each split with its own list, merged by merge_splits_kernel (the
//    lower split, earlier positions, wins a tie).
__global__ void __launch_bounds__(WARPS * 32)
scan_cand_kernel(const float* __restrict__ table, const int* __restrict__ cand,
                 const float* __restrict__ q, const int* __restrict__ q_idx,
                 float* __restrict__ out_d, int* __restrict__ out_i, int B,
                 int C, int N, int D, int k, int exclude_self, float c,
                 int kind, int per_split) {
  extern __shared__ float smem[];
  float* qs = smem;                                    // [WARPS][D]
  float* lds = qs + (size_t)WARPS * D;                 // [WARPS][k]
  int* lis = reinterpret_cast<int*>(lds + (size_t)WARPS * k);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;                 // no block-wide barrier below
  const int split = blockIdx.y, splits = gridDim.y;
  const int lo = split * per_split;
  const int hi = min(C, lo + per_split);
  float* qv = qs + (size_t)warp * D;
  float* ld = lds + (size_t)warp * k;
  int* li = lis + (size_t)warp * k;

  float s = 0.0f;
  for (int kk = lane; kk < D; kk += 32) {
    const float v = q[(size_t)b * D + kk];
    s = fmaf(v, v, s);
    qv[kk] = (kind == LORENTZ && kk == 0) ? -v : v;    // Minkowski signature
  }
  const float xx = warp_sum(s);
  const int qi = q_idx[b];
  for (int i = lane; i < k; i += 32) { ld[i] = INFINITY; li[i] = -1; }
  __syncwarp();
  float kth = INFINITY;
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), 1e-12f);
  const float xm = 1.0f - c * xx;
  const int* crow = cand + (size_t)b * C;

  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int p = p0 + lane;
    const int id = p < hi ? crow[p] : -1;
    float d = INFINITY;
    if (id >= 0 && id < N && !(exclude_self && id == qi)) {
      const float* row = table + (size_t)id * D;
      float g = 0.0f, yy = 0.0f;
      for (int kk = 0; kk < D; ++kk) {
        const float yv = __ldg(row + kk);
        g = fmaf(qv[kk], yv, g);
        yy = fmaf(yv, yv, yy);
      }
      if (kind == LORENTZ) {
        d = arcosh1p(fmaxf(-c * g - 1.0f, 0.0f)) / sc;
      } else {
        const float d2 = fmaxf(xx - 2.0f * g + yy, 0.0f);
        if (kind == EUCLIDEAN) {
          d = sqrtf(d2);
        } else {
          const float den = xm * (1.0f - c * yy);
          d = arcosh1p(2.0f * c * d2 / fmaxf(den, 1e-7f)) / sc;
        }
      }
    }
    unsigned hit = __ballot_sync(FULL, d < kth);
    while (hit) {
      const int src = __ffs(hit) - 1;
      hit &= hit - 1;
      const float dc = __shfl_sync(FULL, d, src);
      const int ic = __shfl_sync(FULL, id, src);
      if (dc < kth) {
        insert(ld, li, k, lane, dc, ic);
        kth = ld[k - 1];
      }
    }
  }
  const size_t base = ((size_t)b * splits + split) * k;
  for (int i = lane; i < k; i += 32) {
    out_d[base + i] = ld[i];
    out_i[base + i] = li[i];
  }
}

// --- PQ scan by ADC ----------------------------------------------------------
//
// Replaces hyperspace_tpu/kernels/scan_topk.py `_pq_body` (launched by
// `_launch_pq`), with the tile math of `_pq_tile`/`_pq_dist_from_sum`.
// Contract: hs_scan_topk's, over codes [M, m] uint8 and per-query lookup
// tables lut [B, m*256]: a row's score is the sum of lut[s*256 + code[s]]
// over s = 0..m-1, in that order, closed into the distance of the
// reconstructed row with the TPU kernel's clamps.
//
// What bounds it on an H100: the table lookups.  A row costs m bytes of
// code and m shared-memory reads (at m = 3 the 82,115-row slab is 246 KB,
// so device memory is nowhere near the limit).  The design:
//  - eight query warps a block, each with its m*256-float LUT in shared
//    memory (8 KB at m = 8; the block opts into dynamic shared memory
//    above 48 KB);
//  - one tile of code rows is staged in shared memory once for all eight
//    warps; each lane scores one row a step;
//  - lanes read their LUT entries at data-dependent addresses, so a
//    step's 32 reads meet bank conflicts (about 3-way for random codes);
//    left as is in this first version;
//  - the threshold test, `insert` and the split merge as hs_scan_topk;
//    at k = 170 (the engine's over-fetch at k = 10) the list fills over
//    the first rows and inserts dominate the first tile only.
__global__ void __launch_bounds__(WARPS * 32)
scan_pq_kernel(const unsigned char* __restrict__ codes,
               const float* __restrict__ lut, const int* __restrict__ q_idx,
               float* __restrict__ out_d, int* __restrict__ out_i, int B,
               int M, int m, int k, int col0, int n, int exclude_self,
               float c, int kind, int rows_per_split, int tm) {
  extern __shared__ float smem[];
  const int lw = m * 256;
  float* luts = smem;                                  // [WARPS][m*256]
  float* lds = luts + (size_t)WARPS * lw;              // [WARPS][k]
  int* lis = reinterpret_cast<int*>(lds + (size_t)WARPS * k);
  unsigned char* tile =
      reinterpret_cast<unsigned char*>(lis + (size_t)WARPS * k);  // [tm][m]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  const bool active = b < B;
  const int split = blockIdx.y, splits = gridDim.y;
  const int lo = split * rows_per_split;
  const int hi = min(M, lo + rows_per_split);
  float* lv = luts + (size_t)warp * lw;
  float* ld = lds + (size_t)warp * k;
  int* li = lis + (size_t)warp * k;

  int qi = -1;
  if (active) {
    for (int i = lane; i < lw; i += 32) lv[i] = lut[(size_t)b * lw + i];
    qi = q_idx[b];
    for (int i = lane; i < k; i += 32) { ld[i] = INFINITY; li[i] = -1; }
  }
  __syncwarp();
  float kth = INFINITY;
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), 1e-12f);

  for (int t0 = lo; t0 < hi; t0 += tm) {
    const int rows = min(tm, hi - t0);
    __syncthreads();
    const unsigned char* src = codes + (size_t)t0 * m;
    for (int i = threadIdx.x; i < rows * m; i += WARPS * 32) tile[i] = src[i];
    __syncthreads();
    if (!active) continue;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      const int gcol = col0 + t0 + r;
      float d = INFINITY;
      if (r < rows && gcol < n && !(exclude_self && gcol == qi)) {
        const unsigned char* code = tile + (size_t)r * m;
        float ssum = 0.0f;
        for (int s = 0; s < m; ++s)
          ssum = __fadd_rn(ssum, lv[s * 256 + code[s]]);
        if (kind == EUCLIDEAN) {
          d = sqrtf(fmaxf(ssum, 0.0f));
        } else {
          // the plain version's rounding: no contraction into an FMA
          const float u = fmaxf(__fsub_rn(__fmul_rn(-c, ssum), 1.0f), 0.0f);
          d = arcosh1p(u) / sc;
        }
      }
      unsigned hit = __ballot_sync(FULL, d < kth);
      while (hit) {
        const int srcl = __ffs(hit) - 1;
        hit &= hit - 1;
        const float dc = __shfl_sync(FULL, d, srcl);
        if (dc < kth) {
          insert(ld, li, k, lane, dc, col0 + t0 + r0 + srcl);
          kth = ld[k - 1];
        }
      }
    }
  }
  if (active) {
    const size_t base = ((size_t)b * splits + split) * k;
    for (int i = lane; i < k; i += 32) {
      out_d[base + i] = ld[i];
      out_i[base + i] = li[i];
    }
  }
}

}  // namespace

// Shared memory the scan kernel needs for a tile of `tm` rows.
static size_t smem_bytes(int D, int ds, int k, int tm) {
  return ((size_t)tm * ds + (size_t)WARPS * D + (size_t)WARPS * k) * 4 +
         (size_t)WARPS * k * 4;
}

extern "C" int hs_scan_topk(const float* slab, const float* q,
                            const int* q_idx, float* part_d, int* part_i,
                            float* od, int* oi, int B, int M, int D, int k,
                            int col0, int n, int exclude_self, float c,
                            int kind, int splits, void* stream) {
  if (k < 1 || k > KMAX || splits < 1 || splits > MAX_SPLITS || D < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int ds = D | 1;  // odd row stride: lanes read distinct banks
  const size_t budget = 200 * 1024;
  int tm = 256;
  while (tm > 32 && smem_bytes(D, ds, k, tm) > budget) tm -= 32;
  const size_t bytes = smem_bytes(D, ds, k, tm);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      scan_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_split = (M + splits - 1) / splits;
  dim3 grid((B + WARPS - 1) / WARPS, splits);
  float* sd = splits == 1 ? od : part_d;
  int* si = splits == 1 ? oi : part_i;
  scan_topk_kernel<<<grid, WARPS * 32, bytes, st>>>(
      slab, q, q_idx, sd, si, B, M, D, ds, k, col0, n, exclude_self, c, kind,
      rows_per_split, tm);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  merge_splits_kernel<<<(B + 127) / 128, 128, 0, st>>>(part_d, part_i, od, oi,
                                                       B, splits, k);
  return (int)cudaGetLastError();
}

// Merge each row's split lists into [B, k] when the launch used splits.
static int merge_if_split(float* pd, int* pi, float* od, int* oi, int B,
                          int splits, int k, cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  merge_splits_kernel<<<(B + 127) / 128, 128, 0, st>>>(pd, pi, od, oi, B,
                                                       splits, k);
  return (int)cudaGetLastError();
}

extern "C" int hs_scan_topk_cand(const float* table, const int* cand,
                                 const float* q, const int* q_idx,
                                 float* part_d, int* part_i, float* od,
                                 int* oi, int B, int C, int N, int D, int k,
                                 int exclude_self, float c, int kind,
                                 int splits, void* stream) {
  if (k < 1 || k > KMAX || splits < 1 || splits > MAX_SPLITS || D < 1 ||
      C < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = ((size_t)WARPS * D + (size_t)WARPS * k) * 4 +
                       (size_t)WARPS * k * 4;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      scan_cand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int per_split = (C + splits - 1) / splits;
  dim3 grid((B + WARPS - 1) / WARPS, splits);
  scan_cand_kernel<<<grid, WARPS * 32, bytes, st>>>(
      table, cand, q, q_idx, splits == 1 ? od : part_d,
      splits == 1 ? oi : part_i, B, C, N, D, k, exclude_self, c, kind,
      per_split);
  return merge_if_split(part_d, part_i, od, oi, B, splits, k, st);
}

extern "C" int hs_scan_topk_pq(const unsigned char* codes, const float* lut,
                               const int* q_idx, float* part_d, int* part_i,
                               float* od, int* oi, int B, int M, int m, int k,
                               int col0, int n, int exclude_self, float c,
                               int kind, int splits, void* stream) {
  if (k < 1 || k > KMAX || splits < 1 || splits > MAX_SPLITS || m < 1 ||
      m > 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int tm = 1024;
  const size_t bytes = ((size_t)WARPS * m * 256 + (size_t)WARPS * k) * 4 +
                       (size_t)WARPS * k * 4 + (size_t)tm * m;
  cudaError_t e = cudaFuncSetAttribute(
      scan_pq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_split = (M + splits - 1) / splits;
  dim3 grid((B + WARPS - 1) / WARPS, splits);
  scan_pq_kernel<<<grid, WARPS * 32, bytes, st>>>(
      codes, lut, q_idx, splits == 1 ? od : part_d,
      splits == 1 ? oi : part_i, B, M, m, k, col0, n, exclude_self, c, kind,
      rows_per_split, tm);
  return merge_if_split(part_d, part_i, od, oi, B, splits, k, st);
}
