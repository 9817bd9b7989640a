// Hyperbolic flash attention (HyboNet, Chen et al. 2022) for sm_90a:
// forward, dq and dk/dv, f32 in and out, f32 FMA arithmetic.
//
// Replaces hyperspace_tpu/kernels/attention.py: the forward `_attn_body`
// (pallas_call at :199), the dq kernel `_dq_body` (:410) and the dk/dv
// kernel `_dkv_body` (:461).  Scores are affine in the squared Lorentz
// distance, σ_ij = (2/c + 2⟨q_i,k_j⟩_L + β)/τ, the softmax weights average
// the values, and the epilogue rescales the average back onto the
// hyperboloid: out = s / (√c·√(−⟨s,s⟩_L)).  The forward also writes each
// row's log-sum-exp (1e30 on rows with no valid key, so a recomputed
// weight exp(σ − lse) underflows to 0) and the pre-normalisation norm;
// the backward recomputes σ and the weights from them, so no [Nq, Nk]
// matrix is ever stored in either direction.
//
// What bounds it on an H100: operations.  Per (batch·head) the forward
// does 2·Nq·Nk·D multiply-adds (the Gram and p·v), dq 3·Nq·Nk·D (Gram,
// ⟨dsp, v⟩, dσ·Jk) and dk/dv 4·Nq·Nk·D (Gram, p·dsp, ⟨dsp, v⟩, dσ·Jq),
// against D·(Nq + Nk) values read.  At HyboNet's D = 33 that is about
// 16 operations per byte, so float32 FMA throughput (67 TFLOP/s) is the
// bound, not the 3.35 TB/s of device memory.
//
// Design (a simple, right kernel; tensor cores, TMA and warp
// specialisation are later work):
//   - one thread owns one row: a query row in the forward and in dq, a
//     key row in dk/dv.  Its operand row and its f32 accumulators live in
//     registers, zero-padded from D to DP (a multiple of 8);
//   - a block of 64 threads streams the other side through shared memory
//     in tiles of 64 rows (k with lane 0 negated, v; or q, dsp, lse, di),
//     read back as float4 broadcasts: every thread of a warp reads the
//     same word, so there are no bank conflicts;
//   - the mask is uint8 [B/group, Nq, Nk], shared by `group` consecutive
//     batch·head rows (the heads of one sequence), staged per tile;
//   - σ is computed by one routine in all three kernels, with explicitly
//     rounded operations in the JAX kernel's order, so the backward's
//     recomputed weights see the forward's bits;
//   - the forward carries (running max, denominator, numerator) through
//     16-key chunks (one rescale per chunk); dq writes each query block's
//     partial of Σ dσ·σ (the τ gradient), summed in a fixed order by the
//     caller: no atomics anywhere, every result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;    // threads per block = rows owned per block
constexpr int TILE = 64;    // rows of the other side per shared tile
constexpr int CHUNK = 16;   // keys per online-softmax rescale (forward)
constexpr float NEG = -1e30f;
constexpr float LSE_EMPTY = 1e30f;
constexpr float EPS_F32 = 1e-7f;
constexpr float MIN_NORM_F32 = 1e-12f;

// Σ_d r[d]·s[d] in ascending d with one FMA each: r in registers, s a
// 16-byte aligned shared row.  Both operand orders give the same bits.
template <int DP>
__device__ __forceinline__ float dot_rs(const float (&r)[DP],
                                        const float* s) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float g = 0.0f;
#pragma unroll
  for (int t = 0; t < DP / 4; ++t) {
    const float4 w = s4[t];
    g = fmaf(r[4 * t + 0], w.x, g);
    g = fmaf(r[4 * t + 1], w.y, g);
    g = fmaf(r[4 * t + 2], w.z, g);
    g = fmaf(r[4 * t + 3], w.w, g);
  }
  return g;
}

// acc[d] += w·s[d]
template <int DP>
__device__ __forceinline__ void axpy_rs(float (&acc)[DP], float w,
                                        const float* s) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int t = 0; t < DP / 4; ++t) {
    const float4 u = s4[t];
    acc[4 * t + 0] = fmaf(w, u.x, acc[4 * t + 0]);
    acc[4 * t + 1] = fmaf(w, u.y, acc[4 * t + 1]);
    acc[4 * t + 2] = fmaf(w, u.z, acc[4 * t + 2]);
    acc[4 * t + 3] = fmaf(w, u.w, acc[4 * t + 3]);
  }
}

// σ = (2/c + 2·gram + β)/τ, each operation rounded on its own (never
// contracted), in the order of hyperspace_tpu/kernels/attention.py:93
__device__ __forceinline__ float score(float gram, float two_c, float beta,
                                       float tau) {
  return __fdiv_rn(__fadd_rn(__fadd_rn(two_c, __fmul_rn(2.0f, gram)), beta),
                   tau);
}

// One row of a [n, d] f32 matrix into registers, zero-padded to DP;
// `neg0` negates lane 0 (the Minkowski flip J).
template <int DP>
__device__ __forceinline__ void load_row(float (&r)[DP], const float* src,
                                         bool ok, int d, bool neg0) {
#pragma unroll
  for (int t = 0; t < DP; ++t) r[t] = (ok && t < d) ? src[t] : 0.0f;
  if (neg0) r[0] = -r[0];
}

// rows [r0, r0 + TILE) of a [n, d] matrix into a shared [TILE][DP] tile,
// zero-filled past n and past d; `neg0` negates lane 0
template <int DP>
__device__ __forceinline__ void load_tile(float (*dst)[DP],
                                          const float* src, int r0, int n,
                                          int d, bool neg0) {
  for (int e = threadIdx.x; e < TILE * DP; e += ROWS) {
    const int r = e / DP, col = e - r * DP;
    float val = 0.0f;
    if (r0 + r < n && col < d) {
      val = src[(size_t)(r0 + r) * d + col];
      if (neg0 && col == 0) val = -val;
    }
    dst[r][col] = val;
  }
}

// valid(i, j) for the [ROWS or TILE] × [TILE or ROWS] block of (query,
// key) pairs starting at (i0, j0): in range and, with a mask, mask > 0.
// `by_key` stores it as t[j][i] (queries on threads read along i), else
// t[i][j] (keys on threads read along j).
__device__ __forceinline__ void load_valid(unsigned char* t, int ni, int nj,
                                           const unsigned char* mask, int i0,
                                           int j0, int nq, int nk,
                                           bool by_key) {
  for (int e = threadIdx.x; e < ni * nj; e += ROWS) {
    const int i = e / nj, j = e - i * nj;
    const int qi = i0 + i, kj = j0 + j;
    unsigned char ok = qi < nq && kj < nk;
    if (ok && mask != nullptr) ok = mask[(size_t)qi * nk + kj] != 0;
    t[by_key ? j * ni + i : i * nj + j] = ok;
  }
}

// ---- forward ---------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(ROWS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const unsigned char* __restrict__ mask, int group,
                 const float* __restrict__ beta,
                 const float* __restrict__ tau, float c, int nq, int nk,
                 int d, float* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ nrm) {
  __shared__ __align__(16) float ks[TILE][DP];
  __shared__ __align__(16) float vs[TILE][DP];
  __shared__ unsigned char ok[TILE * ROWS];  // ok[j][i]
  const int b = blockIdx.y, i0 = blockIdx.x * ROWS, i = i0 + threadIdx.x;
  const bool row_ok = i < nq;
  const float two_c = __fdiv_rn(2.0f, c), be = beta[b], ta = tau[b];
  const float* kb = k + (size_t)b * nk * d;
  const float* vb = v + (size_t)b * nk * d;
  const unsigned char* mb =
      mask == nullptr ? nullptr : mask + (size_t)(b / group) * nq * nk;
  float qr[DP], acc[DP];
  load_row(qr, q + ((size_t)b * nq + i) * d, row_ok, d, false);
#pragma unroll
  for (int t = 0; t < DP; ++t) acc[t] = 0.0f;
  float m = NEG, l = 0.0f;
  for (int j0 = 0; j0 < nk; j0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    load_tile<DP>(ks, kb, j0, nk, d, true);
    load_tile<DP>(vs, vb, j0, nk, d, false);
    load_valid(ok, ROWS, TILE, mb, i0, j0, nq, nk, true);
    __syncthreads();
    const int rows = min(TILE, nk - j0);
    for (int jc = 0; jc < rows; jc += CHUNK) {
      float s[CHUNK];
      float cmax = NEG;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int j = jc + u;
        s[u] = NEG;
        if (ok[j * ROWS + threadIdx.x])
          s[u] = score(dot_rs<DP>(qr, ks[j]), two_c, be, ta);
        cmax = fmaxf(cmax, s[u]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        s[u] = ok[(jc + u) * ROWS + threadIdx.x] ? expf(s[u] - m_new) : 0.0f;
        psum += s[u];
      }
      l = alpha * l + psum;
#pragma unroll
      for (int t = 0; t < DP; ++t) acc[t] *= alpha;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) axpy_rs<DP>(acc, s[u], vs[jc + u]);
      m = m_new;
    }
  }
  if (!row_ok) return;
  // epilogue (kernels/attention.py:116-135): s = acc/l, rescaled onto the
  // hyperboloid with the kernel's clamps; rows with no valid key give 0
  const float l_den = fmaxf(l, MIN_NORM_F32);
  float sp = 0.0f;
#pragma unroll
  for (int t = 0; t < DP; ++t) {
    acc[t] /= l_den;
    sp = fmaf(t == 0 ? -acc[t] : acc[t], acc[t], sp);
  }
  const float nv = sqrtf(fmaxf(fmaxf(-sp, EPS_F32), 0.0f));
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), MIN_NORM_F32);
  const float scale = sc * nv;
  float* o = out + ((size_t)b * nq + i) * d;
#pragma unroll
  for (int t = 0; t < DP; ++t)
    if (t < d) o[t] = acc[t] / scale;
  lse[(size_t)b * nq + i] =
      l > 0.0f ? m + logf(fmaxf(l, 1e-38f)) : LSE_EMPTY;
  nrm[(size_t)b * nq + i] = nv;
}

// ---- dq --------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(ROWS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dsp,
                const float* __restrict__ lse, const float* __restrict__ di,
                const unsigned char* __restrict__ mask, int group,
                const float* __restrict__ beta,
                const float* __restrict__ tau, float c, int nq, int nk,
                int d, float* __restrict__ dq, float* __restrict__ part) {
  __shared__ __align__(16) float ks[TILE][DP];
  __shared__ __align__(16) float vs[TILE][DP];
  __shared__ unsigned char ok[TILE * ROWS];  // ok[j][i]
  __shared__ float red[ROWS];
  const int b = blockIdx.y, i0 = blockIdx.x * ROWS, i = i0 + threadIdx.x;
  const bool row_ok = i < nq;
  const float two_c = __fdiv_rn(2.0f, c), be = beta[b], ta = tau[b];
  const float* kb = k + (size_t)b * nk * d;
  const float* vb = v + (size_t)b * nk * d;
  const unsigned char* mb =
      mask == nullptr ? nullptr : mask + (size_t)(b / group) * nq * nk;
  const size_t row = (size_t)b * nq + i;
  float qr[DP], gr[DP], acc[DP];
  load_row(qr, q + row * d, row_ok, d, false);
  load_row(gr, dsp + row * d, row_ok, d, false);
#pragma unroll
  for (int t = 0; t < DP; ++t) acc[t] = 0.0f;
  const float lse_i = row_ok ? lse[row] : LSE_EMPTY;
  const float di_i = row_ok ? di[row] : 0.0f;
  float tsum = 0.0f;  // Σ_j dσ_ij·σ_ij
  for (int j0 = 0; j0 < nk; j0 += TILE) {
    __syncthreads();
    load_tile<DP>(ks, kb, j0, nk, d, true);
    load_tile<DP>(vs, vb, j0, nk, d, false);
    load_valid(ok, ROWS, TILE, mb, i0, j0, nq, nk, true);
    __syncthreads();
    const int rows = min(TILE, nk - j0);
    for (int j = 0; j < rows; ++j) {
      if (!ok[j * ROWS + threadIdx.x]) continue;
      const float sig = score(dot_rs<DP>(qr, ks[j]), two_c, be, ta);
      const float p = expf(sig - lse_i);
      const float dsig = p * (dot_rs<DP>(gr, vs[j]) - di_i);
      axpy_rs<DP>(acc, dsig, ks[j]);
      tsum = fmaf(dsig, sig, tsum);
    }
  }
  if (row_ok) {
    const float s = 2.0f / ta;
    float* o = dq + row * d;
#pragma unroll
    for (int t = 0; t < DP; ++t)
      if (t < d) o[t] = s * acc[t];
  }
  // the block's partial of Σ dσ·σ, by a fixed-order tree
  red[threadIdx.x] = row_ok ? tsum : 0.0f;
  __syncthreads();
  for (int w = ROWS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) part[(size_t)b * gridDim.x + blockIdx.x] = red[0];
}

// ---- dk, dv ----------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(ROWS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dsp,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 const unsigned char* __restrict__ mask, int group,
                 const float* __restrict__ beta,
                 const float* __restrict__ tau, float c, int nq, int nk,
                 int d, float* __restrict__ dk, float* __restrict__ dv) {
  __shared__ __align__(16) float qs[TILE][DP];
  __shared__ __align__(16) float gs[TILE][DP];
  __shared__ float lse_s[TILE], di_s[TILE];
  __shared__ unsigned char ok[TILE * ROWS];  // ok[i][j]
  const int b = blockIdx.y, j0 = blockIdx.x * ROWS, j = j0 + threadIdx.x;
  const bool row_ok = j < nk;
  const float two_c = __fdiv_rn(2.0f, c), be = beta[b], ta = tau[b];
  const float* qb = q + (size_t)b * nq * d;
  const float* gb = dsp + (size_t)b * nq * d;
  const unsigned char* mb =
      mask == nullptr ? nullptr : mask + (size_t)(b / group) * nq * nk;
  const size_t row = (size_t)b * nk + j;
  float kr[DP], vr[DP], dka[DP], dva[DP];
  load_row(kr, k + row * d, row_ok, d, true);
  load_row(vr, v + row * d, row_ok, d, false);
#pragma unroll
  for (int t = 0; t < DP; ++t) dka[t] = dva[t] = 0.0f;
  for (int i0 = 0; i0 < nq; i0 += TILE) {
    __syncthreads();
    load_tile<DP>(qs, qb, i0, nq, d, false);
    load_tile<DP>(gs, gb, i0, nq, d, false);
    for (int e = threadIdx.x; e < TILE; e += ROWS) {
      const bool in = i0 + e < nq;
      lse_s[e] = in ? lse[(size_t)b * nq + i0 + e] : LSE_EMPTY;
      di_s[e] = in ? di[(size_t)b * nq + i0 + e] : 0.0f;
    }
    load_valid(ok, TILE, ROWS, mb, i0, j0, nq, nk, false);
    __syncthreads();
    const int rows = min(TILE, nq - i0);
    for (int ii = 0; ii < rows; ++ii) {
      if (!ok[ii * ROWS + threadIdx.x]) continue;
      const float sig = score(dot_rs<DP>(kr, qs[ii]), two_c, be, ta);
      const float p = expf(sig - lse_s[ii]);
      axpy_rs<DP>(dva, p, gs[ii]);
      const float dsig = p * (dot_rs<DP>(vr, gs[ii]) - di_s[ii]);
      axpy_rs<DP>(dka, dsig, qs[ii]);
    }
  }
  if (!row_ok) return;
  const float s = 2.0f / ta;
  float* odk = dk + row * d;
  float* odv = dv + row * d;
#pragma unroll
  for (int t = 0; t < DP; ++t) {
    if (t < d) {
      odk[t] = t == 0 ? -s * dka[t] : s * dka[t];  // dk = (2/τ)·J·Σ dσ q
      odv[t] = dva[t];
    }
  }
}

template <int DP>
int launch_fwd(const float* q, const float* k, const float* v,
               const unsigned char* mask, int group, const float* beta,
               const float* tau, float c, int b, int nq, int nk, int d,
               float* out, float* lse, float* nrm, cudaStream_t s) {
  const dim3 grid((nq + ROWS - 1) / ROWS, b);
  flash_fwd_kernel<DP><<<grid, ROWS, 0, s>>>(q, k, v, mask, group, beta,
                                             tau, c, nq, nk, d, out, lse,
                                             nrm);
  return 0;
}

template <int DP>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* dsp, const float* lse, const float* di,
               const unsigned char* mask, int group, const float* beta,
               const float* tau, float c, int b, int nq, int nk, int d,
               float* dq, float* part, float* dk, float* dv,
               cudaStream_t s) {
  if (dq != nullptr) {
    const dim3 grid((nq + ROWS - 1) / ROWS, b);
    flash_dq_kernel<DP><<<grid, ROWS, 0, s>>>(q, k, v, dsp, lse, di, mask,
                                              group, beta, tau, c, nq, nk,
                                              d, dq, part);
  } else {
    const dim3 grid((nk + ROWS - 1) / ROWS, b);
    flash_dkv_kernel<DP><<<grid, ROWS, 0, s>>>(q, k, v, dsp, lse, di, mask,
                                               group, beta, tau, c, nq, nk,
                                               d, dk, dv);
  }
  return 0;
}

// DP = D rounded up to a multiple of 8, 8 ≤ DP ≤ MAX_DP
constexpr int MAX_DP = 72;

#define HS_DISPATCH(DPV, CALL) \
  switch (DPV) {               \
    case 8: CALL(8); break;    \
    case 16: CALL(16); break;  \
    case 24: CALL(24); break;  \
    case 32: CALL(32); break;  \
    case 40: CALL(40); break;  \
    case 48: CALL(48); break;  \
    case 56: CALL(56); break;  \
    case 64: CALL(64); break;  \
    case 72: CALL(72); break;  \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

// q [b, nq, d], k and v [b, nk, d], mask null or uint8 [b/group, nq, nk],
// beta and tau [b]; writes out [b, nq, d], lse and nrm [b, nq].  All f32
// and contiguous; 1 ≤ d ≤ 72.
extern "C" int hs_flash_fwd(const float* q, const float* k, const float* v,
                            const unsigned char* mask, int group,
                            const float* beta, const float* tau, float c,
                            int b, int nq, int nk, int d, float* out,
                            float* lse, float* nrm, void* stream) {
  if (d < 1 || d > MAX_DP) return (int)cudaErrorInvalidValue;
  if (b > 0 && nq > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int dp = (d + 7) / 8 * 8;
#define HS_FWD(DPV) launch_fwd<DPV>(q, k, v, mask, group, beta, tau, c, b, \
                                    nq, nk, d, out, lse, nrm, s)
    HS_DISPATCH(dp, HS_FWD)
#undef HS_FWD
  }
  return (int)cudaGetLastError();
}

// dsp [b, nq, d], lse and di [b, nq]; writes dq [b, nq, d] and part
// [b, ceil(nq / 64)], the per-query-block partials of Σ dσ·σ.
extern "C" int hs_flash_dq(const float* q, const float* k, const float* v,
                           const float* dsp, const float* lse,
                           const float* di, const unsigned char* mask,
                           int group, const float* beta, const float* tau,
                           float c, int b, int nq, int nk, int d, float* dq,
                           float* part, void* stream) {
  if (d < 1 || d > MAX_DP) return (int)cudaErrorInvalidValue;
  if (b > 0 && nq > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int dp = (d + 7) / 8 * 8;
#define HS_DQ(DPV) launch_bwd<DPV>(q, k, v, dsp, lse, di, mask, group, beta, \
                                   tau, c, b, nq, nk, d, dq, part, nullptr,  \
                                   nullptr, s)
    HS_DISPATCH(dp, HS_DQ)
#undef HS_DQ
  }
  return (int)cudaGetLastError();
}

// writes dk and dv [b, nk, d]
extern "C" int hs_flash_dkv(const float* q, const float* k, const float* v,
                            const float* dsp, const float* lse,
                            const float* di, const unsigned char* mask,
                            int group, const float* beta, const float* tau,
                            float c, int b, int nq, int nk, int d, float* dk,
                            float* dv, void* stream) {
  if (d < 1 || d > MAX_DP) return (int)cudaErrorInvalidValue;
  if (b > 0 && nk > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int dp = (d + 7) / 8 * 8;
#define HS_DKV(DPV) launch_bwd<DPV>(q, k, v, dsp, lse, di, mask, group,    \
                                    beta, tau, c, b, nq, nk, d, nullptr,   \
                                    nullptr, dk, dv, s)
    HS_DISPATCH(dp, HS_DKV)
#undef HS_DKV
  }
  return (int)cudaGetLastError();
}
