// The fused gyro-linear layer y = proj((M ⊗_c x) ⊕_c b) (kernel N5) for
// sm_90a, one launch.
//
// Replaces hyperspace_tpu/kernels/hyplinear.py `_launch_hyp_linear` (the
// Pallas body `_hyp_linear_body`): the f32 product x @ M at full precision
// (the TPU kernel's Precision.HIGHEST; no TF32 — tanh∘artanh amplifies its
// error), the Möbius rescale tanh(‖Mx‖/‖x‖·artanh(√c‖x‖))·Mx/(‖Mx‖√c) with
// rows where Mx = 0 sent to the origin, ⊕ b, then proj, with the TPU
// kernel's clamps (EPS 1e-7, MIN_NORM 1e-12, the log-form artanh clamped at
// 1 ± 3e-7, tanh clipped at ±20, proj's margin 4e-3).
//
// What bounds it on an H100: at the layer path's [169,343, 128] × [128, 128]
// the product's 5.55 GFLOP over 67 TFLOP/s f32 (0.083 ms) against 0.052 ms
// of bytes: operations, just.  The design takes any (d_in, d_out): a block
// owns 64 rows and walks the d_out columns in 64-wide tiles, each a classic
// shared-memory f32 GEMM tile (16-deep slices of x and M, 4 × 4 outputs a
// thread, FMAs in a fixed order).  It writes the raw Mx to an f32 buffer
// (the output itself when the output is f32) and keeps, per row, ‖Mx‖²,
// ⟨Mx, b⟩ and max|Mx| in registers, summed over a row's 16 threads by a
// butterfly (fixed order: the same bits every launch); ‖x‖² comes from the
// staged x slices.  The Möbius rescale, the sum with b and proj are then
// closed forms in those scalars and ‖b‖²: z = α·Mx + β·b.  A last sweep of
// the block's own rows applies α, β and the proj scale and writes the
// output in its dtype.  Shared memory is 9 KB whatever the sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float EPS_F32 = 1e-7f;
constexpr float MIN_NORM_F32 = 1e-12f;
constexpr float BALL_EPS_F32 = 4e-3f;
constexpr float ARTANH_EPS_F32 = 3e-7f;
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int AP = BM + 4;  // padded row of the transposed x slice

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ksafe_sqrt(float x) {
  return sqrtf(fmaxf(x, 0.0f));
}
__device__ __forceinline__ float kartanh(float x) {
  x = fminf(fmaxf(x, -1.0f + ARTANH_EPS_F32), 1.0f - ARTANH_EPS_F32);
  return 0.5f * (log1pf(x) - log1pf(-x));
}
__device__ __forceinline__ float ktanh(float x) {
  return tanhf(fminf(fmaxf(x, -20.0f), 20.0f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
hyp_linear_kernel(const T* __restrict__ x, const float* __restrict__ m,
                  const float* __restrict__ b, float* mx, T* out,
                  long long n, int din, int dout,
                  const float* __restrict__ cp, float cv) {
  __shared__ __align__(16) float xs[BK][AP];   // x slice, transposed
  __shared__ __align__(16) float ms[BK][BN];   // M slice
  __shared__ float x2s[BM], alpha[BM], beta[BM], pnorm[BM];
  __shared__ float b2s;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.x * BM;
  const float c = cp ? *cp : cv;

  if (tid < 32) {  // ‖b‖², one warp, fixed order
    float s = 0.f;
    for (int j = tid; j < dout; j += 32) s = fmaf(b[j], b[j], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tid == 0) b2s = s;
  }

  // per-row partial statistics of rows ty*4 + i over this thread's columns
  float s_mx2[4] = {0.f, 0.f, 0.f, 0.f}, s_mb[4] = {0.f, 0.f, 0.f, 0.f};
  float s_max[4] = {0.f, 0.f, 0.f, 0.f};
  float x2 = 0.f;  // ‖x‖² of row `tid` (tid < BM)
  for (int c0 = 0; c0 < dout; c0 += BN) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < din; k0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const long long gr = row0 + r;
        const int gk = k0 + k;
        xs[k][r] = (gr < n && gk < din) ? load(x + gr * din + gk) : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int k = e / BN, j = e % BN;
        const int gk = k0 + k, gc = c0 + j;
        ms[k][j] = (gk < din && gc < dout) ? m[(long long)gk * dout + gc]
                                           : 0.f;
      }
      __syncthreads();
      if (c0 == 0 && tid < BM) {
#pragma unroll
        for (int k = 0; k < BK; ++k) x2 = fmaf(xs[k][tid], xs[k][tid], x2);
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
        const float4 w = *reinterpret_cast<const float4*>(&ms[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long gr = row0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gc = c0 + tx * 4 + j;
        if (gc < dout) {
          const float v = acc[i][j];
          if (gr < n) mx[gr * dout + gc] = v;
          s_mx2[i] = fmaf(v, v, s_mx2[i]);
          s_mb[i] = fmaf(v, b[gc], s_mb[i]);
          s_max[i] = fmaxf(s_max[i], fabsf(v));
        }
      }
    }
  }
  if (tid < BM) x2s[tid] = x2;
  // a row's 16 threads are 16 neighbouring lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      s_mx2[i] += __shfl_xor_sync(0xffffffffu, s_mx2[i], o);
      s_mb[i] += __shfl_xor_sync(0xffffffffu, s_mb[i], o);
      s_max[i] = fmaxf(s_max[i], __shfl_xor_sync(0xffffffffu, s_max[i], o));
    }
  }
  __syncthreads();
  const float max_norm =
      (1.0f - BALL_EPS_F32) / fmaxf(ksafe_sqrt(c), MIN_NORM_F32);
  if (tx == 0) {
    const float sc = fmaxf(ksafe_sqrt(c), MIN_NORM_F32);
    const float b2 = b2s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float mx2 = s_mx2[i], mb = s_mb[i];
      // M ⊗ x = s·Mx (s = 0 where Mx = 0)
      const float xn = fmaxf(ksafe_sqrt(x2s[r]), MIN_NORM_F32);
      const float mn = fmaxf(ksafe_sqrt(mx2), MIN_NORM_F32);
      const float s = s_max[i] == 0.f
                          ? 0.f
                          : ktanh(mn / xn * kartanh(sc * xn)) / (mn * sc);
      // (s·Mx) ⊕ b = α·Mx + β·b
      const float r2 = s * s * mx2, rb = s * mb;
      const float d = fmaxf(1.0f + 2.0f * c * rb + (c * c) * r2 * b2, EPS_F32);
      const float al = (1.0f + 2.0f * c * rb + c * b2) * s / d;
      const float be = (1.0f - c * r2) / d;
      alpha[r] = al;
      beta[r] = be;
      const float z2 = al * al * mx2 + 2.0f * al * be * mb + be * be * b2;
      const float zn = fmaxf(ksafe_sqrt(z2), MIN_NORM_F32);
      pnorm[r] = zn > max_norm ? zn : 0.f;  // 0: inside, kept as is
    }
  }
  __syncthreads();
  for (long long e = tid; e < (long long)BM * dout; e += THREADS) {
    const int r = (int)(e / dout), j = (int)(e % dout);
    const long long gr = row0 + r;
    if (gr >= n) break;
    float z = alpha[r] * mx[gr * dout + j] + beta[r] * b[j];
    if (pnorm[r] > 0.f) z = z / pnorm[r] * max_norm;
    store(out + gr * dout + j, z);
  }
}

}  // namespace

// x [n, din] of `kind` (0 float32, 1 bfloat16), m [din, dout] and b [dout]
// float32, out [n, dout] of `kind`, mx an f32 [n, dout] scratch (out itself
// when kind is 0); c read from the device pointer when it is not null.
extern "C" int hs_hyp_linear(int kind, const void* x, const float* m,
                             const float* b, float* mx, void* out,
                             long long n, int din, int dout, const float* cp,
                             float cv, void* stream) {
  if (n <= 0 || dout <= 0) return 0;
  const unsigned blocks = (unsigned)((n + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    hyp_linear_kernel<float><<<blocks, THREADS, 0, st>>>(
        (const float*)x, m, b, mx, (float*)out, n, din, dout, cp, cv);
  else if (kind == 1)
    hyp_linear_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, m, b, mx, (__nv_bfloat16*)out, n, din, dout,
        cp, cv);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
