// Hyperbolic-MLR logits (Ganea et al. 2018, eq. 25) for sm_90a, f32.
//
// Replaces hyperspace_tpu/kernels/mlr.py `hyp_mlr` (the Pallas kernel
// `_mlr_body`), which expands the Möbius addition z = (−p_k) ⊕ x into
// rank-2 expressions of six inner products so the [N, K, d] intermediate
// never exists:
//
//   α = 1 − 2c⟨p,x⟩ + c‖x‖²,  β = 1 − c‖p‖²,
//   den = max(1 − 2c⟨p,x⟩ + c²‖p‖²‖x‖², EPS)
//   ⟨z,a⟩ = (−α⟨p,a⟩ + β⟨x,a⟩)/den,  ‖z‖² = (α²‖p‖² − 2αβ⟨p,x⟩ + β²‖x‖²)/den²
//   logit = (λ_p‖a‖/√c)·asinh(2√c⟨z,a⟩ / (max(1 − c‖z‖², EPS)·‖a‖)).
//
// What bounds it on an H100: nothing on the main path — the head sees
// x [256, 128], p and a [8, 128] (HyboNet's bench leg), a few hundred KB
// and a few hundred thousand operations, so it costs a launch.  The
// design is the simplest right one: one warp per (row, class) pair, lanes
// striding over d to take the six inner products (‖x‖², ‖p‖², ‖a‖², ⟨p,a⟩,
// ⟨x,p⟩, ⟨x,a⟩) with f32 FMAs, a butterfly reduction, and lane 0 applying
// the closed form with the TPU kernel's clamps (EPS 1e-7 on den, 1 − c‖z‖²
// and 1 − c‖p‖²; MIN_NORM 1e-12 on √c and ‖a‖) and its log-form asinh.

#include <cuda_runtime.h>

namespace {

constexpr float EPS_F32 = 1e-7f;
constexpr float MIN_NORM_F32 = 1e-12f;
constexpr int WARPS_PER_BLOCK = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sign(x)·log1p(|x| + x²/(1 + √(1 + x²))), hyperspace_tpu's `kasinh`
__device__ __forceinline__ float kasinh(float x) {
  const float ax = fabsf(x);
  const float r = sqrtf(fmaxf(ax * ax + 1.0f, 0.0f));
  const float y = log1pf(ax + ax * ax / (1.0f + r));
  return x > 0.0f ? y : (x < 0.0f ? -y : 0.0f);
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
mlr_kernel(const float* __restrict__ x, const float* __restrict__ p,
           const float* __restrict__ a, float* __restrict__ out, int n,
           int k, int d, float c) {
  const int pair = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= n * k) return;  // the whole warp leaves together
  const int row = pair / k, cls = pair % k;
  const float* xr = x + (size_t)row * d;
  const float* pr = p + (size_t)cls * d;
  const float* ar = a + (size_t)cls * d;
  float x2 = 0.f, p2 = 0.f, a2 = 0.f, pa = 0.f, xp = 0.f, xa = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float xv = xr[i], pv = pr[i], av = ar[i];
    x2 = fmaf(xv, xv, x2);
    p2 = fmaf(pv, pv, p2);
    a2 = fmaf(av, av, a2);
    pa = fmaf(pv, av, pa);
    xp = fmaf(xv, pv, xp);
    xa = fmaf(xv, av, xa);
  }
  x2 = warp_sum(x2);
  p2 = warp_sum(p2);
  a2 = warp_sum(a2);
  pa = warp_sum(pa);
  xp = warp_sum(xp);
  xa = warp_sum(xa);
  if (lane != 0) return;
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), MIN_NORM_F32);
  const float a_norm = fmaxf(sqrtf(fmaxf(a2, 0.0f)), MIN_NORM_F32);
  const float alpha = 1.0f - 2.0f * c * xp + c * x2;
  const float beta = 1.0f - c * p2;
  const float den = fmaxf(1.0f - 2.0f * c * xp + (c * c) * p2 * x2, EPS_F32);
  const float za = (-alpha * pa + beta * xa) / den;
  const float z2 = (alpha * alpha * p2 - 2.0f * alpha * beta * xp
                    + beta * beta * x2) / (den * den);
  const float lam_p = 2.0f / fmaxf(1.0f - c * p2, EPS_F32);
  const float arg = 2.0f * sc * za / (fmaxf(1.0f - c * z2, EPS_F32) * a_norm);
  out[(size_t)row * k + cls] = (lam_p * a_norm / sc) * kasinh(arg);
}

}  // namespace

// x [n, d], p and a [k, d], out [n, k]; all f32, contiguous.
extern "C" int hs_hyp_mlr(const float* x, const float* p, const float* a,
                          float* out, int n, int k, int d, float c,
                          void* stream) {
  const long long pairs = (long long)n * k;
  if (pairs > 0) {
    const int blocks = (int)((pairs + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
    mlr_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        x, p, a, out, n, k, d, c);
  }
  return (int)cudaGetLastError();
}
