// The Poincaré ball's row-wise ops (kernels N1–N4) for sm_90a.
//
// Replaces hyperspace_tpu/kernels/pointwise.py `_launch_rowwise` (the one
// Pallas launcher behind mobius_add, mobius_scalar_mul, expmap, logmap,
// expmap0, logmap0 and ptransp): each op fuses its chain of row norms,
// clamps and transcendentals into one pass over [n, d] rows, f32 inside
// whatever the input dtype, with the TPU kernels' helpers
// (hyperspace_tpu/kernels/_support.py:129-210): kartanh in log form clamped
// at 1 ± 3e-7, ktanh clipped at ±20, ktanc/kartanc on their series below
// 1e-3, kproj's margin 4e-3, EPS 1e-7, MIN_NORM 1e-12.
//
// What bounds it on an H100: bytes.  Each op reads its one to three [n, d]
// rows and writes one, a few dozen operations an element, far below the
// card's 20 operations a byte.  The design: a group of G lanes of a warp
// per row (G = 8, 16 or 32, the smallest that covers d up to 32), lanes
// striding over d so a group's loads are coalesced, the row's dot products
// summed by a butterfly over the group (fixed order: the same bits every
// launch).  A second and third sweep over the row (the ops whose output
// needs the norm of an intermediate: expmap, expmap0's proj, logmap's
// Möbius difference) read the row again from L1.  An operand with row
// stride 0 is one row broadcast to every row (a bias).  c and r come as a
// value or, when the caller holds them on the card, as a device pointer, so
// the host never waits for them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float EPS_F32 = 1e-7f;
constexpr float MIN_NORM_F32 = 1e-12f;
constexpr float BALL_EPS_F32 = 4e-3f;
constexpr float ARTANH_EPS_F32 = 3e-7f;
constexpr int THREADS = 256;

enum Op { ADD, SMUL, EXPMAP, LOGMAP, EXPMAP0, LOGMAP0, PTRANSP };

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
__device__ __forceinline__ float ktanc(float x) {
  return fabsf(x) < 1e-3f ? 1.0f - x * x / 3.0f : ktanh(x) / x;
}
__device__ __forceinline__ float kartanc(float x) {
  return fabsf(x) < 1e-3f ? 1.0f + x * x / 3.0f : kartanh(x) / x;
}
__device__ __forceinline__ float klambda(float x2, float c) {
  return 2.0f / fmaxf(1.0f - c * x2, EPS_F32);
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The Möbius sum's coefficients: x ⊕ y = (A·x + B·y) / D.
struct Mobius {
  float a, b, d;
};
__device__ __forceinline__ Mobius mobius(float x2, float y2, float xy,
                                         float c) {
  Mobius m;
  m.a = 1.0f + 2.0f * c * xy + c * y2;
  m.b = 1.0f - c * x2;
  m.d = fmaxf(1.0f + 2.0f * c * xy + (c * c) * x2 * y2, EPS_F32);
  return m;
}

// kproj's factor: 0 keeps the point, else the point goes to z/‖z‖·max_norm.
__device__ __forceinline__ float proj_norm(float z2, float c,
                                           float* max_norm) {
  const float norm = fmaxf(ksafe_sqrt(z2), MIN_NORM_F32);
  *max_norm = (1.0f - BALL_EPS_F32) / fmaxf(ksafe_sqrt(c), MIN_NORM_F32);
  return norm > *max_norm ? norm : 0.0f;
}

template <int OP, int G, typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
rowwise_kernel(const Tin* __restrict__ t0, long long s0,
               const Tin* __restrict__ t1, long long s1,
               const Tin* __restrict__ t2, long long s2,
               Tout* __restrict__ out, long long n, int d,
               const float* __restrict__ cp, float cv,
               const float* __restrict__ rp, float rv) {
  const int lane = threadIdx.x % G;
  const long long row = (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  // rows past n still take part in the shuffles, on zeros
  const bool live = row < n;
  const Tin* p0 = t0 + (live ? row * s0 : 0);
  const Tin* p1 = t1 ? t1 + (live ? row * s1 : 0) : nullptr;
  const Tin* p2 = t2 ? t2 + (live ? row * s2 : 0) : nullptr;
  Tout* po = out + (live ? row * (long long)d : 0);
  const float c = cp ? *cp : cv;
  const float sc = ksafe_sqrt(c);

  // sweep 1: the row's dot products
  float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f, q4 = 0.f;
  if (live) {
    for (int i = lane; i < d; i += G) {
      const float a = load(p0 + i);
      q0 = fmaf(a, a, q0);
      if constexpr (OP == ADD || OP == EXPMAP || OP == LOGMAP ||
                    OP == PTRANSP) {
        const float b = load(p1 + i);
        q1 = fmaf(b, b, q1);
        q2 = fmaf(a, b, q2);
        if constexpr (OP == PTRANSP) {
          const float v = load(p2 + i);
          q3 = fmaf(b, v, q3);
          q4 = fmaf(a, v, q4);
        }
      }
    }
  }
  q0 = group_sum<G>(q0);
  if constexpr (OP == ADD || OP == EXPMAP || OP == LOGMAP || OP == PTRANSP) {
    q1 = group_sum<G>(q1);
    q2 = group_sum<G>(q2);
  }
  if constexpr (OP == PTRANSP) {
    q3 = group_sum<G>(q3);
    q4 = group_sum<G>(q4);
  }

  if constexpr (OP == ADD) {  // x ⊕ y; q0 = ‖x‖², q1 = ‖y‖², q2 = ⟨x,y⟩
    const Mobius m = mobius(q0, q1, q2, c);
    if (!live) return;
    for (int i = lane; i < d; i += G)
      store(po + i, (m.a * load(p0 + i) + m.b * load(p1 + i)) / m.d);
  } else if constexpr (OP == SMUL) {  // r ⊗ x
    const float r = rp ? *rp : rv;
    const float norm = fmaxf(ksafe_sqrt(q0), MIN_NORM_F32);
    const float t = ktanh(r * kartanh(sc * norm));
    const float den = fmaxf(sc * norm, MIN_NORM_F32);
    if (!live) return;
    for (int i = lane; i < d; i += G) store(po + i, t * load(p0 + i) / den);
  } else if constexpr (OP == EXPMAP) {  // proj(x ⊕ s·v); q1 = ‖v‖², q2 = ⟨x,v⟩
    const float lam = klambda(q0, c);
    const float t = sc * lam * ksafe_sqrt(q1) / 2.0f;
    const float s = ktanc(t) * lam / 2.0f;
    const Mobius m = mobius(q0, s * s * q1, s * q2, c);
    float z2 = 0.f;
    if (live) {
      for (int i = lane; i < d; i += G) {
        const float z = (m.a * load(p0 + i) + m.b * (s * load(p1 + i))) / m.d;
        z2 = fmaf(z, z, z2);
      }
    }
    z2 = group_sum<G>(z2);
    float max_norm;
    const float pn = proj_norm(z2, c, &max_norm);
    if (!live) return;
    for (int i = lane; i < d; i += G) {
      float z = (m.a * load(p0 + i) + m.b * (s * load(p1 + i))) / m.d;
      if (pn > 0.f) z = z / pn * max_norm;
      store(po + i, z);
    }
  } else if constexpr (OP == LOGMAP) {  // (2/λ_x)·artanc(√c‖u‖)·u, u = −x ⊕ y
    const Mobius m = mobius(q0, q1, -q2, c);
    float u2 = 0.f;
    if (live) {
      for (int i = lane; i < d; i += G) {
        const float u = (m.a * -load(p0 + i) + m.b * load(p1 + i)) / m.d;
        u2 = fmaf(u, u, u2);
      }
    }
    u2 = group_sum<G>(u2);
    const float f = (2.0f / klambda(q0, c)) * kartanc(sc * ksafe_sqrt(u2));
    if (!live) return;
    for (int i = lane; i < d; i += G)
      store(po + i, f * ((m.a * -load(p0 + i) + m.b * load(p1 + i)) / m.d));
  } else if constexpr (OP == EXPMAP0) {  // proj(tanc(√c‖v‖)·v)
    const float f = ktanc(sc * ksafe_sqrt(q0));
    float z2 = 0.f;
    if (live) {
      for (int i = lane; i < d; i += G) {
        const float z = f * load(p0 + i);
        z2 = fmaf(z, z, z2);
      }
    }
    z2 = group_sum<G>(z2);
    float max_norm;
    const float pn = proj_norm(z2, c, &max_norm);
    if (!live) return;
    for (int i = lane; i < d; i += G) {
      float z = f * load(p0 + i);
      if (pn > 0.f) z = z / pn * max_norm;
      store(po + i, z);
    }
  } else if constexpr (OP == LOGMAP0) {  // artanc(√c‖y‖)·y
    const float f = kartanc(sc * ksafe_sqrt(q0));
    if (!live) return;
    for (int i = lane; i < d; i += G) store(po + i, f * load(p0 + i));
  } else {  // PTRANSP: gyr[y, −x] v · λ_x / λ_y
    // q0 = ‖x‖², q1 = ‖y‖², q2 = ⟨x,y⟩, q3 = ⟨y,v⟩, q4 = ⟨x,v⟩; the
    // gyration's u = y, v = −x, w = v
    const float c2 = c * c;
    const float uv = -q2, uw = q3, vw = -q4;
    const float a = -c2 * uw * q0 + c * vw + 2.0f * c2 * uv * vw;
    const float b = -c2 * vw * q1 - c * uw;
    const float dd = fmaxf(1.0f + 2.0f * c * uv + c2 * q1 * q0, EPS_F32);
    const float lam_x = klambda(q0, c), lam_y = klambda(q1, c);
    if (!live) return;
    for (int i = lane; i < d; i += G) {
      const float g = load(p2 + i) +
                      2.0f * (a * load(p1 + i) + b * -load(p0 + i)) / dd;
      store(po + i, g * lam_x / lam_y);
    }
  }
}

template <int OP, typename Tin, typename Tout>
int launch_typed(const void* t0, long long s0, const void* t1, long long s1,
                 const void* t2, long long s2, void* out, long long n, int d,
                 const float* cp, float cv, const float* rp, float rv,
                 cudaStream_t stream) {
  const int g = d <= 8 ? 8 : (d <= 16 ? 16 : 32);
  const long long rows = THREADS / g;
  const unsigned blocks = (unsigned)((n + rows - 1) / rows);
  const Tin* a = (const Tin*)t0;
  const Tin* b = (const Tin*)t1;
  const Tin* v = (const Tin*)t2;
  Tout* o = (Tout*)out;
  if (g == 8)
    rowwise_kernel<OP, 8, Tin, Tout><<<blocks, THREADS, 0, stream>>>(
        a, s0, b, s1, v, s2, o, n, d, cp, cv, rp, rv);
  else if (g == 16)
    rowwise_kernel<OP, 16, Tin, Tout><<<blocks, THREADS, 0, stream>>>(
        a, s0, b, s1, v, s2, o, n, d, cp, cv, rp, rv);
  else
    rowwise_kernel<OP, 32, Tin, Tout><<<blocks, THREADS, 0, stream>>>(
        a, s0, b, s1, v, s2, o, n, d, cp, cv, rp, rv);
  return (int)cudaGetLastError();
}

// kinds: 0 float32, 1 bfloat16; the inputs share one kind (the wrapper
// widens a mixed set to float32), the output has the first input's kind.
template <int OP>
int launch(int in_kind, int out_kind, const void* t0, long long s0,
           const void* t1, long long s1, const void* t2, long long s2,
           void* out, long long n, int d, const float* cp, float cv,
           const float* rp, float rv, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_kind == 0 && out_kind == 0)
    return launch_typed<OP, float, float>(t0, s0, t1, s1, t2, s2, out, n, d,
                                          cp, cv, rp, rv, st);
  if (in_kind == 1 && out_kind == 1)
    return launch_typed<OP, __nv_bfloat16, __nv_bfloat16>(
        t0, s0, t1, s1, t2, s2, out, n, d, cp, cv, rp, rv, st);
  if (in_kind == 0 && out_kind == 1)
    return launch_typed<OP, float, __nv_bfloat16>(t0, s0, t1, s1, t2, s2, out,
                                                  n, d, cp, cv, rp, rv, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every launcher: t0..t2 [n, d] rows of `in_kind` with row strides s0..s2
// (d, or 0 for one row broadcast to all; unused operands null), out [n, d]
// of `out_kind`; c (and r) read from the device pointer when it is not
// null, else the value.
extern "C" int hs_mobius_add(int in_kind, int out_kind, const void* t0,
                             long long s0, const void* t1, long long s1,
                             const void* t2, long long s2, void* out,
                             long long n, int d, const float* cp, float cv,
                             const float* rp, float rv, void* stream) {
  return launch<ADD>(in_kind, out_kind, t0, s0, t1, s1, t2, s2, out, n, d,
                     cp, cv, rp, rv, stream);
}
extern "C" int hs_mobius_scalar_mul(int in_kind, int out_kind, const void* t0,
                                    long long s0, const void* t1, long long s1,
                                    const void* t2, long long s2, void* out,
                                    long long n, int d, const float* cp,
                                    float cv, const float* rp, float rv,
                                    void* stream) {
  return launch<SMUL>(in_kind, out_kind, t0, s0, t1, s1, t2, s2, out, n, d,
                      cp, cv, rp, rv, stream);
}
extern "C" int hs_expmap(int in_kind, int out_kind, const void* t0,
                         long long s0, const void* t1, long long s1,
                         const void* t2, long long s2, void* out, long long n,
                         int d, const float* cp, float cv, const float* rp,
                         float rv, void* stream) {
  return launch<EXPMAP>(in_kind, out_kind, t0, s0, t1, s1, t2, s2, out, n, d,
                        cp, cv, rp, rv, stream);
}
extern "C" int hs_logmap(int in_kind, int out_kind, const void* t0,
                         long long s0, const void* t1, long long s1,
                         const void* t2, long long s2, void* out, long long n,
                         int d, const float* cp, float cv, const float* rp,
                         float rv, void* stream) {
  return launch<LOGMAP>(in_kind, out_kind, t0, s0, t1, s1, t2, s2, out, n, d,
                        cp, cv, rp, rv, stream);
}
extern "C" int hs_expmap0(int in_kind, int out_kind, const void* t0,
                          long long s0, const void* t1, long long s1,
                          const void* t2, long long s2, void* out, long long n,
                          int d, const float* cp, float cv, const float* rp,
                          float rv, void* stream) {
  return launch<EXPMAP0>(in_kind, out_kind, t0, s0, t1, s1, t2, s2, out, n,
                         d, cp, cv, rp, rv, stream);
}
extern "C" int hs_logmap0(int in_kind, int out_kind, const void* t0,
                          long long s0, const void* t1, long long s1,
                          const void* t2, long long s2, void* out, long long n,
                          int d, const float* cp, float cv, const float* rp,
                          float rv, void* stream) {
  return launch<LOGMAP0>(in_kind, out_kind, t0, s0, t1, s1, t2, s2, out, n,
                         d, cp, cv, rp, rv, stream);
}
extern "C" int hs_ptransp(int in_kind, int out_kind, const void* t0,
                          long long s0, const void* t1, long long s1,
                          const void* t2, long long s2, void* out, long long n,
                          int d, const float* cp, float cv, const float* rp,
                          float rv, void* stream) {
  return launch<PTRANSP>(in_kind, out_kind, t0, s0, t1, s1, t2, s2, out, n,
                         d, cp, cv, rp, rv, stream);
}
