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
// card's 20 operations a byte.  Two designs, by width:
// - narrow rows, d ≤ 16 (the WordNet table's d = 10, the HVAE latent's 8):
//   a warp takes 32 consecutive rows, one contiguous span of 32·d elements
//   an operand, copied into shared memory with 16-byte loads; each lane then
//   holds one whole row in registers (d = 8 and 10 compile-time, other
//   widths up to 16 in a 16-wide instance padded with zeros), takes the
//   row's dot products in order with no shuffles, evaluates the closed form
//   once, turns each division of an element by a row's scalar into a
//   multiply by its reciprocal, and runs the second sweep (expmap, expmap0,
//   logmap) from its registers; the output rows are staged in the same
//   shared span and written with 16-byte stores.  An operand with row
//   stride 0 (a bias) is read once a block.  Rows a lane, so no lane idles
//   on a 10-wide row and the transcendentals run once a row, not once a
//   lane;
// - wider rows: a warp of 32 lanes per row, lanes striding over d so the
//   loads are coalesced, the row's dot products summed by a butterfly (a
//   fixed order: the same bits every launch), a second and third sweep (the
//   ops whose output needs the norm of an intermediate: expmap, expmap0's
//   proj, logmap's Möbius difference) reading the row again from L1.
// c and r come as a value or, when the caller holds them on the card, as a
// device pointer, so the host never waits for them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float EPS_F32 = 1e-7f;
constexpr float MIN_NORM_F32 = 1e-12f;
constexpr float BALL_EPS_F32 = 4e-3f;
constexpr float ARTANH_EPS_F32 = 3e-7f;
constexpr int THREADS = 256;
constexpr int PK_WARPS = 4, PK_THREADS = 32 * PK_WARPS;
constexpr int PK_DMAX = 16;            // the widest row of the packed kernel

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

template <int OP, typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
rowwise_kernel(const Tin* __restrict__ t0, long long s0,
               const Tin* __restrict__ t1, long long s1,
               const Tin* __restrict__ t2, long long s2,
               Tout* __restrict__ out, long long n, int d,
               const float* __restrict__ cp, float cv,
               const float* __restrict__ rp, float rv) {
  constexpr int G = 32;                     // lanes a row
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
  q0 = warp_sum(q0);
  if constexpr (OP == ADD || OP == EXPMAP || OP == LOGMAP || OP == PTRANSP) {
    q1 = warp_sum(q1);
    q2 = warp_sum(q2);
  }
  if constexpr (OP == PTRANSP) {
    q3 = warp_sum(q3);
    q4 = warp_sum(q4);
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
    z2 = warp_sum(z2);
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
    u2 = warp_sum(u2);
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
    z2 = warp_sum(z2);
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

// how many [n, d] operands an op reads
template <int OP>
constexpr int ARITY =
    OP == PTRANSP ? 3 : (OP == ADD || OP == EXPMAP || OP == LOGMAP ? 2 : 1);

// element i of a row held as 32-bit words, and back
template <typename T>
__device__ __forceinline__ float word_elem(const unsigned* w, int i) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w[i]);
  const unsigned u = w[i >> 1];
  return __uint_as_float(i & 1 ? u & 0xffff0000u : u << 16);
}
template <typename T>
__device__ __forceinline__ void elem_word(unsigned* w, int i, float v) {
  if constexpr (sizeof(T) == 4) {
    w[i] = __float_as_uint(v);
  } else {
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    w[i >> 1] = i & 1 ? (w[i >> 1] & 0xffffu) | (h << 16) : h;
  }
}

// a lane's row of D elements of T (D = 0: d ≤ DM, the rest zero) at s, as
// f32 registers; whole 16-, 8- or 4-byte words where the row's bytes allow
template <int D, int DM, typename T>
__device__ __forceinline__ void row_in(const T* s, float (&r)[DM], int d) {
  constexpr int BYTES = D * (int)sizeof(T);
  if constexpr (D > 0 && BYTES % 4 == 0) {
    constexpr int W = BYTES / 4;
    unsigned w[W];
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 q = reinterpret_cast<const uint4*>(s)[i];
        w[4 * i] = q.x, w[4 * i + 1] = q.y, w[4 * i + 2] = q.z;
        w[4 * i + 3] = q.w;
      }
    } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        const uint2 q = reinterpret_cast<const uint2*>(s)[i];
        w[2 * i] = q.x, w[2 * i + 1] = q.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i)
        w[i] = reinterpret_cast<const unsigned*>(s)[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) r[i] = word_elem<T>(w, i);
  } else {
#pragma unroll
    for (int i = 0; i < DM; ++i) r[i] = i < d ? load(s + i) : 0.f;
  }
}

// the lane's output row from f32 registers into s, as row_in reads
template <int D, int DM, typename T>
__device__ __forceinline__ void row_out(T* s, const float (&r)[DM], int d) {
  constexpr int BYTES = D * (int)sizeof(T);
  if constexpr (D > 0 && BYTES % 4 == 0) {
    constexpr int W = BYTES / 4;
    unsigned w[W];
#pragma unroll
    for (int i = 0; i < D; ++i) elem_word<T>(w, i, r[i]);
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i)
        reinterpret_cast<uint4*>(s)[i] =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i)
        reinterpret_cast<uint2*>(s)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) reinterpret_cast<unsigned*>(s)[i] = w[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < DM; ++i)
      if (i < d) store(s + i, r[i]);
  }
}

// `count` elements between device memory and a warp's shared span (16-byte
// aligned), 16 bytes a lane where the device side is 16-byte aligned
template <typename T>
__device__ __forceinline__ void span_in(T* dst, const T* src, int count,
                                        int lane) {
  int done = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    const int nv = count * (int)sizeof(T) / 16;
    for (int i = lane; i < nv; i += 32)
      reinterpret_cast<uint4*>(dst)[i] =
          __ldg(reinterpret_cast<const uint4*>(src) + i);
    done = nv * 16 / (int)sizeof(T);
  }
  for (int i = done + lane; i < count; i += 32) dst[i] = src[i];
}
template <typename T>
__device__ __forceinline__ void span_out(T* dst, const T* src, int count,
                                         int lane) {
  int done = 0;
  if ((reinterpret_cast<size_t>(dst) & 15) == 0) {
    const int nv = count * (int)sizeof(T) / 16;
    for (int i = lane; i < nv; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = nv * 16 / (int)sizeof(T);
  }
  for (int i = done + lane; i < count; i += 32) dst[i] = src[i];
}

// one op on a lane's rows x (t0), y (t1) and v (t2), zero past d
template <int OP, int DM>
__device__ __forceinline__ void row_op(const float (&x)[DM],
                                       const float (&y)[DM],
                                       const float (&v)[DM], float (&o)[DM],
                                       float c, float sc, float r) {
  float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f, q4 = 0.f;
#pragma unroll
  for (int i = 0; i < DM; ++i) {
    q0 = fmaf(x[i], x[i], q0);
    if constexpr (ARITY<OP> > 1) {
      q1 = fmaf(y[i], y[i], q1);
      q2 = fmaf(x[i], y[i], q2);
    }
    if constexpr (OP == PTRANSP) {
      q3 = fmaf(y[i], v[i], q3);
      q4 = fmaf(x[i], v[i], q4);
    }
  }
  // each element's division by a row's scalar is a multiply by its
  // reciprocal, taken once a row
  if constexpr (OP == ADD) {  // x ⊕ y; q0 = ‖x‖², q1 = ‖y‖², q2 = ⟨x,y⟩
    const Mobius m = mobius(q0, q1, q2, c);
    const float fa = m.a / m.d, fb = m.b / m.d;
#pragma unroll
    for (int i = 0; i < DM; ++i) o[i] = fa * x[i] + fb * y[i];
  } else if constexpr (OP == SMUL) {  // r ⊗ x
    const float norm = fmaxf(ksafe_sqrt(q0), MIN_NORM_F32);
    const float t = ktanh(r * kartanh(sc * norm));
    const float f = t / fmaxf(sc * norm, MIN_NORM_F32);
#pragma unroll
    for (int i = 0; i < DM; ++i) o[i] = f * x[i];
  } else if constexpr (OP == EXPMAP) {  // proj(x ⊕ s·v); q1 = ‖v‖², q2 = ⟨x,v⟩
    const float lam = klambda(q0, c);
    const float t = sc * lam * ksafe_sqrt(q1) / 2.0f;
    const float s = ktanc(t) * lam / 2.0f;
    const Mobius m = mobius(q0, s * s * q1, s * q2, c);
    const float fa = m.a / m.d, fb = m.b * s / m.d;
    float z2 = 0.f;
#pragma unroll
    for (int i = 0; i < DM; ++i) {
      o[i] = fa * x[i] + fb * y[i];
      z2 = fmaf(o[i], o[i], z2);
    }
    float max_norm;
    const float pn = proj_norm(z2, c, &max_norm);
    if (pn > 0.f) {
      const float f = max_norm / pn;
#pragma unroll
      for (int i = 0; i < DM; ++i) o[i] *= f;
    }
  } else if constexpr (OP == LOGMAP) {  // (2/λ_x)·artanc(√c‖u‖)·u, u = −x ⊕ y
    const Mobius m = mobius(q0, q1, -q2, c);
    const float fa = -m.a / m.d, fb = m.b / m.d;
    float u2 = 0.f;
#pragma unroll
    for (int i = 0; i < DM; ++i) {
      o[i] = fa * x[i] + fb * y[i];
      u2 = fmaf(o[i], o[i], u2);
    }
    const float f = (2.0f / klambda(q0, c)) * kartanc(sc * ksafe_sqrt(u2));
#pragma unroll
    for (int i = 0; i < DM; ++i) o[i] *= f;
  } else if constexpr (OP == EXPMAP0) {  // proj(tanc(√c‖v‖)·v)
    const float f = ktanc(sc * ksafe_sqrt(q0));
    float z2 = 0.f;
#pragma unroll
    for (int i = 0; i < DM; ++i) {
      o[i] = f * x[i];
      z2 = fmaf(o[i], o[i], z2);
    }
    float max_norm;
    const float pn = proj_norm(z2, c, &max_norm);
    if (pn > 0.f) {
      const float g = max_norm / pn;
#pragma unroll
      for (int i = 0; i < DM; ++i) o[i] *= g;
    }
  } else if constexpr (OP == LOGMAP0) {  // artanc(√c‖y‖)·y
    const float f = kartanc(sc * ksafe_sqrt(q0));
#pragma unroll
    for (int i = 0; i < DM; ++i) o[i] = f * x[i];
  } else {  // PTRANSP: gyr[y, −x] v · λ_x / λ_y, as rowwise_kernel
    const float c2 = c * c;
    const float uv = -q2, uw = q3, vw = -q4;
    const float a = -c2 * uw * q0 + c * vw + 2.0f * c2 * uv * vw;
    const float b = -c2 * vw * q1 - c * uw;
    const float dd = fmaxf(1.0f + 2.0f * c * uv + c2 * q1 * q0, EPS_F32);
    const float lam = klambda(q0, c) / klambda(q1, c);
    const float fa = 2.0f * a / dd, fb = -2.0f * b / dd;
#pragma unroll
    for (int i = 0; i < DM; ++i) o[i] = (v[i] + fa * y[i] + fb * x[i]) * lam;
  }
}

// d ≤ 16: a lane a row, a warp 32 consecutive rows (see the head of the
// file); D = 0 takes any d ≤ 16 in a 16-wide instance
template <int OP, int D, typename Tin, typename Tout>
__global__ void __launch_bounds__(PK_THREADS)
packed_kernel(const Tin* __restrict__ t0, long long s0,
              const Tin* __restrict__ t1, long long s1,
              const Tin* __restrict__ t2, long long s2,
              Tout* __restrict__ out, long long n, int d_rt,
              const float* __restrict__ cp, float cv,
              const float* __restrict__ rp, float rv) {
  constexpr int NIN = ARITY<OP>;
  constexpr int DM = D > 0 ? D : PK_DMAX;
  constexpr int SPAN = 32 * DM * (int)sizeof(Tin);      // bytes a warp span
  static_assert(sizeof(Tout) <= sizeof(Tin), "the output reuses a span");
  const int d = D > 0 ? D : d_rt;
  __shared__ __align__(16) unsigned char spans[PK_WARPS][NIN][SPAN];
  __shared__ __align__(16) unsigned char shared_row[NIN][DM * sizeof(Tin)];
  const Tin* src[3] = {t0, t1, t2};
  const long long stride[3] = {s0, s1, s2};
#pragma unroll
  for (int j = 0; j < NIN; ++j)
    if (stride[j] == 0)
      for (int i = threadIdx.x; i < d; i += PK_THREADS)
        reinterpret_cast<Tin*>(shared_row[j])[i] = src[j][i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = ((long long)blockIdx.x * PK_WARPS + warp) * 32;
  if (row0 >= n) return;                     // the whole warp together
  const int rows = (int)min(32LL, n - row0);
#pragma unroll
  for (int j = 0; j < NIN; ++j)
    if (stride[j] != 0)
      span_in(reinterpret_cast<Tin*>(spans[warp][j]), src[j] + row0 * d,
              rows * d, lane);
  __syncwarp();
  float x[DM], y[DM], v[DM], o[DM];
#pragma unroll
  for (int i = 0; i < DM; ++i) x[i] = y[i] = v[i] = 0.f;
  const bool live = lane < rows;
  const Tin* row[NIN];                      // the lane's row of each operand
#pragma unroll
  for (int j = 0; j < NIN; ++j)
    row[j] = stride[j] == 0 ? reinterpret_cast<const Tin*>(shared_row[j])
                            : reinterpret_cast<const Tin*>(spans[warp][j]) +
                                  lane * d;
  if (live) {
    row_in<D>(row[0], x, d);
    if constexpr (NIN > 1) row_in<D>(row[1], y, d);
    if constexpr (NIN > 2) row_in<D>(row[2], v, d);
  }
  __syncwarp();                              // the spans are read
  const float c = cp ? *cp : cv;
  row_op<OP, DM>(x, y, v, o, c, ksafe_sqrt(c), rp ? *rp : rv);
  Tout* so = reinterpret_cast<Tout*>(spans[warp][0]);
  if (live) row_out<D>(so + lane * d, o, d);
  __syncwarp();
  span_out(out + row0 * d, so, rows * d, lane);
}

template <int OP, typename Tin, typename Tout>
int launch_typed(const void* t0, long long s0, const void* t1, long long s1,
                 const void* t2, long long s2, void* out, long long n, int d,
                 const float* cp, float cv, const float* rp, float rv,
                 cudaStream_t stream) {
  const Tin* a = (const Tin*)t0;
  const Tin* b = (const Tin*)t1;
  const Tin* v = (const Tin*)t2;
  Tout* o = (Tout*)out;
  if (d <= PK_DMAX) {
    const unsigned blocks =
        (unsigned)((n + 32 * PK_WARPS - 1) / (32 * PK_WARPS));
    if (d == 8)
      packed_kernel<OP, 8, Tin, Tout><<<blocks, PK_THREADS, 0, stream>>>(
          a, s0, b, s1, v, s2, o, n, d, cp, cv, rp, rv);
    else if (d == 10)
      packed_kernel<OP, 10, Tin, Tout><<<blocks, PK_THREADS, 0, stream>>>(
          a, s0, b, s1, v, s2, o, n, d, cp, cv, rp, rv);
    else
      packed_kernel<OP, 0, Tin, Tout><<<blocks, PK_THREADS, 0, stream>>>(
          a, s0, b, s1, v, s2, o, n, d, cp, cv, rp, rv);
  } else {
    const unsigned blocks = (unsigned)((n + THREADS / 32 - 1) / (THREADS / 32));
    rowwise_kernel<OP, Tin, Tout><<<blocks, THREADS, 0, stream>>>(
        a, s0, b, s1, v, s2, o, n, d, cp, cv, rp, rv);
  }
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
