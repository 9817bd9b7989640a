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
//   logit = (λ_p‖a‖/√c)·asinh(2√c⟨z,a⟩ / (max(1 − c‖z‖², EPS)·‖a‖)),
//
// with the TPU kernel's clamps (EPS 1e-7 on den, 1 − c‖z‖² and 1 − c‖p‖²;
// MIN_NORM 1e-12 on √c and ‖a‖) and its log-form asinh.
//
// What bounds it on an H100: at HGCN node classification's head,
// [169,343, 40 classes, d 32], bytes: the kernel must read x (21.7 MB) and
// write the logits (27.1 MB), 0.0146 ms at 3.35 TB/s; the two products
// x·pᵀ and x·aᵀ, 0.87 GFLOP taken as 3×TF32, are 0.0053 ms at 495 TFLOP/s
// on the tensor cores, and the closed form, about 30 f32 operations a
// logit, 0.0032 ms at 67 TFLOP/s.  At HyboNet's heads
// ([256, 8, 128] and smaller) nothing but latency: a launch.  Two plans,
// chosen by the wrapper (kernels/mlr.py `mlr_plan`):
//
// The pair plan, for a few thousand logits: a warp per (row, class), as
// the first port had it; one load round trip and no block barrier.
//
// The tile plan, for more.  Only four of the six inner products depend on
// both the row and the class, so it takes each of the others once:
// - a block stages its chunk of classes (p and a rows, zero-padded, rows
//   pitched at 16 mod 32 words) in shared memory once, already split for
//   the tensor core, and computes the per-class constants (‖p‖², ⟨p,a⟩, β,
//   −2β, c²‖p‖², β², λ_p‖a‖/√c and 2√c/‖a‖), while its warps' first slices
//   of x are in flight;
// - a warp owns a 16-row tile and the whole chunk (up to 64 classes) and
//   takes both products on the tensor cores, `mma.sync.m16n8k8` TF32 with
//   every operand split hi + lo (tf32.cuh; the lo part rounded to TF32),
//   three products a pair, each 16-wide k slice into fresh accumulators
//   added to the running sums in f32.  A lane reads 4 neighbouring k of
//   two rows of x as one 16-byte load and the classes' hi and lo as 16-byte
//   shared loads (the k order inside each slice is permuted to match; the
//   sum is the same).  ‖x‖² is an f32 sum of the loaded x, once a row;
// - the closed form runs once a logit on the lane that holds it in its
//   accumulator fragment (every lane busy), with one reciprocal of den and
//   fast reciprocals for the divisions (the bounds: den, 1 − c‖z‖² ≥ EPS);
// - the tile's logits are staged in shared memory and written as one
//   contiguous block in 16-byte stores where the chunk holds every class,
//   else a row segment at a time, consecutive lanes on consecutive floats.
// Where the row tiles alone would leave the card short of warps, up to 8
// warps take a tile's k slices in turn and the first adds the others'
// fragments in a fixed order.  A block takes one group of 8/splits tiles
// (at the node-classification head 1,323 blocks).  No atomics: the same
// bits every launch.

#include <cuda_runtime.h>

#include "tf32.cuh"

namespace {

constexpr float EPS_F32 = 1e-7f;
constexpr float MIN_NORM_F32 = 1e-12f;
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int MAX_DEVICES = 64;
constexpr int STAGE_BATCH = 4;         // staging loads in flight a thread
// the per-class constants, each a [kcp] array in shared memory
enum Const { PA, P2, BETA, M2BETA, C2P2, B2, PREF, GC, NCONST };

// sign(x)·log1p(|x| + x²/(1 + √(1 + x²))), hyperspace_tpu's `kasinh`; the
// tile kernel takes the root as s·rsqrt(s) and divides by a fast reciprocal
// (1 + x² ≥ 1, 1 + √(1 + x²) ≥ 2)
template <bool FAST>
__device__ __forceinline__ float kasinh(float x) {
  const float ax = fabsf(x);
  const float s = fmaxf(ax * ax + 1.0f, 0.0f);
  const float r = FAST ? s * rsqrtf(s) : sqrtf(s);   // s ≥ 1
  const float q = FAST ? __fdividef(ax * ax, 1.0f + r) : ax * ax / (1.0f + r);
  const float y = log1pf(ax + q);
  return x > 0.0f ? y : (x < 0.0f ? -y : 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The pair plan, for launches of few logits: a warp per (row, class), lanes
// striding over d for the six inner products, a butterfly, lane 0 applying
// the closed form (exact divisions).  One load round trip and no block
// barrier: at HyboNet's heads ([256, 8, 128] and smaller) this is faster
// than staging a block's classes (PERF.md §6).
__global__ void __launch_bounds__(THREADS)
pair_kernel(const float* __restrict__ x, const float* __restrict__ p,
            const float* __restrict__ a, float* __restrict__ out, int n,
            int k, int d, const float* __restrict__ cp) {
  const float c = __ldg(cp);  // the curvature, from device memory
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
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
  out[(size_t)row * k + cls] = (lam_p * a_norm / sc) * kasinh<false>(arg);
}

// x[row, k .. k + 3], zero past n rows or d columns
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long row, int k, long long n,
                                        int d, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= n) return v;
  const float* r = x + row * d;
  if (vec) {
    if (k < d) v = __ldg(reinterpret_cast<const float4*>(r + k));
  } else {
    v.x = k < d ? __ldg(r + k) : 0.f;
    v.y = k + 1 < d ? __ldg(r + k + 1) : 0.f;
    v.z = k + 2 < d ? __ldg(r + k + 2) : 0.f;
    v.w = k + 3 < d ? __ldg(r + k + 3) : 0.f;
  }
  return v;
}

// x = hi + lo for the tensor core, lo rounded to TF32 (to nearest, ties
// away) where tf32.cuh's split leaves the tensor core to truncate it: the
// logits stay within the f32 plain version's tier at 6.8 M of them
// (PERF.md §6)
__device__ __forceinline__ void split_op(float x, unsigned& hi,
                                         unsigned& lo) {
  split_tf32(x, hi, lo);
  lo += 0x1000u;
}

// one logit from ⟨x,p⟩, ⟨x,a⟩, ‖x‖², c·‖x‖² and the class's constants
struct ClassConst {
  float pa, p2, beta, m2beta, c2p2, b2, pref, gc;
};
__device__ __forceinline__ float logit(float xp, float xa, float x2,
                                       float cx2, float c,
                                       const ClassConst& k) {
  const float t = fmaf(-2.0f * c, xp, 1.0f);       // 1 − 2c⟨p,x⟩
  const float alpha = t + cx2;
  const float den = fmaxf(fmaf(k.c2p2, x2, t), EPS_F32);
  const float na = fmaf(-alpha, k.pa, k.beta * xa);             // ⟨z,a⟩·den
  const float nz = fmaf(alpha, fmaf(alpha, k.p2, k.m2beta * xp),
                        k.b2 * x2);                              // ‖z‖²·den²
  // 1 − c‖z‖² = (den² − c·nz)/den², its clamp at EPS scaled by den², so
  // that 2√c⟨z,a⟩/((1 − c‖z‖²)‖a‖) takes one reciprocal
  const float d2 = den * den;
  const float qd = fmaxf(fmaf(-c, nz, d2), EPS_F32 * d2);
  return k.pref * kasinh<true>(__fdividef(k.gc * na * den, qd));
}

// x [n, d], p and a [k, d], out [n, k]; grid.y walks the class chunks of
// kc classes (NT = kc/8 n-tiles), grid.x the groups of WARPS/splits 16-row
// tiles, one group a block.
template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
mlr_kernel(const float* __restrict__ x, const float* __restrict__ p,
           const float* __restrict__ a, float* __restrict__ out, long long n,
           int k, int d, const float* __restrict__ cp, int kc, int splits,
           int dp, bool vec) {
  const float c = __ldg(cp);  // the curvature, from device memory
  constexpr int KCP = 8 * NT;
  extern __shared__ __align__(16) unsigned smem[];
  // p and a staged split for the tensor core: hi (p rounded to TF32,
  // unmasked) and lo (the exact remainder), [KCP][dp] each
  unsigned* ph = smem;
  unsigned* pl = ph + KCP * dp;
  unsigned* ah = pl + KCP * dp;
  unsigned* al = ah + KCP * dp;
  float* cst = reinterpret_cast<float*>(al + KCP * dp);  // [NCONST][KCP]
  // a warp's own region: its tile's logits [16][KCP], or (splits > 1) its
  // partial fragments [8·NT + 2][32]
  const int region = splits > 1 ? 32 * (8 * NT + 2) : 16 * KCP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* own = cst + NCONST * KCP + warp * region;
  const int c0 = blockIdx.y * kc;
  const int kcl = min(kc, k - c0);           // this chunk's live classes
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp / splits, part = warp % splits;
  const long long tile = (long long)blockIdx.x * (WARPS / splits) + slot;
  const long long r0 = tile * 16 + g, r1 = r0 + 8;
  const int nslices = (d + 15) / 16;

  // the tile's first slice of x, in flight while the classes are staged
  float4 u = load4(x, r0, part * 16 + 4 * t, n, d, vec);
  float4 w = load4(x, r1, part * 16 + 4 * t, n, d, vec);

  // stage the chunk's p and a rows (zero past d and past the live
  // classes), 16-byte loads where the rows allow, all of a thread's loads
  // in flight together
  const bool rows16 = vec && reinterpret_cast<size_t>(p) % 16 == 0 &&
                      reinterpret_cast<size_t>(a) % 16 == 0;
  const int per_row = dp / 4, items = KCP * per_row;
  for (int i0 = threadIdx.x; i0 < items; i0 += STAGE_BATCH * THREADS) {
    float4 pv[STAGE_BATCH], av[STAGE_BATCH];
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      const int i = i0 + b * THREADS;
      const int cl = i / per_row, j = 4 * (i - cl * per_row);
      pv[b] = av[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < items && cl < kcl) {
        pv[b] = load4(p + (size_t)(c0 + cl) * d, 0, j, 1, d, rows16);
        av[b] = load4(a + (size_t)(c0 + cl) * d, 0, j, 1, d, rows16);
      }
    }
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      const int i = i0 + b * THREADS;
      if (i >= items) break;
      const int cl = i / per_row, at = cl * dp + 4 * (i - cl * per_row);
      uint4 hp, lp, ha, la;
      split_op(pv[b].x, hp.x, lp.x);
      split_op(pv[b].y, hp.y, lp.y);
      split_op(pv[b].z, hp.z, lp.z);
      split_op(pv[b].w, hp.w, lp.w);
      split_op(av[b].x, ha.x, la.x);
      split_op(av[b].y, ha.y, la.y);
      split_op(av[b].z, ha.z, la.z);
      split_op(av[b].w, ha.w, la.w);
      *reinterpret_cast<uint4*>(ph + at) = hp;
      *reinterpret_cast<uint4*>(pl + at) = lp;
      *reinterpret_cast<uint4*>(ah + at) = ha;
      *reinterpret_cast<uint4*>(al + at) = la;
    }
  }
  __syncthreads();
  // the per-class constants: G lanes a class (G = 32 for one n-tile of
  // classes, fewer for more), all the chunk's classes at once
  constexpr int G = KCP <= 8 ? 32 : (KCP <= 16 ? 16 : (KCP <= 32 ? 8 : 4));
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), MIN_NORM_F32);
  for (int cl = (int)threadIdx.x / G; cl < KCP; cl += THREADS / G) {
    float p2 = 0.f, pa = 0.f, a2 = 0.f;
    // the rows just staged, read again from L1 in f32
    const float* pr = p + (size_t)(c0 + cl) * d;
    const float* ar = a + (size_t)(c0 + cl) * d;
    const int len = cl < kcl ? d : 0;
#pragma unroll 4
    for (int j = threadIdx.x % G; j < len; j += G) {
      const float pv = __ldg(pr + j), av = __ldg(ar + j);
      p2 = fmaf(pv, pv, p2);
      pa = fmaf(pv, av, pa);
      a2 = fmaf(av, av, a2);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      p2 += __shfl_xor_sync(0xffffffffu, p2, o);
      pa += __shfl_xor_sync(0xffffffffu, pa, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    }
    if (threadIdx.x % G == 0) {
      const float a_norm = fmaxf(sqrtf(fmaxf(a2, 0.0f)), MIN_NORM_F32);
      const float beta = 1.0f - c * p2;
      const float lam_p = 2.0f / fmaxf(beta, EPS_F32);
      cst[PA * KCP + cl] = pa;
      cst[P2 * KCP + cl] = p2;
      cst[BETA * KCP + cl] = beta;
      cst[M2BETA * KCP + cl] = -2.0f * beta;
      cst[C2P2 * KCP + cl] = (c * c) * p2;
      cst[B2 * KCP + cl] = beta * beta;
      cst[PREF * KCP + cl] = lam_p * a_norm / sc;
      cst[GC * KCP + cl] = 2.0f * sc / a_norm;
    }
  }
  __syncthreads();

  float accp[NT][4], acca[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) accp[j][e] = acca[j][e] = 0.f;
  float x2[2] = {0.f, 0.f};
  for (int s = part; s < nslices; s += splits) {
    const int k0 = s * 16 + 4 * t;
    if (s != part) {
      u = load4(x, r0, k0, n, d, vec);
      w = load4(x, r1, k0, n, d, vec);
    }
    x2[0] = fmaf(u.x, u.x,
                 fmaf(u.y, u.y, fmaf(u.z, u.z, fmaf(u.w, u.w, x2[0]))));
    x2[1] = fmaf(w.x, w.x,
                 fmaf(w.y, w.y, fmaf(w.z, w.z, fmaf(w.w, w.w, x2[1]))));
    // k step 0 takes the lane's k0, k0 + 1 (A columns t, t + 4), step 1
    // its k0 + 2, k0 + 3
    unsigned h0[4], l0[4], h1[4], l1[4];
    split_op(u.x, h0[0], l0[0]);
    split_op(w.x, h0[1], l0[1]);
    split_op(u.y, h0[2], l0[2]);
    split_op(w.y, h0[3], l0[3]);
    split_op(u.z, h1[0], l1[0]);
    split_op(w.z, h1[1], l1[1]);
    split_op(u.w, h1[2], l1[2]);
    split_op(w.w, h1[3], l1[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int at = (8 * j + g) * dp + k0;
      const uint4 bph = *reinterpret_cast<const uint4*>(ph + at);
      const uint4 bpl = *reinterpret_cast<const uint4*>(pl + at);
      const uint4 bah = *reinterpret_cast<const uint4*>(ah + at);
      const uint4 bal = *reinterpret_cast<const uint4*>(al + at);
      // the slice's hi·hi and its cross terms lo·hi + hi·lo each into a
      // fresh accumulator, added to the running sums in f32: the tensor
      // core truncates as it accumulates, so a long chain of mma into one
      // accumulator drifts (PERF.md §6)
      float bp[4] = {0.f, 0.f, 0.f, 0.f}, sp[4] = {0.f, 0.f, 0.f, 0.f};
      float ba[4] = {0.f, 0.f, 0.f, 0.f}, sa[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(sp, l0, bph.x, bph.y);
      mma_tf32(sp, h0, bpl.x, bpl.y);
      mma_tf32(sp, l1, bph.z, bph.w);
      mma_tf32(sp, h1, bpl.z, bpl.w);
      mma_tf32(bp, h0, bph.x, bph.y);
      mma_tf32(bp, h1, bph.z, bph.w);
      mma_tf32(sa, l0, bah.x, bah.y);
      mma_tf32(sa, h0, bal.x, bal.y);
      mma_tf32(sa, l1, bah.z, bah.w);
      mma_tf32(sa, h1, bal.z, bal.w);
      mma_tf32(ba, h0, bah.x, bah.y);
      mma_tf32(ba, h1, bah.z, bah.w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accp[j][e] += bp[e] + sp[e];
        acca[j][e] += ba[e] + sa[e];
      }
    }
  }
  if (splits > 1) {                          // the first part adds the rest
    if (part != 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          own[(8 * j + e) * 32 + lane] = accp[j][e];
          own[(8 * j + 4 + e) * 32 + lane] = acca[j][e];
        }
      own[(8 * NT) * 32 + lane] = x2[0];
      own[(8 * NT + 1) * 32 + lane] = x2[1];
    }
    __syncthreads();
    if (part != 0) return;
    for (int q = 1; q < splits; ++q) {
      const float* o = own + q * region;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          accp[j][e] += o[(8 * j + e) * 32 + lane];
          acca[j][e] += o[(8 * j + 4 + e) * 32 + lane];
        }
      x2[0] += o[(8 * NT) * 32 + lane];
      x2[1] += o[(8 * NT + 1) * 32 + lane];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)                // the quad's 4 lanes, in order
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      x2[h] += __shfl_xor_sync(0xffffffffu, x2[h], o);
  const float cx2[2] = {c * x2[0], c * x2[1]};
  // the logits of rows g, g + 8 and classes 8j + 2t, + 1, staged
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t;
    ClassConst kk[2];
#pragma unroll
    for (int q = 0; q < NCONST; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(cst + q * KCP + col);
      reinterpret_cast<float*>(&kk[0])[q] = v.x;
      reinterpret_cast<float*>(&kk[1])[q] = v.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      own[(g + 8 * h) * KCP + col + (e & 1)] =
          logit(accp[j][e], acca[j][e], x2[h], cx2[h], c, kk[e & 1]);
    }
  }
  __syncwarp();
  // 16 rows × kcl classes: a contiguous block of the output where the
  // chunk is all of k, else a row segment at a time
  const int live = (int)min(16LL, n - tile * 16);
  if (live <= 0) return;
  float* dst = out + tile * 16 * k + c0;
  if (kcl == k && k == KCP && reinterpret_cast<size_t>(dst) % 16 == 0) {
    const int nv = live * KCP / 4;
    for (int i = lane; i < nv; i += 32)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(own)[i];
    return;
  }
  const int step_r = 32 / kcl, step_c = 32 % kcl;
  int r = lane / kcl, cc = lane - (lane / kcl) * kcl;
  for (int i = lane; i < live * kcl; i += 32) {
    dst[(long long)r * k + cc] = own[r * KCP + cc];
    r += step_r;
    cc += step_c;
    if (cc >= kcl) {
      cc -= kcl;
      ++r;
    }
  }
}

// staged rows pitched at 16 mod 32 words: conflict-free 16-byte fragment
// loads
int row_pitch(int d) {
  const int slices = d > 16 ? (d + 15) / 16 : 1;
  return 16 * slices + (slices % 2 == 0 ? 16 : 0);
}

// bytes of dynamic shared memory of a tile block: p and a staged [kc, dp]
// as hi and lo parts, the class constants, and each warp's region (as
// mlr_kernel lays them out)
long long block_smem(int kc, int splits, int d) {
  const long long region = splits > 1 ? 32 * (kc + 2) : 16 * kc;
  return 4LL * (4LL * kc * row_pitch(d) + NCONST * kc + WARPS * region);
}

template <int NT>
int launch(const float* x, const float* p, const float* a, float* out,
           long long n, int k, int d, const float* c, int kc, int splits,
           cudaStream_t st) {
  auto kern = mlr_kernel<NT>;
  static int cap[MAX_DEVICES];      // the card's opt-in limit, once a card
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!cap[dev]) {
    int opt = 0;
    e = cudaDeviceGetAttribute(&opt, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             opt);
    if (e != cudaSuccess) return (int)e;
    cap[dev] = opt;
  }
  const long long smem = block_smem(kc, splits, d);
  if (smem > cap[dev]) return (int)cudaErrorInvalidValue;
  const int chunks = (k + kc - 1) / kc;
  const int per_block = WARPS / splits;
  const long long groups = ((n + 15) / 16 + per_block - 1) / per_block;
  const bool vec = d % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  kern<<<dim3((unsigned)groups, chunks), THREADS, (size_t)smem, st>>>(
      x, p, a, out, n, k, d, c, kc, splits, row_pitch(d), vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, d], p and a [k, d], out [n, k]; all f32, contiguous; c one f32 in
// device memory (a learned curvature is read where the step left it, never
// on the host).  The plan
// (kernels/mlr.py `mlr_plan`): the pair kernel (tile 0), or the tile kernel
// with kc classes a chunk (a multiple of 8, at most 64) and `splits` warps
// a tile (1, 2, 4 or 8).  The tile kernel's row pitch and shared memory
// follow from (kc, splits, d) here; a plan whose block exceeds the card's
// shared memory is refused.
extern "C" int hs_hyp_mlr(const float* x, const float* p, const float* a,
                          float* out, long long n, int k, int d,
                          const float* c, int tile, int kc, int splits,
                          void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (!tile) {                               // at most a few thousand logits
    if (n * k > (1LL << 30)) return (int)cudaErrorInvalidValue;
    const int blocks = (int)((n * k + WARPS - 1) / WARPS);
    pair_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        x, p, a, out, (int)n, k, d, c);
    return (int)cudaGetLastError();
  }
  if (kc <= 0 || kc % 8 || kc > 64 || splits < 1 || WARPS % splits)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, const float*, const float*, float*,
                         long long, int, int, const float*, int, int,
                         cudaStream_t);
  constexpr Launch by_tiles[8] = {launch<1>, launch<2>, launch<3>, launch<4>,
                                  launch<5>, launch<6>, launch<7>, launch<8>};
  return by_tiles[kc / 8 - 1](x, p, a, out, n, k, d, c, kc, splits,
                              (cudaStream_t)stream);
}

// the tile block's shared memory in bytes, as hs_hyp_mlr launches it (the
// wrapper's plan models it to choose kc; the `cuda` tests hold the two
// equal)
extern "C" long long hs_hyp_mlr_smem(int kc, int splits, int d) {
  return block_smem(kc, splits, d);
}
