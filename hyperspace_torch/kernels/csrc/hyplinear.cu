// The fused gyro-linear layer y = proj((M ⊗_c x) ⊕_c b) (kernel N5) for
// sm_90a, one launch, on the tensor cores.
//
// Replaces hyperspace_tpu/kernels/hyplinear.py `_launch_hyp_linear` (the
// Pallas body `_hyp_linear_body`): the product x @ M at f32 accuracy (the
// TPU kernel's Precision.HIGHEST), the Möbius rescale
// tanh(‖Mx‖/‖x‖·artanh(√c‖x‖))·Mx/(‖Mx‖√c) with rows where max|Mx| = 0
// sent to the origin, ⊕ b, then proj, with the TPU kernel's clamps (EPS
// 1e-7, MIN_NORM 1e-12, the log-form artanh clamped at 1 ± 3e-7, tanh
// clipped at ±20, proj's margin 4e-3).
//
// What bounds it on an H100: bytes.  At the layer path's [169,343, 128] ×
// [128, 128] the kernel must read x (87 MB) and write the output (87 MB):
// 0.052 ms at 3.35 TB/s.  The product's three TF32 passes (below) are 16.6
// GFLOP, 0.034 ms at the data sheet's 495 TFLOP/s of dense TF32 (0.065 at
// the 254.6 TFLOP/s that benchmarks/flash_probe.py measured for
// `mma.sync`); the 67 TFLOP/s of f32 FMAs outside the tensor cores is no
// floor for it.  At × [128, 32] x alone is 87 MB of 109.
//
// Precision.  TF32 keeps 10 mantissa bits; tanh∘artanh amplifies the
// product's error near the ball's edge, and one TF32 product a pair misses
// the JAX package's tier (rtol = atol = 2e-4; tests/test_torch_hyplinear_
// split.py emulates both on the CPU).  So every operand is split as the
// flash kernels split theirs (tf32.cuh, `split_tf32`): hi = x rounded to
// TF32, lo = the remainder, and a pair is lo·hi' + hi·lo' + hi·hi', summed
// in f32 by the tensor core (a bf16 x has no lo: two products).  ‖x‖² is a full f32 sum
// of the loaded x, never of its split.
//
// Design, against what held the SIMT kernel back:
// - the product on the tensor cores (`mma.sync.m16n8k8` TF32), a warp
//   owning 16 rows and the whole column tile (up to 128 columns: 64 f32
//   accumulators a thread), so no product goes through device memory: the
//   row statistics ‖Mx‖², ⟨Mx, b⟩ and max|Mx| are summed from the
//   fragments (over the warp's n-tiles in registers, then over the quad by
//   shuffles, a fixed order), α, β and the proj scale are applied in
//   registers, and each output is written once, in its dtype, 16 bytes a
//   lane where d_out and the base allow;
// - M resident: a block stages M (transposed, rows padded to 16 mod 32
//   floats so the fragment reads are conflict-free 16-byte loads) once and
//   walks row tiles (persistent blocks, as many as fit on the card);
// - x streamed into the A fragments by 16-byte `cp.async` copies (a lane
//   takes 4 neighbouring k of two rows; the product's k order is permuted
//   to match, the same permutation for M), each lane 3 slices of 16 ahead
//   of the one it multiplies, through the tile boundaries: with one slice
//   in flight the stream, not the tensor cores, set the time (a single
//   TF32 product a pair ran only 0.12 against 0.17 ms);
// - the column tile fits d_out (8, 16, 32, 64 or 128 columns), so 128 → 32
//   multiplies no zero columns.
// A d_out above 128 walks 128-wide column tiles twice (statistics, then
// the product again and the output; the same bits both times), and a d_in
// whose M does not fit restages M in 128-deep slices: paths of the same
// kernel, held by the same tests.  No atomics: the same bits every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr float EPS_F32 = 1e-7f;
constexpr float MIN_NORM_F32 = 1e-12f;
constexpr float BALL_EPS_F32 = 4e-3f;
constexpr float ARTANH_EPS_F32 = 3e-7f;
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;       // rows a block tile: 16 a warp
constexpr int X_STAGES = 4;            // 16-wide x slices in flight a lane
constexpr int KB_SLICE = 128;          // M's depth staged at once when all of
                                       // it does not fit
constexpr int M_SMEM_CAP = 112 * 1024; // M's shared tile, at most
constexpr int MAX_DEVICES = 64;

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

// cp.async of 16, 8 or 4 bytes into shared memory; with `bytes` 0 it
// reads nothing and writes zeros
__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         int size, int bytes) {
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
  else if (size == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

struct Shape {
  long long n;
  int din, dout, kb, ldk;
  bool vec_in, vec_out, resident;
};

// x streamed into the A fragments: lane (g, t) of a warp owns rows g and
// g + 8 of the warp's 16 and, in each 16-wide slice of d_in, their values
// at 4t .. 4t + 3.  A lane copies exactly what it reads, into slots of its
// own (X_STAGES slices deep, 16 bytes a row for f32 and 8 for bf16,
// neighbouring lanes on neighbouring slots), so no barrier is needed: it
// waits for its own copies.  The lane walks one stream of slices through
// the whole launch (every product() call of every tile the block owns, in
// call order), X_STAGES − 1 slices ahead of the one it multiplies, across
// tile boundaries.
template <typename T>
struct XStream {
  static constexpr int SLOT = 4 * sizeof(T);
  const T* x;
  long long n, ntiles, tile;  // tile: the tile of the next slice to copy
  int din, nch, calls, ch, call;
  int head, next;             // the slots to copy into and to read next
  unsigned sbase;             // this lane's first slot (shared address)
  const char* gbase;          // the same, generic
  bool vec;

  __device__ __forceinline__ int slot(int s, int h) const {
    return (s * 2 + h) * THREADS * SLOT;
  }
  __device__ __forceinline__ void fetch(int off, long long r, int k) const {
    const bool in = r < n && k < din;
    const T* p = x + (in ? r * din + k : 0);
    if (vec) {
      cp_async(sbase + off, p, SLOT, in ? SLOT : 0);
    } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = in && k + i < din;
        cp_async(sbase + off + 4 * i, ok ? p + i : x, 4, ok ? 4 : 0);
      }
    } else {  // bf16 values one at a time: two bytes is below cp.async
      __nv_bfloat16 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = in && k + i < din ? p[i] : __float2bfloat16_rn(0.0f);
      *reinterpret_cast<uint2*>(const_cast<char*>(gbase) + off) =
          *reinterpret_cast<const uint2*>(v);
    }
  }
  // copy the next slice of the stream (an empty group past its end)
  __device__ __forceinline__ void copy_next() {
    if (tile < ntiles) {
      const int lane = threadIdx.x & 31;
      const long long r = tile * ROWS + (threadIdx.x >> 5) * 16 + (lane >> 2);
      const int k = 16 * ch + 4 * (lane & 3);
      fetch(slot(head, 0), r, k);
      fetch(slot(head, 1), r + 8, k);
      if (++ch == nch) {
        ch = 0;
        if (++call == calls) call = 0, tile += gridDim.x;
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    head = head + 1 == X_STAGES ? 0 : head + 1;
  }
  // the next slice's values for rows g (xa) and g + 8 (xb)
  __device__ __forceinline__ void take(float (&xa)[4], float (&xb)[4]) {
    asm volatile("cp.async.wait_group %0;" :: "n"(X_STAGES - 2) : "memory");
    read(gbase + slot(next, 0), xa);
    read(gbase + slot(next, 1), xb);
    next = next + 1 == X_STAGES ? 0 : next + 1;
    copy_next();
  }
  __device__ __forceinline__ static void read(const char* p, float (&v)[4]) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
      v[0] = __low2float(lo), v[1] = __high2float(lo);
      v[2] = __low2float(hi), v[3] = __high2float(hi);
    }
  }
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 q;
  q.x = *reinterpret_cast<unsigned*>(&lo);
  q.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

// Stage M[k0 : k0 + kb, c0 : c0 + CT] transposed into mt[CT][ldk] (zeros
// past d_in and d_out): a lane reads 4 rows of one column (neighbouring
// lanes on neighbouring columns) and writes them as one 16-byte word.
template <int CT>
__device__ __forceinline__ void stage_m(float* mt, const float* m, int din,
                                        int dout, int k0, int c0, int kb,
                                        int ldk) {
  for (int e = threadIdx.x; e < CT * (kb / 4); e += THREADS) {
    const int cc = e % CT, kq = e / CT;
    const int col = c0 + cc, k = k0 + 4 * kq;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (col < dout && k + i < din)
                 ? __ldg(m + (long long)(k + i) * dout + col)
                 : 0.0f;
    *reinterpret_cast<float4*>(mt + cc * ldk + 4 * kq) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// acc = x[rows ra, rb] @ M[:, ct·CT : (ct + 1)·CT] in 3×TF32 (2 for bf16
// x), and x2 += the rows' ‖x‖² when `want_x2`.  Lane (g, t) holds rows ra
// = tile row g and rb = g + 8; in each 16-wide slice it takes x[r][4t :
// 4t + 4] from the stream, which feed k-slots t and t + 4 of two m16n8k8
// steps (step s: values 2s and 2s + 1), and reads M's column 8j + g at
// the same four k.
template <typename T, int NT>
__device__ __forceinline__ void product(float (&acc)[NT][4], float* mt,
                                        XStream<T>& xs,
                                        const float* __restrict__ m,
                                        const Shape& sh, int ct, bool want_x2,
                                        float (&x2)[2]) {
  constexpr int CT = 8 * NT;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const int nkb = (sh.din + sh.kb - 1) / sh.kb;
  for (int kbi = 0; kbi < nkb; ++kbi) {
    const int k0 = kbi * sh.kb;
    if (!sh.resident) {
      __syncthreads();
      stage_m<CT>(mt, m, sh.din, sh.dout, k0, ct * CT, sh.kb, sh.ldk);
      __syncthreads();
    }
    const int nch = (min(sh.kb, sh.din - k0) + 15) >> 4;
    for (int ch = 0; ch < nch; ++ch) {
      float xa[4], xb[4];
      xs.take(xa, xb);
      if (want_x2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x2[0] = fmaf(xa[i], xa[i], x2[0]);
          x2[1] = fmaf(xb[i], xb[i], x2[1]);
        }
      }
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        split_tf32(xa[2 * s], ah[s][0], al[s][0]);
        split_tf32(xb[2 * s], ah[s][1], al[s][1]);
        split_tf32(xa[2 * s + 1], ah[s][2], al[s][2]);
        split_tf32(xb[2 * s + 1], ah[s][3], al[s][3]);
      }
      const float* mp = mt + g * sh.ldk + 16 * ch + 4 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(mp + 8 * j * sh.ldk);
        unsigned bh[4], bl[4];
        split_tf32(w.x, bh[0], bl[0]);
        split_tf32(w.y, bh[1], bl[1]);
        split_tf32(w.z, bh[2], bl[2]);
        split_tf32(w.w, bh[3], bl[3]);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if constexpr (std::is_same<T, float>::value)
            mma_tf32(acc[j], al[s], bh[2 * s], bh[2 * s + 1]);
          mma_tf32(acc[j], ah[s], bl[2 * s], bl[2 * s + 1]);
          mma_tf32(acc[j], ah[s], bh[2 * s], bh[2 * s + 1]);
        }
      }
    }
  }
}

// a lane's part of rows ra (h = 0) and rb (h = 1): ‖Mx‖², ⟨Mx, b⟩,
// max|Mx| over its columns of column tile ct
template <int NT>
__device__ __forceinline__ void row_stats(const float (&acc)[NT][4],
                                          const float* __restrict__ b,
                                          int dout, int ct, float (&mx2)[2],
                                          float (&mb)[2], float (&mmax)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = ct * 8 * NT + 8 * j + 2 * t;
    const float b0 = col < dout ? __ldg(b + col) : 0.0f;
    const float b1 = col + 1 < dout ? __ldg(b + col + 1) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      mx2[h] = fmaf(v1, v1, fmaf(v0, v0, mx2[h]));
      mb[h] = fmaf(v1, b1, fmaf(v0, b0, mb[h]));
      mmax[h] = fmaxf(mmax[h], fmaxf(fabsf(v0), fabsf(v1)));
    }
  }
}

// out = (α·Mx + β·b)·q for column tile ct: a lane holds rows ra and rb at
// columns 2t, 2t + 1 of each n-tile; with `vec_out` lanes t and t ^ 1 swap
// halves so that an even lane writes 4 columns of ra and an odd lane 4 of
// rb, 16 bytes (8 for bf16) each
template <typename T, int NT>
__device__ __forceinline__ void write_out(const float (&acc)[NT][4],
                                          T* __restrict__ out,
                                          const float* __restrict__ b,
                                          const Shape& sh, int ct,
                                          long long ra, long long rb,
                                          const float (&al)[2],
                                          const float (&be)[2],
                                          const float (&q)[2]) {
  const int t = threadIdx.x & 3;
  const bool odd = t & 1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = ct * 8 * NT + 8 * j + 2 * t;
    const float b0 = col < sh.dout ? __ldg(b + col) : 0.0f;
    const float b1 = col + 1 < sh.dout ? __ldg(b + col + 1) : 0.0f;
    const float o0 = (al[0] * acc[j][0] + be[0] * b0) * q[0];
    const float o1 = (al[0] * acc[j][1] + be[0] * b1) * q[0];
    const float o2 = (al[1] * acc[j][2] + be[1] * b0) * q[1];
    const float o3 = (al[1] * acc[j][3] + be[1] * b1) * q[1];
    if (sh.vec_out) {
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? o0 : o2, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? o1 : o3, 1);
      const long long row = odd ? rb : ra;
      const int c4 = odd ? col - 2 : col;
      if (row < sh.n && c4 < sh.dout) {
        T* p = out + row * sh.dout + c4;
        if (odd)
          store4(p, r0, r1, o2, o3);
        else
          store4(p, o0, o1, r0, r1);
      }
    } else {
      if (ra < sh.n) {
        if (col < sh.dout) store1(out + ra * sh.dout + col, o0);
        if (col + 1 < sh.dout) store1(out + ra * sh.dout + col + 1, o1);
      }
      if (rb < sh.n) {
        if (col < sh.dout) store1(out + rb * sh.dout + col, o2);
        if (col + 1 < sh.dout) store1(out + rb * sh.dout + col + 1, o3);
      }
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
hyp_linear_kernel(const T* __restrict__ x, const float* __restrict__ m,
                  const float* __restrict__ b, T* __restrict__ out, Shape sh,
                  const float* __restrict__ cp, float cv) {
  constexpr int CT = 8 * NT;
  extern __shared__ float4 smem4[];
  float* mt = reinterpret_cast<float*>(smem4);
  __shared__ float b2s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float c = cp ? *cp : cv;
  const int nct = (sh.dout + CT - 1) / CT;

  if (warp == 0) {  // ‖b‖², one warp, fixed order
    float s = 0.f;
    for (int j = lane; j < sh.dout; j += 32) s = fmaf(b[j], b[j], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) b2s = s;
  }
  const long long ntiles = (sh.n + ROWS - 1) / ROWS;
  XStream<T> xs;
  xs.x = x, xs.n = sh.n, xs.ntiles = ntiles, xs.tile = blockIdx.x;
  xs.din = sh.din, xs.nch = (sh.din + 15) / 16;
  xs.calls = nct == 1 ? 1 : 2 * nct;  // product() calls a tile
  xs.ch = xs.call = xs.head = xs.next = 0;
  xs.vec = sh.vec_in;
  const int x_off = CT * sh.ldk * 4 + threadIdx.x * XStream<T>::SLOT;
  xs.gbase = reinterpret_cast<const char*>(smem4) + x_off;
  xs.sbase = (unsigned)__cvta_generic_to_shared(smem4) + x_off;
  if (xs.nch == 0) xs.tile = ntiles;  // d_in = 0: nothing to stream
  for (int i = 0; i < X_STAGES - 1; ++i) xs.copy_next();
  if (sh.resident) stage_m<CT>(mt, m, sh.din, sh.dout, 0, 0, sh.kb, sh.ldk);
  __syncthreads();
  const float b2 = b2s;
  const float sc = fmaxf(ksafe_sqrt(c), MIN_NORM_F32);
  const float max_norm = (1.0f - BALL_EPS_F32) / sc;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long ra = tile * ROWS + warp * 16 + (lane >> 2), rb = ra + 8;
    float x2[2] = {0.f, 0.f}, mx2[2] = {0.f, 0.f}, mb[2] = {0.f, 0.f};
    float mmax[2] = {0.f, 0.f};
    float acc[NT][4];
    for (int ct = 0; ct < nct; ++ct) {
      product<T, NT>(acc, mt, xs, m, sh, ct, ct == 0, x2);
      row_stats<NT>(acc, b, sh.dout, ct, mx2, mb, mmax);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the quad's 4 lanes, a fixed order
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        x2[h] += __shfl_xor_sync(0xffffffffu, x2[h], o);
        mx2[h] += __shfl_xor_sync(0xffffffffu, mx2[h], o);
        mb[h] += __shfl_xor_sync(0xffffffffu, mb[h], o);
        mmax[h] = fmaxf(mmax[h], __shfl_xor_sync(0xffffffffu, mmax[h], o));
      }
    }
    float al[2], be[2], q[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // M ⊗ x = s·Mx (s = 0 where Mx = 0)
      const float xn = fmaxf(ksafe_sqrt(x2[h]), MIN_NORM_F32);
      const float mn = fmaxf(ksafe_sqrt(mx2[h]), MIN_NORM_F32);
      const float s = mmax[h] == 0.f
                          ? 0.f
                          : ktanh(mn / xn * kartanh(sc * xn)) / (mn * sc);
      // (s·Mx) ⊕ b = α·Mx + β·b, then proj's scale q
      const float r2 = s * s * mx2[h], rbv = s * mb[h];
      const float d =
          fmaxf(1.0f + 2.0f * c * rbv + (c * c) * r2 * b2, EPS_F32);
      al[h] = (1.0f + 2.0f * c * rbv + c * b2) * s / d;
      be[h] = (1.0f - c * r2) / d;
      const float z2 = al[h] * al[h] * mx2[h] + 2.0f * al[h] * be[h] * mb[h] +
                       be[h] * be[h] * b2;
      const float zn = fmaxf(ksafe_sqrt(z2), MIN_NORM_F32);
      q[h] = zn > max_norm ? max_norm / zn : 1.0f;
    }
    if (nct == 1) {
      write_out<T, NT>(acc, out, b, sh, 0, ra, rb, al, be, q);
    } else {
      for (int ct = 0; ct < nct; ++ct) {
        product<T, NT>(acc, mt, xs, m, sh, ct, false, x2);
        write_out<T, NT>(acc, out, b, sh, ct, ra, rb, al, be, q);
      }
    }
  }
}

template <typename T, int NT>
int launch(const void* x, const float* m, const float* b, void* out,
           long long n, int din, int dout, const float* cp, float cv,
           cudaStream_t st) {
  constexpr int CT = 8 * NT;
  // M's rows padded to 16 mod 32 floats: a quarter-warp's 16-byte fragment
  // reads (columns g and g + 1, k 0..15) cover the 32 banks once
  auto pitch = [](int kb) { return kb % 32 == 0 ? kb + 16 : kb; };
  Shape sh;
  sh.n = n, sh.din = din, sh.dout = dout;
  sh.kb = din <= 0 ? 16 : (din + 15) / 16 * 16;
  if ((long long)CT * pitch(sh.kb) * 4 > M_SMEM_CAP) sh.kb = KB_SLICE;
  sh.ldk = pitch(sh.kb);
  sh.resident = dout <= CT && din <= sh.kb;
  sh.vec_in = din % 4 == 0 &&
              reinterpret_cast<size_t>(x) % (4 * sizeof(T)) == 0;
  sh.vec_out = dout % 4 == 0 &&
               reinterpret_cast<size_t>(out) % (4 * sizeof(T)) == 0;
  constexpr int x_smem = X_STAGES * 2 * THREADS * XStream<T>::SLOT;
  const size_t smem = (size_t)CT * sh.ldk * 4 + x_smem;
  auto kern = hyp_linear_kernel<T, NT>;
  // per card: the shared-memory limit set once, and the resident blocks
  // for the last launch's shared memory (a layer's d_in is fixed, so a
  // path asks the occupancy API once a layer)
  struct Fit {
    size_t smem;
    long long slots;
  };
  static Fit fit_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  Fit& fit = fit_of[dev];
  if (fit.slots == 0) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             M_SMEM_CAP + x_smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (fit.slots == 0 || fit.smem != smem) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                  smem);
    fit.smem = smem;
    fit.slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  }
  const long long tiles = (n + ROWS - 1) / ROWS;
  const unsigned grid =
      (unsigned)(tiles < fit.slots ? tiles : fit.slots);
  kern<<<grid, THREADS, smem, st>>>((const T*)x, m, b, (T*)out, sh, cp, cv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kind(const void* x, const float* m, const float* b, void* out,
                long long n, int din, int dout, const float* cp, float cv,
                cudaStream_t st) {
  // the narrowest column tile that holds d_out (128-wide tiles above)
  if (dout <= 8) return launch<T, 1>(x, m, b, out, n, din, dout, cp, cv, st);
  if (dout <= 16) return launch<T, 2>(x, m, b, out, n, din, dout, cp, cv, st);
  if (dout <= 32) return launch<T, 4>(x, m, b, out, n, din, dout, cp, cv, st);
  if (dout <= 64) return launch<T, 8>(x, m, b, out, n, din, dout, cp, cv, st);
  return launch<T, 16>(x, m, b, out, n, din, dout, cp, cv, st);
}

}  // namespace

// x [n, din] of `kind` (0 float32, 1 bfloat16), m [din, dout] and b [dout]
// float32, out [n, dout] of `kind`; c read from the device pointer when it
// is not null
extern "C" int hs_hyp_linear(int kind, const void* x, const float* m,
                             const float* b, void* out, long long n, int din,
                             int dout, const float* cp, float cv,
                             void* stream) {
  if (n <= 0 || dout <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    return launch_kind<float>(x, m, b, out, n, din, dout, cp, cv, st);
  if (kind == 1)
    return launch_kind<__nv_bfloat16>(x, m, b, out, n, din, dout, cp, cv,
                                      st);
  return (int)cudaErrorInvalidValue;
}
