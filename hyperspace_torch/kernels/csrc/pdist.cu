// All-pairs hyperbolic distance matrix, float32, for sm_90a.
//
// Replaces hyperspace_tpu/kernels/distmat.py `_poincare_body` and
// `_lorentz_body` (the Pallas kernel launched in `_launch_pdist`).
//
// Closed forms (as in the Pallas bodies and `pdist_plain`):
//   ball:        d2 = max(‖x‖² − 2⟨x,y⟩ + ‖y‖², 0),
//                u = 2c·d2 / max((1−c‖x‖²)(1−c‖y‖²), 1e-7)
//   hyperboloid: u = max(−c⟨x,y⟩_L − 1, 0)   (x's time lane negated)
//   dist = arcosh(1 + u) / max(√c, 1e-12),  arcosh(1 + u) = ln(1 + u + √(u(u+2)))
//
// What bounds it on an H100: the [n, m] float32 output, n·m·4 bytes over
// 3.35 TB/s (at the served D = 10 the inputs are a few per cent of it):
// 0.0025 ms for one two-stage chunk [1024, 2048], 0.10 ms for the WordNet
// table [1024, 82,115].  An output takes D FMAs for the Gram and about 25
// instructions of closed form, so at D = 10 the instructions weigh as much
// as the store; the design cuts both:
// - the Gram runs exactly D products: D = 10 and 11 (the served ball and
//   its Lorentz lift) are compile-time, a lane keeping its 4 columns' y
//   rows in registers (staged once per block through a transposed shared
//   tile) and reading each x row from shared memory as a broadcast; any
//   other D takes a general loop over 16-wide slices of both operands
//   staged in shared memory, 4 rows a warp;
// - the per-row (‖x‖², 1 − c‖x‖², 2c/(1 − c‖x‖²)) and per-column (‖y‖²,
//   1 − c‖y‖², its reciprocal) factors are computed once per row or column
//   of the tile, so an output takes no division: u = d2·(2c/fx)·(1/fy)
//   where fx·fy ≥ 1e-7, else d2·2c/1e-7 (the clamp keeps its meaning for
//   rows outside the ball, where a factor is ≤ 0: a hoisted reciprocal of
//   a negative factor is never used on its own);
// - √v as v·rsqrt(v), and ln(1 + w) as log2(1 + w)·ln 2, both by the MUFU
//   with subnormals flushed (the final 1/√c folded into that constant): a
//   few 1e-7 absolute at d ≈ 0, 2 ulp above, against the tier's atol 1e-4
//   and rtol 1e-5;
// - streaming stores (`st.global.cs`: the write-once output does not evict
//   the table chunk the next launch reads), 16 bytes a lane (4 neighbouring
//   columns) where a row starts on a 16-byte boundary, else 4 bytes: at m
//   % 4 ≠ 0 (m = 82,115, 287) that is 3 rows in 4.  Realigning those rows
//   by shuffles into 16-byte words with a scalar head and tail cost more
//   than the four stores (0.221 against 0.154 ms at [1024, 82,115] on an
//   H100; the same kernel at an aligned pitch, 82,112, took 0.143);
// - a block is 4 warps over 128 columns and a row tile whose height the
//   host picks from the shape: the shortest multiple of 4 rows (at most
//   64) whose blocks fit on the card in one wave, so that one two-stage
//   chunk ([1024, 2048]) runs in a single wave and 8 query rows take two
//   4-row tiles.  Row tiles lie on grid.x and column tiles on grid.y
//   (blocks launched in turn share y's tile); an m past the 65,535 column
//   tiles a grid holds (8.4 M) takes one launch per 65,535 (a loop inside
//   the kernel cost 16 registers and 5 % at [1024, 82,115] on an H100).
// At [1024, 82,115] the time swings by up to 13 % between builds that
// differ only in the launch's arithmetic or in `Args`' layout (0.151 to
// 0.172 ms on an H100, the same registers): keep the floats of `Args` on
// a 16-byte boundary, as below, and time any edit at that shape.
// Sums run in a fixed order, ‖x‖², ‖y‖² and ⟨x,y⟩ in the same one, so a
// ball row against its own copy gives d = 0 exactly; no atomics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int COLS = 128;        // columns a block: 4 a lane
constexpr int CP = COLS + 4;     // pitch of the transposed y tile
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int KS = 16;           // the general loop's slice of D
constexpr int GEN_ROWS = 4;      // the general loop's rows a warp
constexpr int MAX_TILE_ROWS = 64;
constexpr int MAX_GRID_Y = 65535;  // column tiles a launch's grid holds
constexpr int MAX_DEVICES = 64;
constexpr float LN2 = 0.69314718055994531f;

enum Kind { POINCARE = 0, LORENTZ = 1 };

struct Args {
  const float* x;
  const float* y;
  float* out;
  int n, m, d, rows;           // rows: the row tile's height
  float c, c2, c2e7, ln2_sc;   // c, 2c, 2c/1e-7, ln 2 / max(√c, 1e-12)
  int out_mod4;                // the output base's offset in floats, mod 4
  int col_base;                // the launch's first column (last: see above)
};

// the MUFU's log2 and 1/√x, subnormals flushed (no rescaling branch)
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the distance from the Gram g and the factors; ry is 1/fy
template <int KIND>
__device__ __forceinline__ float dist_of(const Args& a, float g, float xx,
                                         float fx, float px, float yy,
                                         float fy, float ry) {
  float u;
  if constexpr (KIND == LORENTZ) {
    u = -a.c * g - 1.0f;
  } else {
    const float d2 = fmaxf(fmaf(-2.0f, g, xx) + yy, 0.0f);
    u = fx * fy >= 1e-7f ? d2 * px * ry : d2 * a.c2e7;
  }
  u = fmaxf(u, 0.0f);
  const float v = u * (u + 2.0f);
  const float s = v > 1e-30f ? v * rsqrt_approx(v) : 0.0f;
  return lg2_approx(1.0f + (u + s)) * a.ln2_sc;
}

// Write a lane's 4 outputs of row r at columns col .. col + 3: one
// 16-byte streaming store where the row starts on a 16-byte boundary, else
// (m % 4 ≠ 0, every other row or more) four 4-byte ones
__device__ __forceinline__ void store_row(const Args& a, int r, int col,
                                          const float (&o)[4]) {
  float* p = a.out + (size_t)r * a.m + col;
  const bool aligned = (((r & 3) * (a.m & 3) + a.out_mod4) & 3) == 0;
  if (aligned && col + 3 < a.m) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < a.m) __stcs(p + i, o[i]);
}

// DT > 0: D = DT, a lane's 4 y rows in registers, rows of the tile walked
// by the warps; DT == 0: any D, GEN_ROWS rows a warp, D walked in KS-wide
// slices
template <int DT, int KIND>
__global__ void __launch_bounds__(THREADS) pdist_kernel(Args a) {
  constexpr int XP = DT > 0 ? (DT + 3) / 4 * 4 : KS;  // x row pitch
  constexpr int YD = DT > 0 ? DT : KS;                // y tile depth
  __shared__ __align__(16) float ys[YD * CP];         // y tile, transposed
  __shared__ __align__(16) float xs[MAX_TILE_ROWS * XP];
  __shared__ float4 xf[MAX_TILE_ROWS];                // xx, fx, 2c/fx
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * a.rows;
  const int col0 = blockIdx.y * COLS + a.col_base;
  const int col = col0 + 4 * lane;
  constexpr bool ball = KIND != LORENTZ;

  if constexpr (DT > 0) {
    for (int e = threadIdx.x; e < COLS * DT; e += THREADS) {
      const int cc = e / DT, k = e % DT;
      ys[k * CP + cc] = col0 + cc < a.m
                            ? __ldg(a.y + (size_t)(col0 + cc) * DT + k)
                            : 0.0f;
    }
    for (int e = threadIdx.x; e < a.rows * DT; e += THREADS) {
      const int r = e / DT, k = e % DT;
      float v = row0 + r < a.n ? __ldg(a.x + (size_t)(row0 + r) * DT + k)
                               : 0.0f;
      xs[r * XP + k] = (!ball && k == 0) ? -v : v;  // Minkowski signature
    }
    __syncthreads();
    if (ball) {
      for (int r = threadIdx.x; r < a.rows; r += THREADS) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < DT; ++k) s = fmaf(xs[r * XP + k], xs[r * XP + k], s);
        const float fx = 1.0f - a.c * s;
        xf[r] = make_float4(s, fx, a.c2 / fx, 0.0f);
      }
    }
    float yv[4][DT];
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      const float4 q = *reinterpret_cast<const float4*>(ys + k * CP + 4 * lane);
      yv[0][k] = q.x, yv[1][k] = q.y, yv[2][k] = q.z, yv[3][k] = q.w;
    }
    float yy[4] = {0.f, 0.f, 0.f, 0.f}, fy[4], ry[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < DT; ++k) yy[i] = fmaf(yv[i][k], yv[i][k], yy[i]);
      fy[i] = 1.0f - a.c * yy[i];
      ry[i] = 1.0f / fy[i];
    }
    __syncthreads();
    for (int r = warp; r < a.rows; r += WARPS) {
      if (row0 + r >= a.n) break;
      float xv[XP];
#pragma unroll
      for (int k = 0; k < XP; k += 4) {
        const float4 q = *reinterpret_cast<const float4*>(xs + r * XP + k);
        xv[k] = q.x, xv[k + 1] = q.y, xv[k + 2] = q.z, xv[k + 3] = q.w;
      }
      const float4 f = ball ? xf[r] : make_float4(0.f, 0.f, 0.f, 0.f);
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float g = 0.0f;
#pragma unroll
        for (int k = 0; k < DT; ++k) g = fmaf(xv[k], yv[i][k], g);
        o[i] = dist_of<KIND>(a, g, f.x, f.y, f.z, yy[i], fy[i], ry[i]);
      }
      store_row(a, row0 + r, col, o);
    }
  } else {
    // GEN_ROWS rows a warp, rows row0 + warp·GEN_ROWS + i (a.rows is
    // WARPS·GEN_ROWS)
    const int r0 = warp * GEN_ROWS;
    float g[GEN_ROWS][4] = {}, xx[GEN_ROWS] = {}, yy[4] = {};
    for (int k0 = 0; k0 < a.d; k0 += KS) {
      const int kn = min(KS, a.d - k0);
      __syncthreads();
      for (int e = threadIdx.x; e < COLS * KS; e += THREADS) {
        const int cc = e / KS, k = e % KS;
        ys[k * CP + cc] = (col0 + cc < a.m && k < kn)
                              ? __ldg(a.y + (size_t)(col0 + cc) * a.d + k0 + k)
                              : 0.0f;
      }
      for (int e = threadIdx.x; e < a.rows * KS; e += THREADS) {
        const int rr = e / KS, k = e % KS;
        float v = (row0 + rr < a.n && k < kn)
                      ? __ldg(a.x + (size_t)(row0 + rr) * a.d + k0 + k)
                      : 0.0f;
        xs[rr * XP + k] = (!ball && k0 + k == 0) ? -v : v;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        const float4 q = *reinterpret_cast<const float4*>(ys + k * CP + 4 * lane);
        const float yk[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) yy[i] = fmaf(yk[i], yk[i], yy[i]);
#pragma unroll
        for (int j = 0; j < GEN_ROWS; ++j) {
          const float xv = xs[(r0 + j) * XP + k];
          xx[j] = fmaf(xv, xv, xx[j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) g[j][i] = fmaf(xv, yk[i], g[j][i]);
        }
      }
    }
    float fy[4], ry[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) fy[i] = 1.0f - a.c * yy[i], ry[i] = 1.0f / fy[i];
#pragma unroll
    for (int j = 0; j < GEN_ROWS; ++j) {
      const int r = row0 + r0 + j;
      if (r >= a.n) break;
      const float fx = 1.0f - a.c * xx[j], px = a.c2 / fx;
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = dist_of<KIND>(a, g[j][i], xx[j], fx, px, yy[i], fy[i], ry[i]);
      store_row(a, r, col, o);
    }
  }
}

template <int DT, int KIND>
int launch(Args a, cudaStream_t st) {
  const int col_tiles = (a.m + COLS - 1) / COLS;
  if (DT == 0) {
    a.rows = WARPS * GEN_ROWS;
  } else {
    // the shortest row tile (a multiple of 4, at most 64) whose blocks all
    // fit on the card at once: one wave, each block's set-up (y's tile in
    // registers, the factors) spread over as many rows as that allows
    static int slots_of[MAX_DEVICES];  // resident blocks on each card
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    int slots = slots_of[dev];
    if (slots == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pdist_kernel<DT, KIND>, THREADS, 0);
      slots = slots_of[dev] = (per_sm > 0 ? per_sm : 1) * sms;
    }
    a.rows = WARPS;
    while (a.rows < MAX_TILE_ROWS &&
           (long long)col_tiles * ((a.n + a.rows - 1) / a.rows) > slots)
      a.rows += WARPS;
  }
  for (int tile0 = 0; tile0 < col_tiles; tile0 += MAX_GRID_Y) {
    const int tiles = col_tiles - tile0;
    a.col_base = tile0 * COLS;
    const dim3 grid((a.n + a.rows - 1) / a.rows,
                    tiles < MAX_GRID_Y ? tiles : MAX_GRID_Y);
    pdist_kernel<DT, KIND><<<grid, THREADS, 0, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int hs_pdist(const float* x, const float* y, float* out, int n,
                        int m, int d, float c, int kind, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  Args a;
  a.x = x, a.y = y, a.out = out, a.n = n, a.m = m, a.d = d;
  a.rows = a.col_base = 0;
  a.c = c, a.c2 = 2.0f * c, a.c2e7 = 2.0f * c / 1e-7f;
  a.ln2_sc = LN2 / fmaxf(sqrtf(fmaxf(c, 0.0f)), 1e-12f);
  a.out_mod4 = (int)((reinterpret_cast<size_t>(out) / 4) & 3);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == LORENTZ) {
    if (d == 10) return launch<10, LORENTZ>(a, st);
    if (d == 11) return launch<11, LORENTZ>(a, st);
    return launch<0, LORENTZ>(a, st);
  }
  if (d == 10) return launch<10, POINCARE>(a, st);
  if (d == 11) return launch<11, POINCARE>(a, st);
  return launch<0, POINCARE>(a, st);
}
