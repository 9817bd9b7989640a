// Hyperbolic flash attention (HyboNet, Chen et al. 2022) for sm_90a:
// forward, dq and dk/dv, f32 in and out; the forward on the tensor cores
// (3×TF32), dq and dk/dv in f32 FMA arithmetic.
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
// 16 operations per byte, so arithmetic, not the 3.35 TB/s of device
// memory, is the bound.
//
// The forward runs on the tensor cores at f32 accuracy:
//   - a block of four warps owns 64 query rows, 16 a warp; the Gram
//     Q·(JK)ᵀ and the average P·V are `mma.sync.m16n8k8` TF32 products
//     with f32 accumulation, D zero-padded to DP (a multiple of 8);
//   - TF32 keeps 10 mantissa bits, far coarser than the JAX kernel's
//     Precision.HIGHEST, so every operand x is split into hi (x rounded
//     to TF32, to nearest, ties away from zero, as `cvt.rna`) and lo
//     (x − hi, exact, truncated to TF32), and each product is taken as
//     lo·hi' + hi·lo' + hi·hi' (3×TF32, CUTLASS's OpMultiplyAddFastF32):
//     near f32 accuracy (tests/test_torch_tf32_split.py holds the scheme
//     against float64 on HyboNet-like rows).  The split is integer and
//     f32 arithmetic: `cvt` issues at a quarter of their rate;
//   - J, the flip of lane 0, is applied to the query rows (⟨q, Jk⟩ =
//     ⟨Jq, k⟩ term by term), so K and V tiles are copied unchanged: 64
//     keys a tile, double-buffered in shared memory by 4-byte `cp.async`
//     (a row of D = 33 floats is 132 bytes, so neither 16-byte copies nor
//     a TMA tensor map fit its stride), rows padded to DP + 4 floats so
//     the fragment reads hit 32 distinct banks; the next tile's copy
//     overlaps this tile's products;
//   - the mask is uint8 [B/group, Nq, Nk], shared by `group` consecutive
//     batch·head rows (the heads of one sequence).  A pre-pass packs it
//     into one bit a (query, key) pair, once a launch rather than at
//     every tile of every head, so a lane reads four words a tile for
//     its two rows, a tile ahead; a warp skips a tile in which none of
//     its rows has a valid key (that leaves every bit of the result as it
//     was: the tile would add exact zeros);
//   - σ comes from the accumulator fragments through `score_rcp` (the
//     bits of `score`, the division by τ taken through its correctly
//     rounded reciprocal, as are the epilogue's), the online softmax
//     keeps each row's max and sum per fragment row (sums combined
//     across the quad at the end) with no branch a weight, and P goes from the score fragment (columns 2t, 2t+1) straight into
//     the A operand of P·V (which wants k = t, t+4) by reading V's rows in
//     the order 2t, 2t+1 of each 8-key slice: a sum over keys does not
//     care for their order.
//
// dq and dk/dv (a simple, right design; tensor cores for them are later
// work):
//   - one thread owns one row: a query row in dq, a key row in dk/dv.
//     Its operand row and its f32 accumulators live in registers,
//     zero-padded from D to DP;
//   - a block of 64 threads streams the other side through shared memory
//     in tiles of 64 rows (k with lane 0 negated, v; or q, dsp, lse, di),
//     read back as float4 broadcasts: every thread of a warp reads the
//     same word, so there are no bank conflicts;
//   - σ is recomputed with `score` on an ascending-d FMA Gram, so it
//     agrees with the forward's tensor-core σ to rounding (about 1e-6
//     relative), not bit for bit.  The backward takes the forward's lse,
//     and `chip_smoke.py` (`check_flash`) holds dq, dk, dv and dτ of the
//     whole Function against autograd of the dense twin and float64;
//   - dq writes each query block's partial of Σ dσ·σ (the τ gradient),
//     summed in a fixed order by the caller: no atomics anywhere, every
//     result is deterministic.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

constexpr int ROWS = 64;    // dq, dk/dv: threads a block = rows it owns
constexpr int TILE = 64;    // dq, dk/dv: rows of the other side a tile
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

// ---- forward: tensor cores -------------------------------------------------

constexpr int FWD_WARPS = 4;
constexpr int FWD_THREADS = 32 * FWD_WARPS;
constexpr int FWD_ROWS = 16 * FWD_WARPS;  // query rows a block
constexpr int KT = 64;                    // keys a tile

constexpr unsigned TF32_MASK = 0xffffe000u;  // sign, exponent, 10 bits

// x = hi + lo + (a remainder below 2^-21·|x|), both TF32: hi is
// `cvt.rna.tf32.f32` of x (round to nearest, ties away from zero) and lo
// is x − hi (exact) with its 13 low bits dropped.  Integer and f32 ops
// only: a `cvt` runs at a quarter of their rate, and the split is taken
// for every key and value a warp reads.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & TF32_MASK;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & TF32_MASK;
}

// x / y from r, the correctly rounded 1/y: q0 = x·r, then q0 + (x −
// y·q0)·r.  Markstein's theorem makes that the correctly rounded quotient
// (for quotients in the normal range), the bits of `x / y`, without the
// division's branch to a slow path, which keeps a row of divisions from
// interleaving
__device__ __forceinline__ float div_rcp(float x, float y, float r) {
  const float q0 = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q0, y, x), r, q0);
}

// σ as `score` computes it, the division by τ through its reciprocal
__device__ __forceinline__ float score_rcp(float gram, float two_c,
                                           float beta, float tau,
                                           float rcp_tau) {
  return div_rcp(
      __fadd_rn(__fadd_rn(two_c, __fmul_rn(2.0f, gram)), beta), tau,
      rcp_tau);
}

// c += a·b for one m16n8k8 tile (A row-major, B column-major)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b at near f32 accuracy: lo·hi + hi·lo, then hi·hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4], float b0,
                                           float b1) {
  unsigned bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// a 4-byte copy from device memory to the shared address `dst`; with
// `bytes` 0 it reads nothing and writes 0
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// rows [j0, j0 + KT) of a [nk, d] matrix, columns < d, into a shared
// [KT][DP + 4] tile: a warp copies a row at a time, a lane a column; rows
// past nk are written as 0 (the products read them; only masked keys meet
// them, but a weight of 0 times a stale NaN is NaN).  The columns past d
// are never written.  `dst` is the tile's shared address, taken once: a
// generic-to-shared conversion at each copy costs a special-register read.
template <int DP>
__device__ __forceinline__ void stage_rows(unsigned dst, const float* src,
                                           int j0, int nk, int d) {
  constexpr int S = DP + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* base = src;
  dst += 4u * (warp * S + lane);
  src += (size_t)(j0 + warp) * d + lane;
  if (j0 + KT <= nk) {  // a whole tile: no row past nk
#pragma unroll
    for (int rr = 0; rr < KT / FWD_WARPS; ++rr) {
#pragma unroll
      for (int c0 = 0; c0 < DP; c0 += 32)
        if (c0 + lane < d) cp_async4(dst + 4u * c0, src + c0);
      dst += 4u * FWD_WARPS * S;
      src += (size_t)FWD_WARPS * d;
    }
    return;
  }
#pragma unroll
  for (int rr = 0; rr < KT / FWD_WARPS; ++rr) {
    const bool in = j0 + warp + FWD_WARPS * rr < nk;
#pragma unroll
    for (int c0 = 0; c0 < DP; c0 += 32)
      if (c0 + lane < d)
        cp_async4(dst + 4u * c0, in ? src + c0 : base, in ? 4 : 0);
    dst += 4u * FWD_WARPS * S;
    src += (size_t)FWD_WARPS * d;
  }
}

// one bit a byte: byte k of x non-zero -> bit k; the multiply moves bit
// 8k of the 0/1 bytes to bit 21 + k without carries
__device__ __forceinline__ unsigned nonzero_bits4(unsigned x) {
  const unsigned t = __vcmpne4(x, 0u) & 0x01010101u;
  return (t * 0x00204081u >> 21) & 0xfu;
}

// bits[i][w] for each query row i of the [rows, nk] masks: bit j is
// valid(i, 32w + j), the key in range and mask > 0.  When every row
// starts on 16 bytes (nk a multiple of 16, an aligned base), a thread
// reads a word's 32 bytes with two 16-byte loads; otherwise a warp reads
// 32 consecutive bytes and ballots them into one word.
__global__ void __launch_bounds__(256)
pack_mask_kernel(const unsigned char* __restrict__ mask, long rows, int nk,
                 int words, unsigned* __restrict__ bits) {
  const long total = rows * words;
  if (nk % 16 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0) {
    const long step = (long)gridDim.x * blockDim.x;
    for (long wi = (long)blockIdx.x * blockDim.x + threadIdx.x; wi < total;
         wi += step) {
      const long i = wi / words;
      const int j0 = 32 * (int)(wi - i * words);
      const uint4* src = reinterpret_cast<const uint4*>(mask + i * nk + j0);
      unsigned word = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (j0 + 16 * h >= nk) break;
        const uint4 x = src[h];
        word |= (nonzero_bits4(x.x) | nonzero_bits4(x.y) << 4 |
                 nonzero_bits4(x.z) << 8 | nonzero_bits4(x.w) << 12)
                << (16 * h);
      }
      bits[wi] = word;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const long step = ((long)gridDim.x * blockDim.x) >> 5;
  for (long wi = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       wi < total; wi += step) {
    const long i = wi / words;
    const int j = 32 * (int)(wi - i * words) + lane;
    const unsigned word = __ballot_sync(FULL, j < nk && mask[i * nk + j]);
    if (lane == 0) bits[wi] = word;
  }
}

// valid bits of key tile jt (keys 64jt..64jt + 63) for the lane's rows
// row0 and row0 + 8: vb[r][w] covers keys 64jt + 32w + 0..31.  From the
// packed mask, or, with no mask, the keys below nk.
__device__ __forceinline__ void tile_bits(unsigned (&vb)[2][2],
                                          const unsigned* mbits, int words,
                                          int row0, int nq, int nk, int jt) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int wi = 2 * jt + w, left = nk - 32 * wi;
      unsigned bits = left >= 32 ? ~0u : left <= 0 ? 0u : (1u << left) - 1u;
      if (mbits != nullptr)
        bits = row < nq && wi < words ? mbits[(size_t)row * words + wi] : 0u;
      vb[r][w] = row < nq ? bits : 0u;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(FWD_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const unsigned* __restrict__ mask_bits, int group,
                 const float* __restrict__ beta,
                 const float* __restrict__ tau, float c, int nq, int nk,
                 int d, float* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ nrm) {
  constexpr int S = DP + 4, KD = DP / 8;
  extern __shared__ __align__(16) float smem[];  // [2][K tile, V tile]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * FWD_ROWS + 16 * (threadIdx.x >> 5);
  const float two_c = __fdiv_rn(2.0f, c), be = beta[b], ta = tau[b];
  const float rta = __frcp_rn(ta);
  const float* kb = k + (size_t)b * nk * d;
  const float* vb = v + (size_t)b * nk * d;
  const int words = (nk + 31) / 32;
  const unsigned* mb = mask_bits == nullptr
                           ? nullptr
                           : mask_bits + (size_t)(b / group) * nq * words;

  // the warp's rows of Jq as A fragments (a0: (g, t), a1: (g + 8, t),
  // a2: (g, t + 4), a3: (g + 8, t + 4) of each 8-column slice), split
  unsigned qh[KD][4], ql[KD][4];
  const float* qb = q + (size_t)b * nq * d;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int row = r0 + g + 8 * (h & 1), col = 8 * kd + t + 4 * (h >> 1);
      float x = row < nq && col < d ? qb[(size_t)row * d + col] : 0.0f;
      if (col == 0) x = -x;
      split_tf32(x, qh[kd][h], ql[kd][h]);
    }
  }
  // o[n]: columns 8n + 2t, + 1 of rows g (o[n][0..1]) and g + 8 ([2..3])
  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};  // l: this lane's columns

  // the columns past d stay 0 in all four tiles; the copies never touch
  // them (rows past nk are zeroed where a tile is staged)
  for (int e = threadIdx.x; e < 4 * KT * (DP - d); e += FWD_THREADS) {
    const int r = e / (DP - d);
    smem[r * S + d + (e - r * (DP - d))] = 0.0f;
  }
  __syncthreads();
  const int tiles = (nk + KT - 1) / KT;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(smem);
  constexpr unsigned TILE_BYTES = 4u * KT * S;
  unsigned nbits[2][2];  // the valid bits of the tile to come
  if (tiles > 0) {
    stage_rows<DP>(sbase, kb, 0, nk, d);
    stage_rows<DP>(sbase + TILE_BYTES, vb, 0, nk, d);
    tile_bits(nbits, mb, words, r0 + g, nq, nk, 0);
  }
  cp_async_commit();
  for (int jt = 0; jt < tiles; ++jt) {
    unsigned vbits[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      vbits[r][0] = nbits[r][0];
      vbits[r][1] = nbits[r][1];
    }
    if (jt + 1 < tiles) {  // the next tile's copy overlaps this one
      const unsigned nxt = sbase + ((jt + 1) & 1) * 2 * TILE_BYTES;
      stage_rows<DP>(nxt, kb, (jt + 1) * KT, nk, d);
      stage_rows<DP>(nxt + TILE_BYTES, vb, (jt + 1) * KT, nk, d);
      tile_bits(nbits, mb, words, r0 + g, nq, nk, jt + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = smem + (jt & 1) * 2 * KT * S;
    const float* vs = ks + KT * S;
    if (__any_sync(FULL, (vbits[0][0] | vbits[0][1] | vbits[1][0] |
                          vbits[1][1]) != 0)) {
      // the lane's keys 8n + 2t + e sit at bit 8(n mod 4) + e of its
      // words shifted by 2t
      unsigned sb[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sb[r][0] = vbits[r][0] >> (2 * t);
        sb[r][1] = vbits[r][1] >> (2 * t);
      }
      // Gram of the warp's 16 rows and the 64 keys: s[n] holds keys
      // 8n + 2t, + 1 of rows g ([0..1]) and g + 8 ([2..3])
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* kr = ks + (8 * n + g) * S + 8 * kd + t;
          mma_3xtf32(s[n], qh[kd], ql[kd], kr[0], kr[4]);
        }
      }
      float tmax[2] = {NEG, NEG};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const bool ok = (sb[h >> 1][n >> 2] >> (8 * (n & 3) + (h & 1))) & 1u;
          const float sig = score_rcp(s[n][h], two_c, be, ta, rta);
          s[n][h] = ok ? sig : NEG;
          tmax[h >> 1] = fmaxf(tmax[h >> 1], s[n][h]);
        }
      }
      // an invalid key's σ is NEG, whose weight underflows to 0 against
      // any row max but NEG itself: a row with no valid key yet subtracts
      // +inf instead, so every weight of the tile is exp(−inf) = 0 with no
      // branch (a branch a weight would keep the exps from interleaving)
      float alpha[2], shift[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(FULL, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(FULL, tmax[r], 2));
        const float m_new = fmaxf(m[r], tmax[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        shift[r] = m_new == NEG ? INFINITY : m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          s[n][h] = expf(s[n][h] - shift[h >> 1]);
          l[h >> 1] += s[n][h];
        }
      }
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // P·V over each 8-key slice, its keys taken in the order 2t, 2t + 1
      // (k = t, t + 4 of the A fragment), which is where s holds them
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        unsigned ph[4], pl[4];
        split_tf32(s[n][0], ph[0], pl[0]);
        split_tf32(s[n][2], ph[1], pl[1]);
        split_tf32(s[n][1], ph[2], pl[2]);
        split_tf32(s[n][3], ph[3], pl[3]);
        const float* vr = vs + (8 * n + 2 * t) * S + g;
#pragma unroll
        for (int dn = 0; dn < KD; ++dn)
          mma_3xtf32(o[dn], ph, pl, vr[8 * dn], vr[S + 8 * dn]);
      }
    }
    __syncthreads();  // the tile is consumed before its buffer refills
  }
  cp_async_wait<0>();

  // epilogue (kernels/attention.py:116-135): s = acc/l, rescaled onto the
  // hyperboloid with the kernel's clamps; rows with no valid key give 0
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), MIN_NORM_F32);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const float l_den = fmaxf(l[r], MIN_NORM_F32);
    const float rcp_l = __frcp_rn(l_den);
    float sp = 0.0f;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = div_rcp(o[n][2 * r + e], l_den, rcp_l);
        o[n][2 * r + e] = a;
        sp = fmaf(n == 0 && t == 0 && e == 0 ? -a : a, a, sp);
      }
    }
    sp += __shfl_xor_sync(FULL, sp, 1);
    sp += __shfl_xor_sync(FULL, sp, 2);
    const float nv = sqrtf(fmaxf(fmaxf(-sp, EPS_F32), 0.0f));
    const float scale = sc * nv, rcp_s = __frcp_rn(scale);
    const int row = r0 + g + 8 * r;
    if (row >= nq) continue;
    float* orow = out + ((size_t)b * nq + row) * d;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < d) orow[col] = div_rcp(o[n][2 * r + e], scale, rcp_s);
      }
    }
    if (t == 0) {
      lse[(size_t)b * nq + row] =
          l[r] > 0.0f ? m[r] + logf(fmaxf(l[r], 1e-38f)) : LSE_EMPTY;
      nrm[(size_t)b * nq + row] = nv;
    }
  }
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
               const unsigned* mask_bits, int group, const float* beta,
               const float* tau, float c, int b, int nq, int nk, int d,
               float* out, float* lse, float* nrm, cudaStream_t s) {
  const int smem = 2 * 2 * KT * (DP + 4) * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + FWD_ROWS - 1) / FWD_ROWS, b);
  flash_fwd_kernel<DP><<<grid, FWD_THREADS, smem, s>>>(
      q, k, v, mask_bits, group, beta, tau, c, nq, nk, d, out, lse, nrm);
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
// and contiguous; 1 ≤ d ≤ 72.  With a mask, mask_bits is scratch of
// (b/group)·nq·ceil(nk/32) words, which first receives the mask as bits.
extern "C" int hs_flash_fwd(const float* q, const float* k, const float* v,
                            const unsigned char* mask, int group,
                            unsigned* mask_bits, const float* beta,
                            const float* tau, float c, int b, int nq, int nk,
                            int d, float* out, float* lse, float* nrm,
                            void* stream) {
  if (d < 1 || d > MAX_DP) return (int)cudaErrorInvalidValue;
  if (b > 0 && nq > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int dp = (d + 7) / 8 * 8;
    const unsigned* bits = nullptr;
    if (mask != nullptr && nk > 0) {
      const long words = (long)(b / group) * nq * ((nk + 31) / 32);
      const long blocks = (words + 7) / 8;  // a warp a word at most
      pack_mask_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
          mask, (long)(b / group) * nq, nk, (nk + 31) / 32, mask_bits);
      bits = mask_bits;
    }
#define HS_FWD(DPV) launch_fwd<DPV>(q, k, v, bits, group, beta, tau, c, b, \
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
