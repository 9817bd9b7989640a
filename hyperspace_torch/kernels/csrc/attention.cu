// Hyperbolic flash attention (HyboNet, Chen et al. 2022) for sm_90a:
// forward, dq and dk/dv, f32 in and out, all three on the tensor cores
// (3×TF32).
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
//   - σ comes from the accumulator fragments through `score_rcp` (each
//     operation of kernels/attention.py:93 rounded on its own, the
//     division by τ taken through its correctly rounded reciprocal, as
//     are the epilogue's), the online softmax
//     keeps each row's max and sum per fragment row (sums combined
//     across the quad at the end) with no branch a weight, and P goes from the score fragment (columns 2t, 2t+1) straight into
//     the A operand of P·V (which wants k = t, t+4) by reading V's rows in
//     the order 2t, 2t+1 of each 8-key slice: a sum over keys does not
//     care for their order.
//
// dq and dk/dv are the forward's layout, and the second on its side:
//   - a block of four warps owns 64 rows of its side, 16 a warp (query
//     rows in dq, key rows in dk/dv) and streams the other side in 64-row
//     tiles through the forward's double-buffered `cp.async` staging: K
//     and V in dq; Q, dsp and their rows' lse and di in dk/dv.  The first
//     tile's copy is issued before the block loads its own rows;
//   - the warp's own operands sit in registers as split A fragments (Jq
//     and dsp in dq; Jk and v in dk/dv) and each 8-row slice of a tile
//     runs its products at once, so a lane holds one 16 × 8 score and
//     one product fragment at a time beside its accumulators.  dq: S =
//     (JQ)·Kᵀ (the forward's products in the forward's order, so σ has
//     the forward's bits), P = exp(σ − lse), dP = dsp·Vᵀ, dσ = P∘(dP −
//     di), dQ += dσ·K.  dk/dv: Sᵀ = (JK)·Qᵀ, Pᵀ = exp(σ − lse_i) with lse
//     and di read per query column, dV += Pᵀ·dsp, dPᵀ = V·dspᵀ, dσᵀ =
//     Pᵀ∘(dPᵀ − di), dK += dσᵀ·Q.  Every product is 3×TF32; P and dσ are
//     split into hi and lo before they feed the next product, from the C
//     fragment straight into the A operand as P is in the forward;
//   - what bounds them on the card is latency, not the tensor cores: at
//     168 registers dq keeps three blocks on an SM (12 warps), dk/dv at
//     about 220 two, and `mma.sync` TF32 takes about 30 cycles from issue
//     to result.  So no weight takes a branch (an invalid pair's exponent
//     is NEG − lse, whose exp is 0), the split hands the tensor core its
//     operands unmasked (`split_tf32`: it reads neither part's low 13
//     bits), and dk/dv, which has registers to spare, runs the three
//     terms of its Sᵀ and dPᵀ on chains of their own (`mma_3chain`); dq
//     does not, as the extra registers would cost it a block an SM;
//   - J and 2/τ are applied once, at the store (Σ dσ·Jk = J·Σ dσ·k), so
//     K and Q tiles are copied unchanged;
//   - dP − di cancels (Σ_j P_ij·dP_ij = di_i), so it is taken as ⟨dsp,
//     v − m⟩ − (di − ⟨dsp, m⟩) with m the batch·head's first value row:
//     the V tile (dq) or the warp's V rows (dk/dv) less m, and di less
//     ⟨dsp, m⟩ in f32.  The product's 3×TF32 error then scales with the
//     values' spread about m, not with their offset, and identical value
//     rows cancel exactly, as in f32;
//   - the mask is read as packed bits: dq as the forward does, dk/dv from
//     a transposed copy (one bit a pair, key-major: `pack_mask_t_kernel`)
//     so a lane reads its two key rows' words as the forward reads its
//     query rows'; a warp skips the 32 rows of a tile in which none of
//     its rows has a valid pair (they would add exact zeros);
//   - the wrapper cuts the other side into parts (`splits`) from the
//     shape and the card: at least enough that a launch puts two blocks
//     on every SM, then the count that needs the fewest rounds of resident
//     blocks (`hs_flash_bwd_blocks_per_sm`) for its tiles.  Each part's
//     block writes its partial, already scaled, and `sum_splits_kernel`
//     adds the parts in order;
//   - dq writes each block's partial of Σ dσ·σ (the τ gradient), summed
//     across the quad and the warps by a fixed tree and across the blocks
//     and parts by the caller: no atomics anywhere, every result is
//     deterministic.  `chip_smoke.py` (`check_flash`) holds dq, dk, dv and
//     dτ of the whole Function against autograd of the dense twin and
//     float64.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

constexpr float NEG = -1e30f;
constexpr float LSE_EMPTY = 1e30f;
constexpr float EPS_F32 = 1e-7f;
constexpr float MIN_NORM_F32 = 1e-12f;

// ---- forward: tensor cores -------------------------------------------------

constexpr int FWD_WARPS = 4;
constexpr int FWD_THREADS = 32 * FWD_WARPS;
constexpr int FWD_ROWS = 16 * FWD_WARPS;  // query rows a block
constexpr int KT = 64;                    // keys a tile

static_assert(FWD_THREADS == 2 * KT, "dk/dv stages lse and di a thread each");

constexpr unsigned TF32_MASK = 0xffffe000u;  // sign, exponent, 10 bits


// x = hi + lo + (a remainder below 2^-21·|x|), both TF32, as the tensor
// core reads them: hi is `cvt.rna.tf32.f32` of x (round to nearest, ties
// away from zero) and lo is x − hi (exact) with its 13 low bits dropped.
// The tensor core reads neither operand's 13 low bits, so hi goes to it
// unmasked (the rounding carry already in) and lo untruncated: the same
// products, one operation fewer.  Integer and f32 ops only: a `cvt` runs
// at a quarter of their rate, and the split is taken for every key and
// value a warp reads.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi & TF32_MASK)));
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

// σ = (2/c + 2·gram + β)/τ, each operation rounded on its own (never
// contracted), in the order of hyperspace_tpu/kernels/attention.py:93; the
// division by τ through its reciprocal
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

// the columns past d of the four row tiles at the start of shared memory
// are zeroed once (the copies never touch them)
template <int DP>
__device__ __forceinline__ void zero_pad_columns(float* smem, int d) {
  constexpr int S = DP + 4;
  for (int e = threadIdx.x; e < 4 * KT * (DP - d); e += FWD_THREADS) {
    const int r = e / (DP - d);
    smem[r * S + d + (e - r * (DP - d))] = 0.0f;
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

  // rows past nk are zeroed where a tile is staged
  zero_pad_columns<DP>(smem, d);
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

// ---- dq and dk/dv: tensor cores --------------------------------------------

// the mask transposed into bits, key-major: bits_t[gi][j][w] bit i is
// valid(32w + i, j) for sequence gi, the query in range and mask > 0.  A
// block takes 32 keys and 8 words of queries, a warp a 32 × 32 block of
// pairs: each lane reads its query row's 32 bytes (two 16-byte loads when
// rows start on 16 bytes) and 32 ballots turn them into the 32 keys'
// words, which go out through shared memory as 32-byte key rows.
constexpr int PACK_WARPS = 8;

__global__ void __launch_bounds__(32 * PACK_WARPS)
pack_mask_t_kernel(const unsigned char* __restrict__ mask, int groups,
                   int nq, int nk, unsigned* __restrict__ bits_t) {
  __shared__ unsigned out[32][PACK_WARPS + 1];  // [key][query word]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qwords = (nq + 31) / 32, kwords = (nk + 31) / 32;
  const int qgroups = (qwords + PACK_WARPS - 1) / PACK_WARPS;
  const long tasks = (long)groups * kwords * qgroups;
  const bool wide =
      nk % 16 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  for (long ti = blockIdx.x; ti < tasks; ti += gridDim.x) {
    const int qg = (int)(ti % qgroups);
    const long rest = ti / qgroups;
    const int kw = (int)(rest % kwords), gi = (int)(rest / kwords);
    const int i = 32 * (PACK_WARPS * qg + warp) + lane, j0 = 32 * kw;
    unsigned x[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};  // byte k: key j0 + k
    if (i < nq) {
      const unsigned char* src = mask + ((size_t)gi * nq + i) * nk + j0;
      if (wide) {
        const uint4 a = reinterpret_cast<const uint4*>(src)[0];
        x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
        if (j0 + 16 < nk) {
          const uint4 c = reinterpret_cast<const uint4*>(src)[1];
          x[4] = c.x, x[5] = c.y, x[6] = c.z, x[7] = c.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 32; ++kk)
          if (j0 + kk < nk && src[kk] != 0)
            x[kk >> 2] |= 1u << (8 * (kk & 3));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 32; ++kk) {
      const unsigned w =
          __ballot_sync(FULL, (x[kk >> 2] >> (8 * (kk & 3))) & 0xffu);
      if (lane == kk) out[kk][warp] = w;
    }
    __syncthreads();
    const int jj = threadIdx.x / PACK_WARPS, qw = threadIdx.x % PACK_WARPS;
    const int j = j0 + jj, w = PACK_WARPS * qg + qw;
    if (j < nk && w < qwords)
      bits_t[((size_t)gi * nk + j) * qwords + w] = out[jj][qw];
    __syncthreads();
  }
}

// out[i] = Σ_s part[s·n + i], the parts added in order s = 0, 1, ...
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, int splits, long n,
                  float* __restrict__ out) {
  const long step = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    float s = part[i];
    for (int sp = 1; sp < splits; ++sp) s += part[sp * n + i];
    out[i] = s;
  }
}

// the warp's 16 rows [r0, r0 + 16) of a [n, d] matrix as split A
// fragments (a0: (g, t), a1: (g + 8, t), a2: (g, t + 4), a3: (g + 8,
// t + 4) of each 8-column slice), zero past n and past d; `neg0` negates
// lane 0 (the flip J), a `centre` row (or null) is subtracted, and with
// a `with` row the lane's share of each of its rows' dot with it (rows
// g and g + 8, ascending columns) is added to dot[0], dot[1]
template <int KD>
__device__ __forceinline__ void load_a(unsigned (&ah)[KD][4],
                                       unsigned (&al)[KD][4],
                                       const float* src, int r0, int n,
                                       int d, bool neg0,
                                       const float* centre = nullptr,
                                       const float* with = nullptr,
                                       float* dot = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int row = r0 + g + 8 * (h & 1), col = 8 * kd + t + 4 * (h >> 1);
      float x = row < n && col < d ? src[(size_t)row * d + col] : 0.0f;
      if (with != nullptr && row < n && col < d)
        dot[h & 1] = fmaf(x, with[col], dot[h & 1]);
      if (centre != nullptr && row < n && col < d)
        x = __fsub_rn(x, centre[col]);
      if (neg0 && col == 0) x = -x;
      split_tf32(x, ah[kd][h], al[kd][h]);
    }
  }
}

// a score-shaped C fragment (columns 2t, 2t + 1 of rows g, g + 8) split
// as the A operand of a product over those columns, taken in the order
// 2t, 2t + 1 (k = t, t + 4)
__device__ __forceinline__ void c_to_a(const float (&c)[4],
                                       unsigned (&ah)[4],
                                       unsigned (&al)[4]) {
  split_tf32(c[0], ah[0], al[0]);
  split_tf32(c[2], ah[1], al[1]);
  split_tf32(c[1], ah[2], al[2]);
  split_tf32(c[3], ah[3], al[3]);
}

// c = Σ_kd a[kd]·b[kd] at near f32 accuracy for one 16 × 8 tile, A in
// split registers and B the row `br` of a staged tile (k-step kd: columns
// 8kd + t, 8kd + t + 4): the three terms of each step on chains of their
// own (lo·hi, hi·lo, hi·hi), added at the end in that order, so a chain is
// KD dependent MMAs rather than 3·KD.  c starts at 0.
template <int KD>
__device__ __forceinline__ void mma_3chain(float (&c)[4],
                                           const unsigned (&ah)[KD][4],
                                           const unsigned (&al)[KD][4],
                                           const float* br) {
  float c1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    unsigned h0, l0, h1, l1;
    split_tf32(br[8 * kd], h0, l0);
    split_tf32(br[8 * kd + 4], h1, l1);
    mma_tf32(c, al[kd], h0, h1);
    mma_tf32(c1, ah[kd], l0, l1);
    mma_tf32(c2, ah[kd], h0, h1);
  }
#pragma unroll
  for (int h = 0; h < 4; ++h)
    c[h] = __fadd_rn(__fadd_rn(c[h], c1[h]), c2[h]);
}

// di[i] −= ⟨dsp_i, m⟩ for the 64 rows i of a staged dsp tile, two
// threads a row, each over one parity of the columns (those past d are 0
// in both), added in a fixed order.  dP − di is taken as ⟨dsp, v − m⟩ −
// (di − ⟨dsp, m⟩) with m the first value row of the batch·head: the
// 3×TF32 error of the product scales with the values' spread about m,
// not with their offset, and identical value rows cancel exactly, as in
// f32.
template <int DP>
__device__ __forceinline__ void centre_di(const float* rows, float* di,
                                          const float* ms) {
  const int i = threadIdx.x >> 1, h = threadIdx.x & 1;
  const float* row = rows + i * (DP + 4);
  float pd = 0.0f;
#pragma unroll
  for (int col = h; col < DP; col += 2) pd = fmaf(row[col], ms[col], pd);
  pd += __shfl_xor_sync(FULL, pd, 1);
  if (h == 0) di[i] = __fsub_rn(di[i], pd);
}

// the per-row accumulators of a warp, scaled by `s` (lane 0 by −s when
// `flip`), into rows [r0, r0 + 16) of a [n, d] matrix
template <int KD>
__device__ __forceinline__ void store_c(const float (&acc)[KD][4], float* dst,
                                        int r0, int n, int d, float s,
                                        bool flip) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
    float* o = dst + (size_t)row * d;
#pragma unroll
    for (int dn = 0; dn < KD; ++dn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * dn + 2 * t + e;
        if (col < d)
          o[col] = (flip && col == 0 ? -s : s) * acc[dn][2 * r + e];
      }
    }
  }
}

// dq: a block owns 64 query rows and streams key tiles [jt0, jt1), its
// part (blockIdx.z of gridDim.z, the parts differing by a tile at most)
// of the keys.  Writes (2/τ)·J·Σ_j dσ_ij·k_j to dq's rows of part z
// ([splits][b][nq][d]) and the block's Σ dσ·σ to part[b][z][blockIdx.x].
template <int DP>
__global__ void __launch_bounds__(FWD_THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dsp,
                const float* __restrict__ lse, const float* __restrict__ di,
                const unsigned* __restrict__ mask_bits, int group,
                const float* __restrict__ beta,
                const float* __restrict__ tau, float c, int nq, int nk,
                int d, float* __restrict__ dq,
                float* __restrict__ part) {
  constexpr int S = DP + 4, KD = DP / 8;
  extern __shared__ __align__(16) float smem[];  // [2][K tile, V tile]
  __shared__ float red[FWD_WARPS], ms[DP];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y, z = blockIdx.z;
  const int r0 = blockIdx.x * FWD_ROWS + 16 * warp;
  const float two_c = __fdiv_rn(2.0f, c), be = beta[b], ta = tau[b];
  const float rta = __frcp_rn(ta);
  const float* kb = k + (size_t)b * nk * d;
  const float* vb = v + (size_t)b * nk * d;  // row 0: the centre m
  const int words = (nk + 31) / 32;
  const unsigned* mb = mask_bits == nullptr
                           ? nullptr
                           : mask_bits + (size_t)(b / group) * nq * words;

  // the first tile's copy overlaps the set-up
  const int tiles = (nk + KT - 1) / KT;
  const int parts = gridDim.z;
  const int jt0 = z * tiles / parts, jt1 = (z + 1) * tiles / parts;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(smem);
  constexpr unsigned TILE_BYTES = 4u * KT * S;
  unsigned nbits[2][2];
  if (jt0 < jt1) {
    stage_rows<DP>(sbase, kb, jt0 * KT, nk, d);
    stage_rows<DP>(sbase + TILE_BYTES, vb, jt0 * KT, nk, d);
    tile_bits(nbits, mb, words, r0 + g, nq, nk, jt0);
  }
  cp_async_commit();
  zero_pad_columns<DP>(smem, d);
  if (threadIdx.x < DP)
    ms[threadIdx.x] = (int)threadIdx.x < d && nk > 0 ? vb[threadIdx.x] : 0.0f;

  // the warp's rows of Jq and of dsp as split A fragments, and with dsp
  // each row's ⟨dsp, m⟩ (lane shares summed over the quad in a fixed
  // order) for the centred di − ⟨dsp, m⟩
  unsigned qh[KD][4], ql[KD][4], gh[KD][4], gl[KD][4];
  float lr[2], dr[2] = {0.0f, 0.0f};  // lse and centred di, rows g, g + 8
  load_a<KD>(qh, ql, q + (size_t)b * nq * d, r0, nq, d, true);
  load_a<KD>(gh, gl, dsp + (size_t)b * nq * d, r0, nq, d, false, nullptr,
             nk > 0 ? vb : nullptr, dr);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    dr[r] += __shfl_xor_sync(FULL, dr[r], 1);
    dr[r] += __shfl_xor_sync(FULL, dr[r], 2);
    lr[r] = row < nq ? lse[(size_t)b * nq + row] : LSE_EMPTY;
    dr[r] = row < nq ? __fsub_rn(di[(size_t)b * nq + row], dr[r]) : 0.0f;
  }
  // acc[n]: columns 8n + 2t, + 1 of rows g ([0..1]) and g + 8 ([2..3])
  float acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float ts = 0.0f;  // the lane's Σ dσ·σ

  for (int jt = jt0; jt < jt1; ++jt) {
    const int buf = (jt - jt0) & 1;
    unsigned vbits[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      vbits[r][0] = nbits[r][0];
      vbits[r][1] = nbits[r][1];
    }
    if (jt + 1 < jt1) {  // the next tile's copy overlaps this one
      const unsigned nxt = sbase + (buf ^ 1) * 2 * TILE_BYTES;
      stage_rows<DP>(nxt, kb, (jt + 1) * KT, nk, d);
      stage_rows<DP>(nxt + TILE_BYTES, vb, (jt + 1) * KT, nk, d);
      tile_bits(nbits, mb, words, r0 + g, nq, nk, jt + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = smem + buf * 2 * KT * S;
    float* vs = smem + buf * 2 * KT * S + KT * S;
    for (int r = warp; r < KT; r += FWD_WARPS)  // v − m, in place
      for (int col = lane; col < d; col += 32) vs[r * S + col] -= ms[col];
    __syncthreads();
    unsigned sb[2][2];  // key 8n + 2t + e at bit 8(n mod 4) + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sb[r][0] = vbits[r][0] >> (2 * t);
      sb[r][1] = vbits[r][1] >> (2 * t);
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) {  // keys 32w .. 32w + 31 of the tile
      // no valid pair in the warp's rows: dσ = 0 on all of them
      if (!__any_sync(FULL, (vbits[0][w] | vbits[1][w]) != 0)) continue;
#pragma unroll
      for (int n = 4 * w; n < 4 * w + 4; ++n) {  // keys 8n .. 8n + 7
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const float* kr = ks + (8 * n + g) * S + 8 * kd + t;
          mma_3xtf32(s, qh[kd], ql[kd], kr[0], kr[4]);
        }
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const float* vr = vs + (8 * n + g) * S + 8 * kd + t;
          mma_3xtf32(dp, gh[kd], gl[kd], vr[0], vr[4]);
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const bool ok =
              (sb[h >> 1][n >> 2] >> (8 * (n & 3) + (h & 1))) & 1u;
          const float sig = score_rcp(s[h], two_c, be, ta, rta);
          // an invalid pair's exponent is NEG − lse: its weight is 0 with
          // no branch around the exp
          const float p = expf((ok ? sig : NEG) - lr[h >> 1]);
          s[h] = p * (dp[h] - dr[h >> 1]);  // dσ
          ts = fmaf(s[h], sig, ts);
        }
        unsigned ah[4], al[4];
        c_to_a(s, ah, al);
        const float* kr = ks + (8 * n + 2 * t) * S + g;
#pragma unroll
        for (int dn = 0; dn < KD; ++dn)
          mma_3xtf32(acc[dn], ah, al, kr[8 * dn], kr[S + 8 * dn]);
      }
    }
    __syncthreads();  // the tile is consumed before its buffer refills
  }
  cp_async_wait<0>();

  // the block's partial of Σ dσ·σ: the warp's lanes by a butterfly, the
  // warps in order
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) ts += __shfl_xor_sync(FULL, ts, o);
  if (lane == 0) red[warp] = ts;
  store_c<KD>(acc, dq + ((size_t)z * gridDim.y + b) * nq * d, r0, nq, d,
              __fdiv_rn(2.0f, ta), true);
  __syncthreads();
  if (threadIdx.x == 0)
    part[((size_t)b * gridDim.z + z) * gridDim.x + blockIdx.x] =
        (red[0] + red[1]) + (red[2] + red[3]);
}

// dk/dv: a block owns 64 key rows and streams query tiles [it0, it1), its
// part (blockIdx.z of gridDim.z) of the queries.  Writes (2/τ)·J·Σ_i
// dσ_ij·q_i to dk and Σ_i p_ij·dsp_i to dv, rows of part z
// ([splits][b][nk][d]).
template <int DP>
__global__ void __launch_bounds__(FWD_THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dsp,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 const unsigned* __restrict__ mask_bits_t, int group,
                 const float* __restrict__ beta,
                 const float* __restrict__ tau, float c, int nq, int nk,
                 int d, float* __restrict__ dk,
                 float* __restrict__ dv) {
  constexpr int S = DP + 4, KD = DP / 8;
  // [2][Q tile, dsp tile], then [2][lse, di] of the tiles' rows
  extern __shared__ __align__(16) float smem[];
  __shared__ float ms[DP];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, z = blockIdx.z;
  const int r0 = blockIdx.x * FWD_ROWS + 16 * (threadIdx.x >> 5);
  const float two_c = __fdiv_rn(2.0f, c), be = beta[b], ta = tau[b];
  const float rta = __frcp_rn(ta);
  const float* qb = q + (size_t)b * nq * d;
  const float* gb = dsp + (size_t)b * nq * d;
  const float* lb = lse + (size_t)b * nq;
  const float* db = di + (size_t)b * nq;
  const int words = (nq + 31) / 32;
  const unsigned* mb = mask_bits_t == nullptr
                           ? nullptr
                           : mask_bits_t + (size_t)(b / group) * nk * words;

  // the first tile's copy overlaps the set-up
  const int tiles = (nq + KT - 1) / KT;
  const int parts = gridDim.z;
  const int it0 = z * tiles / parts, it1 = (z + 1) * tiles / parts;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(smem);
  constexpr unsigned TILE_BYTES = 4u * KT * S;
  const unsigned vbase = sbase + 4 * TILE_BYTES;  // lse, di: 2·KT a buffer
  const float* vecs = smem + 4 * KT * S;
  // lse (threads 0..63) or di (64..127) of a tile's rows; rows past nq
  // read nothing and hold 0 (their weights are selected away)
  const int e = threadIdx.x & (KT - 1);
  const float* vsrc = threadIdx.x < KT ? lb : db;
  unsigned nbits[2][2];
  if (it0 < it1) {
    stage_rows<DP>(sbase, qb, it0 * KT, nq, d);
    stage_rows<DP>(sbase + TILE_BYTES, gb, it0 * KT, nq, d);
    const bool in = it0 * KT + e < nq;
    cp_async4(vbase + 4u * threadIdx.x, in ? vsrc + it0 * KT + e : vsrc,
              in ? 4 : 0);
    tile_bits(nbits, mb, words, r0 + g, nk, nq, it0);
  }
  cp_async_commit();
  zero_pad_columns<DP>(smem, d);
  const float* vb = v + (size_t)b * nk * d;  // row 0: the centre m
  if (threadIdx.x < DP)
    ms[threadIdx.x] = (int)threadIdx.x < d ? vb[threadIdx.x] : 0.0f;

  unsigned kh[KD][4], kl[KD][4], vh[KD][4], vl[KD][4];
  load_a<KD>(kh, kl, k + (size_t)b * nk * d, r0, nk, d, true);
  load_a<KD>(vh, vl, vb, r0, nk, d, false, vb);
  float dka[KD][4], dva[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) {
#pragma unroll
    for (int h = 0; h < 4; ++h) dka[n][h] = dva[n][h] = 0.0f;
  }

  for (int it = it0; it < it1; ++it) {
    const int buf = (it - it0) & 1;
    unsigned vbits[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      vbits[r][0] = nbits[r][0];
      vbits[r][1] = nbits[r][1];
    }
    if (it + 1 < it1) {  // the next tile's copy overlaps this one
      const int i1 = (it + 1) * KT;
      const unsigned nxt = sbase + (buf ^ 1) * 2 * TILE_BYTES;
      stage_rows<DP>(nxt, qb, i1, nq, d);
      stage_rows<DP>(nxt + TILE_BYTES, gb, i1, nq, d);
      const bool in = i1 + e < nq;
      cp_async4(vbase + 4u * ((buf ^ 1) * 2 * KT + threadIdx.x),
                in ? vsrc + i1 + e : vsrc, in ? 4 : 0);
      tile_bits(nbits, mb, words, r0 + g, nk, nq, it + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qs = smem + buf * 2 * KT * S;
    const float* gs = qs + KT * S;
    const float* ls = vecs + buf * 2 * KT;
    float* ds = smem + 4 * KT * S + buf * 2 * KT + KT;
    centre_di<DP>(gs, ds, ms);  // rows past nq: dsp 0, di 0
    __syncthreads();
    unsigned sb[2][2];  // query 8n + 2t + e at bit 8(n mod 4) + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sb[r][0] = vbits[r][0] >> (2 * t);
      sb[r][1] = vbits[r][1] >> (2 * t);
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) {  // queries 32w .. 32w + 31 of the tile
      // no valid pair in the warp's rows: p = dσ = 0 on all of them
      if (!__any_sync(FULL, (vbits[0][w] | vbits[1][w]) != 0)) continue;
#pragma unroll
      for (int n = 4 * w; n < 4 * w + 4; ++n) {  // queries 8n .. 8n + 7
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_3chain<KD>(s, kh, kl, qs + (8 * n + g) * S + t);
        mma_3chain<KD>(dp, vh, vl, gs + (8 * n + g) * S + t);
        const float2 lq =
            *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
        const float2 dq2 =
            *reinterpret_cast<const float2*>(ds + 8 * n + 2 * t);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const bool ok =
              (sb[h >> 1][n >> 2] >> (8 * (n & 3) + (h & 1))) & 1u;
          const float sig = score_rcp(s[h], two_c, be, ta, rta);
          const float li = (h & 1) ? lq.y : lq.x;  // no branch: as dq
          const float p = expf((ok ? sig : NEG) - li);
          s[h] = p;
          dp[h] = p * (dp[h] - ((h & 1) ? dq2.y : dq2.x));  // dσ
        }
        unsigned ph[4], pl[4], sh[4], sl[4];
        c_to_a(s, ph, pl);
        c_to_a(dp, sh, sl);
        const float* gr = gs + (8 * n + 2 * t) * S + g;
        const float* qr = qs + (8 * n + 2 * t) * S + g;
#pragma unroll
        for (int dn = 0; dn < KD; ++dn) {
          mma_3xtf32(dva[dn], ph, pl, gr[8 * dn], gr[S + 8 * dn]);
          mma_3xtf32(dka[dn], sh, sl, qr[8 * dn], qr[S + 8 * dn]);
        }
      }
    }
    __syncthreads();  // the tile is consumed before its buffer refills
  }
  cp_async_wait<0>();
  const size_t at = ((size_t)z * gridDim.y + b) * nk * d;
  store_c<KD>(dka, dk + at, r0, nk, d, __fdiv_rn(2.0f, ta), true);
  store_c<KD>(dva, dv + at, r0, nk, d, 1.0f, false);
}

// shared memory of the forward and dq ([2][K tile, V tile]) and of dk/dv
// ([2][Q tile, dsp tile], then [2][lse, di])
template <int DP>
constexpr int tiles_smem() {
  return 2 * 2 * KT * (DP + 4) * (int)sizeof(float);
}

template <int DP>
constexpr int dkv_smem() {
  return tiles_smem<DP>() + 2 * 2 * KT * (int)sizeof(float);
}

template <int DP>
int launch_fwd(const float* q, const float* k, const float* v,
               const unsigned* mask_bits, int group, const float* beta,
               const float* tau, float c, int b, int nq, int nk, int d,
               float* out, float* lse, float* nrm, cudaStream_t s) {
  const int smem = tiles_smem<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + FWD_ROWS - 1) / FWD_ROWS, b);
  flash_fwd_kernel<DP><<<grid, FWD_THREADS, smem, s>>>(
      q, k, v, mask_bits, group, beta, tau, c, nq, nk, d, out, lse, nrm);
  return 0;
}

// out = Σ of `splits` parts of n floats each, in order
void sum_splits(const float* part, int splits, long n, float* out,
                cudaStream_t s) {
  const long blocks = (n + 255) / 256;
  sum_splits_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      part, splits, n, out);
}


// blocks of the dq (which 0) or dk/dv (1) kernel resident on one SM
template <int DP>
cudaError_t occupancy(int which, int* n) {
  const int smem = which == 0 ? tiles_smem<DP>() : dkv_smem<DP>();
  const void* fn = which == 0 ? (const void*)flash_dq_kernel<DP>
                              : (const void*)flash_dkv_kernel<DP>;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, fn, FWD_THREADS,
                                                       smem);
}

template <int DP>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dsp, const float* lse, const float* di,
              const unsigned* mask_bits, int group, const float* beta,
              const float* tau, float c, int b, int nq, int nk, int d,
              int splits, float* dq, float* dq_part, float* part,
              cudaStream_t s) {
  const int smem = tiles_smem<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + FWD_ROWS - 1) / FWD_ROWS, b, splits);
  flash_dq_kernel<DP><<<grid, FWD_THREADS, smem, s>>>(
      q, k, v, dsp, lse, di, mask_bits, group, beta, tau, c, nq, nk, d,
      splits > 1 ? dq_part : dq, part);
  if (splits > 1) sum_splits(dq_part, splits, (long)b * nq * d, dq, s);
  return 0;
}

template <int DP>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dsp, const float* lse, const float* di,
               const unsigned* mask_bits_t, int group, const float* beta,
               const float* tau, float c, int b, int nq, int nk, int d,
               int splits, float* dk, float* dv, float* dkv_part,
               cudaStream_t s) {
  const int smem = dkv_smem<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long n = (long)b * nk * d;
  const dim3 grid((nk + FWD_ROWS - 1) / FWD_ROWS, b, splits);
  flash_dkv_kernel<DP><<<grid, FWD_THREADS, smem, s>>>(
      q, k, v, dsp, lse, di, mask_bits_t, group, beta, tau, c, nq, nk, d,
      splits > 1 ? dkv_part : dk, splits > 1 ? dkv_part + splits * n : dv);
  if (splits > 1) {
    sum_splits(dkv_part, splits, n, dk, s);
    sum_splits(dkv_part + splits * n, splits, n, dv, s);
  }
  return 0;
}

// the uint8 mask [rows, nk] into bits [rows][ceil(nk/32)] (the forward's
// and dq's layout)
void pack_mask(const unsigned char* mask, long rows, int nk, unsigned* bits,
               cudaStream_t s) {
  const long words = rows * ((nk + 31) / 32);
  const long blocks = (words + 7) / 8;  // a warp a word at most
  pack_mask_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      mask, rows, nk, (nk + 31) / 32, bits);
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
      pack_mask(mask, (long)(b / group) * nq, nk, mask_bits, s);
      bits = mask_bits;
    }
    int err = 0;
#define HS_FWD(DPV) err = launch_fwd<DPV>(q, k, v, bits, group, beta, tau, \
                                          c, b, nq, nk, d, out, lse, nrm, s)
    HS_DISPATCH(dp, HS_FWD)
#undef HS_FWD
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// blocks of the dq (which 0) or dk/dv (which 1) kernel at width d that
// fit on one streaming multiprocessor of the current device (the
// wrapper's choice of parts reads it); negative on an error
extern "C" int hs_flash_bwd_blocks_per_sm(int which, int d) {
  if (d < 1 || d > MAX_DP || which < 0 || which > 1) return -1;
  const int dp = (d + 7) / 8 * 8;
  int n = 0;
  cudaError_t err = cudaSuccess;
#define HS_OCC(DPV) err = occupancy<DPV>(which, &n)
  HS_DISPATCH(dp, HS_OCC)
#undef HS_OCC
  return err == cudaSuccess ? n : -(int)err;
}

// dsp [b, nq, d], lse and di [b, nq], the rest as hs_flash_fwd; the keys
// cut into 1 ≤ splits parts.  Writes dq [b, nq, d] and part [b, splits,
// ceil(nq / 64)], the per-block partials of Σ dσ·σ.  Scratch: mask_bits
// as hs_flash_fwd's; with splits > 1, dq_part of splits·b·nq·d floats.
extern "C" int hs_flash_dq(const float* q, const float* k, const float* v,
                           const float* dsp, const float* lse,
                           const float* di, const unsigned char* mask,
                           int group, unsigned* mask_bits, const float* beta,
                           const float* tau, float c, int b, int nq, int nk,
                           int d, int splits, float* dq, float* dq_part,
                           float* part, void* stream) {
  if (d < 1 || d > MAX_DP || splits < 1) return (int)cudaErrorInvalidValue;
  if (b > 0 && nq > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int dp = (d + 7) / 8 * 8;
    const unsigned* bits = nullptr;
    if (mask != nullptr && nk > 0) {
      pack_mask(mask, (long)(b / group) * nq, nk, mask_bits, s);
      bits = mask_bits;
    }
    int err = 0;
#define HS_DQ(DPV) err = launch_dq<DPV>(q, k, v, dsp, lse, di, bits, group, \
                                        beta, tau, c, b, nq, nk, d, splits, \
                                        dq, dq_part, part, s)
    HS_DISPATCH(dp, HS_DQ)
#undef HS_DQ
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// writes dk and dv [b, nk, d]; the queries cut into 1 ≤ splits parts.
// Scratch: with a mask, mask_bits_t of (b/group)·nk·ceil(nq/32) words,
// which first receives the mask transposed into bits; with splits > 1,
// dkv_part of 2·splits·b·nk·d floats.
extern "C" int hs_flash_dkv(const float* q, const float* k, const float* v,
                            const float* dsp, const float* lse,
                            const float* di, const unsigned char* mask,
                            int group, unsigned* mask_bits_t,
                            const float* beta, const float* tau, float c,
                            int b, int nq, int nk, int d, int splits,
                            float* dk, float* dv, float* dkv_part,
                            void* stream) {
  if (d < 1 || d > MAX_DP || splits < 1) return (int)cudaErrorInvalidValue;
  if (b > 0 && nk > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int dp = (d + 7) / 8 * 8;
    const unsigned* bits = nullptr;
    if (mask != nullptr && nq > 0) {
      const int groups = b / group;
      const long blocks = (long)groups * ((nk + 31) / 32) *
                          (((nq + 31) / 32 + PACK_WARPS - 1) / PACK_WARPS);
      pack_mask_t_kernel<<<(int)(blocks < 8192 ? blocks : 8192),
                           32 * PACK_WARPS, 0, s>>>(mask, groups, nq, nk,
                                                    mask_bits_t);
      bits = mask_bits_t;
    }
    int err = 0;
#define HS_DKV(DPV) err = launch_dkv<DPV>(q, k, v, dsp, lse, di, bits,      \
                                          group, beta, tau, c, b, nq, nk, d, \
                                          splits, dk, dv, dkv_part, s)
    HS_DISPATCH(dp, HS_DKV)
#undef HS_DKV
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
