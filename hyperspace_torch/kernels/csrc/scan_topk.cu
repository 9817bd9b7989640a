// Streaming k-NN scans (k <= 256), for sm_90a.  Three entries:
//
//  - hs_scan_topk: the exact scan over a table slab;
//  - hs_scan_topk_pq: ADC over a PQ-coded slab;
//  - hs_scan_topk_cand: per-query candidate rows, the IVF probing scorer.
//
// The table's lanes (the serving engine's `precision=`): the slab scan
// reads float32, bf16, int8 rows with a float32 scale a row, or int4 rows
// (two nibbles a byte, planar: byte j holds element j low and element
// ceil(D/2) + j high, sign-extended) with an f16 scale a row; the
// candidate scan reads float32, bf16 or int8 with its scale.  Only the
// table's bytes shrink: every lane widens its elements to float32
// (code · scale, one rounding) and scores them with the float32 lane's
// arithmetic, as the Pallas bodies' `_tile_rows_f32` does.
//
// Contract of every entry (identical to the Pallas kernels'): for each
// query row b, the k smallest distances, ascending, with global ids;
// rows at global id >= n are masked, and so is the query's own row under
// exclude_self; unreachable slots are (+inf, -1); ties go to the lowest
// global column (for the candidate scan: the earlier candidate position).
//
// The three scans share one selection machine, built for this card:
//
//  - One total order.  A candidate is the 64-bit key (distance bits,
//    global column; for the candidate scan, candidate position):
//    distances are >= +0 (every closed form clamps before its last
//    step), so their bits order as the floats do, and the tie rule is
//    the key's low word.  Lists, buffers and merges compare keys only,
//    so the answer is the k smallest keys of the slab whatever order the
//    work runs in.
//  - A warp owns one query's list of k keys, sorted, in shared memory.
//    Each lane scores R rows a step (independent chains, 32 rows apart).
//    A candidate that passes the threshold test is ballot-compacted into
//    the warp's 32-entry buffer with the closed form's last argument
//    (not yet the distance), in column order.  When the buffer is full,
//    and at the end, the warp flushes it: each lane closes one entry
//    into its distance (the first version's arithmetic, bit for bit)
//    and applies the exact test, the 32 keys are sorted bitonically
//    across the lanes, and merged into the list by merge path (each lane
//    writes ceil(k/32) outputs).  The test between flushes uses the k-th
//    as it stood at the last flush: stale, so it lets more through,
//    never less.
//  - The slab is split over blockIdx.y so that small batches fill the
//    card.  The splits of one query share a threshold: one 32-bit word a
//    query in global memory (the float bits of a distance, +inf at
//    start, filled by the caller).  A warp whose list is full lowers the
//    word to its k-th by atomicMin after a flush, and rereads it once a
//    tile.  A full list's k-th bounds the query's global k-th from above,
//    so a key whose distance is strictly above the word is not in the
//    answer; an equal distance may be (a lower column), so it is kept
//    and the merge decides.  Which candidates reach a list then depends
//    on the atomics' timing; the answer does not.
//  - The threshold test runs on the closed form's argument, before the
//    transcendental (arg_bound below derives the margin).  A survivor
//    gets the exact distance and the exact test at its flush.
//  - A second kernel merges a query's split lists: one warp a query,
//    pairs of lists merged by merge path in rounds, in shared memory.
//
// What bounds the slab scans on an H100: latency more than any unit.
// At D = 10 a pair costs 10 shared loads (the row; the query sits in
// registers) and 20 FMAs in two dependent chains, the threshold test a
// compare and a ballot; almost no pair reaches a flush.  The dense scan
// holds about 100 registers a thread (two blocks an SM), so a warp's
// chains must overlap: on an H100 80GB HBM3 at the serving shape one
// row a lane a step took 0.70 ms, four rows a lane 0.44.
// The table (3.3 MB at the serving shape) lives in the 50 MB L2; each
// block stages its tiles once for its 8 query warps.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int KMAX = 256;
constexpr int KREG = KMAX / 32;
constexpr int MAX_SPLITS = 64;
// a merge warp holds two buffers of S·k keys in SMEM_BUDGET
constexpr int MERGE_KEYS = 12800;
constexpr size_t SMEM_BUDGET = 200 * 1024;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;
constexpr u64 EMPTY = (0x7f800000ull << 32) | 0xffffffffull;  // (+inf, -1)

enum Kind { POINCARE = 0, LORENTZ = 1, EUCLIDEAN = 2 };
// the table's element lanes (kernels/scan_topk.py _LANES)
enum Lane { F32 = 0, BF16 = 1, INT8 = 2, INT4 = 3 };

// bytes of one table row, and of its scale, in a lane
__host__ __device__ constexpr int row_bytes(int lane, int D) {
  return lane == F32 ? 4 * D : lane == BF16 ? 2 * D
         : lane == INT8 ? D : (D + 1) / 2;
}
__host__ __device__ constexpr int scale_bytes(int lane) {
  return lane == INT8 ? 4 : lane == INT4 ? 2 : 0;
}

__device__ __forceinline__ float arcosh1p(float u) {
  u = fmaxf(u, 0.0f);
  return log1pf(u + sqrtf(fmaxf(u * (u + 2.0f), 0.0f)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ u64 pack(float d, int col) {
  return ((u64)__float_as_uint(d) << 32) | (unsigned)col;
}

__device__ __forceinline__ float key_dist(u64 x) {
  return __uint_as_float((unsigned)(x >> 32));
}

// --- the threshold test's margin ------------------------------------------
//
// A hyperbolic distance is computed as F(u) = fl(log1pf(a)/sc) with
// a = fl(u + sqrtf(fl(u·fl(u + 2)))), u >= 0 the closed form's argument
// (arcosh1p).  Against f(u) = arcosh(1 + u)/sc in exact arithmetic on
// the same float u and sc, to first order in 2^-24:
//   fl(u + 2), fl(u·(u + 2)): 2 roundings, halved by the sqrt  -> 1
//   sqrtf (correctly rounded), the sum u + s (both terms >= 0)  -> 2
//   log1p(a) has relative condition a/((1 + a)·log1p(a)) <= 1, and
//   log1pf itself is within 1 ulp (2·2^-24) of log1p           -> 2
//   the division by sc (correctly rounded)                      -> 1
// so |F(u)/f(u) - 1| <= 6·2^-24 (second-order terms are below 2^-40).
// This bounds F on each side of f, so it holds whether or not log1pf is
// monotone: F(u) <= T implies f(u) <= T/(1 - 6·2^-24) < T·(1 + EPS_D)
// with EPS_D = 16·2^-24, which also covers a log1pf off by 2 ulp
// (3 + 4 + 1 = 8 <= 16, and 1/(1 - x) < 1 + 2x).  f is increasing, so
//   u <= cosh(sc·T·(1 + EPS_D)) - 1 = 2·sinh²(sc·T·(1 + EPS_D)/2) = U(T)
// evaluated in double (error ~1e-16) and rounded up to float.  The ball's
// argument is a quotient num/den' tested as num <= U·den' (no division):
// fl(num/den') <= U implies num <= U·den'·(1 + 2^-24), and fl(U'·den')
// >= U·den'·(1 + 2^-24) when U' = U·(1 + EPS_Q), EPS_Q = 2^-22, which U
// carries for every kind.  Below u = 2^-126 the roundings are absolute,
// not relative, so U is at least 2^-96 (every such u passes).  Euclidean
// distances are sqrtf (correctly rounded, monotone): the test on d² is
// exact, against the largest float x with sqrtf(x) <= T.
constexpr double EPS_D = 16.0 / 16777216.0;
constexpr double EPS_Q = 1.0 / 4194304.0;

__device__ float arg_bound(float T, int kind, float sc) {
  if (!(T < INFINITY)) return INFINITY;
  if (kind == EUCLIDEAN) {
    float x = __fmul_ru(T, T);
    while (x > 0.0f && sqrtf(x) > T) x = __int_as_float(__float_as_int(x) - 1);
    for (;;) {
      const float up = __int_as_float(__float_as_int(x) + 1);
      if (up < INFINITY && sqrtf(up) <= T) x = up; else break;
    }
    return x;
  }
  const double s = sinh(0.5 * (double)sc * (double)T * (1.0 + EPS_D));
  return fmaxf(__double2float_ru(2.0 * s * s * (1.0 + EPS_Q)), 0x1p-96f);
}

// --- the selection machine ------------------------------------------------

// The i for which the first `diag` outputs of merge(A, B) are A[0..i)
// and B[0..diag-i); A's entry goes first on equal keys.
__device__ __forceinline__ int merge_path(const u64* A, int na, const u64* B,
                                          int nb, int diag) {
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (A[mid] <= B[diag - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Ascending bitonic sort of one key a lane across the warp.
__device__ __forceinline__ u64 sort32(u64 x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 y = __shfl_xor_sync(FULL, x, stride);
      const bool keep_min = ((lane & size) == 0) == ((lane & stride) == 0);
      x = keep_min ? (y < x ? y : x) : (y < x ? x : y);
    }
  }
  return x;
}

// The k smallest of list A (k, sorted) and B (nb, sorted) into A: each
// lane stages its ceil(k/32) outputs in registers, then writes them.
__device__ void merge_list(u64* A, int k, const u64* B, int nb, int lane) {
  const int P = (k + 31) >> 5;
  const int diag = min(lane * P, k);
  int i = merge_path(A, k, B, nb, diag), j = diag - i;
  u64 out[KREG];
#pragma unroll
  for (int t = 0; t < KREG; ++t) {
    if (t < P && diag + t < k) {       // i + j < k, so A[i] is in range
      const bool ta = j >= nb || A[i] <= B[j];
      out[t] = ta ? A[i] : B[j];
      i += ta;
      j += !ta;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KREG; ++t)
    if (t < P && diag + t < k) A[diag + t] = out[t];
  __syncwarp();
}

// One warp's state: its list and buffer in shared memory, its query's
// shared threshold word, and the threshold test it applies.
struct Sel {
  u64* list;        // [k] keys, ascending
  u64* bk;          // [32] sorted keys of a flush
  float* ba;        // [32] closed-form argument (ball: numerator)
  float* bb;        // [32] ball: the clamped denominator
  int* bc;          // [32] global column
  unsigned* word;   // the query's shared threshold, or null (one split)
  unsigned wnext;   // lane 0: the word as loaded at the last tile
  int k, lane, cnt, kind;
  float sc;
  float seen;       // the lowest word value this warp has seen
  float T;          // min(k-th distance, seen): what U bounds
  float U;          // arg_bound(T)
  u64 kth;          // list[k - 1]
};

__device__ __forceinline__ void sel_init(Sel& s, unsigned char* base,
                                         int warp, int k, int lane,
                                         int kind, float sc,
                                         unsigned* word) {
  u64* lists = reinterpret_cast<u64*>(base);
  u64* bks = lists + WARPS * k;
  float* bas = reinterpret_cast<float*>(bks + WARPS * 32);
  s.list = lists + warp * k;
  s.bk = bks + warp * 32;
  s.ba = bas + warp * 32;
  s.bb = bas + WARPS * 32 + warp * 32;
  s.bc = reinterpret_cast<int*>(bas + 2 * WARPS * 32) + warp * 32;
  s.word = word;
  s.wnext = 0x7f800000u;
  s.k = k;
  s.lane = lane;
  s.cnt = 0;
  s.kind = kind;
  s.sc = sc;
  s.seen = s.T = s.U = INFINITY;
  s.kth = EMPTY;
  for (int i = lane; i < k; i += 32) s.list[i] = EMPTY;
}

// Shared memory of the selection machine for a block of WARPS warps.
__host__ __device__ constexpr size_t sel_bytes(int k) {
  return (size_t)WARPS * k * 8 + (size_t)WARPS * 32 * (8 + 12);
}

__device__ __forceinline__ void retarget(Sel& s) {
  const float t = fminf(key_dist(s.kth), s.seen);
  if (t != s.T) {
    s.T = t;
    s.U = arg_bound(t, s.kind, s.sc);
  }
}

// Once a tile: take the word loaded at the previous tile and load it
// again, so the warp never waits for the load.
__device__ __forceinline__ void reread(Sel& s) {
  if (s.word == nullptr) return;
  const float wf = __uint_as_float(__shfl_sync(FULL, s.wnext, 0));
  if (s.lane == 0) s.wnext = *reinterpret_cast<volatile unsigned*>(s.word);
  if (wf < s.seen) {
    s.seen = wf;
    retarget(s);
  }
}

// Close the buffered candidates into keys, keep those that beat the
// list's k-th and are not above the word, sort them, merge them in,
// publish a full list's k-th.
__device__ void flush(Sel& s) {
  const int lane = s.lane;
  u64 key = EMPTY;
  if (lane < s.cnt) {
    const float a = s.ba[lane];
    float d;
    if (s.kind == EUCLIDEAN) {
      d = sqrtf(a);
    } else {
      d = arcosh1p(s.kind == POINCARE ? a / s.bb[lane] : a) / s.sc;
    }
    // the list's entries all have lower columns, so this is the key
    // test; +inf never enters (the plain version's (+inf, -1))
    if (d < key_dist(s.kth) && d <= s.seen) key = pack(d, s.bc[lane]);
  }
  s.cnt = 0;
  const unsigned live = __ballot_sync(FULL, key != EMPTY);
  if (live) {
    key = sort32(key, lane);
    s.bk[lane] = key;
    __syncwarp();
    merge_list(s.list, s.k, s.bk, __popc(live), lane);
    s.kth = s.list[s.k - 1];
    const float kd = key_dist(s.kth);
    if (s.word != nullptr && kd < s.seen) {   // the list is full
      unsigned old = 0;
      if (lane == 0) old = atomicMin(s.word, __float_as_uint(kd));
      s.seen = fminf(kd, __uint_as_float(__shfl_sync(FULL, old, 0)));
    }
    retarget(s);
  }
  __syncwarp();
}

// Each lane offers one candidate (pass: it passed the threshold test).
__device__ __forceinline__ void push(Sel& s, bool pass, float a, float b,
                                     int col) {
  unsigned hit = __ballot_sync(FULL, pass);
  while (hit) {
    const int room = 32 - s.cnt;
    const int rank = __popc(hit & ((1u << s.lane) - 1u));
    const bool take = ((hit >> s.lane) & 1u) && rank < room;
    if (take) {
      const int at = s.cnt + rank;
      s.ba[at] = a;
      s.bb[at] = b;
      s.bc[at] = col;
    }
    const int nhit = __popc(hit);
    if (nhit < room) {
      s.cnt += nhit;
      return;
    }
    hit &= ~__ballot_sync(FULL, take);
    s.cnt = 32;
    __syncwarp();
    flush(s);
  }
}

// A key's low word as written out: the column, or with `cand` (the
// candidate scan's list of a query) the id at that position; -1 stays.
__device__ __forceinline__ int key_id(u64 x, const int* cand) {
  const int p = (int)(unsigned)x;
  return cand == nullptr || p < 0 ? p : __ldg(cand + p);
}

__device__ __forceinline__ void sel_finish(Sel& s, float* out_d, int* out_i,
                                           size_t base,
                                           const int* cand = nullptr) {
  if (s.cnt) {
    __syncwarp();
    flush(s);
  }
  for (int i = s.lane; i < s.k; i += 32) {
    const u64 x = s.list[i];
    out_d[base + i] = key_dist(x);
    out_i[base + i] = key_id(x, cand);
  }
}

// --- copies into shared memory -------------------------------------------

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows × D floats from src (any float alignment) into a tile of row
// stride ds at shared address dst, one 4-byte cp.async an element.  The
// block walks the elements in order (coalesced reads); (r0, k0) is this
// thread's first (row, lane) and (sr, sk) the step of NT elements.
__device__ __forceinline__ void stage_rows(unsigned dst, const float* src,
                                           int rows, int D, int ds, int r0,
                                           int k0, int sr, int sk) {
  const int total = rows * D;
  int r = r0, kk = k0;
  for (int e = threadIdx.x; e < total; e += NT) {
    cp_async4(dst + 4u * (unsigned)(r * ds + kk), src + e);
    kk += sk;
    r += sr;
    if (kk >= D) {
      kk -= D;
      ++r;
    }
  }
  cp_commit();
}

// len bytes from src (any alignment) into buf so that byte i lands at
// buf[o + i], o = src mod 16: 16-byte cp.async for the aligned middle,
// plain byte copies for the head and tail.  Returns o.
__device__ __forceinline__ int stage_codes(unsigned char* buf, unsigned sbuf,
                                           const unsigned char* src,
                                           int len) {
  const int o = (int)((uintptr_t)src & 15);
  const int h = min((16 - o) & 15, len);
  const int nch = (len - h) >> 4;
  const int tail = h + (nch << 4);
  for (int i = threadIdx.x; i < h; i += NT) buf[o + i] = src[i];
  for (int ch = threadIdx.x; ch < nch; ch += NT)
    cp_async16(sbuf + (unsigned)(o + h + 16 * ch), src + h + 16 * ch);
  for (int i = tail + (int)threadIdx.x; i < len; i += NT) buf[o + i] = src[i];
  cp_commit();
  return o;
}

// Element kk of staged row r in a narrow lane, widened to float32:
// rt holds the tile's rows (rb bytes each), st their scales.
template <int LANE>
__device__ __forceinline__ float tile_elem(const unsigned char* rt,
                                           const unsigned char* st, int r,
                                           int kk, int rb) {
  const unsigned char* row = rt + (size_t)r * rb;
  if constexpr (LANE == BF16) {
    return __bfloat162float(__ushort_as_bfloat16(
        *reinterpret_cast<const unsigned short*>(row + 2 * kk)));
  } else if constexpr (LANE == INT8) {
    const float s = *reinterpret_cast<const float*>(st + 4 * r);
    return __fmul_rn((float)(signed char)row[kk], s);
  } else {                          // INT4: rb = ceil(D/2) bytes a row
    const bool low = kk < rb;
    const int v = row[low ? kk : kk - rb];
    int nib = low ? (v & 15) : (v >> 4);
    nib = nib >= 8 ? nib - 16 : nib;
    const float s = __half2float(*reinterpret_cast<const __half*>(st + 2 * r));
    return __fmul_rn((float)nib, s);
  }
}

// Element i of a bf16 or int8 table, widened to float32 (int8: times
// the row's scale s).
template <int LANE>
__device__ __forceinline__ float table_elem(const float* table, size_t i,
                                            float s) {
  if constexpr (LANE == BF16) {
    return __bfloat162float(__ushort_as_bfloat16(
        __ldg(reinterpret_cast<const unsigned short*>(table) + i)));
  } else {
    return __fmul_rn(
        (float)__ldg(reinterpret_cast<const signed char*>(table) + i), s);
  }
}

// --- the exact scan ---------------------------------------------------------
//
// Replaces hyperspace_tpu/kernels/scan_topk.py `_slab_body` (launched by
// `_launch_slab`), with the tile math of `_slab_tile`, the running top-k
// of `_merge` and the threshold test of `_prune`.
//
// One warp a query row, WARPS query rows a block; the block stages tiles
// of `tm` table rows in shared memory (odd row stride ds: a lane reads
// its own row, conflict-free), double-buffered by cp.async when two fit
// (`stages`); each lane scores one row a step.  DQ > 0 holds the query
// in DQ registers (D <= DQ); DQ = 0 is the general width, the query in
// shared memory.  Every distance keeps the first version's arithmetic:
// the same fmaf chains for g and yy, the same clamps.  The threshold
// test: Lorentz on u = max(-c·g - 1, 0), the ball on 2c·d2 against
// U·max(den, 1e-7), Euclidean exactly on d2.
//
// The narrow lanes (LANE != F32) stage each tile's raw bytes, and its
// rows' scales, by 16-byte cp.async into one of two byte buffers (a row
// of 10 int8 or 5 int4 bytes starts at any byte, so they are staged as
// bytes, as the PQ codes are), double-buffered; when a tile has landed
// the block widens it into the float32 tile (one pass, each element
// once), and the warps score it exactly as the float32 lane does.
template <int KIND, int DQ, int R, int LANE>
__global__ void __launch_bounds__(NT)
scan_topk_kernel(const float* __restrict__ slab, const float* __restrict__ q,
                 const int* __restrict__ q_idx, unsigned* __restrict__ thr,
                 float* __restrict__ out_d, int* __restrict__ out_i, int B,
                 int M, int D, int ds, int k, int col0, int n,
                 int exclude_self, float c, int rows_per_split, int tm,
                 int stages, const unsigned char* __restrict__ scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + sel_bytes(k));  // [WARPS][D]
  float* tiles = qs + (DQ == 0 ? WARPS * D : 0);         // [stages][tm][ds]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  const bool active = b < B;
  const int split = blockIdx.y, splits = gridDim.y;
  const int lo = split * rows_per_split;
  const int hi = min(M, lo + rows_per_split);
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), 1e-12f);
  Sel s;
  sel_init(s, smem, warp, k, lane, KIND, sc,
           (thr != nullptr && active) ? thr + b : nullptr);
  float* qv = qs + warp * D;
  float qr[DQ > 0 ? DQ : 1];

  float xx = 0.0f;
  int qi = -1;
  if (active) {
    float acc = 0.0f;
    for (int kk = lane; kk < D; kk += 32) {
      const float v = q[(size_t)b * D + kk];
      acc = fmaf(v, v, acc);
      if (DQ == 0) qv[kk] = (KIND == LORENTZ && kk == 0) ? -v : v;
    }
    xx = warp_sum(acc);
    if constexpr (DQ > 0) {
#pragma unroll
      for (int kk = 0; kk < DQ; ++kk) {
        const float v = kk < D ? q[(size_t)b * D + kk] : 0.0f;
        qr[kk] = (KIND == LORENTZ && kk == 0) ? -v : v;  // Minkowski
      }
    }
    qi = q_idx[b];
  }
  __syncwarp();
  const float xm = 1.0f - c * xx;

  const unsigned tbase = (unsigned)__cvta_generic_to_shared(tiles);
  const unsigned tstride = (unsigned)tm * (unsigned)ds * 4u;
  const int r0 = (int)threadIdx.x / D, k0 = (int)threadIdx.x % D;
  const int sr = NT / D, sk = NT % D;
  const int nt = hi > lo ? (hi - lo + tm - 1) / tm : 0;
  // the narrow lanes' byte buffers, after the one float32 tile
  constexpr int SB = scale_bytes(LANE);
  const int rb = row_bytes(LANE, D);
  const int rawb = (tm * rb + 31) & ~15, scb = (tm * SB + 31) & ~15;
  unsigned char* raw = reinterpret_cast<unsigned char*>(tiles + (size_t)tm * ds);
  unsigned char* sraw = raw + 2 * rawb;
  const unsigned rbase = tbase + tstride, sbase = rbase + 2u * (unsigned)rawb;
  int o_next = 0, so_next = 0;
  auto stage_lane = [&](int t0, int rows, int buf) {
    o_next = stage_codes(raw + buf * rawb, rbase + (unsigned)(buf * rawb),
                         reinterpret_cast<const unsigned char*>(slab) +
                             (size_t)t0 * rb,
                         rows * rb);
    if (SB)
      so_next = stage_codes(sraw + buf * scb, sbase + (unsigned)(buf * scb),
                            scale + (size_t)t0 * SB, rows * SB);
  };
  if constexpr (LANE == F32) {
    if (stages == 2 && nt > 0)
      stage_rows(tbase, slab + (size_t)lo * D, min(tm, hi - lo), D, ds, r0,
                 k0, sr, sk);
  } else {
    if (nt > 0) stage_lane(lo, min(tm, hi - lo), 0);
  }
  for (int t = 0; t < nt; ++t) {
    const int t0 = lo + t * tm;
    const int rows = min(tm, hi - t0);
    if constexpr (LANE == F32) {
      if (stages == 1) {
        __syncthreads();               // the tile is free again
        stage_rows(tbase, slab + (size_t)t0 * D, rows, D, ds, r0, k0, sr,
                   sk);
      }
      cp_wait_all();
      __syncthreads();                 // tile t landed; t - 1 was read
      if (stages == 2 && t + 1 < nt) {
        const int t1 = t0 + tm;
        stage_rows(tbase + ((t + 1) & 1) * tstride, slab + (size_t)t1 * D,
                   min(tm, hi - t1), D, ds, r0, k0, sr, sk);
      }
    } else {
      const int o = o_next, so = so_next;
      cp_wait_all();
      __syncthreads();     // raw tile t landed; the float tile was read
      if (t + 1 < nt) stage_lane(t0 + tm, min(tm, hi - t0 - tm), (t + 1) & 1);
      const unsigned char* rt = raw + (t & 1) * rawb + o;
      const unsigned char* st = sraw + (t & 1) * scb + so;
      for (int e = threadIdx.x; e < rows * D; e += NT) {
        const int r = e / D, kk = e - r * D;
        tiles[r * ds + kk] = tile_elem<LANE>(rt, st, r, kk, rb);
      }
      __syncthreads();                 // the float tile is written
    }
    if (!active) continue;
    reread(s);
    const float* tile = tiles + (size_t)(stages == 2 ? (t & 1) : 0) * tm * ds;
    for (int rs = 0; rs < rows; rs += 32 * R) {
      // R rows a lane, 32 apart: R independent chains, pushed in
      // column order
      const float* row[R];
      int gcol[R];
      bool ok[R];
      float g[R], yy[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int r = rs + 32 * rr + lane;
        gcol[rr] = col0 + t0 + r;
        ok[rr] = r < rows && gcol[rr] < n &&
                 !(exclude_self && gcol[rr] == qi);
        row[rr] = tile + (r < rows ? r : 0) * ds;
        g[rr] = yy[rr] = 0.0f;
      }
      if constexpr (DQ > 0) {
#pragma unroll
        for (int c4 = 0; c4 < DQ; c4 += 4) {
          if (c4 < D) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (c4 + j < D) {
#pragma unroll
                for (int rr = 0; rr < R; ++rr) {
                  const float yv = row[rr][c4 + j];
                  g[rr] = fmaf(qr[c4 + j], yv, g[rr]);
                  yy[rr] = fmaf(yv, yv, yy[rr]);
                }
              }
            }
          }
        }
      } else {
        for (int kk = 0; kk < D; ++kk) {
          const float qk = qv[kk];
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const float yv = row[rr][kk];
            g[rr] = fmaf(qk, yv, g[rr]);
            yy[rr] = fmaf(yv, yv, yy[rr]);
          }
        }
      }
      float a[R], bq[R];
      bool pass[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        bq[rr] = 1.0f;
        if constexpr (KIND == LORENTZ) {
          a[rr] = fmaxf(-c * g[rr] - 1.0f, 0.0f);
          pass[rr] = a[rr] <= s.U;
        } else {
          const float d2 = fmaxf(xx - 2.0f * g[rr] + yy[rr], 0.0f);
          if constexpr (KIND == EUCLIDEAN) {
            a[rr] = d2;
            pass[rr] = d2 <= s.U;
          } else {
            const float den = xm * (1.0f - c * yy[rr]);
            a[rr] = 2.0f * c * d2;
            bq[rr] = fmaxf(den, 1e-7f);
            pass[rr] = a[rr] <= s.U * bq[rr];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        push(s, ok[rr] && pass[rr], a[rr], bq[rr], gcol[rr]);
    }
  }
  if (active) sel_finish(s, out_d, out_i, ((size_t)b * splits + split) * k);
}

// --- PQ scan by ADC ----------------------------------------------------------
//
// Replaces hyperspace_tpu/kernels/scan_topk.py `_pq_body` (launched by
// `_launch_pq`), with the tile math of `_pq_tile`/`_pq_dist_from_sum`.
// Contract: hs_scan_topk's, over codes [M, m] uint8 and per-query lookup
// tables lut [B, m*256]: a row's score is the sum of lut[s*256 + code[s]]
// over s = 0..m-1, in that order (__fadd_rn), closed into the distance of
// the reconstructed row with the TPU kernel's clamps.
//
// What bounds it on an H100: the table lookups.  A row costs m bytes of
// code and m shared-memory reads at data-dependent addresses (about
// 3-way bank conflicts for random codes); no pair computes a logarithm
// unless it passes the test on u = max(-c·ssum - 1, 0) (Euclidean: on
// max(ssum, 0), exactly).  Eight query warps a block, each with its
// m*256-float LUT in shared memory; one tile of code rows, copied by
// 16-byte cp.async (any base alignment: byte copies for the head and the
// tail), double-buffered, serves all eight.  MM is m.
template <int MM, int R>
__global__ void __launch_bounds__(NT)
scan_pq_kernel(const unsigned char* __restrict__ codes,
               const float* __restrict__ lut, const int* __restrict__ q_idx,
               unsigned* __restrict__ thr, float* __restrict__ out_d,
               int* __restrict__ out_i, int B, int M, int k, int col0, int n,
               int exclude_self, float c, int kind, int rows_per_split,
               int tm) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LW = MM * 256;
  float* luts = reinterpret_cast<float*>(smem + sel_bytes(k));  // [WARPS][LW]
  unsigned char* tiles = reinterpret_cast<unsigned char*>(luts + WARPS * LW);
  const int tb = ((tm * MM + 16) + 15) & ~15;             // bytes a tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  const bool active = b < B;
  const int split = blockIdx.y, splits = gridDim.y;
  const int lo = split * rows_per_split;
  const int hi = min(M, lo + rows_per_split);
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), 1e-12f);
  Sel s;
  // the flush closes u with arcosh1p (no quotient) or sqrtf
  sel_init(s, smem, warp, k, lane, kind == EUCLIDEAN ? EUCLIDEAN : LORENTZ,
           sc, (thr != nullptr && active) ? thr + b : nullptr);
  float* lv = luts + warp * LW;

  int qi = -1;
  if (active) {
    for (int i = lane; i < LW; i += 32) lv[i] = lut[(size_t)b * LW + i];
    qi = q_idx[b];
  }
  __syncwarp();

  const unsigned tbase = (unsigned)__cvta_generic_to_shared(tiles);
  const int nt = hi > lo ? (hi - lo + tm - 1) / tm : 0;
  int o_next = 0;
  if (nt > 0)
    o_next = stage_codes(tiles, tbase, codes + (size_t)lo * MM,
                         min(tm, hi - lo) * MM);
  for (int t = 0; t < nt; ++t) {
    const int t0 = lo + t * tm;
    const int rows = min(tm, hi - t0);
    const int o = o_next;
    cp_wait_all();
    __syncthreads();                   // tile t landed; t - 1 was read
    if (t + 1 < nt) {
      const int t1 = t0 + tm, nb = (t + 1) & 1;
      o_next = stage_codes(tiles + nb * tb, tbase + (unsigned)(nb * tb),
                           codes + (size_t)t1 * MM, min(tm, hi - t1) * MM);
    }
    if (!active) continue;
    reread(s);
    const unsigned char* tile = tiles + (t & 1) * tb + o;
    for (int rs = 0; rs < rows; rs += 32 * R) {
      // R rows a lane, 32 apart, as in the exact scan
      float ssum[R];
      int gcol[R];
      bool ok[R];
      const unsigned char* code[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int r = rs + 32 * rr + lane;
        gcol[rr] = col0 + t0 + r;
        ok[rr] = r < rows && gcol[rr] < n &&
                 !(exclude_self && gcol[rr] == qi);
        code[rr] = tile + (r < rows ? r : 0) * MM;
        ssum[rr] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < MM; ++j)
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          ssum[rr] = __fadd_rn(ssum[rr], lv[j * 256 + code[rr][j]]);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        float a;
        if (kind == EUCLIDEAN) {
          a = fmaxf(ssum[rr], 0.0f);
        } else {
          // the plain version's rounding: no contraction into an FMA
          a = fmaxf(__fsub_rn(__fmul_rn(-c, ssum[rr]), 1.0f), 0.0f);
        }
        push(s, ok[rr] && a <= s.U, a, 1.0f, gcol[rr]);
      }
    }
  }
  if (active) sel_finish(s, out_d, out_i, ((size_t)b * splits + split) * k);
}

// --- the split merge of the two slab scans -----------------------------
//
// One warp a query: its S sorted lists ([B, S, k]) are read once into
// shared memory as keys (one coalesced pass with no branch on the data,
// so the loads overlap), then merged in rounds, pairs of lists into the
// k smallest of each pair (merge path; 32/pairs lanes a pair, each lane
// writing its share of the outputs into the other buffer; an odd list
// is carried).  A round costs O(k·pairs/32 + log k) dependent steps, so
// 64 lists of 10 take 6 short rounds and 5 lists of 170 three.  (Reading
// only each list's prefix at or below the threshold word, found by
// binary searches, was slower at every shape measured.)  With `cand`
// ([B, C], the candidate scan's) the lists hold positions, written out
// as the ids there.
__global__ void merge_tree_kernel(const float* __restrict__ pd,
                                  const int* __restrict__ pi,
                                  float* __restrict__ od,
                                  int* __restrict__ oi, int B, int S, int k,
                                  const int* __restrict__ cand, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wm = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * wm + warp;
  if (b >= B) return;                 // no block-wide barrier below
  const int sk = S * k;
  u64* src = reinterpret_cast<u64*>(smem) + (size_t)warp * 2 * sk;
  u64* dst = src + sk;
  const size_t base = (size_t)b * sk;
#pragma unroll 4
  for (int i = lane; i < sk; i += 32)
    src[i] = pack(pd[base + i], pi[base + i]);
  __syncwarp();
  int L = S;
  while (L > 1) {
    const int pairs = L >> 1;
    const int G = pairs >= 32 ? 1 : 32 / pairs;
    const int p = lane / G, gl = lane - p * G;
    if (p < pairs) {
      const u64* A = src + (size_t)(2 * p) * k;
      const u64* Bl = A + k;
      u64* O = dst + (size_t)p * k;
      const int P = (k + G - 1) / G;
      const int diag = min(gl * P, k), end = min(diag + P, k);
      int i = merge_path(A, k, Bl, k, diag), j = diag - i;
      for (int o = diag; o < end; ++o) {   // i + j < k
        const bool ta = j >= k || A[i] <= Bl[j];
        O[o] = ta ? A[i] : Bl[j];
        i += ta;
        j += !ta;
      }
    }
    if (L & 1)
      for (int i = lane; i < k; i += 32)
        dst[(size_t)pairs * k + i] = src[(size_t)(L - 1) * k + i];
    __syncwarp();
    L = pairs + (L & 1);
    u64* tmp = src;
    src = dst;
    dst = tmp;
  }
  const int* crow = cand == nullptr ? nullptr : cand + (size_t)b * C;
  for (int i = lane; i < k; i += 32) {
    const u64 x = src[i];
    od[(size_t)b * k + i] = key_dist(x);
    oi[(size_t)b * k + i] = key_id(x, crow);
  }
}

// --- per-query candidate scan (the IVF probing scorer) --------------------
//
// Replaces hyperspace_tpu/kernels/scan_topk.py `_cand_body` (launched by
// `_launch_cand`), with the tile math of `_cand_tile`/`_pair_dist_b`.
// Contract: query row b scores the table rows whose ids stand in
// cand[b, 0..C) (-1 = padding, anywhere in the list; an id outside
// [0, N) counts as padding); its own row is masked under exclude_self;
// ties go to the earlier candidate position, and an id listed twice
// counts at each of its positions; slots beyond the reachable candidates
// are (+inf, -1).
//
// What bounds it on an H100: the gathers.  Each candidate costs one
// random row read of D floats (the 3.3 MB table of the serving path sits
// in the 50 MB L2) and ~2D multiply-adds.  The TPU kernel streams a
// pre-gathered [B, C, 128-lane] block; this one gathers each row by id
// straight from the table, so no [B, C, D] copy is ever written:
//  - keys are (distance bits, candidate position): the position keeps
//    the tie rule and duplicate ids; the ids are read back from cand
//    when the answer is written (sel_finish, merge_tree_kernel);
//  - one warp a query and split, the slab scans' selection machine
//    (threshold test before the logarithm, buffered flushes, the
//    query's threshold word shared by its splits);
//  - each lane takes R positions a step, 32 apart, pushed in position
//    order, the next step's ids loading while this step's rows arrive;
//    at D = 10 and 11 (the ball and its hyperboloid lift) the row sits
//    in registers, read by 8-byte loads where the pitch and the table's
//    pointer allow; any other D loops with the query in shared memory;
//  - the positions split over blockIdx.y, merged by merge_tree_kernel.
// The distance arithmetic is the first version's: the same fmaf chains
// for g and yy, the same clamps.  The bf16 and int8 lanes (LANE) read
// each element as its type, widened to float32 (int8: times the row's
// scale, read beside its id) before the same chains.
template <int KIND, int DC, int VW, int R, int LANE>
__global__ void __launch_bounds__(NT)
scan_cand_kernel(const float* __restrict__ table, const int* __restrict__ cand,
                 const float* __restrict__ q, const int* __restrict__ q_idx,
                 unsigned* __restrict__ thr, float* __restrict__ out_d,
                 int* __restrict__ out_i, int B, int C, int N, int D, int k,
                 int exclude_self, float c, int per_split,
                 const float* __restrict__ scale) {
  static_assert(DC % VW == 0, "whole loads a row");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + sel_bytes(k));  // [WARPS][D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;                 // no block-wide barrier below
  const int split = blockIdx.y, splits = gridDim.y;
  const int lo = split * per_split;
  const int hi = min(C, lo + per_split);
  const float sc = fmaxf(sqrtf(fmaxf(c, 0.0f)), 1e-12f);
  Sel s;
  sel_init(s, smem, warp, k, lane, KIND, sc,
           thr != nullptr ? thr + b : nullptr);
  float* qv = qs + warp * D;
  float qr[DC > 0 ? DC : 1];
  float acc = 0.0f;
  for (int kk = lane; kk < D; kk += 32) {
    const float v = q[(size_t)b * D + kk];
    acc = fmaf(v, v, acc);
    if (DC == 0) qv[kk] = (KIND == LORENTZ && kk == 0) ? -v : v;
  }
  const float xx = warp_sum(acc);
  if constexpr (DC > 0) {
#pragma unroll
    for (int kk = 0; kk < DC; ++kk) {
      const float v = q[(size_t)b * D + kk];
      qr[kk] = (KIND == LORENTZ && kk == 0) ? -v : v;  // Minkowski
    }
  }
  const int qi = q_idx[b];
  __syncwarp();
  const float xm = 1.0f - c * xx;
  const int* crow = cand + (size_t)b * C;

  int id_n[R];
  auto ids = [&](int base) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int p = base + 32 * rr + lane;
      id_n[rr] = p < hi ? __ldg(crow + p) : -1;
    }
  };
  ids(lo);
  for (int base = lo; base < hi; base += 32 * R) {
    reread(s);
    int pos[R];
    bool ok[R];
    const float* row[R];
    size_t e0[R];      // the narrow lanes: the row's first element
    float rs[R];       // int8: the row's scale
    float g[R], yy[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int id = id_n[rr];
      pos[rr] = base + 32 * rr + lane;
      ok[rr] = id >= 0 && id < N && !(exclude_self && id == qi);
      row[rr] = table + (size_t)(ok[rr] ? id : 0) * D;
      e0[rr] = (size_t)(ok[rr] ? id : 0) * D;
      rs[rr] = 1.0f;
      if constexpr (LANE == INT8)
        rs[rr] = ok[rr] ? __ldg(scale + id) : 0.0f;
      g[rr] = yy[rr] = 0.0f;
    }
    if constexpr (DC > 0) {
      // selects, not branches: every row load of the step issues first
      float y[R][DC];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
#pragma unroll
        for (int t = 0; t < DC; t += VW) {
          if constexpr (LANE != F32) {
            y[rr][t] = ok[rr] ? table_elem<LANE>(table, e0[rr] + t, rs[rr])
                              : 0.0f;
          } else if constexpr (VW == 2) {
            const float2 v =
                ok[rr] ? __ldg(reinterpret_cast<const float2*>(row[rr] + t))
                       : make_float2(0.0f, 0.0f);
            y[rr][t] = v.x;
            y[rr][t + 1] = v.y;
          } else {
            y[rr][t] = ok[rr] ? __ldg(row[rr] + t) : 0.0f;
          }
        }
      }
      ids(base + 32 * R);  // the next step's ids load while the rows arrive
#pragma unroll
      for (int t = 0; t < DC; ++t)
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          g[rr] = fmaf(qr[t], y[rr][t], g[rr]);
          yy[rr] = fmaf(y[rr][t], y[rr][t], yy[rr]);
        }
    } else {
      ids(base + 32 * R);
      for (int kk = 0; kk < D; ++kk) {
        const float qk = qv[kk];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          float yv;
          if constexpr (LANE != F32)
            yv = ok[rr] ? table_elem<LANE>(table, e0[rr] + kk, rs[rr]) : 0.0f;
          else
            yv = ok[rr] ? __ldg(row[rr] + kk) : 0.0f;
          g[rr] = fmaf(qk, yv, g[rr]);
          yy[rr] = fmaf(yv, yv, yy[rr]);
        }
      }
    }
    float a[R], bq[R];
    bool pass[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      bq[rr] = 1.0f;
      if constexpr (KIND == LORENTZ) {
        a[rr] = fmaxf(-c * g[rr] - 1.0f, 0.0f);
        pass[rr] = a[rr] <= s.U;
      } else {
        const float d2 = fmaxf(xx - 2.0f * g[rr] + yy[rr], 0.0f);
        if constexpr (KIND == EUCLIDEAN) {
          a[rr] = d2;
          pass[rr] = d2 <= s.U;
        } else {
          const float den = xm * (1.0f - c * yy[rr]);
          a[rr] = 2.0f * c * d2;
          bq[rr] = fmaxf(den, 1e-7f);
          pass[rr] = a[rr] <= s.U * bq[rr];
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
      push(s, ok[rr] && pass[rr], a[rr], bq[rr], pos[rr]);
  }
  sel_finish(s, out_d, out_i, ((size_t)b * splits + split) * k,
             splits == 1 ? crow : nullptr);
}

}  // namespace

// --- host side -------------------------------------------------------------

typedef void (*DenseFn)(const float*, const float*, const int*, unsigned*,
                        float*, int*, int, int, int, int, int, int, int, int,
                        float, int, int, int, const unsigned char*);

// rows a lane a step: independent chains that hide the shared loads'
// latency (fewer where the query takes many registers; the ADC scan's
// lookups conflict in the banks and gain less from more in flight)
constexpr int DENSE_ROWS = 4, PQ_ROWS = 2;

// the float32 lane's query widths; the narrow lanes keep the query in
// registers up to D = 16 (the served widths) and in shared memory above
constexpr int LANE_DQ_MAX = 16;

template <int KIND, int LANE>
static DenseFn dense_for(int D) {
  if constexpr (LANE == F32) {
    if (D <= 16) return scan_topk_kernel<KIND, 16, DENSE_ROWS, F32>;
    if (D <= 32) return scan_topk_kernel<KIND, 32, DENSE_ROWS, F32>;
    if (D <= 64) return scan_topk_kernel<KIND, 64, 2, F32>;
    return scan_topk_kernel<KIND, 0, DENSE_ROWS, F32>;
  } else {
    if (D <= LANE_DQ_MAX)
      return scan_topk_kernel<KIND, LANE_DQ_MAX, DENSE_ROWS, LANE>;
    return scan_topk_kernel<KIND, 0, DENSE_ROWS, LANE>;
  }
}

template <int KIND>
static DenseFn dense_lane(int D, int lane) {
  switch (lane) {
    case BF16: return dense_for<KIND, BF16>(D);
    case INT8: return dense_for<KIND, INT8>(D);
    case INT4: return dense_for<KIND, INT4>(D);
    default: return dense_for<KIND, F32>(D);
  }
}

typedef void (*PqFn)(const unsigned char*, const float*, const int*,
                     unsigned*, float*, int*, int, int, int, int, int, int,
                     float, int, int, int);

static PqFn pq_for(int m) {
  switch (m) {
    case 1: return scan_pq_kernel<1, PQ_ROWS>;
    case 2: return scan_pq_kernel<2, PQ_ROWS>;
    case 3: return scan_pq_kernel<3, PQ_ROWS>;
    case 4: return scan_pq_kernel<4, PQ_ROWS>;
    case 5: return scan_pq_kernel<5, PQ_ROWS>;
    case 6: return scan_pq_kernel<6, PQ_ROWS>;
    case 7: return scan_pq_kernel<7, PQ_ROWS>;
    default: return scan_pq_kernel<8, PQ_ROWS>;
  }
}

typedef void (*CandFn)(const float*, const int*, const float*, const int*,
                       unsigned*, float*, int*, int, int, int, int, int, int,
                       float, int, const float*);

// candidate rows a lane a step (kernels/scan_topk.py _CAND_ROWS)
constexpr int CAND_ROWS = 2;

template <int KIND, int LANE>
static CandFn cand_for(int D, bool pair_loads) {
  if (D == 10) {
    if constexpr (LANE == F32)
      if (pair_loads) return scan_cand_kernel<KIND, 10, 2, CAND_ROWS, F32>;
    return scan_cand_kernel<KIND, 10, 1, CAND_ROWS, LANE>;
  }
  if (D == 11) return scan_cand_kernel<KIND, 11, 1, CAND_ROWS, LANE>;
  return scan_cand_kernel<KIND, 0, 1, CAND_ROWS, LANE>;
}

template <int KIND>
static CandFn cand_lane(int D, bool pair_loads, int lane) {
  switch (lane) {
    case BF16: return cand_for<KIND, BF16>(D, pair_loads);
    case INT8: return cand_for<KIND, INT8>(D, pair_loads);
    default: return cand_for<KIND, F32>(D, pair_loads);
  }
}

// Merge [B, S, k] split lists into [B, k] (merge_tree_kernel).
static int merge_tree(const float* pd, const int* pi, float* od, int* oi,
                      int B, int S, int k, cudaStream_t st,
                      const int* cand = nullptr, int C = 0) {
  const size_t per_warp = (size_t)16 * S * k;
  const int wm = (int)(SMEM_BUDGET / per_warp < (size_t)WARPS
                           ? SMEM_BUDGET / per_warp : (size_t)WARPS);
  const size_t bytes = per_warp * wm;
  cudaError_t e = cudaFuncSetAttribute(
      merge_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  merge_tree_kernel<<<(B + wm - 1) / wm, wm * 32, bytes, st>>>(
      pd, pi, od, oi, B, S, k, cand, C);
  return (int)cudaGetLastError();
}

// Shared memory of the exact scan: the selection machine, the query
// (general width only) and `stages` tiles of tm rows of stride ds; a
// narrow lane one float tile and two byte buffers each of rows and of
// scales (stage_lane in scan_topk_kernel).
static size_t dense_bytes(int D, int ds, int k, int tm, int stages,
                          bool query_in_smem, int lane = F32) {
  const size_t fixed =
      sel_bytes(k) + (query_in_smem ? (size_t)WARPS * D * 4 : 0);
  if (lane == F32) return fixed + (size_t)stages * tm * ds * 4;
  const size_t rawb = (size_t)((tm * row_bytes(lane, D) + 31) & ~15);
  const size_t scb = (size_t)((tm * scale_bytes(lane) + 31) & ~15);
  return fixed + (size_t)tm * ds * 4 + 2 * rawb + 2 * scb;
}

// The split arguments every slab entry checks: splits > 1 needs the
// part buffers, the threshold words, and a merge that fits.
static bool bad_split_args(int k, int splits, const void* thr,
                           const void* part_d, const void* part_i) {
  return k < 1 || k > KMAX || splits < 1 || splits > MAX_SPLITS ||
         (splits > 1 && (thr == nullptr || part_d == nullptr ||
                         part_i == nullptr || splits * k > MERGE_KEYS));
}

// slab [M, row_bytes(lane, D)] in the lane's element type (float32,
// bf16, int8, int4 packed), scale [M] (int8: float32, int4: f16; null
// otherwise), q [B, D] float32, q_idx [B] int32; with splits > 1 the
// threshold words and part lists as hs_scan_topk_cand takes them.
extern "C" int hs_scan_topk(const void* slab, const void* scale,
                            const float* q, const int* q_idx, unsigned* thr,
                            float* part_d, int* part_i, float* od, int* oi,
                            int B, int M, int D, int k, int col0, int n,
                            int exclude_self, float c, int kind, int lane,
                            int splits, void* stream) {
  if (bad_split_args(k, splits, thr, part_d, part_i) || D < 1 || kind < 0 ||
      kind > 2 || lane < F32 || lane > INT4 ||
      (scale_bytes(lane) > 0) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int ds = D | 1;  // odd row stride: lanes read distinct banks
  const bool qsm = lane == F32 ? D > 64 : D > LANE_DQ_MAX;
  // the widest tile with two stages that leaves several blocks an SM,
  // else the widest that fits at all, two stages before one (a narrow
  // lane always double-buffers its bytes)
  int tm = 0, stages = 0;
  for (size_t budget : {(size_t)56 * 1024, SMEM_BUDGET}) {
    for (int sg = 2; sg >= 1 && !tm; --sg)
      for (int t = 512; t >= 32 && !tm; t -= 32)
        if (dense_bytes(D, ds, k, t, sg, qsm, lane) <= budget) {
          tm = t;
          stages = lane == F32 ? sg : 1;
        }
    if (tm) break;
  }
  if (!tm) return (int)cudaErrorInvalidValue;
  const size_t bytes = dense_bytes(D, ds, k, tm, stages, qsm, lane);
  DenseFn fn = kind == POINCARE  ? dense_lane<POINCARE>(D, lane)
               : kind == LORENTZ ? dense_lane<LORENTZ>(D, lane)
                                 : dense_lane<EUCLIDEAN>(D, lane);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_split = (M + splits - 1) / splits;
  dim3 grid((B + WARPS - 1) / WARPS, splits);
  fn<<<grid, NT, bytes, st>>>(
      static_cast<const float*>(slab), q, q_idx, splits == 1 ? nullptr : thr,
      splits == 1 ? od : part_d, splits == 1 ? oi : part_i, B, M, D, ds, k,
      col0, n, exclude_self, c, rows_per_split, tm, stages,
      static_cast<const unsigned char*>(scale));
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return merge_tree(part_d, part_i, od, oi, B, splits, k, st);
}

extern "C" int hs_scan_topk_pq(const unsigned char* codes, const float* lut,
                               const int* q_idx, unsigned* thr, float* part_d,
                               int* part_i, float* od, int* oi, int B, int M,
                               int m, int k, int col0, int n,
                               int exclude_self, float c, int kind,
                               int splits, void* stream) {
  if (bad_split_args(k, splits, thr, part_d, part_i) || m < 1 || m > 8 ||
      kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  // the widest code tile that leaves several blocks an SM, else the
  // widest that fits
  const size_t fixed = sel_bytes(k) + (size_t)WARPS * m * 256 * 4;
  int tm = 0;
  for (size_t budget : {(size_t)56 * 1024, SMEM_BUDGET}) {
    for (int t = 2048; t >= 32 && !tm; t -= 32)
      if (fixed + 2 * (size_t)(((t * m + 16) + 15) & ~15) <= budget) tm = t;
    if (tm) break;
  }
  if (!tm) return (int)cudaErrorInvalidValue;
  const size_t bytes = fixed + 2 * (size_t)(((tm * m + 16) + 15) & ~15);
  PqFn fn = pq_for(m);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_split = (M + splits - 1) / splits;
  dim3 grid((B + WARPS - 1) / WARPS, splits);
  fn<<<grid, NT, bytes, st>>>(codes, lut, q_idx, splits == 1 ? nullptr : thr,
                              splits == 1 ? od : part_d,
                              splits == 1 ? oi : part_i, B, M, k, col0, n,
                              exclude_self, c, kind, rows_per_split, tm);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return merge_tree(part_d, part_i, od, oi, B, splits, k, st);
}

// table [N, D] in the lane's element type (float32, bf16 or int8),
// scale [N] float32 (int8 only, else null), cand [B, C] int32, q [B, D]
// f32, q_idx [B] int32; with splits > 1 the threshold words thr [B]
// (+inf bits) and the part lists part_d, part_i [B, splits, k]; od, oi
// [B, k].
extern "C" int hs_scan_topk_cand(const void* table, const float* scale,
                                 const int* cand, const float* q,
                                 const int* q_idx, unsigned* thr,
                                 float* part_d, int* part_i, float* od,
                                 int* oi, int B, int C, int N, int D, int k,
                                 int exclude_self, float c, int kind,
                                 int lane, int splits, void* stream) {
  if (bad_split_args(k, splits, thr, part_d, part_i) || D < 1 || C < 0 ||
      kind < 0 || kind > 2 || lane < F32 || lane > INT8 ||
      (lane == INT8) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool pair = D % 2 == 0 && reinterpret_cast<uintptr_t>(table) % 8 == 0;
  const CandFn fn = kind == POINCARE  ? cand_lane<POINCARE>(D, pair, lane)
                    : kind == LORENTZ ? cand_lane<LORENTZ>(D, pair, lane)
                                      : cand_lane<EUCLIDEAN>(D, pair, lane);
  const size_t bytes =
      sel_bytes(k) + (D == 10 || D == 11 ? 0 : (size_t)WARPS * D * 4);
  if (bytes > SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int per_split = (C + splits - 1) / splits;
  dim3 grid((B + WARPS - 1) / WARPS, splits);
  fn<<<grid, NT, bytes, st>>>(static_cast<const float*>(table), cand, q,
                              q_idx, splits == 1 ? nullptr : thr,
                              splits == 1 ? od : part_d,
                              splits == 1 ? oi : part_i, B, C, N, D, k,
                              exclude_self, c, per_split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return merge_tree(part_d, part_i, od, oi, B, splits, k, st, cand, C);
}
