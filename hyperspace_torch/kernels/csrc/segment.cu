// Sorted segment reductions over receiver-sorted edges, for sm_90a: the
// segment sum of [E, F] rows, the attention backward's fused edge pass
// and the per-edge scalar sum or max.
//
// 1. `segsum_kernel` replaces hyperspace_tpu/kernels/segment.py
//    `csr_segment_sum` (the Pallas kernel `_pallas_csr`), which turns the
//    scatter into one-hot matrix products over a host-built (node block ×
//    edge chunk) plan because the TPU has no atomics and a slow scatter:
//        out[r] = Σ_{e: recv_e = r} vals_e     (bf16 or f32, f32 sums)
//    Bytes bound it: every value and receiver read once and each output
//    row written once, E·F·size + 4E + N·F·size over 3.35 TB/s (0.127 ms
//    at [1,467,392, 128] bf16, 0.033 at F = 32).
// 2. `att_edges_kernel` replaces `csr_att_bwd_edges` (segment.py:392,
//    which picks the receivers' (d_num | d_den) rows by one-hot products
//    from a VMEM block):
//        dpre_e = (<d_num[r], h_e> + d_den[r]) · w_e · (1 − (lm_e/B)²)
//                 · (lm_e ≥ 0 ? 1 : slope),     d_alpha_r[r] = Σ dpre_e,
//    reading the [E, F] residual rows and adding the d_den term itself
//    (no ones-column copy).  Bytes: E·(F·size + 16) + N·(4(F + 1) + 4),
//    0.143 ms at 1.44 M bf16 rows of 128, 0.041 at F = 32.
// 3. `reduce1d_kernel` replaces `csr_segment_reduce_1d` (segment.py:257,
//    whose TPU kernel keeps a [bn, 128] lane-partial accumulator per node
//    block and combines the lanes in XLA): sum, or max from the TPU
//    kernel's fill -3e38 (so an empty row reads -3e38), in one pass over
//    the edges with no row pointer.  The mean row holds about 8.5 edges,
//    so a warp a row would leave most lanes idle; instead a block takes a
//    tile of 1024 consecutive edges (4 a thread, read with 16-byte loads
//    when both arrays are 16-byte aligned), reduces runs of equal
//    receivers in registers and combines runs across threads by a
//    segmented scan (shuffles with head flags in a warp, shared memory
//    across warps).  A row belongs to the tile that holds its first edge:
//    a tile skips its leading edges whose receiver is that of the edge
//    before it, and when its last row runs past the tile, the whole block
//    walks the row's further edges (4096 a step, one block-wide sum at the
//    end), so a hub row is read by a block, never split between owners,
//    and needs no fix-up pass.  The thread that holds the edge after a gap
//    of receivers fills the empty rows between, or queues a gap of more
//    than 64 rows for the whole block to fill; with no edge at all every
//    row is filled.  Bytes: 8 B an edge and 4 B a row, about 0.004 ms at
//    1.4 M edges.
//
// What the design has to answer on this card: the mean row holds 8.7
// edges, and at F = 32 a bf16 row is 64 B, so the bytes in flight (some
// 16 KB an SM at 3.35 TB/s) must come from many rows at once, not from a
// row's own edges; the path's pitches (66 B at F = 33 bf16, 258 B at 129,
// 516 B (d_num | d_den) rows) rule out 16-byte loads row by row; a
// warp-wide reduction and a division on every lane for each edge cost B5
// more than its bytes; and a row-pointer pass costs a launch and a
// scratch buffer a call.  Both kernels stream the edges:
//   - The edges are cut into as many equal spans of whole chunks as the
//     card holds blocks at once (the occupancy API), one span a block.  A
//     block owns every row whose first edge lies in its span and skips
//     its leading edges that continue the row before; it reads on past
//     the span until its last row ends (the walk), so a hub row has one
//     owner and needs no fix-up pass.  The thread that finds a row's
//     first edge queues the empty rows between the key before it and the
//     row, zeroed by a warp (the block for a long run); the rows below the
//     first receiver and above the last are the fill blocks' at the
//     grid's end.  One launch, no row pointer, no atomics on outputs:
//     each row is summed by one block in a fixed order, so the result is
//     bitwise repeatable.
//   - The block streams its span in chunks of t edges (about TILE_BYTES,
//     ATT_TILE_BYTES of values) through two shared-memory buffers: the
//     next chunk's copy is issued before this chunk is summed.  Since the
//     edges are sorted and the rows row-major, a chunk's values are one
//     contiguous span: 16-byte `cp.async` for its aligned middle, element
//     copies for the head and tail (loaded into registers at issue,
//     stored just before the wait; no byte outside the span is read), so
//     any row pitch (66 B at F = 33 bf16, 258 B at 129) and any data_ptr
//     take the same path.  The row that runs into the next chunk is
//     carried: its partial sums stay in shared memory.
//   - B1 gives a thread a (row, W columns), consecutive threads on
//     consecutive columns, and sums the row's edges in edge order after
//     the carried part; W = 2 (bf16x2 or float2 loads and stores) when F
//     is even and the rows start pair-aligned, else 1.
//   - B5 gives an edge a group of G lanes (1, or more when a chunk holds
//     fewer edges than the block threads, as wide rows do), so the dot
//     needs no warp-wide reduction and the division and the `edge_dpre`
//     chain run once an edge.  Each group starts its columns 4 bytes
//     further than the last (wrapping), so the lanes' reads of h and of
//     the (d_num | d_den) rows fall in different banks at any pitch.  The
//     chunk's rows (d_num | d_den) are copied into shared memory once for
//     all their edges, before the next chunk's copy is issued, so that
//     waiting for them leaves that copy in flight; w and lm are loaded
//     before the dot.  A thread a row sums its dpre in edge order after
//     the carried part.
//   Registers (nvcc -Xptxas -v, sm_90a): 63-64 for segsum_kernel and
//   61-63 for att_edges_kernel, no spills.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_FILL = -3.0e38f;  // the TPU kernel's max fill

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// W consecutive elements of T as one load and store: the column pairs of
// an even width whose rows start 2·sizeof(T)-aligned
template <typename T, int W>
struct Vec {
  T x;
};
template <>
struct Vec<float, 2> {
  float2 x;
};
template <>
struct Vec<__nv_bfloat16, 2> {
  __nv_bfloat162 x;
};
__device__ __forceinline__ void add_to(float (&a)[1], Vec<float, 1> v) {
  a[0] += v.x;
}
__device__ __forceinline__ void add_to(float (&a)[1],
                                       Vec<__nv_bfloat16, 1> v) {
  a[0] += __bfloat162float(v.x);
}
__device__ __forceinline__ void add_to(float (&a)[2], Vec<float, 2> v) {
  a[0] += v.x.x;
  a[1] += v.x.y;
}
__device__ __forceinline__ void add_to(float (&a)[2],
                                       Vec<__nv_bfloat16, 2> v) {
  const float2 u = __bfloat1622float2(v.x);
  a[0] += u.x;
  a[1] += u.y;
}
__device__ __forceinline__ void store_vec(float* p, const float (&a)[1]) {
  *p = a[0];
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&a)[1]) {
  *p = __float2bfloat16_rn(a[0]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&a)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&a)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a[0], a[1]);
}

constexpr int R1D_THREADS = 256;
constexpr int R1D_EDGES = 4;                         // edges a thread
constexpr int R1D_TILE = R1D_THREADS * R1D_EDGES;    // edges a block owns
constexpr int R1D_WALK = 4 * R1D_TILE;               // edges a walk step
constexpr int NO_ROW = INT_MAX;                      // past the last edge
constexpr int R1D_GAP = 64;       // a longer run of empty rows is queued
constexpr int R1D_GAPQ = 32;      // gaps a block queues; the rest are
                                  // filled by the thread that found them

template <bool MAX>
__device__ __forceinline__ float r1d_op(float a, float b) {
  return MAX ? fmaxf(a, b) : a + b;
}

// edges [i, i + 4) of (vals, recv); past `e` a key of NO_ROW and `fill`
__device__ __forceinline__ void load4(const float* __restrict__ vals,
                                      const int* __restrict__ recv, int i,
                                      int e, bool vec, float fill,
                                      float (&v)[R1D_EDGES],
                                      int (&k)[R1D_EDGES]) {
  if (vec && i + R1D_EDGES <= e) {
    const float4 a = *reinterpret_cast<const float4*>(vals + i);
    const int4 b = *reinterpret_cast<const int4*>(recv + i);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    k[0] = b.x; k[1] = b.y; k[2] = b.z; k[3] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < R1D_EDGES; ++u) {
      const bool in = i + u < e;
      v[u] = in ? vals[i + u] : fill;
      k[u] = in ? recv[i + u] : NO_ROW;
    }
  }
}

// fills the empty rows [lo, hi): a long run goes to the block's queue
// while it has room, the rest the calling thread writes itself
__device__ __forceinline__ void fill_rows(float* __restrict__ out, int lo,
                                          int hi, float fill, int* n_gap,
                                          int2* gaps) {
  if (hi - lo > R1D_GAP) {
    const int q = atomicAdd(n_gap, 1);
    if (q < R1D_GAPQ) {
      gaps[q] = make_int2(lo, hi);
      return;
    }
  }
  for (int r = lo; r < hi; ++r) out[r] = fill;
}

template <bool MAX>
__global__ void __launch_bounds__(R1D_THREADS)
reduce1d_kernel(const float* __restrict__ vals, const int* __restrict__ recv,
                float* __restrict__ out, int e, int n) {
  __shared__ float w_agg[R1D_THREADS / 32];
  __shared__ int w_head[R1D_THREADS / 32];
  __shared__ int walk_key;
  __shared__ float walk_val;
  __shared__ int2 gaps[R1D_GAPQ];
  __shared__ int n_gap;
  const float fill = MAX ? NEG_FILL : 0.0f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (e == 0) {                          // no edge: every row is empty
    const int r = blockIdx.x * R1D_THREADS + tid;
    if (r < n) out[r] = fill;
    return;
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(recv)) & 15) == 0;
  const int s0 = blockIdx.x * R1D_TILE, end = min(s0 + R1D_TILE, e);
  const int skip = s0 > 0 ? recv[s0 - 1] : -1;  // an earlier tile's row
  const int i0 = s0 + R1D_EDGES * tid;
  float v[R1D_EDGES];
  int k[R1D_EDGES];
  load4(vals, recv, i0, end, vec, fill, v, k);
  const int before = i0 == 0 ? -1 : (i0 < end ? recv[i0 - 1] : NO_ROW);
  const int after = i0 + R1D_EDGES < e ? recv[i0 + R1D_EDGES] : NO_ROW;
  if (tid == 0) {
    walk_key = -1;
    n_gap = 0;
  }

  // the thread's trailing run (from its last head) and whether it has one
  float tail = fill;
  bool head = false;
#pragma unroll
  for (int u = 0; u < R1D_EDGES; ++u) {
    const bool h = k[u] != (u == 0 ? before : k[u - 1]);
    tail = r1d_op<MAX>(h ? fill : tail, v[u]);
    head = head || h;
  }
  // segmented inclusive scan over the warp, then the exclusive carry
  float agg = tail;
  bool flag = head;
#pragma unroll
  for (int dd = 1; dd < 32; dd <<= 1) {
    const float ao = __shfl_up_sync(FULL, agg, dd);
    const bool fo = __shfl_up_sync(FULL, flag, dd);
    if (lane >= dd) {
      if (!flag) agg = r1d_op<MAX>(ao, agg);
      flag = flag || fo;
    }
  }
  if (lane == 31) {
    w_agg[warp] = agg;
    w_head[warp] = flag;
  }
  float carry = __shfl_up_sync(FULL, agg, 1);
  bool carry_head = __shfl_up_sync(FULL, flag, 1);
  if (lane == 0) {
    carry = fill;
    carry_head = false;
  }
  __syncthreads();
  if (!carry_head) {                    // the run reaches into earlier warps
    float wc = fill;
    for (int w = 0; w < warp; ++w)
      wc = w_head[w] ? w_agg[w] : r1d_op<MAX>(wc, w_agg[w]);
    carry = r1d_op<MAX>(wc, carry);
  }

  // write each owned run that ends here; fill the empty rows before each
  // edge (and after the last one)
  float run = carry;
#pragma unroll
  for (int u = 0; u < R1D_EDGES; ++u) {
    const int i = i0 + u;
    if (i >= end) break;
    const int prev = u == 0 ? before : k[u - 1];
    fill_rows(out, max(prev + 1, 0), min(k[u], n), fill, &n_gap, gaps);
    if (i == e - 1) fill_rows(out, max(k[u] + 1, 0), n, fill, &n_gap, gaps);
    run = r1d_op<MAX>(k[u] != prev ? fill : run, v[u]);
    const int next = u + 1 < R1D_EDGES ? k[u + 1] : after;
    if (k[u] == skip || (next == k[u] && i + 1 < end)) continue;
    if (next == k[u]) {                 // the tile's last row runs on
      walk_key = k[u];
      walk_val = run;
    } else {
      out[k[u]] = run;
    }
  }
  __syncthreads();
  for (int g = 0; g < min(n_gap, R1D_GAPQ); ++g)   // the queued gaps
    for (int r = gaps[g].x + tid; r < gaps[g].y; r += R1D_THREADS)
      out[r] = fill;
  const int wk = walk_key;
  if (wk < 0) return;
  // the block walks the rest of its last row, 4096 edges a step, and
  // sums once at the end in a fixed order
  float acc = fill;
  for (int p = end; p < e; p += R1D_WALK) {
#pragma unroll
    for (int c = 0; c < R1D_WALK / R1D_TILE; ++c) {
      load4(vals, recv, p + c * R1D_TILE + R1D_EDGES * tid, e, vec, fill, v,
            k);
#pragma unroll
      for (int u = 0; u < R1D_EDGES; ++u)
        if (k[u] == wk) acc = r1d_op<MAX>(acc, v[u]);
    }
    if (recv[min(p + R1D_WALK, e) - 1] != wk) break;
  }
#pragma unroll
  for (int dd = 16; dd > 0; dd >>= 1)
    acc = r1d_op<MAX>(acc, __shfl_xor_sync(FULL, acc, dd));
  if (lane == 0) w_agg[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = walk_val;
    for (int w = 0; w < R1D_THREADS / 32; ++w)
      total = r1d_op<MAX>(total, w_agg[w]);
    out[wk] = total;
  }
}


// --- the streaming scheme of B1 and B5 ----------------------------------------

constexpr int SEG_NT = 256;        // threads of a segment-sum block
constexpr int ATT_NT = 128;        // threads of an edge-pass block
constexpr int TILE_BYTES = 24576;  // a chunk's values, about: B1
constexpr int ATT_TILE_BYTES = 16384;  // and B5
constexpr int TILE_MAX = 1024;     // edges a chunk, at most
constexpr int DN_BYTES = 8192;     // B5's staged (d_num | d_den) rows, about
constexpr int FILL_ROWS = 2048;    // rows a fill block covers
constexpr int GAPQ = 64;           // gaps a block queues a chunk
constexpr int GAP_WARP = 1024;     // a longer gap is zeroed by the block
constexpr int MAX_SMEM = 232448;   // shared memory a block may use

// shared-memory slots: the count of queued gaps, and B5's carried row
// sums (two, by chunk parity)
enum { M_NGAP, M_C0, M_C1, M_SLOTS };

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

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the keys of edges [i0, i0 + cnt) into keys (shared address skeys): -1
// before the first edge, NO_ROW past the last
template <int NT>
__device__ __forceinline__ void stage_keys(int* keys, unsigned skeys,
                                           const int* __restrict__ recv,
                                           long long i0, int cnt, int e) {
  for (int k = threadIdx.x; k < cnt; k += NT) {
    const long long i = i0 + k;
    if (i < 0)
      keys[k] = -1;
    else if (i >= e)
      keys[k] = NO_ROW;
    else
      cp_async4(skeys + 4u * k, recv + i);
  }
}

// The head and tail elements of a staged span, loaded into registers when
// the copy is issued and stored into shared memory just before it is
// waited for, so that no thread stalls on them while it issues copies.
template <typename T>
struct Pend {
  T v[2];
  T* d[2];
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (d[k] != nullptr) *d[k] = v[k];
  }
};

// `len` elements from src (any element alignment) into buf (16-byte
// aligned, shared address sbuf) so that element i lands at byte
// o + i·sizeof(T), o = src mod 16: 16-byte cp.async for the aligned
// middle, element copies for the head and tail (held in `pd` until
// pd.flush()).  No byte outside the span is read.  Returns o.
template <typename T, int NT>
__device__ __forceinline__ int stage_span(unsigned char* buf, unsigned sbuf,
                                          const T* src, int len,
                                          Pend<T>& pd) {
  constexpr int S = (int)sizeof(T);
  const int o = (int)((uintptr_t)src & 15);
  const int bytes = len * S;
  const int hb = min((16 - o) & 15, bytes);
  const int nch = (bytes - hb) >> 4;
  const int tail = (hb + (nch << 4)) / S;
  T* dst = reinterpret_cast<T*>(buf + o);
  const unsigned char* s8 = reinterpret_cast<const unsigned char*>(src) + hb;
  const unsigned d8 = sbuf + (unsigned)(o + hb);
  for (int c = threadIdx.x; c < nch; c += NT)
    cp_async16(d8 + 16u * c, s8 + 16 * c);
  // at most 15 bytes each: fewer elements than threads
  const int i = threadIdx.x, j = tail + (int)threadIdx.x;
  pd.d[0] = i < hb / S ? dst + i : nullptr;
  pd.d[1] = j < len ? dst + j : nullptr;
  if (pd.d[0] != nullptr) pd.v[0] = src[i];
  if (pd.d[1] != nullptr) pd.v[1] = src[j];
  return o;
}

// exclusive prefix sum of v over the block, and the block's total
template <int NT>
__device__ __forceinline__ int block_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int off = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int s = scratch[w];
    off += w < warp ? s : 0;
    total += s;
  }
  return off + x - v;
}

// A block owns the edges [s_lo, s_hi) and streams them through shared
// memory in chunks of t edges (values and the chunk's keys, with the key
// before and after it), double-buffered: the next chunk is copied while
// this one is summed.  A row the block owns may run past s_hi; the block
// then reads on (the walk) until it ends.  Across chunks it carries one
// open row: the last row of a chunk when it runs into the next.
struct Stream {
  int cn;     // the chunk's edges
  bool walk;  // past s_hi: only the open row's edges are the block's
  bool open;  // it begins with the row carried from the chunk before
  bool cont;  // its last segment runs into the next chunk
  bool next;  // the next chunk is needed
};

// kw[i] is the key of edge p − 1 + i, for i in [0, t + 2).
__device__ __forceinline__ Stream chunk_state(const int* kw, int p, int t,
                                              int e, int s_hi, bool open,
                                              int okey) {
  Stream c;
  c.cn = min(t, e - p);
  c.walk = p >= s_hi;
  c.open = open;
  // the chunk's last edge is the block's: the open row's in a walk, else
  // unless the block has only met an earlier block's row so far
  const bool last = c.walk ? kw[c.cn] == okey : (open || kw[c.cn] != kw[0]);
  c.cont = last && c.cn == t && p + t < e && kw[c.cn + 1] == kw[c.cn];
  c.next = p + t < s_hi || c.cont;
  return c;
}

// The chunk's segments: seg[s] is the first edge (chunk-relative) of the
// s-th row the block sums here, seg[ns] the end of the last.  Segment 0
// is the open row when the chunk begins with it; the others are the rows
// whose first edge lies in the chunk (none in a walk, which holds only
// the open row's edges, a prefix).  Edges before the first segment belong
// to an earlier block's row.  rowof[i], when given, is the segment of
// edge i.  The thread that finds a row's first edge queues the empty rows
// between the key before it and the row for fill_queued (or zeros them
// itself when the queue is full; rows [lo, hi) are elements [lo·f, hi·f)
// of out); the rows before the first edge are the fill blocks'.  Returns
// ns; ends with the block synchronised.
template <typename T, int NT>
__device__ __forceinline__ int chunk_segments(const int* kw, const Stream& c,
                                              int okey, int* seg, int* rowof,
                                              int* misc, int* scratch,
                                              int* gq, T* __restrict__ out,
                                              int f, int n) {
  constexpr int EPT = TILE_MAX / NT;
  const int i0 = threadIdx.x * EPT;
  int cnt = 0;
  if (threadIdx.x == 0) misc[M_NGAP] = 0;
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int i = i0 + u;
    if (i < c.cn) cnt += c.walk ? kw[i + 1] == okey : kw[i + 1] != kw[i];
  }
  int total;
  int pos = block_scan<NT>(cnt, scratch, total);
  const int o = c.open ? 1 : 0;
  int run = o + pos - 1;
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int i = i0 + u;
    if (i < c.cn) {
      if (!c.walk && kw[i + 1] != kw[i]) {
        seg[o + pos++] = i;
        ++run;
        const int lo = kw[i] + 1, hi = min(kw[i + 1], n);
        if (lo > 0 && hi > lo) {
          const int q = atomicAdd(&misc[M_NGAP], 1);
          if (q < GAPQ) {
            gq[2 * q] = lo;
            gq[2 * q + 1] = hi;
          } else {
            for (size_t x = (size_t)lo * f; x < (size_t)hi * f; ++x)
              store(out + x, 0.0f);
          }
        }
      }
      if (rowof != nullptr) rowof[i] = c.walk ? 0 : run;
    }
  }
  const int ns = c.walk ? 1 : o + total;
  if (threadIdx.x == 0) {
    if (c.open) seg[0] = 0;
    seg[ns] = c.walk ? total : c.cn;
  }
  __syncthreads();
  return ns;
}

// The gaps chunk_segments queued, zeroed a warp a gap, the whole block a
// gap of more than GAP_WARP elements.
template <typename T, int NT>
__device__ __forceinline__ void fill_queued(T* __restrict__ out,
                                            const int* misc, const int* gq,
                                            int f) {
  const int ng = min(misc[M_NGAP], GAPQ), lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < ng; g += NT / 32) {
    const size_t lo = (size_t)gq[2 * g] * f, hi = (size_t)gq[2 * g + 1] * f;
    if (hi - lo <= GAP_WARP)
      for (size_t x = lo + lane; x < hi; x += 32) store(out + x, 0.0f);
  }
  for (int g = 0; g < ng; ++g) {
    const size_t lo = (size_t)gq[2 * g] * f, hi = (size_t)gq[2 * g + 1] * f;
    if (hi - lo > GAP_WARP)
      for (size_t x = lo + threadIdx.x; x < hi; x += NT) store(out + x, 0.0f);
  }
}

// A fill block: zeros the rows of its FILL_ROWS that lie below the first
// receiver or above the last (every row when there is no edge).
template <typename T, int NT>
__device__ __forceinline__ void fill_outside(T* __restrict__ out,
                                             const int* __restrict__ recv,
                                             int e, int f, int n, int b) {
  const int r0 = b * FILL_ROWS, r1 = min(r0 + FILL_ROWS, n);
  const int first = e > 0 ? recv[0] : n;
  const int last = e > 0 ? recv[e - 1] : n;
  const int spans[2][2] = {{r0, min(r1, first)}, {max(r0, last + 1), r1}};
#pragma unroll
  for (int k = 0; k < 2; ++k)
    for (size_t x = (size_t)spans[k][0] * f + threadIdx.x;
         x < (size_t)spans[k][1] * f; x += NT)
      store(out + x, 0.0f);
}

__host__ __device__ __forceinline__ size_t round16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// bytes of one of a block's two value buffers: a chunk and the slack of
// its alignment
__host__ __device__ __forceinline__ size_t chunk_bytes(int t, size_t rowb) {
  return round16((size_t)t * rowb + 16);
}

// --- B1: the segment sum --------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(SEG_NT)
segsum_kernel(const T* __restrict__ vals, const int* __restrict__ recv,
              T* __restrict__ out, int e, int f, int n, int t, int span,
              int nblk) {
  constexpr int NT = SEG_NT;
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x >= nblk) {
    fill_outside<T, NT>(out, recv, e, f, n, (int)blockIdx.x - nblk);
    return;
  }
  const int tk = t + 2;                        // a chunk's keys
  int* keys = reinterpret_cast<int*>(smem);    // 2 · tk
  int* seg = keys + 2 * tk;                    // t + 2
  int* misc = seg + t + 2;                     // M_SLOTS
  int* scratch = misc + M_SLOTS;               // NT / 32
  int* gq = scratch + NT / 32;                 // 2 · GAPQ
  float* wsum = reinterpret_cast<float*>(gq + 2 * GAPQ);   // 2 · f
  const size_t boff =
      round16((size_t)(2 * tk + t + 2 + M_SLOTS + NT / 32 + 2 * GAPQ) * 4
              + (size_t)2 * f * 4);
  unsigned char* buf = smem + boff;
  const size_t cb = chunk_bytes(t, (size_t)f * sizeof(T));
  const unsigned sb = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned sbuf = sb + (unsigned)boff;

  const int s_lo = blockIdx.x * span, s_hi = min(s_lo + span, e);
  int oo[2];
  Pend<T> pv;
  stage_keys<NT>(keys, sb, recv, (long long)s_lo - 1, tk, e);
  oo[0] = stage_span<T, NT>(buf, sbuf, vals + (size_t)s_lo * f,
                            (min(s_lo + t, e) - s_lo) * f, pv);
  cp_commit();
  bool open = false;
  int okey = -1;
  for (int k = 0, p = s_lo;; ++k, p += t) {
    const int cur = k & 1, nxt = cur ^ 1;
    const int* kw = keys + cur * tk;
    pv.flush();
    cp_wait<0>();
    __syncthreads();
    const Stream c = chunk_state(kw, p, t, e, s_hi, open, okey);
    if (c.next) {               // the next chunk's copy overlaps this one
      const int pn = p + t;
      stage_keys<NT>(keys + nxt * tk, sb + 4u * nxt * tk, recv, pn - 1, tk,
                     e);
      oo[nxt] = stage_span<T, NT>(buf + nxt * cb, sbuf + (unsigned)(nxt * cb),
                                  vals + (size_t)pn * f,
                                  (min(pn + t, e) - pn) * f, pv);
      cp_commit();
    }
    const int ns = chunk_segments<T, NT>(kw, c, okey, seg, nullptr, misc,
                                         scratch, gq, out, f, n);
    fill_queued<T, NT>(out, misc, gq, f);
    // a thread a (segment, W columns), consecutive threads on
    // consecutive columns; each segment's edges summed in order after the
    // carried part of the open row
    using V = Vec<T, W>;
    const int fw = f / W;       // W-column groups a row
    const V* tv = reinterpret_cast<const V*>(buf + cur * cb + oo[cur]);
    const float* cin = wsum + cur * f;
    float* cout = wsum + nxt * f;
    int s = threadIdx.x / fw, col = threadIdx.x - s * fw;
    const int ds = NT / fw, dc = NT - ds * fw;
    while (s < ns) {
      const int a = seg[s], b = seg[s + 1];
      const V* q = tv + (size_t)a * fw + col;
      float acc[W];
#pragma unroll
      for (int u = 0; u < W; ++u)
        acc[u] = s == 0 && open ? cin[W * col + u] : 0.0f;
      for (int i = a; i < b; ++i, q += fw) add_to(acc, *q);
      const int row = kw[a + 1];
      if (s == ns - 1 && c.cont) {
#pragma unroll
        for (int u = 0; u < W; ++u) cout[W * col + u] = acc[u];
      } else if ((unsigned)row < (unsigned)n) {
        store_vec(out + (size_t)row * f + W * col, acc);
      }
      col += dc;
      s += ds;
      if (col >= fw) {
        col -= fw;
        ++s;
      }
    }
    open = c.cont;
    okey = kw[c.cn];
    if (!c.next) break;
  }
}

// --- B5: the attention backward's edge pass --------------------------------

// dpre of one edge from its dot <d_num[r], h_e>, computed in the TPU
// kernel's order with explicitly rounded operations.
__device__ __forceinline__ float edge_dpre(float dot, float dden, float w,
                                           float lm, float bound,
                                           float slope) {
  const float q = __fdiv_rn(lm, bound);
  const float dw = __fadd_rn(dot, dden);
  const float t = __fmul_rn(__fmul_rn(dw, w),
                            __fsub_rn(1.0f, __fmul_rn(q, q)));
  return __fmul_rn(t, lm >= 0.0f ? 1.0f : slope);
}

// <dr, hr> over f columns from shared memory: lane g of a group of G
// lanes takes the columns r0 + g, r0 + g + G, ... (wrapping at f, the same
// trip count on every lane) in four partial sums; the group's lanes are
// then summed by butterfly, so that each holds the dot.
template <typename T, int G>
__device__ __forceinline__ float row_dot(const float* dr, const T* hr, int f,
                                         int r0, int g) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int c = r0 + g;
  c -= c >= f ? f : 0;
  int k = g;
  for (; k + 3 * G < f; k += 4 * G) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = fmaf(dr[c], to_f32(hr[c]), a[u]);
      c += G;
      c -= c >= f ? f : 0;
    }
  }
  for (; k < f; k += G) {
    a[0] = fmaf(dr[c], to_f32(hr[c]), a[0]);
    c += G;
    c -= c >= f ? f : 0;
  }
  float d = (a[0] + a[1]) + (a[2] + a[3]);
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) d += __shfl_xor_sync(FULL, d, m);
  return d;
}

// the (d_num | d_den) rows of segments [s0, s1) into dns, f1 floats each
template <int NT>
__device__ __forceinline__ void stage_dn(unsigned sdns,
                                         const float* __restrict__ dn,
                                         const int* kw, const int* seg,
                                         int s0, int s1, int f1, int n) {
  for (int it = threadIdx.x; it < (s1 - s0) * f1; it += NT) {
    const int j = it / f1, c = it - j * f1;
    const int row = min(max(kw[seg[s0 + j] + 1], 0), n - 1);
    cp_async4(sdns + 4u * it, dn + (size_t)row * f1 + c);
  }
}

// B5's pass with G lanes an edge (G = 1 when a chunk has as many edges
// as the block threads; more for wide rows, whose chunks are short).
template <typename T, int G>
__global__ void __launch_bounds__(ATT_NT)
att_edges_kernel(const float* __restrict__ dn, const T* __restrict__ h,
                 const float* __restrict__ w, const float* __restrict__ lm,
                 const int* __restrict__ recv, float* __restrict__ dpre,
                 float* __restrict__ dar, int e, int f, int n, int t,
                 int span, int dnr, int nblk, float bound, float slope) {
  constexpr int NT = ATT_NT;
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x >= nblk) {
    fill_outside<float, NT>(dar, recv, e, 1, n, (int)blockIdx.x - nblk);
    return;
  }
  const int tk = t + 2, f1 = f + 1;
  int* keys = reinterpret_cast<int*>(smem);    // 2 · tk
  int* seg = keys + 2 * tk;                    // t + 2
  int* rowof = seg + t + 2;                    // t
  int* misc = rowof + t;                       // M_SLOTS
  int* scratch = misc + M_SLOTS;               // NT / 32
  int* gq = scratch + NT / 32;                 // 2 · GAPQ
  float* dp = reinterpret_cast<float*>(gq + 2 * GAPQ);     // t
  float* dns = dp + t;                         // dnr · f1
  float* carry = reinterpret_cast<float*>(misc);
  const size_t boff =
      round16((size_t)(2 * tk + 2 * t + 2 + M_SLOTS + NT / 32 + 2 * GAPQ)
              * 4 + (size_t)(t + dnr * f1) * 4);
  unsigned char* buf = smem + boff;
  const size_t cb = chunk_bytes(t, (size_t)f * sizeof(T));
  const unsigned sb = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned sbuf = sb + (unsigned)boff;
  const unsigned sdns = sb + (unsigned)((unsigned char*)dns - smem);
  // lane g of an edge's group; the group's first column is 4 bytes
  // further than the last group's, so that the lanes' reads of h and of
  // the dn rows fall in different banks
  const int g = (int)threadIdx.x % G, slot = (int)threadIdx.x / G;
  const int r0 = (int)((((threadIdx.x & 31) / G) * (4 / sizeof(T))) % f);

  const int s_lo = blockIdx.x * span, s_hi = min(s_lo + span, e);
  int oo[2];
  Pend<T> pv;
  stage_keys<NT>(keys, sb, recv, (long long)s_lo - 1, tk, e);
  oo[0] = stage_span<T, NT>(buf, sbuf, h + (size_t)s_lo * f,
                            (min(s_lo + t, e) - s_lo) * f, pv);
  cp_commit();
  bool open = false;
  int okey = -1;
  for (int k = 0, p = s_lo;; ++k, p += t) {
    const int cur = k & 1, nxt = cur ^ 1;
    const int* kw = keys + cur * tk;
    pv.flush();
    cp_wait<0>();
    __syncthreads();
    const Stream c = chunk_state(kw, p, t, e, s_hi, open, okey);
    const int ns = chunk_segments<float, NT>(kw, c, okey, seg, rowof, misc,
                                             scratch, gq, dar, 1, n);
    // the first rows' (d_num | d_den) before the next chunk's copy, so
    // that waiting for them leaves the copy in flight
    stage_dn<NT>(sdns, dn, kw, seg, 0, min(ns, dnr), f1, n);
    cp_commit();
    if (c.next) {
      const int pn = p + t;
      stage_keys<NT>(keys + nxt * tk, sb + 4u * nxt * tk, recv, pn - 1, tk,
                     e);
      oo[nxt] = stage_span<T, NT>(buf + nxt * cb, sbuf + (unsigned)(nxt * cb),
                                  h + (size_t)pn * f,
                                  (min(pn + t, e) - pn) * f, pv);
      cp_commit();
    }
    fill_queued<float, NT>(dar, misc, gq, 1);
    const T* tv = reinterpret_cast<const T*>(buf + cur * cb + oo[cur]);
    const float cin = carry[M_C0 + cur];
    for (int s0 = 0; s0 < ns; s0 += dnr) {
      const int s1 = min(ns, s0 + dnr);
      if (s0 > 0) {             // more rows than dns holds: the next batch
        stage_dn<NT>(sdns, dn, kw, seg, s0, s1, f1, n);
        cp_commit();
        cp_wait<0>();
      } else if (c.next) {
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      // an edge a group of G lanes, every lane through the loop (the
      // group's butterfly needs all of them)
      for (int i0 = seg[s0]; i0 < seg[s1]; i0 += NT / G) {
        const int i = min(i0 + slot, seg[s1] - 1);
        const float wv = w[p + i], lv = lm[p + i];
        const float* dr = dns + (rowof[i] - s0) * f1;
        const float dot = row_dot<T, G>(dr, tv + (size_t)i * f, f, r0, g);
        if (i0 + slot < seg[s1] && g == 0) {
          const float q = edge_dpre(dot, dr[f], wv, lv, bound, slope);
          dpre[p + i] = q;
          dp[i] = q;
        }
      }
      __syncthreads();
      // a segment's dpre summed in edge order by its thread, after the
      // carried part of the open row
      for (int s = s0 + threadIdx.x; s < s1; s += NT) {
        float sum = s == 0 && open ? cin : 0.0f;
        for (int i = seg[s]; i < seg[s + 1]; ++i) sum += dp[i];
        const int row = kw[seg[s] + 1];
        if (s == ns - 1 && c.cont)
          carry[M_C0 + nxt] = sum;
        else if ((unsigned)row < (unsigned)n)
          dar[row] = sum;
      }
      __syncthreads();
    }
    open = c.cont;
    okey = kw[c.cn];
    if (!c.next) break;
  }
}


// The launch geometry of a streaming kernel: t edges a chunk (about
// TILE_BYTES of values), and the edges of [0, e) cut into as many equal
// spans of whole chunks as the card holds blocks at once; the fill
// blocks follow.
struct Geom {
  int t, span, nblk, nfill;
};

template <typename K>
int stream_geom(K kernel, int nt, size_t smem, int e, int n, int t,
                Geom& g) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, nt, smem)) != cudaSuccess)
    return (int)err;
  const long long chunks = ((long long)e + t - 1) / t;
  const long long resident = std::max(1LL, (long long)sms * per_sm);
  const long long per_blk = std::max(1LL, (chunks + resident - 1) / resident);
  g.t = t;
  g.span = (int)std::min<long long>(per_blk * t, INT_MAX / 2);
  g.nblk = (int)((e + (long long)g.span - 1) / g.span);
  g.nfill = (n + FILL_ROWS - 1) / FILL_ROWS;
  return 0;
}

int chunk_edges(size_t rowb, int tile_bytes) {
  return (int)std::max<size_t>(1, std::min<size_t>(tile_bytes / rowb,
                                                    TILE_MAX));
}

template <typename T, int W>
int launch_segsum(const void* vals, const int* recv, void* out, int e, int f,
                  int n, cudaStream_t s) {
  const size_t rowb = (size_t)f * sizeof(T);
  const int t = chunk_edges(rowb, TILE_BYTES);
  const size_t smem =
      round16((size_t)(3 * t + 6 + M_SLOTS + SEG_NT / 32 + 2 * GAPQ) * 4
              + (size_t)2 * f * 4)
      + 2 * chunk_bytes(t, rowb);
  Geom g;
  const int err =
      stream_geom(segsum_kernel<T, W>, SEG_NT, smem, e, n, t, g);
  if (err) return err;
  segsum_kernel<T, W><<<g.nblk + g.nfill, SEG_NT, smem, s>>>(
      (const T*)vals, recv, (T*)out, e, f, n, g.t, g.span, g.nblk);
  return 0;
}

template <typename T, int G>
int launch_att_g(const float* dn, const T* h, const float* w,
                 const float* lm, const int* recv, float* dpre, float* dar,
                 int e, int f, int n, int t, float bound, float slope,
                 cudaStream_t s) {
  const int dnr = (int)std::max<size_t>(
      1, std::min<size_t>(DN_BYTES / (4 * (size_t)(f + 1)), t + 1));
  const size_t smem =
      round16((size_t)(4 * t + 6 + M_SLOTS + ATT_NT / 32 + 2 * GAPQ) * 4
              + (size_t)(t + dnr * (f + 1)) * 4)
      + 2 * chunk_bytes(t, (size_t)f * sizeof(T));
  Geom g;
  const int err =
      stream_geom(att_edges_kernel<T, G>, ATT_NT, smem, e, n, t, g);
  if (err) return err;
  att_edges_kernel<T, G><<<g.nblk + g.nfill, ATT_NT, smem, s>>>(
      dn, h, w, lm, recv, dpre, dar, e, f, n, g.t, g.span, dnr, g.nblk,
      bound, slope);
  return 0;
}

// G lanes an edge: the most for which one pass of the block's lanes
// still covers a chunk
template <typename T>
int launch_att_edges(const float* dn, const void* h, const float* w,
                     const float* lm, const int* recv, float* dpre,
                     float* dar, int e, int f, int n, float bound,
                     float slope, cudaStream_t s) {
  const int t = chunk_edges((size_t)f * sizeof(T), ATT_TILE_BYTES);
  const T* hh = (const T*)h;
#define HS_ATT_G(G)                                                        \
  if (G * t <= ATT_NT)                                                     \
    return launch_att_g<T, G>(dn, hh, w, lm, recv, dpre, dar, e, f, n, t,  \
                              bound, slope, s);
  HS_ATT_G(32)
  HS_ATT_G(16)
  HS_ATT_G(8)
  HS_ATT_G(4)
  HS_ATT_G(2)
#undef HS_ATT_G
  return launch_att_g<T, 1>(dn, hh, w, lm, recv, dpre, dar, e, f, n, t,
                            bound, slope, s);
}

}  // namespace

// vals [e, f] (bf16 when `bf16` is non-zero, else f32), recv [e] int32
// ascending in [0, n), out [n, f] of the values' type.  One launch, no
// scratch.
extern "C" int hs_csr_segment_sum(const void* vals, const int* recv,
                                  void* out, int e, int f, int n, int bf16,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && f > 0) {
    // column pairs when every row starts at a pair boundary
    const size_t size = bf16 ? 2 : 4;
    const bool pairs = f % 2 == 0 && ((uintptr_t)vals | (uintptr_t)out)
                                             % (2 * size) == 0;
    const int err =
        bf16 ? (pairs ? launch_segsum<__nv_bfloat16, 2>(vals, recv, out, e,
                                                        f, n, s)
                      : launch_segsum<__nv_bfloat16, 1>(vals, recv, out, e,
                                                        f, n, s))
             : (pairs ? launch_segsum<float, 2>(vals, recv, out, e, f, n, s)
                      : launch_segsum<float, 1>(vals, recv, out, e, f, n, s));
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

// vals [e] f32, recv [e] int32 ascending in [0, n), out [n] f32; `max`
// non-zero for the maximum, else the sum.  One launch, no scratch.
extern "C" int hs_csr_segment_reduce_1d(const float* vals, const int* recv,
                                        float* out, int e, int n, int max,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const int blocks = e > 0 ? (e + R1D_TILE - 1) / R1D_TILE
                             : (n + R1D_THREADS - 1) / R1D_THREADS;
    if (max)
      reduce1d_kernel<true><<<blocks, R1D_THREADS, 0, s>>>(vals, recv, out,
                                                           e, n);
    else
      reduce1d_kernel<false><<<blocks, R1D_THREADS, 0, s>>>(vals, recv, out,
                                                            e, n);
  }
  return (int)cudaGetLastError();
}

// dn [n, f + 1] f32 (d_num | d_den), h [e, f] residual sender rows (bf16
// when `bf16` is non-zero, else f32), w and lm [e] f32, recv [e] int32
// ascending in [0, n); writes dpre [e] and dar [n], both f32.  One
// launch, no scratch.
extern "C" int hs_csr_att_bwd_edges(const float* dn, const void* h,
                                    const float* w, const float* lm,
                                    const int* recv, float* dpre, float* dar,
                                    int e, int f, int n, int bf16,
                                    float bound, float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && f > 0) {
    const int err =
        bf16 ? launch_att_edges<__nv_bfloat16>(dn, h, w, lm, recv, dpre, dar,
                                               e, f, n, bound, slope, s)
             : launch_att_edges<float>(dn, h, w, lm, recv, dpre, dar, e, f,
                                       n, bound, slope, s);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
