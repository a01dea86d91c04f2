// Ragged paged attention for Hopper (sm_90a): kernel B4 of the port.
//
// Replaces paddle_tpu/ops/paged_attention.py::paged_attention_kernel, the
// Pallas TPU kernel behind ragged_paged_attention(impl="pallas").
//
// Function. Token row t of q [T, H, d] attends the first lens[t] cached
// positions of its own block table tables[t, :]: position p lives in page
// tables[t, p / page_size] at row p % page_size of the pools
// [num_pages, page_size, KVH, d]. The H / KVH q heads of one group share a
// kv head. int8 pools carry one float32 scale per page row ([num_pages,
// page_size]) and are dequantized as value * scale. lens[t] == 0 gives a
// zero row; -1 table entries are read as page 0. Scores and the softmax
// are float32; the output has q's dtype. Any d, any page_size and any
// group H / KVH.
//
// Two routes; ops/paged_attention.py::paged_route names the one a
// launch takes, and the launcher takes only that one (no fallback).
//
// tile (paged_attention_plan + paged_attention_tile): d a multiple of 16
// up to 256, pages of a power of two from 8 rows, every dtype; the route
// sends it launches whose sequences hold _TILE_SEQ_ROWS live rows or more
// on average (the caller's seq_rows: prefill chunks, mixed ticks with few
// decode rows): on shorter runs (decode batches of any width, verify
// windows of 4, chunks of short prompts, mixed ticks with many decode
// rows) it was measured slower than simt, its fixed cost a launch (the
// plan) and an item not paid back by few rows. What bounds
// it on this card: at decode the bytes of K/V (each live page read once,
// ~4 operations a head a byte); on chunk, verify and mixed-tick tiles of
// up to 64 q vectors the bytes too for the half types and int8 (64 q
// vectors x 4 operations per element read is ~128 operations a byte of
// bf16, below the tensor cores' ~295), and at f32 the 3xTF32 operations
// (3 products of 4 operations per element per q vector against 495
// TFLOP/s of tf32 and 3.35 TB/s: ~2 tf32 operations a byte at the ridge).
// What the design does about it:
// - Every page a run reads comes in once per kv head: a run (the rows of
//   one sequence with rising limits and agreeing tables, times the GQA
//   group) is up to 64 q vectors, where the older kernel capped it at 32
//   (16 rows), so a 64-row prefill chunk reads each page once, not four
//   times.
// - No block starts without work. paged_attention_plan (one block, a
//   thread a row) finds the runs and lists (run, partition) items on the
//   card; a persistent grid of paged_attention_tile blocks (as many as the
//   card holds at once) walks items x (kv head, q-head tile). The older
//   grid of (partition x row x kv head) blocks, most of which exit after
//   reading the lens and comparing tables, spent most of a chunk or
//   mixed-tick launch starting such blocks.
// - Pages by TMA. One thread of a producer warp reads the partition's
//   page ids and streams K and V into a ring of 3-6 stages of 64 page
//   rows (fewer for f32 at d > 64 and the half types at d 256), each
//   page's rows one box per 128-byte panel of a tensor map over the pool
//   as (d, KVH, page_size, num_pages), 128-byte swizzled (int8: whole rows
//   unswizzled, the scales by bulk copies); full and empty mbarriers
//   between producer and consumers; pages past the partition read as
//   zeros (a page coordinate past the pool).
// - Products on the tensor cores by mma.sync. A consumer warp owns 16 q
//   vectors (the Q tile is loaded once per item and stays in shared
//   memory) and, where a run has fewer than 64 q vectors (decode, verify
//   windows), a slice of each stage's page rows, so all four consumer
//   warps work; the slices merge through shared memory. mma.sync and not
//   wgmma: f32 pools split K and V into tf32 hi + lo as each fragment is
//   loaded, which a wgmma B operand (shared memory only, K-major for
//   tf32) would need as four more copies of each stage, one transposed;
//   and the products bound no pool type here: the f32 tile does six
//   times bf16's tensor-core work (three tf32 products at half bf16's
//   rate) and takes ~1.3x its time at the gpt2 chunk, so bf16's products
//   are at most ~7% of its time (PERF.md, section 6), the most wgmma
//   could take off; the rest is each item's page stream and latency.
//   f32: 3xTF32 (hi = tf32(x), lo = tf32(x - hi); hi lo + lo hi + hi hi
//   for Q K^T and P V), ~2^-21 relative a product, well inside the 2e-5
//   limit, where one tf32 product is not. bf16 / f16: the pool's type, q
//   of another type as hi + lo, P rounded to the pool's type as B1 rounds
//   it. int8: each stage converted to bf16 in shared memory (exact), q
//   split into bf16 hi + lo, the K scale folded into S's columns and the V
//   scale into P's, P x scale split into bf16 hi + lo.
// - The online softmax stays float32 in registers (log2 units, each row
//   masked at its own limit); sums in a fixed order, so two launches give
//   the same bits.
//
// simt (paged_attention, or paged_attention_streamed where its stages
// would pass a block's shared memory, as the launcher decides): what the
// tile kernel does not take (shorter runs, d not a multiple of 16 or
// above 256, other page sizes, misaligned pools). The older design,
// flash-decoding on float32 FMAs: grid (partition, row, kv head), a
// block skipping rows that continue a run of up to 16 rows (one row a
// block, no table compared, where the caller says each row is a sequence
// of its own),
// stages of up to 64 page rows by cp.async of 16, 8, 4, 2 or 1 bytes
// into padded rows, two in flight; QK a page row a thread against staged
// q vectors; any d (past d 256 output-column tiles over grid axis z) and
// any page size (sub-stages of a page).
//
// The streamed kernel takes head dims whose staged rows pass a block's
// shared memory (past ~19K elements at f32): K, q and V from global
// memory over d in warp-strided slices, 32 page rows a pass.
//
// A row spanning several partitions writes float32 partials (m, l, acc);
// paged_attention_merge combines them in partition order, with no
// atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;    // page rows of K (and of V) in one stage
constexpr int kMaxQ = 32;       // q vectors of a block: run rows x head tile
constexpr int kMaxItems = 16;   // output elements a thread accumulates
constexpr int kMaxElems = kMaxItems * kThreads;  // q vectors x columns
constexpr int kMaxRun = 16;     // rows of one sequence in one block
constexpr int kStageBudget = 72 * 1024;  // bytes of the two K/V stages
constexpr int kQBudget = 8192;  // float32 q elements of a block (q x d)
constexpr int kMaxCols = 256;   // output columns of a block
constexpr float kLog2e = 1.4426950408889634f;

// dtype codes shared with paddle_tpu_torch/ops/paged_attention.py
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int32_t* tables;
  const int32_t* lens;
  void* out;
  float* part_ml;   // [T, H, n_parts, 2]: m (log2 units) and l
  float* part_acc;  // [T, H, n_parts, d]
  int q_dtype;
  int T, n_heads, kv_heads, d, page_size, pages_per_seq;
  int part_pages, n_parts, run_rows;
  // a stage: stage_pages whole pages (n_sub 1), or one stage_rows slice of
  // a page (n_sub sub-stages a page); stage_rows rows either way
  int stage_pages, n_sub, stage_rows;
  int head_tile, n_head_tiles;  // q heads of a block, tiles of a group
  int cols, n_col_tiles;        // output columns of a block, their tiles
  int max_q;  // q vectors of a block at most: run_rows x head_tile
  float scale;
  // the tile kernel: page rows a stage and a TMA box, ring depth, rows of
  // the Q tile, q split into hi + lo, the pool's page count (a page
  // coordinate past it reads zeros), the shared-memory layout (byte
  // offsets from the 1024-aligned base), a ring stage's size and the
  // bytes its TMA copies bring
  int rows, box_rows, stages, q_rows, split_q, num_pages;
  int q_off, ring_off, conv_off, scale_off, bar_off;
  int stage_size, stage_tx;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float load_f32(const void* p, int64_t i,
                                          int dtype) {
  switch (dtype) {
    case kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kF16:
      return __half2float(static_cast<const __half*>(p)[i]);
    default:
      return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_f32(void* p, int64_t i, float v,
                                          int dtype) {
  switch (dtype) {
    case kBF16:
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
      break;
    case kF16:
      static_cast<__half*>(p)[i] = __float2half(v);
      break;
    default:
      static_cast<float*>(p)[i] = v;
  }
}

// `bytes` (16, 8 or 4) from global to shared memory; with kNarrow, 2 or 1
// bytes are copied at once (the next barrier publishes them, like a
// landed cp.async)
template <bool kNarrow = false>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else if (!kNarrow || bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  else if (bytes == 2)
    *static_cast<uint16_t*>(smem) = *static_cast<const uint16_t*>(gmem);
  else
    *static_cast<uint8_t*>(smem) = *static_cast<const uint8_t*>(gmem);
}

// the widest copy (16, 8, 4, 2 or 1 bytes) that divides `bytes`
__host__ __device__ inline int chunk_bytes(int bytes) {
  return bytes % 16 == 0 ? 16
         : bytes % 8 == 0 ? 8
         : bytes % 4 == 0 ? 4
         : bytes % 2 == 0 ? 2 : 1;
}

// float32 q elements a staged q vector takes: d rounded up to 8, so each
// vector starts 16-byte aligned for the float4 reads
__host__ __device__ inline int q_stride(int d) { return (d + 7) / 8 * 8; }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 elements of a staged row, as float32
template <typename KV>
__device__ __forceinline__ void load8(float (&x)[8], const unsigned char* p);
template <>
__device__ __forceinline__ void load8<float>(float (&x)[8],
                                             const unsigned char* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(float (&x)[8],
                                                     const unsigned char* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load8<__half>(float (&x)[8],
                                              const unsigned char* p) {
  const __half2* h = reinterpret_cast<const __half2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load8<int8_t>(float (&x)[8],
                                              const unsigned char* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * i)));
    x[4 + i] = static_cast<float>(static_cast<int8_t>(u.y >> (8 * i)));
  }
}

// Whether row r continues row r - 1's run: both live, lens non-decreasing,
// and the tables equal over row r - 1's live pages. Every thread of the
// block calls it and gets the same answer.
__device__ bool joins(const Args& a, int r) {
  const int lp = a.lens[r - 1];
  if (lp <= 0 || a.lens[r] < lp) return false;
  const int n = (lp + a.page_size - 1) / a.page_size;
  const int32_t* prev = a.tables + static_cast<int64_t>(r - 1) *
                                       a.pages_per_seq;
  const int32_t* cur = prev + a.pages_per_seq;
  int differ = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    differ |= prev[i] != cur[i];
  return !__syncthreads_or(differ);
}

// Partitions of `part_pages` pages a row of length len spans.
__device__ __forceinline__ int parts_of(const Args& a, int len) {
  const int pages = (len + a.page_size - 1) / a.page_size;
  return (pages + a.part_pages - 1) / a.part_pages;
}

// bytes of a staged row of `cols` elements, padded by 16 (conflict-free
// row-wise reads)
__host__ __device__ inline int row_bytes(int kv_size, int cols) {
  return (cols * kv_size + 15) / 16 * 16 + 16;
}

// Dynamic shared memory: two stages of (K rows of all of d, V rows of the
// block's columns), then float32 q vectors, scores, int8 scales and
// softmax state.
__host__ __device__ inline size_t smem_bytes(int kv_size, int d, int cols,
                                             int stage_rows, int max_q) {
  return 2ull * stage_rows * (row_bytes(kv_size, d) + row_bytes(kv_size, cols)) +
         4ull * (max_q * q_stride(d) + max_q * kMaxRows + 4 * kMaxRows + kThreads +
                 3 * max_q + kMaxRun);
}

// kAnyD: a head dim that is not a multiple of 8 (narrow copies, a q
// stride rounded up, QK's tail columns); a multiple of 8 runs without them
template <typename KV, bool kAnyD>
__global__ void __launch_bounds__(kThreads) paged_attention(Args a) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const int pj = blockIdx.x;  // partition of the row's pages
  const int r = blockIdx.y;
  const int kvh = blockIdx.z / (a.n_head_tiles * a.n_col_tiles);
  const int tile = blockIdx.z % (a.n_head_tiles * a.n_col_tiles);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.n_heads / a.kv_heads;
  const int d = a.d;
  const int ps = a.page_size;
  // this block's q heads kvh G + g0 .. + gh and output columns c0 .. + dc
  const int g0 = tile / a.n_col_tiles * a.head_tile;
  const int gh = min(a.head_tile, G - g0);
  const int c0 = tile % a.n_col_tiles * a.cols;
  const int dc = min(a.cols, d - c0);
  const int head0 = kvh * G + g0;

  // the run of rows this block owns: r .. r1 - 1
  if (r % a.run_rows != 0 && joins(a, r)) return;
  int r1 = r + 1;
  while (r1 < a.T && r1 % a.run_rows != 0 && joins(a, r1)) ++r1;
  const int M = (r1 - r) * gh;  // q vectors: row-major (row, head)
  const int max_len = a.lens[r1 - 1];
  if (max_len <= 0) {  // a zero row, always a run of one
    if (pj == 0)
      for (int i = tid; i < gh * dc; i += kThreads)
        store_f32(a.out,
                  (static_cast<int64_t>(r) * a.n_heads + head0 + i / dc) * d +
                      c0 + i % dc,
                  0.f, a.q_dtype);
    return;
  }
  const int live = (max_len + ps - 1) / ps;
  const int p_begin = pj * a.part_pages;
  if (p_begin >= live) return;
  const int p_end = min(live, p_begin + a.part_pages);

  const int rbk = row_bytes(sizeof(KV), d);
  const int rbv = row_bytes(sizeof(KV), a.cols);
  const int stage_rows = a.stage_rows;
  const size_t stage_bytes = static_cast<size_t>(stage_rows) * (rbk + rbv);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv = smem;  // [stage][K rows | V rows]
  float* q_s = reinterpret_cast<float*>(smem + 2 * stage_bytes);
  const int qd = kAnyD ? q_stride(d) : d;
  float* s_s = q_s + a.max_q * qd;  // [max_q][kMaxRows]: scores, then P
  float* sc_s = s_s + a.max_q * kMaxRows;  // [stage][K | V][kMaxRows]
  float* red_s = sc_s + 4 * kMaxRows;  // [kThreads]: PV partial sums
  float* m_s = red_s + kThreads;
  float* l_s = m_s + a.max_q;
  float* al_s = l_s + a.max_q;
  int* len_s = reinterpret_cast<int*>(al_s + a.max_q);

  const int32_t* table = a.tables + static_cast<int64_t>(r1 - 1) *
                                        a.pages_per_seq;
  const int64_t row_stride = static_cast<int64_t>(a.kv_heads) * d *
                             sizeof(KV);  // bytes between page rows
  const int64_t head_off = static_cast<int64_t>(kvh) * d * sizeof(KV);
  // copies of a K row (all of d) and of a V row (columns c0 .. + dc),
  // each as wide as the row's bytes and its offset allow
  // (a multiple of 8: a V row of the block's columns never has more
  // chunks than a K row of all of d)
  const int kv_size = static_cast<int>(sizeof(KV));
  const int kchunk = kAnyD ? chunk_bytes(d * kv_size)
                           : (d * kv_size % 16 == 0 ? 16 : 8);
  const int kchunks = d * kv_size / kchunk;
  const int vchunk =
      kAnyD ? min(kchunk, chunk_bytes(dc * kv_size | c0 * kv_size))
            : (kchunk == 16 && a.cols * kv_size % 16 == 0 ? 16 : 8);
  const int vchunks = dc * kv_size / vchunk;
  const int nchunks = kAnyD ? max(kchunks, vchunks) : kchunks;
  // stage si: first page p0, first row of that page sub, rows rows
  auto stage_of = [&](int si, int& p0, int& sub, int& rows) {
    if (a.n_sub == 1) {
      p0 = p_begin + si * a.stage_pages;
      sub = 0;
      rows = min(a.stage_pages, p_end - p0) * ps;
    } else {
      p0 = p_begin + si / a.n_sub;
      sub = si % a.n_sub * stage_rows;
      rows = min(stage_rows, ps - sub);
    }
  };
  auto issue = [&](int si, int st) {
    int p0, sub, rows;
    stage_of(si, p0, sub, rows);
    unsigned char* kd = kv + st * stage_bytes;
    unsigned char* vd = kd + static_cast<size_t>(stage_rows) * rbk;
    // chunk ch of a row: K's, and V's
    for (int i = tid; i < rows * nchunks; i += kThreads) {
      const int rr = i / nchunks;
      const int ch = i - rr * nchunks;
      const int pr = sub + rr;  // row counted from the stage's first page
      const int page = max(table[p0 + pr / ps], 0);
      const int64_t g = (static_cast<int64_t>(page) * ps + pr % ps) *
                            row_stride +
                        head_off;
      if (!kAnyD || ch < kchunks)
        cp_async<kAnyD>(kd + rr * rbk + ch * kchunk,
                        static_cast<const unsigned char*>(a.k_pages) + g +
                            ch * kchunk,
                        kchunk);
      if (ch < vchunks)
        cp_async<kAnyD>(vd + rr * rbv + ch * vchunk,
                        static_cast<const unsigned char*>(a.v_pages) + g +
                            c0 * sizeof(KV) + ch * vchunk,
                        vchunk);
    }
    if (kQuant) {
      for (int i = tid; i < rows; i += kThreads) {
        const int pr = sub + i;
        const int64_t row =
            static_cast<int64_t>(max(table[p0 + pr / ps], 0)) * ps + pr % ps;
        cp_async(sc_s + (2 * st) * kMaxRows + i, a.k_scales + row, 4);
        cp_async(sc_s + (2 * st + 1) * kMaxRows + i, a.v_scales + row, 4);
      }
    }
    cp_async_commit();
  };

  issue(0, 0);
  // q vectors in log2 units: exp(x) = exp2(x * log2 e)
  const float qscale = a.scale * kLog2e;
  for (int i = tid; i < M * d; i += kThreads) {
    const int m = i / d;
    const int c = i - m * d;
    const int64_t src =
        (static_cast<int64_t>(r + m / gh) * a.n_heads + head0 + m % gh) * d +
        c;
    q_s[m * qd + c] = load_f32(a.q, src, a.q_dtype) * qscale;
  }
  if (tid < M) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  if (tid < r1 - r) len_s[tid] = a.lens[r + tid];
  float acc[kMaxItems];
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) acc[k] = 0.f;

  // QK: thread (kr, grp) scores stage row kr. With at least as many q
  // vectors as groups, group grp takes q vectors grp + ngrp * i over the
  // whole head dim; with fewer (decode), the groups split the head dim
  // into dparts interleaved 8-column parts and the softmax sums them;
  // part 0 also takes the last d % 8 columns.
  const int ngrp = kThreads / stage_rows;
  const int kr = tid % stage_rows;
  const int grp = tid / stage_rows;
  const int dparts = M < ngrp ? min(ngrp, a.max_q) / M : 1;
  const bool qk_active = grp < (dparts > 1 ? M * dparts : ngrp);
  const int m0 = dparts > 1 ? grp % M : grp;
  const int qstep = dparts > 1 ? M : ngrp;
  const int dpart = dparts > 1 ? grp / M : 0;
  // PV: thread owns output element i = tid % (M dc); with few elements
  // (decode), jsplit threads share one, each over every jsplit-th row
  const int items = M * dc;
  const int jsplit = 2 * items <= kThreads ? min(4, kThreads / items) : 1;
  // the last page's sub-stages stop at the longest row's end
  const int n_stages =
      a.n_sub == 1
          ? (p_end - p_begin + a.stage_pages - 1) / a.stage_pages
          : (p_end - p_begin - 1) * a.n_sub +
                (min(ps, max_len - (p_end - 1) * ps) + stage_rows - 1) /
                    stage_rows;
  for (int si = 0; si < n_stages; ++si) {
    const int st = si & 1;
    if (si + 1 < n_stages) {
      issue(si + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int p0, sub, rows;
    stage_of(si, p0, sub, rows);
    const int pos0 = p0 * ps + sub;
    const unsigned char* kd = kv + st * stage_bytes;
    const unsigned char* vd = kd + static_cast<size_t>(stage_rows) * rbk;
    const float* ksc = sc_s + (2 * st) * kMaxRows;
    const float* vsc = ksc + kMaxRows;

    // raw scores of stage row kr (partial over the head dim if dparts > 1)
    if (qk_active && kr < rows) {
      float s[kMaxQ / 2];
#pragma unroll
      for (int i = 0; i < kMaxQ / 2; ++i) s[i] = 0.f;
      const unsigned char* krow = kd + kr * rbk;
      const int d8 = kAnyD ? d & ~7 : d;
      for (int c = 8 * dpart; c < d8; c += 8 * dparts) {
        float x[8];
        load8<KV>(x, krow + c * sizeof(KV));
#pragma unroll
        for (int i = 0; i < kMaxQ / 2; ++i) {
          const int m = m0 + qstep * i;
          if (m >= M) break;
          const float4 qa =
              *reinterpret_cast<const float4*>(q_s + m * qd + c);
          const float4 qb =
              *reinterpret_cast<const float4*>(q_s + m * qd + c + 4);
          s[i] += qa.x * x[0] + qa.y * x[1] + qa.z * x[2] + qa.w * x[3] +
                  qb.x * x[4] + qb.y * x[5] + qb.z * x[6] + qb.w * x[7];
        }
      }
      if (kAnyD && dpart == 0)
        for (int c = d8; c < d; ++c) {
          const float x =
              to_f32(*reinterpret_cast<const KV*>(krow + c * sizeof(KV)));
#pragma unroll
          for (int i = 0; i < kMaxQ / 2; ++i) {
            const int m = m0 + qstep * i;
            if (m >= M) break;
            s[i] += q_s[m * qd + c] * x;
          }
        }
#pragma unroll
      for (int i = 0; i < kMaxQ / 2; ++i) {
        const int m = m0 + qstep * i;
        if (m >= M) break;
        s_s[(m + M * dpart) * kMaxRows + kr] = s[i];
      }
    }
    __syncthreads();

    // online softmax, one warp per q vector: the score (parts summed,
    // K's scale, the row's causal limit), then P (times V's scale) kept
    for (int m = warp; m < M; m += kWarps) {
      float* srow = s_s + m * kMaxRows;
      const int len = len_s[m / gh];
      float x0 = 0.f, x1 = 0.f;
      for (int dp = 0; dp < dparts; ++dp) {
        if (lane < rows) x0 += srow[dp * M * kMaxRows + lane];
        if (lane + 32 < rows) x1 += srow[dp * M * kMaxRows + lane + 32];
      }
      x0 = lane < rows && pos0 + lane < len
               ? x0 * (kQuant ? ksc[lane] : 1.f) : -INFINITY;
      x1 = lane + 32 < rows && pos0 + lane + 32 < len
               ? x1 * (kQuant ? ksc[lane + 32] : 1.f) : -INFINITY;
      const float m_old = m_s[m];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float e0 = exp2f(x0 - base);
      const float e1 = exp2f(x1 - base);
      if (lane < rows) srow[lane] = kQuant ? e0 * vsc[lane] : e0;
      if (lane + 32 < rows) srow[lane + 32] = kQuant ? e1 * vsc[lane + 32] : e1;
      const float sum = warp_sum(e0 + e1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - base);
        l_s[m] = l_s[m] * alpha + sum;
        m_s[m] = m_new;
        al_s[m] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha acc + P V over this thread's output elements
    if (jsplit == 1 && kThreads % dc == 0) {
      // dc divides the block: the thread's elements share column c, so
      // a V element is read once for all of them, and P four rows at once
      const int c = tid % dc;
      const int m0 = tid / dc;
      const int mstep = kThreads / dc;
      const unsigned char* vcol = vd + c * sizeof(KV);
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        if (m0 + mstep * k >= M) break;
        acc[k] *= al_s[m0 + mstep * k];
      }
      int j = 0;
      for (; j + 4 <= rows; j += 4) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = to_f32(*reinterpret_cast<const KV*>(vcol + (j + e) * rbv));
#pragma unroll
        for (int k = 0; k < kMaxItems; ++k) {
          const int m = m0 + mstep * k;
          if (m >= M) break;
          const float4 pr =
              *reinterpret_cast<const float4*>(s_s + m * kMaxRows + j);
          acc[k] += pr.x * v[0] + pr.y * v[1] + pr.z * v[2] + pr.w * v[3];
        }
      }
      for (; j < rows; ++j) {
        const float v = to_f32(*reinterpret_cast<const KV*>(vcol + j * rbv));
#pragma unroll
        for (int k = 0; k < kMaxItems; ++k) {
          const int m = m0 + mstep * k;
          if (m >= M) break;
          acc[k] += s_s[m * kMaxRows + j] * v;
        }
      }
    } else if (jsplit == 1) {
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        const int i = tid + k * kThreads;
        if (i >= items) break;
        const int m = i / dc;
        const int c = i - m * dc;
        const float* prow = s_s + m * kMaxRows;
        const unsigned char* vcol = vd + c * sizeof(KV);
        float x = acc[k] * al_s[m];
        for (int j = 0; j < rows; ++j)
          x += prow[j] * to_f32(*reinterpret_cast<const KV*>(vcol + j * rbv));
        acc[k] = x;
      }
    } else {
      const int part = tid / items;
      const int i = tid - part * items;
      if (part < jsplit) {
        const int m = i / dc;
        const int c = i - m * dc;
        const float* prow = s_s + m * kMaxRows;
        const unsigned char* vcol = vd + c * sizeof(KV);
        float x = 0.f;
        for (int j = part; j < rows; j += jsplit)
          x += prow[j] * to_f32(*reinterpret_cast<const KV*>(vcol + j * rbv));
        if (part == 0)
          acc[0] = acc[0] * al_s[m] + x;
        else
          red_s[(part - 1) * items + i] = x;
      }
      __syncthreads();
      if (part == 0)
        for (int q = 1; q < jsplit; ++q) acc[0] += red_s[(q - 1) * items + i];
    }
    __syncthreads();  // the stage is refilled two stages later
  }

  // a row that fits one partition writes its output; a longer one its
  // partials for paged_attention_merge (m and l once, by column tile 0)
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int i = tid + k * kThreads;
    if (i >= items) break;
    const int m = i / dc;
    const int c = i - m * dc;
    const int t = r + m / gh;
    const int64_t th = static_cast<int64_t>(t) * a.n_heads + head0 + m % gh;
    const int np = parts_of(a, len_s[m / gh]);
    if (np <= 1) {
      if (pj == 0) {
        const float l = l_s[m];
        store_f32(a.out, th * d + c0 + c, l == 0.f ? 0.f : acc[k] / l,
                  a.q_dtype);
      }
    } else if (pj < np) {
      const int64_t slot = th * a.n_parts + pj;
      a.part_acc[slot * d + c0 + c] = acc[k];
      if (c0 + c == 0) {
        a.part_ml[2 * slot] = m_s[m];
        a.part_ml[2 * slot + 1] = l_s[m];
      }
    }
  }
}

// The streamed kernel: same grid, partitions, output and partials as
// paged_attention, for head dims whose staged rows do not fit a block.
// One row a block (no runs), at most kStreamQ q heads of the group, 32 page
// rows a pass. QK: warp w scores rows w, w + 4, ...; its lanes walk d in
// strides of 32 (coalesced K and q reads), summed by a warp reduction.
// The online softmax runs a warp per q vector, PV a thread per output
// element of the block's column tile, V read straight from global memory.
constexpr int kStreamRows = 32;  // page rows a pass (one per lane)
constexpr int kStreamQ = 8;      // q vectors of a block

template <typename KV>
__global__ void __launch_bounds__(kThreads) paged_attention_streamed(Args a) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const int pj = blockIdx.x;
  const int t = blockIdx.y;
  const int kvh = blockIdx.z / (a.n_head_tiles * a.n_col_tiles);
  const int tile = blockIdx.z % (a.n_head_tiles * a.n_col_tiles);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.n_heads / a.kv_heads;
  const int d = a.d;
  const int ps = a.page_size;
  const int g0 = tile / a.n_col_tiles * a.head_tile;
  const int M = min(a.head_tile, G - g0);
  const int c0 = tile % a.n_col_tiles * a.cols;
  const int dc = min(a.cols, d - c0);
  const int head0 = kvh * G + g0;
  const int len = a.lens[t];
  if (len <= 0) {
    if (pj == 0)
      for (int i = tid; i < M * dc; i += kThreads)
        store_f32(a.out,
                  (static_cast<int64_t>(t) * a.n_heads + head0 + i / dc) * d +
                      c0 + i % dc,
                  0.f, a.q_dtype);
    return;
  }
  const int live = (len + ps - 1) / ps;
  const int p_begin = pj * a.part_pages;
  if (p_begin >= live) return;
  const int pos_end = min(len, min(live, p_begin + a.part_pages) * ps);

  __shared__ float s_s[kStreamQ][kStreamRows];  // scores, then P
  __shared__ float vsc_s[kStreamRows];
  __shared__ float m_s[kStreamQ], l_s[kStreamQ], al_s[kStreamQ];
  const int32_t* table = a.tables + static_cast<int64_t>(t) * a.pages_per_seq;
  const int64_t row_stride = static_cast<int64_t>(a.kv_heads) * d;
  const KV* kbase = static_cast<const KV*>(a.k_pages) +
                    static_cast<int64_t>(kvh) * d;
  const KV* vbase = static_cast<const KV*>(a.v_pages) +
                    static_cast<int64_t>(kvh) * d + c0;
  const int64_t q0 = (static_cast<int64_t>(t) * a.n_heads + head0) * d;
  // scores in log2 units: exp(x) = exp2(x * log2 e)
  const float qscale = a.scale * kLog2e;
  if (tid < M) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxItems];
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) acc[k] = 0.f;
  auto row_of = [&](int pos) {
    return static_cast<int64_t>(max(table[pos / ps], 0)) * ps + pos % ps;
  };

  for (int pos0 = p_begin * ps; pos0 < pos_end; pos0 += kStreamRows) {
    const int rows = min(kStreamRows, pos_end - pos0);
    for (int j = warp; j < rows; j += kWarps) {
      const int64_t row = row_of(pos0 + j);
      const KV* krow = kbase + row * row_stride;
      float s[kStreamQ];
#pragma unroll
      for (int m = 0; m < kStreamQ; ++m) s[m] = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float x = to_f32(krow[c]);
#pragma unroll
        for (int m = 0; m < kStreamQ; ++m)
          if (m < M)
            s[m] += load_f32(a.q, q0 + static_cast<int64_t>(m) * d + c,
                             a.q_dtype) * x;
      }
#pragma unroll
      for (int m = 0; m < kStreamQ; ++m) s[m] = warp_sum(s[m]);
      if (lane == 0) {
        const float ks = kQuant ? a.k_scales[row] : 1.f;
        for (int m = 0; m < M; ++m) s_s[m][j] = s[m] * ks * qscale;
        if (kQuant) vsc_s[j] = a.v_scales[row];
      }
    }
    __syncthreads();

    // online softmax, one warp per q vector, a lane per page row
    for (int m = warp; m < M; m += kWarps) {
      const float x = lane < rows ? s_s[m][lane] : -INFINITY;
      const float m_old = m_s[m];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float e = lane < rows ? exp2f(x - base) : 0.f;
      if (lane < rows) s_s[m][lane] = kQuant ? e * vsc_s[lane] : e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float alpha = exp2f(m_old - base);
        l_s[m] = l_s[m] * alpha + sum;
        m_s[m] = m_new;
        al_s[m] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha acc + P V over this thread's output elements
#pragma unroll
    for (int k = 0; k < kMaxItems; ++k) {
      const int i = tid + k * kThreads;
      if (i >= M * dc) break;
      const int m = i / dc;
      const int c = i - m * dc;
      float x = acc[k] * al_s[m];
      for (int j = 0; j < rows; ++j)
        x += s_s[m][j] * to_f32(vbase[row_of(pos0 + j) * row_stride + c]);
      acc[k] = x;
    }
    __syncthreads();  // s_s is rewritten by the next pass
  }

  const int np = parts_of(a, len);
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int i = tid + k * kThreads;
    if (i >= M * dc) break;
    const int m = i / dc;
    const int c = i - m * dc;
    const int64_t th = static_cast<int64_t>(t) * a.n_heads + head0 + m;
    if (np <= 1) {
      const float l = l_s[m];
      store_f32(a.out, th * d + c0 + c, l == 0.f ? 0.f : acc[k] / l,
                a.q_dtype);
    } else {
      const int64_t slot = th * a.n_parts + pj;
      a.part_acc[slot * d + c0 + c] = acc[k];
      if (c0 + c == 0) {
        a.part_ml[2 * slot] = m_s[m];
        a.part_ml[2 * slot + 1] = l_s[m];
      }
    }
  }
}

// Combines the partitions of every row that spans more than one, in
// partition order; grid (row, kv head, slice of kThreads of the group's
// G x d output elements)
__global__ void __launch_bounds__(kThreads) paged_attention_merge(Args a) {
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int i = blockIdx.z * kThreads + threadIdx.x;
  const int G = a.n_heads / a.kv_heads;
  const int np = parts_of(a, a.lens[t]);
  if (np <= 1 || i >= G * a.d) return;
  const int g = i / a.d;
  const int c = i - g * a.d;
  const int64_t th = static_cast<int64_t>(t) * a.n_heads + kvh * G + g;
  const float* ml = a.part_ml + 2 * th * a.n_parts;
  const float* pacc = a.part_acc + th * a.n_parts * a.d + c;
  float mx = -INFINITY;
  for (int j = 0; j < np; ++j) mx = fmaxf(mx, ml[2 * j]);
  float l = 0.f, o = 0.f;
  for (int j = 0; j < np; ++j) {
    const float w = exp2f(ml[2 * j] - mx);
    l += ml[2 * j + 1] * w;
    o += pacc[static_cast<int64_t>(j) * a.d] * w;
  }
  store_f32(a.out, th * a.d + c, l == 0.f ? 0.f : o / l, a.q_dtype);
}

// ---------------------------------------------------------------------------
// The tile kernel (Hopper): pages by TMA through an mbarrier ring, the
// products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTileWarps = 4;                      // consumer warps
constexpr int kTileThreads = 32 * (kTileWarps + 1);  // + the producer warp
constexpr int kTileQ = 16 * kTileWarps;            // q vectors of a block
constexpr int kTileStages = 6;                     // ring depth at most
constexpr int kTileParts = 64;                     // pages a partition at most

// the operand type of the products: the pool's, bf16 for int8 pages
// (their integers are exact in bf16), float (as tf32 hi + lo) for f32
template <typename KV>
struct TileOp {
  using T = KV;
};
template <>
struct TileOp<int8_t> {
  using T = __nv_bfloat16;
};

// page rows a stage: 64, fewer where a stage's K and V tiles would pass
// 32 KB (f32 at d > 64, the half types at d 256)
template <typename KV, int D>
__host__ __device__ constexpr int tile_rows() {
  constexpr int e = sizeof(typename TileOp<KV>::T);
  return 16384 / (D * e) < 64 ? 16384 / (D * e) : 64;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) of a tile of `rows` rows held in
// 128-byte panels (128 / size columns each, one after another), each
// row's 16-byte chunks XORed with row % 8: the layout TMA's 128-byte
// swizzle writes, so the 8 rows of one ldmatrix, and the rows g = 0..7
// of one fragment load, fall in 8 distinct bank groups.
__device__ __forceinline__ int tile_off(int row, int col, int rows,
                                        int size) {
  const int pw = 128 / size;
  const int b = (col % pw) * size;
  return (col / pw) * rows * 128 + row * 128 +
         ((((b >> 4) ^ row) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// an arrival that also expects `bytes` more from asynchronous copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed; a wait of more than
// ~2^35 cycles (~17 s) traps, so that a fault in the protocol ends the
// launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// box (c, h, row, page) of a pool viewed as the rank-4 tensor (d, KVH,
// page_size, num_pages); completion counted on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                       int c, int h, int row, int page,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(row),
      "r"(page), "r"(smem_u32(bar))
      : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes, completion on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the 128 consumer threads (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kTileWarps) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// x rounded to tf32 (10 mantissa bits, nearest, ties away from zero), as
// float32 bits with the low 13 bits zero
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
// x = hi + lo (lo exact in float32, then rounded to tf32)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  const float h = tf32_round(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_round(x - h));
}

// c += a b, m16n8k8, tf32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b, m16n8k16, bf16 or f16 operands, float32 sums
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
// two floats rounded to T, packed as one 32-bit operand (x in the low
// half); with `lo`, also the remainders rounded to T
template <typename T>
__device__ __forceinline__ unsigned pack2(float x, float y) {
  const T a = from_f32<T>(x), b = from_f32<T>(y);
  return static_cast<unsigned>(*reinterpret_cast<const uint16_t*>(&a)) |
         (static_cast<unsigned>(*reinterpret_cast<const uint16_t*>(&b))
          << 16);
}
template <typename T>
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  const T a = from_f32<T>(x), b = from_f32<T>(y);
  hi = static_cast<unsigned>(*reinterpret_cast<const uint16_t*>(&a)) |
       (static_cast<unsigned>(*reinterpret_cast<const uint16_t*>(&b)) << 16);
  lo = pack2<T>(x - to_f32(a), y - to_f32(b));
}

// The work of a tile launch, listed by paged_attention_plan: plan[0] the
// count of items, then one (first row, end row, partition) triple an
// item. A run is the rows of one sequence with non-decreasing limits and
// tables equal over the previous row's live pages, within an aligned
// window of run_rows rows (joins); each run takes one item per partition
// of its last (longest) row's pages, a zero row one item. One block of up
// to kPlanThreads, a thread a row; whether each row starts a run is kept
// in shared memory, so a launch takes at most kPlanRows rows.
constexpr int kPlanThreads = 1024;
constexpr int kPlanRows = 16384;

__global__ void __launch_bounds__(kPlanThreads)
    paged_attention_plan(const Args a, int* plan) {
  __shared__ uint8_t flag[kPlanRows];
  __shared__ int scan_s[kPlanThreads];
  int* items = plan + 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ps = a.page_size;
  for (int r = tid; r < a.T; r += nt) {
    bool start = r % a.run_rows == 0;
    if (!start) {
      const int lp = a.lens[r - 1];
      start = lp <= 0 || a.lens[r] < lp;
      const int32_t* prev = a.tables + static_cast<int64_t>(r - 1) *
                                           a.pages_per_seq;
      int differ = 0;  // no early exit: the loads stay independent
      if (!start)
#pragma unroll 8
        for (int i = 0; i < (lp + ps - 1) / ps; ++i)
          differ |= prev[i] != prev[i + a.pages_per_seq];
      start = start || differ;
    }
    flag[r] = start;
  }
  __syncthreads();
  int total = 0;
  for (int base = 0; base < a.T; base += nt) {
    const int r = base + tid;
    int n = 0, r1 = r + 1;
    if (r < a.T && flag[r]) {
      while (r1 < a.T && !flag[r1]) ++r1;
      const int len = a.lens[r1 - 1];
      n = len <= 0 ? 1 : parts_of(a, len);
    }
    scan_s[tid] = n;  // inclusive scan of the item counts
    __syncthreads();
    for (int o = 1; o < nt; o <<= 1) {
      const int v = tid >= o ? scan_s[tid - o] : 0;
      __syncthreads();
      scan_s[tid] += v;
      __syncthreads();
    }
    const int at = total + scan_s[tid] - n;
    for (int j = 0; j < n; ++j) {
      items[3 * (at + j)] = r;
      items[3 * (at + j) + 1] = r1;
      items[3 * (at + j) + 2] = j;
    }
    total += scan_s[nt - 1];
    __syncthreads();
  }
  if (tid == 0) plan[0] = total;
}

// q elements off .. off + 7 (off a multiple of 8) as float32
__device__ __forceinline__ void load_q8(float (&x)[8], const void* q,
                                        int64_t off, int q_dtype) {
  if (q_dtype == kF32) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(q) + off);
    const float4 u = __ldg(p), v = __ldg(p + 1);
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
    x[4] = v.x, x[5] = v.y, x[6] = v.z, x[7] = v.w;
    return;
  }
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(
      static_cast<const uint16_t*>(q) + off));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        q_dtype == kBF16
            ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]))
            : __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Kernel B4's tile design. A persistent block walks the plan's items x
// (kv head, q-head tile) pairs; an item is a run of up to kTileQ q vectors
// (rows of one sequence x the group's q heads) over one partition of its
// pages. Warps 0-3 compute; one thread of warp 4 streams the partition's
// pages into a ring of `stages` stages of `rows` page rows (K and V
// tiles, each page's rows one TMA box per 128-byte panel; int8 tiles as
// boxes of whole rows, with their scales by a bulk copy), full and empty
// mbarriers between them; the ring's phases run on across items. A
// consumer warp owns 16 q vectors (a q tile) and, where the run has fewer
// q tiles than warps, a slice of each stage's page rows (the key slices
// are merged through shared memory at the item's end). Per stage it
// computes S = Q K^T for its rows and slice with mma.sync, masks each row
// at its limit, runs the online softmax in float32 registers (log2
// units), and adds P V. Products by pool type:
// - f32: 3xTF32. Q (raw f32 in shared memory), K, V and P are split at
//   fragment load into hi = tf32(x) and lo = tf32(x - hi); each product
//   sums hi lo + lo hi + hi hi (m16n8k8), each a pass apart.
// - bf16 / f16: m16n8k16 on the pool's type; q of another type is
//   staged as hi + lo in the pool's type (two products); P is rounded to
//   the pool's type for P V, as B1 rounds it.
// - int8: each stage's integers converted to bf16 in shared memory
//   (exact); q split as above; the K scale folds into S's columns, the V
//   scale into P's, and P times the V scale is split into bf16 hi + lo.
// Output and partials as paged_attention's.
template <typename KV, int D>
__global__ void __launch_bounds__(kTileThreads, D <= 128 ? 2 : 1)
    paged_attention_tile(const Args a, const int* __restrict__ plan,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr bool kTf32 = std::is_same<KV, float>::value;
  using T = typename TileOp<KV>::T;   // operand type (float: tf32)
  constexpr int kE = sizeof(T);
  constexpr int R = tile_rows<KV, D>();  // page rows a stage
  constexpr int kNT = R / 8;             // score n-tiles of a stage
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = a.n_heads / a.kv_heads;
  const int d = a.d;
  const int ps = a.page_size;
  const int Z = a.kv_heads * a.n_head_tiles;

  // the layout is sized for a 1024-aligned window (the 128-byte swizzle's
  // period), as a kernel without static shared memory gets it; any other
  // base traps rather than read a tile in the wrong swizzle
  extern __shared__ __align__(1024) unsigned char base[];
  if (smem_u32(base) & 1023) __trap();
  unsigned char* q_s = base + a.q_off;
  unsigned char* ring = base + a.ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + a.bar_off);
  uint64_t* empty = full + kTileStages;
  // page ids of this item and the next (the producer warp's idle lanes
  // read the next item's while this one runs), then the run's limits
  int* pages_s = reinterpret_cast<int*>(empty + kTileStages);
  int* len_s = pages_s + 2 * kTileParts;
  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kTileWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int n_work = plan[0] * Z;
  const int* items = plan + 1;
  // the page ids of work w's partition into dst (-1 reads page 0), by
  // the producer warp
  auto fetch_pages = [&](int w, int* dst) {
    if (w >= n_work) return;
    const int* it = items + 3 * (w / Z);
    const int len = a.lens[it[1] - 1];
    const int p_begin = it[2] * a.part_pages;
    const int n = min((len + ps - 1) / ps, p_begin + a.part_pages) - p_begin;
    const int32_t* table =
        a.tables + static_cast<int64_t>(it[1] - 1) * a.pages_per_seq +
        p_begin;
    for (int i = lane; i < n; i += 32) dst[i] = max(table[i], 0);
  };
  if (warp == kTileWarps) fetch_pages(blockIdx.x, pages_s);
  int buf = 0;  // pages_s half of this item
  int sc = 0;   // stages of earlier items: the ring's phase
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, buf ^= 1) {
    const int* it = items + 3 * (w / Z);
    const int r = it[0], r1 = it[1], pj = it[2];
    const int kvh = w % Z / a.n_head_tiles;
    const int g0 = w % Z % a.n_head_tiles * a.head_tile;
    const int gh = min(a.head_tile, G - g0);
    const int head0 = kvh * G + g0;
    const int M = (r1 - r) * gh;  // q vectors: row-major (row, head)
    const int max_len = a.lens[r1 - 1];
    if (max_len <= 0) {  // a zero row, always a run of one
      for (int i = tid; i < gh * d; i += kTileThreads)
        store_f32(a.out,
                  (static_cast<int64_t>(r) * a.n_heads + head0 + i / d) * d +
                      i % d,
                  0.f, a.q_dtype);
      if (warp == kTileWarps)
        fetch_pages(w + gridDim.x, pages_s + (buf ^ 1) * kTileParts);
      continue;
    }
    const int p_begin = pj * a.part_pages;
    const int n_pages =
        min((max_len + ps - 1) / ps, p_begin + a.part_pages) - p_begin;
    const int pos0 = p_begin * ps;  // position of the partition's row 0
    const int n_stages =
        (min((p_begin + n_pages) * ps, max_len) - pos0 + R - 1) / R;

    // the producer's copies; the consumers' limits and Q tile meanwhile,
    // q vectors as rows (zeros past M and past d): f32 pools keep q as
    // float32, the others as T (hi, then lo if split), 8 elements a unit,
    // 4 units' loads at once
    __syncthreads();  // the previous item is done with shared memory
    if (warp != kTileWarps) {
      for (int i = tid; i < r1 - r; i += 32 * kTileWarps)
        len_s[i] = a.lens[r + i];
      const int units = a.q_rows * D / 8;
      for (int u0 = tid; u0 < units; u0 += 4 * 32 * kTileWarps) {
        float x[4][8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int u = u0 + k * 32 * kTileWarps;
          const int m = u / (D / 8);
          const int c = (u - m * (D / 8)) * 8;
          if (u < units && m < M && c < d) {
            load_q8(x[k], a.q,
                    (static_cast<int64_t>(r + m / gh) * a.n_heads + head0 +
                     m % gh) * d + c,
                    a.q_dtype);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) x[k][e] = 0.f;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int u = u0 + k * 32 * kTileWarps;
          if (u >= units) break;
          const int m = u / (D / 8);
          const int c = (u - m * (D / 8)) * 8;
          if constexpr (kTf32) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float4*>(
                  q_s + tile_off(m, c + 4 * h, a.q_rows, 4)) =
                  make_float4(x[k][4 * h], x[k][4 * h + 1], x[k][4 * h + 2],
                              x[k][4 * h + 3]);
          } else {
            uint4 hi, lo;
            split2<T>(x[k][0], x[k][1], hi.x, lo.x);
            split2<T>(x[k][2], x[k][3], hi.y, lo.y);
            split2<T>(x[k][4], x[k][5], hi.z, lo.z);
            split2<T>(x[k][6], x[k][7], hi.w, lo.w);
            const int o = tile_off(m, c, a.q_rows, kE);
            *reinterpret_cast<uint4*>(q_s + o) = hi;
            if (a.split_q)
              *reinterpret_cast<uint4*>(q_s + a.q_rows * D * kE + o) = lo;
          }
        }
      }
      consumer_sync();
    }

    if (warp == kTileWarps) {  // producer
      if (lane == 0) {
        const int* pg = pages_s + buf * kTileParts;
        const int boxes = R / a.box_rows;
        for (int s = 0; s < n_stages; ++s) {
          const int st = (sc + s) % a.stages;
          mbar_wait(&empty[st], (((sc + s) / a.stages) & 1) ^ 1);
          mbar_arrive_tx(&full[st], a.stage_tx);
          unsigned char* kd = ring + st * a.stage_size;
          unsigned char* vd = kd + a.stage_size / 2;
          for (int b = 0; b < boxes; ++b) {
            const int rel = s * R + b * a.box_rows;  // row of the partition
            const int pi = rel / ps;
            const int row = rel % ps;
            // past the partition's pages: a page coordinate past the
            // pool, which TMA reads as zeros
            const int page = pi < n_pages ? pg[pi] : a.num_pages;
            if constexpr (kQuant) {
              const int off = b * a.box_rows * d;
              tma_box(kd + off, &tk, 0, kvh, row, page, &full[st]);
              tma_box(vd + off, &tv, 0, kvh, row, page, &full[st]);
              float* scl = reinterpret_cast<float*>(base + a.scale_off) +
                           st * 2 * R + b * a.box_rows;
              const int64_t srow =
                  static_cast<int64_t>(pi < n_pages ? page : 0) * ps + row;
              bulk_copy(scl, a.k_scales + srow, a.box_rows * 4, &full[st]);
              bulk_copy(scl + R, a.v_scales + srow, a.box_rows * 4,
                        &full[st]);
            } else {
#pragma unroll
              for (int pn = 0; pn < D * kE / 128; ++pn) {
                const int off = pn * R * 128 + b * a.box_rows * 128;
                tma_box(kd + off, &tk, pn * (128 / kE), kvh, row, page,
                        &full[st]);
                tma_box(vd + off, &tv, pn * (128 / kE), kvh, row, page,
                        &full[st]);
              }
            }
          }
        }
      }
      __syncwarp();
      fetch_pages(w + gridDim.x, pages_s + (buf ^ 1) * kTileParts);
    } else {  // consumers
      // this warp's q tile and key slice
      const int n_qt = (M + 15) / 16;
      const int n_ks = max(1, min(kTileWarps / n_qt, R / 16));
      const int qt = warp % n_qt;
      const int ks = warp / n_qt;
      const bool active = ks < n_ks;
      const int nc = R / n_ks;   // page rows of the slice
      const int nct = nc / 8;    // its score n-tiles
      const int key0 = ks * nc;  // its first row in a stage
      const int g = lane >> 2, t = lane & 3;
      int lim[2];  // limits of this thread's rows: q vectors 16 qt + g, + 8
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * qt + g + 8 * h;
        lim[h] = active && m < M ? len_s[m / gh] : 0;
      }
      const float sc2 = a.scale * kLog2e;  // scores in log2 units
      // the tf32 fragments' byte offsets, before each access's constant:
      // Q row 16 qt + g and K row key0 + g at word t; V row key0 + 2 t at
      // word g % 4, and its chunk term for rows 2 t and 2 t + 1
      const int g16 = g << 4;
      const unsigned char* q_rd = q_s + (16 * qt + g) * 128 + 4 * t;
      const int k_rd = (key0 + g) * 128 + 4 * t;
      const int v_rd = (key0 + 2 * t) * 128 + 4 * (g & 3);
      const int v_x[2] = {((g >> 2) ^ (2 * t)) << 4,
                          ((g >> 2) ^ (2 * t + 1)) << 4};
      float mrow[2] = {-INFINITY, -INFINITY};
      float lrow[2] = {0.f, 0.f};  // this thread's part of the row sums
      float acc[D / 8][4];
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

      for (int s = 0; s < n_stages; ++s) {
        const int st = (sc + s) % a.stages;
        mbar_wait(&full[st], ((sc + s) / a.stages) & 1);
        const unsigned char* kt = ring + st * a.stage_size;
        const unsigned char* vt = kt + a.stage_size / 2;
        const float* ksc = nullptr;
        const float* vsc = nullptr;
        if constexpr (kQuant) {
          // every warp is done with the previous stage's converted tiles
          consumer_sync();
          unsigned char* conv = base + a.conv_off;
          for (int i = tid; i < 2 * R * (D / 8); i += 32 * kTileWarps) {
            const int which = i / (R * (D / 8));  // K, then V
            const int j = i - which * R * (D / 8);
            const int row = j / (D / 8);
            const int c = (j - row * (D / 8)) * 8;
            uint4 out = make_uint4(0, 0, 0, 0);
            if (c < d) {
              const uint2 u = *reinterpret_cast<const uint2*>(
                  (which ? vt : kt) + row * d + c);
              float x[8];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                x[e] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * e)));
                x[4 + e] =
                    static_cast<float>(static_cast<int8_t>(u.y >> (8 * e)));
              }
              out = make_uint4(pack2<T>(x[0], x[1]), pack2<T>(x[2], x[3]),
                               pack2<T>(x[4], x[5]), pack2<T>(x[6], x[7]));
            }
            *reinterpret_cast<uint4*>(conv + which * R * D * 2 +
                                      tile_off(row, c, R, 2)) = out;
          }
          consumer_sync();
          kt = conv;
          vt = conv + R * D * 2;
          ksc = reinterpret_cast<const float*>(base + a.scale_off) +
                st * 2 * R;
          vsc = ksc + R;
        }
        if (active) {
          // S = Q K^T over the warp's 16 q vectors and nc page rows
          float sa[kNT][4];
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sa[j][e] = 0.f;
          if constexpr (kTf32) {
            // k index t <-> column 8 kk + t, t + 4 <-> + 4 (A and B alike).
            // Rows 16 qt + g (+ 8) of Q and key0 + 8 j + g of K are g
            // mod 8, so chunk c of a column block sits at (c ^ g) << 4.
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) {
              if (8 * kk < d) {
                unsigned ah[4], al[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  split_tf32(*reinterpret_cast<const float*>(
                                 q_rd + (i & 1) * 1024 +
                                 kk / 4 * a.q_rows * 128 +
                                 (((2 * (kk % 4) + (i >> 1)) << 4) ^ g16)),
                             ah[i], al[i]);
                // the three products of each n-tile a pass apart, so that
                // consecutive products go to different accumulators
                unsigned bh[kNT][2], bl[kNT][2];
#pragma unroll
                for (int j = 0; j < kNT; ++j) {
                  if (j < nct) {
#pragma unroll
                    for (int i = 0; i < 2; ++i)
                      split_tf32(*reinterpret_cast<const float*>(
                                     kt + k_rd + j * 1024 + kk / 4 * R * 128 +
                                     (((2 * (kk % 4) + i) << 4) ^ g16)),
                                 bh[j][i], bl[j][i]);
                    mma_tf32(sa[j], ah, bl[j][0], bl[j][1]);
                  }
                }
#pragma unroll
                for (int j = 0; j < kNT; ++j)
                  if (j < nct) mma_tf32(sa[j], al, bh[j][0], bh[j][1]);
#pragma unroll
                for (int j = 0; j < kNT; ++j)
                  if (j < nct) mma_tf32(sa[j], ah, bh[j][0], bh[j][1]);
              }
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              if (16 * kk < d) {
                const int arow = 16 * qt + (lane & 7) + ((lane >> 3) & 1) * 8;
                const int acol = 16 * kk + (lane >> 4) * 8;
                unsigned ah[4], al[4];
                ldsm_x4(ah, q_s + tile_off(arow, acol, a.q_rows, 2));
                if (a.split_q)
                  ldsm_x4(al, q_s + a.q_rows * D * 2 +
                                  tile_off(arow, acol, a.q_rows, 2));
#pragma unroll
                for (int j = 0; j < kNT; j += 2) {
                  if (j < nct) {
                    unsigned b[4];
                    ldsm_x4(b, kt + tile_off(key0 + 8 * j + (lane & 7) +
                                                 ((lane >> 4) << 3),
                                             16 * kk + ((lane >> 3) & 1) * 8,
                                             R, 2));
                    if (a.split_q) {
                      mma16<T>(sa[j], al, b[0], b[1]);
                      mma16<T>(sa[j + 1], al, b[2], b[3]);
                    }
                    mma16<T>(sa[j], ah, b[0], b[1]);
                    mma16<T>(sa[j + 1], ah, b[2], b[3]);
                  }
                }
              }
            }
          }

          // scale, K's scale and the limits; the online softmax
          const int kpos = pos0 + s * R + key0;  // position of slice row 0
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1);
              float x = sa[j][e] * sc2;
              if constexpr (kQuant) x *= ksc[key0 + col];
              x = j < nct && kpos + col < lim[e >> 1] ? x : -INFINITY;
              sa[j][e] = x;
              mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
          }
          float alpha[2], mb[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = mx[h];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            const float m_new = fmaxf(mrow[h], v);
            mb[h] = m_new == -INFINITY ? 0.f : m_new;
            alpha[h] = exp2f(mrow[h] - mb[h]);
            mrow[h] = m_new;
          }
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = exp2f(sa[j][e] - mb[e >> 1]);
              sum[e >> 1] += p;
              sa[j][e] = p;
            }
#pragma unroll
          for (int h = 0; h < 2; ++h) lrow[h] = lrow[h] * alpha[h] + sum[h];
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][e] *= alpha[e >> 1];
          if constexpr (kQuant) {
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sa[j][e] *= vsc[key0 + 8 * j + 2 * t + (e & 1)];
          }

          // O += P V
          if constexpr (kTf32) {
            // k index t <-> page row 2t, t + 4 <-> 2t + 1: P's accumulator
            // layout is then its A fragment
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              if (j < nct) {
                unsigned ph[4], pl[4];
                split_tf32(sa[j][0], ph[0], pl[0]);
                split_tf32(sa[j][2], ph[1], pl[1]);
                split_tf32(sa[j][1], ph[2], pl[2]);
                split_tf32(sa[j][3], ph[3], pl[3]);
                // the output columns in passes of 8 n-tiles, the products
                // of a tile a pass apart; row key0 + 8 j + 2 t + i is
                // 2 t + i mod 8, so column block c's chunk 2 (c % 4) + g / 4
                // sits at ((c % 4) << 5) ^ v_x[i]
#pragma unroll
                for (int c0 = 0; c0 < D / 8; c0 += 8) {
                  if (8 * c0 < d) {
                    unsigned vh[8][2], vl[8][2];
#pragma unroll
                    for (int c = 0; c < 8; ++c) {
                      if (8 * (c0 + c) < d) {
#pragma unroll
                        for (int i = 0; i < 2; ++i)
                          split_tf32(*reinterpret_cast<const float*>(
                                         vt + v_rd + i * 128 + j * 1024 +
                                         (c0 + c) / 4 * R * 128 +
                                         ((((c0 + c) % 4) << 5) ^ v_x[i])),
                                     vh[c][i], vl[c][i]);
                        mma_tf32(acc[c0 + c], ph, vl[c][0], vl[c][1]);
                      }
                    }
#pragma unroll
                    for (int c = 0; c < 8; ++c)
                      if (8 * (c0 + c) < d)
                        mma_tf32(acc[c0 + c], pl, vh[c][0], vh[c][1]);
#pragma unroll
                    for (int c = 0; c < 8; ++c)
                      if (8 * (c0 + c) < d)
                        mma_tf32(acc[c0 + c], ph, vh[c][0], vh[c][1]);
                  }
                }
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < kNT; j += 2) {
              if (j < nct) {
                unsigned ph[4], pl[4];
                if constexpr (kQuant) {
                  split2<T>(sa[j][0], sa[j][1], ph[0], pl[0]);
                  split2<T>(sa[j][2], sa[j][3], ph[1], pl[1]);
                  split2<T>(sa[j + 1][0], sa[j + 1][1], ph[2], pl[2]);
                  split2<T>(sa[j + 1][2], sa[j + 1][3], ph[3], pl[3]);
                } else {
                  ph[0] = pack2<T>(sa[j][0], sa[j][1]);
                  ph[1] = pack2<T>(sa[j][2], sa[j][3]);
                  ph[2] = pack2<T>(sa[j + 1][0], sa[j + 1][1]);
                  ph[3] = pack2<T>(sa[j + 1][2], sa[j + 1][3]);
                }
                const int vrow =
                    key0 + 8 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
                for (int c = 0; c < D / 8; c += 2) {
                  if (8 * c < d) {
                    unsigned b[4];
                    ldsm_x4_t(b, vt + tile_off(vrow, 8 * c + (lane >> 4) * 8,
                                               R, 2));
                    if constexpr (kQuant) {
                      mma16<T>(acc[c], pl, b[0], b[1]);
                      mma16<T>(acc[c + 1], pl, b[2], b[3]);
                    }
                    mma16<T>(acc[c], ph, b[0], b[1]);
                    mma16<T>(acc[c + 1], ph, b[2], b[3]);
                  }
                }
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);  // done with the stage
      }

      // the key slices' (m, l, acc) through shared memory (the ring, free
      // once every consumer has passed its last stage), merged in slice
      // order, then written as paged_attention writes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
        lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
      }
      consumer_sync();
      float* acc_s = reinterpret_cast<float*>(ring);  // [warp][16][D]
      float* ml_s = acc_s + kTileWarps * 16 * D;      // [warp][16][2]
      if (active) {
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc_s[(warp * 16 + g + 8 * (e >> 1)) * D + 8 * c + 2 * t +
                  (e & 1)] = acc[c][e];
        if (t == 0)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ml_s[2 * (warp * 16 + g + 8 * h)] = mrow[h];
            ml_s[2 * (warp * 16 + g + 8 * h) + 1] = lrow[h];
          }
      }
      consumer_sync();
      for (int i = tid; i < M * d; i += 32 * kTileWarps) {
        const int m = i / d;
        const int c = i - m * d;
        // key slice k's row of q vector m: warp k n_qt + m / 16, row m % 16
        float mx = -INFINITY;
        for (int k = 0; k < n_ks; ++k)
          mx = fmaxf(mx, ml_s[2 * (m + k * n_qt * 16)]);
        const float mb = mx == -INFINITY ? 0.f : mx;
        float l = 0.f, o = 0.f;
        for (int k = 0; k < n_ks; ++k) {
          const int slot = m + k * n_qt * 16;
          const float w8 = exp2f(ml_s[2 * slot] - mb);
          l += ml_s[2 * slot + 1] * w8;
          o += acc_s[slot * D + c] * w8;
        }
        const int64_t th =
            static_cast<int64_t>(r + m / gh) * a.n_heads + head0 + m % gh;
        const int np = parts_of(a, len_s[m / gh]);
        if (np <= 1) {
          if (pj == 0)
            store_f32(a.out, th * d + c, l == 0.f ? 0.f : o / l, a.q_dtype);
        } else if (pj < np) {
          const int64_t slot = th * a.n_parts + pj;
          a.part_acc[slot * d + c] = o;
          if (c == 0) {
            a.part_ml[2 * slot] = mx;
            a.part_ml[2 * slot + 1] = l;
          }
        }
      }
    }
    sc += n_stages;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (nothing more is linked); null where it is missing
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A pool [num_pages, page_size, KVH, d] as the rank-4 tensor (d, KVH,
// page_size, num_pages), read in boxes of `box_rows` page rows of one
// (page, kv head): 128-byte panels, 128-byte swizzled (int8: whole rows,
// unswizzled). Columns past d and pages past num_pages read as zeros.
template <typename KV>
bool make_pool_map(CUtensorMap* map, const void* pool, const Args& a) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const cuuint64_t e = sizeof(KV);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.d),
                              static_cast<cuuint64_t>(a.kv_heads),
                              static_cast<cuuint64_t>(a.page_size),
                              static_cast<cuuint64_t>(a.num_pages)};
  const cuuint64_t strides[3] = {a.d * e, a.kv_heads * a.d * e,
                                 static_cast<cuuint64_t>(a.page_size) *
                                     a.kv_heads * a.d * e};
  const cuuint32_t box[4] = {
      kQuant ? static_cast<cuuint32_t>(a.d) : static_cast<cuuint32_t>(128 / e),
      1, static_cast<cuuint32_t>(a.box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      std::is_same<KV, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same<KV, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
      : std::is_same<KV, __nv_bfloat16>::value
          ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
          : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return fn(map, type, 4, const_cast<void*>(pool), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            kQuant ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int align_up(int x, int to) { return (x + to - 1) / to * to; }
// shared memory a tile block may take and still let two share an SM
constexpr int kTileSmemTarget = 113 * 1024;

// The tile kernel's launch: q tiles of at most kTileQ q vectors, its
// shared-memory layout and ring depth (3, deeper while two blocks still
// share an SM), the pools' tensor maps; then the merge.
template <typename KV, int D>
cudaError_t launch_tile(Args a, int* plan, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int R = tile_rows<KV, D>();
  const int group = a.n_heads / a.kv_heads;
  a.n_head_tiles = (group + kTileQ - 1) / kTileQ;
  a.head_tile = (group + a.n_head_tiles - 1) / a.n_head_tiles;
  a.run_rows = max(1, kTileQ / a.head_tile);
  a.max_q = min(a.run_rows, a.T) * a.head_tile;
  a.n_col_tiles = 1;
  a.cols = a.d;
  a.rows = R;
  a.box_rows = min(a.page_size, R);
  a.q_rows = (a.max_q + 15) / 16 * 16;
  const int q_bytes = std::is_same<KV, float>::value ? a.q_rows * D * 4
                           : a.q_rows * D * 2 * (a.split_q ? 2 : 1);
  const int tile_bytes = kQuant ? R * a.d : R * D * static_cast<int>(sizeof(KV));
  a.stage_size = 2 * align_up(tile_bytes, 1024);
  a.stage_tx = 2 * tile_bytes + (kQuant ? 2 * R * 4 : 0);
  const int scratch = kTileWarps * 16 * (D + 2) * 4;  // the key-slice merge
  const int fixed_tail = (kQuant ? align_up(2 * R * D * 2, 1024) +
                                       kTileStages * 2 * R * 4
                                 : 0) +
                         2 * kTileStages * 8 + (2 * kTileParts + kTileQ) * 4;
  auto total = [&](int stages) {
    return align_up(q_bytes, 1024) +
           align_up(max(stages * a.stage_size, scratch), 1024) + fixed_tail;
  };
  a.stages = 3;
  while (a.stages < kTileStages && total(a.stages + 1) <= kTileSmemTarget)
    ++a.stages;
  a.q_off = 0;
  a.ring_off = align_up(q_bytes, 1024);
  int off = a.ring_off + align_up(max(a.stages * a.stage_size, scratch), 1024);
  a.conv_off = off;
  if (kQuant) off += align_up(2 * R * D * 2, 1024);
  a.scale_off = off;
  if (kQuant) off += kTileStages * 2 * R * 4;
  a.bar_off = off;
  const size_t smem = total(a.stages);

  CUtensorMap tk, tv;
  if (!make_pool_map<KV>(&tk, a.k_pages, a) ||
      !make_pool_map<KV>(&tv, a.v_pages, a))
    return cudaErrorInvalidValue;
  auto kernel = paged_attention_tile<KV, D>;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  {
    // per device: the largest dynamic shared memory this instantiation
    // was granted, and the blocks an SM holds at each size launched
    static std::mutex mu;
    static std::map<int, size_t> granted;
    static std::map<std::pair<int, size_t>, int> fits;
    std::lock_guard<std::mutex> lock(mu);
    if (smem > granted[dev]) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      granted[dev] = smem;
    }
    auto it = fits.find({dev, smem});
    if (it == fits.end()) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTileThreads, smem);
      if (e != cudaSuccess) return e;
      it = fits.emplace(std::make_pair(dev, smem), per_sm).first;
    }
    per_sm = it->second;
  }
  paged_attention_plan<<<1, min(kPlanThreads, (a.T + 31) / 32 * 32), 0,
                         stream>>>(a, plan);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // persistent blocks: as many as the card holds at once, fewer where the
  // launch has fewer (item, kv head x q-head tile) pairs at most
  const long long most = static_cast<long long>(a.T) * a.n_parts *
                         a.kv_heads * a.n_head_tiles;
  const int blocks = static_cast<int>(
      min(most, static_cast<long long>(max(1, per_sm) * sms)));
  kernel<<<blocks, kTileThreads, smem, stream>>>(a, plan, tk, tv);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_parts == 1) return e;
  const int group_elems = group * a.d;
  paged_attention_merge<<<dim3(a.T, a.kv_heads,
                               (group_elems + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_tile_d(const Args& a, int* plan, cudaStream_t stream) {
  if (a.d <= 64) return launch_tile<KV, 64>(a, plan, stream);
  if (a.d <= 128) return launch_tile<KV, 128>(a, plan, stream);
  return launch_tile<KV, 256>(a, plan, stream);
}

template <typename KV>
cudaError_t launch(const Args& a, bool streamed, cudaStream_t stream) {
  const dim3 grid(a.n_parts, a.T,
                  a.kv_heads * a.n_head_tiles * a.n_col_tiles);
  if (streamed) {
    paged_attention_streamed<KV><<<grid, kThreads, 0, stream>>>(a);
  } else {
    const size_t smem =
        smem_bytes(sizeof(KV), a.d, a.cols, a.stage_rows, a.max_q);
    auto kernel = a.d % 8 ? paged_attention<KV, true>
                          : paged_attention<KV, false>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, kThreads, smem, stream>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_parts == 1) return e;
  const int group_elems = a.n_heads / a.kv_heads * a.d;
  paged_attention_merge<<<dim3(a.T, a.kv_heads,
                               (group_elems + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers
// of contiguous tensors; the stream is PyTorch's current stream.
// `part_pages` is the partition size in pages; `part_ml` [T, H, n_parts,
// 2] and `part_acc` [T, H, n_parts, head_dim] float32 are the workspace
// of rows that span more than one partition (n_parts = ceil(pages_per_seq
// / part_pages); null where n_parts is 1). `plan` is the tile route's
// int32 work list, 1 + 3 T n_parts entries (null for simt). `route` is
// the design ops/paged_attention.py::paged_route names: kRouteTile takes
// at most kPlanRows rows, head dims that are multiples of 16 up to 256,
// page sizes that are powers of two from 8, at most kTileParts pages a
// partition, and pools (and int8 scales) on 16-byte boundaries;
// kRouteSimt takes any head_dim, any page_size and any n_heads that
// kv_heads divides, with the pools aligned to chunk_bytes(head_dim *
// element size), the width the rows are staged in, and runs the staged
// kernel, or the streamed one where the staged rows would pass a block's
// shared memory. `single_rows` (1 or 0): the caller knows that every
// live row is a sequence of its own (a decode batch); each simt block
// then takes one row and compares no tables. Returns
// kMisaligned where pools are not aligned as the route needs,
// kRouteRefused where the route does not take the shape, else the
// cudaError_t of the launches (0 on success). Nothing falls back to
// another route. Allocates nothing.
constexpr int kMisaligned = -1;
constexpr int kRouteRefused = -2;
enum Route : int { kRouteSimt = 0, kRouteTile = 1 };

extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* k_pages, const void* v_pages,
    int kv_dtype, const void* k_scales, const void* v_scales,
    const void* tables, const void* lens, void* out, void* part_ml,
    void* part_acc, int num_tokens, int n_heads, int kv_heads, int head_dim,
    int page_size, int num_pages, int pages_per_seq, int part_pages,
    float scale, int route, int single_rows, void* plan, void* stream) {
  if (head_dim <= 0 || page_size <= 0 || kv_heads <= 0 ||
      n_heads % kv_heads || part_pages <= 0)
    return cudaErrorInvalidValue;
  const int group = n_heads / kv_heads;
  const int kv_size = kv_dtype == kF32 ? 4 : (kv_dtype == kI8 ? 1 : 2);
  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.tables = static_cast<const int32_t*>(tables);
  a.lens = static_cast<const int32_t*>(lens);
  a.out = out;
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.q_dtype = q_dtype;
  a.T = num_tokens;
  a.n_heads = n_heads;
  a.kv_heads = kv_heads;
  a.d = head_dim;
  a.page_size = page_size;
  a.num_pages = num_pages;
  a.pages_per_seq = pages_per_seq;
  a.part_pages = part_pages;
  a.n_parts = (pages_per_seq + part_pages - 1) / part_pages;
  a.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  if (route == kRouteTile) {
    if (num_tokens > kPlanRows || head_dim % 16 || head_dim > 256 ||
        page_size < 8 || (page_size & (page_size - 1)) ||
        part_pages > kTileParts || plan == nullptr)
      return kRouteRefused;
    auto off16 = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 != 0;
    };
    if (off16(k_pages) || off16(v_pages) ||
        (kv_dtype == kI8 && (off16(k_scales) || off16(v_scales))))
      return kMisaligned;
    // q of another type than the products' is staged as hi + lo
    a.split_q = q_dtype != (kv_dtype == kI8 ? kBF16 : kv_dtype);
    switch (kv_dtype) {
      case kF32:
        return launch_tile_d<float>(a, static_cast<int*>(plan), st);
      case kBF16:
        return launch_tile_d<__nv_bfloat16>(a, static_cast<int*>(plan), st);
      case kF16:
        return launch_tile_d<__half>(a, static_cast<int*>(plan), st);
      case kI8:
        return launch_tile_d<int8_t>(a, static_cast<int*>(plan), st);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (route != kRouteSimt) return kRouteRefused;
  const uintptr_t align = chunk_bytes(head_dim * kv_size);
  if (reinterpret_cast<uintptr_t>(k_pages) % align ||
      reinterpret_cast<uintptr_t>(v_pages) % align)
    return kMisaligned;
  // output columns of a block: all of d up to 256, else d split evenly
  a.n_col_tiles = (head_dim + kMaxCols - 1) / kMaxCols;
  a.cols = ((head_dim + a.n_col_tiles - 1) / a.n_col_tiles + 7) / 8 * 8;
  // q heads of a block: within kMaxQ q vectors, kMaxElems accumulated
  // output elements and kQBudget staged q elements, the group split evenly
  const int fit_heads = max(1, min(min(kMaxQ, kMaxElems / a.cols),
                                   kQBudget / q_stride(head_dim)));
  a.n_head_tiles = (group + fit_heads - 1) / fit_heads;
  a.head_tile = (group + a.n_head_tiles - 1) / a.n_head_tiles;
  a.run_rows = max(1, min(min(kMaxRun, kMaxQ / a.head_tile),
                          min(kMaxElems / (a.head_tile * a.cols),
                              kQBudget / (a.head_tile *
                                          q_stride(head_dim)))));
  a.max_q = a.run_rows * a.head_tile;
  // rows a stage holds: up to 64, two stages of K rows (all of d) and V
  // rows (the block's columns) within the budget; whole pages where one
  // fits, else sub-stages of one page
  const int fit = kStageBudget / (2 * (row_bytes(kv_size, head_dim) +
                                       row_bytes(kv_size, a.cols)));
  const int cap = max(1, min(kMaxRows, fit));
  if (page_size <= cap) {
    a.n_sub = 1;
    a.stage_pages = min(cap / page_size, part_pages);
    a.stage_rows = a.stage_pages * page_size;
  } else {
    a.n_sub = (page_size + cap - 1) / cap;
    a.stage_pages = 1;
    a.stage_rows = cap;
  }
  // a block's shared memory past the card's opt-in limit: the streamed
  // kernel, at most kStreamQ q heads a block, one row a block
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const bool streamed =
      smem_bytes(kv_size, head_dim, a.cols, a.stage_rows, a.max_q) >
      static_cast<size_t>(smem_max);
  if (streamed) {
    a.n_head_tiles = (group + kStreamQ - 1) / kStreamQ;
    a.head_tile = (group + a.n_head_tiles - 1) / a.n_head_tiles;
    a.run_rows = 1;
    a.max_q = a.head_tile;
  } else if (single_rows) {
    // every live row its own sequence (a decode batch): a block takes one
    // row and compares no tables; its q area shrinks to what QK's
    // head-dim split uses (dparts), so the sums stay those without the
    // hint, and more blocks share an SM
    a.run_rows = 1;
    a.max_q = max(a.head_tile, min(kThreads / a.stage_rows, a.max_q));
  }
  switch (kv_dtype) {
    case kF32:
      return launch<float>(a, streamed, st);
    case kBF16:
      return launch<__nv_bfloat16>(a, streamed, st);
    case kF16:
      return launch<__half>(a, streamed, st);
    case kI8:
      return launch<int8_t>(a, streamed, st);
    default:
      return cudaErrorInvalidValue;
  }
}
