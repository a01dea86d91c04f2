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
// Bound. Decode and chunked prefill read every K/V byte of every live
// page once and do ~4 flops per element read (QK and PV, per q head of
// the group), far below the card's ~20 flops/byte float32 ridge: the
// kernel is bound by the bytes of K/V it reads.
//
// Design against that bound. The TPU kernel walked a sequential grid axis
// over one row's pages and carried acc/m/l in scratch. Here:
// - Split pages across blocks (flash-decoding). Grid (partition, row,
//   kv head): a block takes `part_pages` consecutive live pages of a row
//   and keeps a float32 online softmax (m, l, acc) over them. A row that
//   fits one partition writes its output directly; a longer one writes
//   its partials to a workspace, and paged_attention_merge combines them
//   in partition order (deterministic). So a few long decode rows still
//   fill the card.
// - One read of a page for the rows of one sequence. The engine lays a
//   prefill chunk's rows of one sequence side by side, with lens rising
//   by one and tables that agree on every live page. A block whose row
//   continues such a run (checked in the kernel: non-decreasing lens, and
//   tables equal over the previous row's live pages) leaves it to the
//   run's first row, whose block scores up to `run_rows` rows (times the
//   GQA group) against each page once, each row with its own causal
//   limit. Any other row is a run of one.
// - Several pages per barrier. A stage holds up to 64 page rows of K and
//   V, copied by 16-, 8- or 4-byte cp.async (the widest that divides a
//   row's bytes; 2- or 1-byte plain copies where none does) into rows
//   padded by 16 bytes (conflict-free row-wise reads), two stages in
//   flight. For QK each thread owns one page row and walks its head dim
//   against the staged q vectors (broadcast reads), eight elements at a
//   time (and, where d is not a multiple of 8, in an instantiation of its
//   own, the last d % 8 one at a time); the online softmax runs a warp
//   per q vector; for PV each thread owns fixed output elements and reads V
//   rows with neighbouring lanes on neighbouring columns (where d divides
//   the block, a thread's elements share one column, so a V element is
//   read once for all of a chunk tile's q vectors). A decode block
//   has few q vectors (the GQA group), so there the threads of one page
//   row split its head dim, and the threads of one output element split
//   the page rows, each summed through shared memory. The per-thread
//   arrays are small (16 output elements, 16 q vectors): their registers
//   bound the blocks in flight, and decode's short, latency-bound blocks
//   need many.
// - int8 pages move as int8 with their scales staged beside them: the K
//   scale folds into the score, the V scale into P.
// - Any shape the TPU kernel takes (it tiles one whole page and one
//   [group, d] q block per grid step). A page longer than a stage (64
//   rows, fewer at a large d) is walked in sub-stages of one page, so a
//   partition still counts whole pages. A group whose q vectors or
//   group x d elements exceed one block is split over q-head tiles (grid
//   axis z); each tile reads the page itself. Above d 256 the output
//   columns split over blocks (grid axis z too): each block sums the
//   score over all of d and stages only its slice of V.
// - A head dim whose two stages of one K row and one V column slice,
//   plus the float32 q vectors of the block's rows, exceed the shared
//   memory a block may have (past ~19K elements at f32) runs a streamed
//   kernel instead: K, q and V are read from global memory over d in
//   warp-strided slices, 32 page rows a pass, so its shared memory does
//   not grow with d. Every shape the staged kernel takes stays on it.
// f32 pools stay on float32 FMAs (TF32 would break the 2e-5 tolerance).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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
// / part_pages); null where n_parts is 1). Takes any head_dim, any
// page_size and any n_heads that kv_heads divides; the pools must be
// aligned to chunk_bytes(head_dim * element size), the width the rows are
// staged in.
// Returns kMisaligned where they are not, else the cudaError_t of the
// launches (0 on success). A head dim whose staged rows exceed a block's
// shared memory runs the streamed kernel. Allocates nothing.
constexpr int kMisaligned = -1;

extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* k_pages, const void* v_pages,
    int kv_dtype, const void* k_scales, const void* v_scales,
    const void* tables, const void* lens, void* out, void* part_ml,
    void* part_acc, int num_tokens, int n_heads, int kv_heads, int head_dim,
    int page_size, int pages_per_seq, int part_pages, float scale,
    void* stream) {
  if (head_dim <= 0 || page_size <= 0 || kv_heads <= 0 ||
      n_heads % kv_heads || part_pages <= 0)
    return cudaErrorInvalidValue;
  const int group = n_heads / kv_heads;
  const int kv_size = kv_dtype == kF32 ? 4 : (kv_dtype == kI8 ? 1 : 2);
  const uintptr_t align = chunk_bytes(head_dim * kv_size);
  if (reinterpret_cast<uintptr_t>(k_pages) % align ||
      reinterpret_cast<uintptr_t>(v_pages) % align)
    return kMisaligned;
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
  a.pages_per_seq = pages_per_seq;
  a.part_pages = part_pages;
  a.n_parts = (pages_per_seq + part_pages - 1) / part_pages;
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
  a.scale = scale;
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
  }
  auto st = static_cast<cudaStream_t>(stream);
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
