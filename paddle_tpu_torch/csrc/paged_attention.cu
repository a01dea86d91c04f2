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
// are float32; the output has q's dtype. d is any multiple of 8 up to 256.
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
//   V, copied by 16-byte (or 8-byte) cp.async into rows padded by 16 bytes
//   (conflict-free row-wise reads), two stages in flight. For QK each
//   thread owns one page row and walks its head dim against the staged
//   q vectors (broadcast reads); the online softmax runs a warp per q
//   vector; for PV each thread owns fixed output elements and reads V
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
constexpr int kMaxQ = 32;       // q vectors of a block: run rows x group
constexpr int kMaxItems = 16;   // output elements a thread accumulates
constexpr int kMaxElems = kMaxItems * kThreads;  // q vectors x d
constexpr int kMaxRun = 16;     // rows of one sequence in one block
constexpr int kStageBudget = 72 * 1024;  // bytes of the two K/V stages
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
  int part_pages, n_parts, stage_pages, run_rows;
  int max_q;  // q vectors of a block at most: run_rows x group
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

// `bytes` (16, 8 or 4) from global to shared memory
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

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

__host__ __device__ inline int row_bytes(int kv_size, int d) {
  return d * kv_size + 16;
}

// Dynamic shared memory: two stages of (K, V) page rows, then float32 q
// vectors, scores, int8 scales and softmax state.
__host__ __device__ inline size_t smem_bytes(int kv_size, int d,
                                             int stage_rows, int max_q) {
  return 4ull * stage_rows * row_bytes(kv_size, d) +
         4ull * (max_q * d + max_q * kMaxRows + 4 * kMaxRows + kThreads +
                 3 * max_q + kMaxRun);
}

template <typename KV>
__global__ void __launch_bounds__(kThreads) paged_attention(Args a) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const int pj = blockIdx.x;  // partition of the row's pages
  const int r = blockIdx.y;
  const int kvh = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.n_heads / a.kv_heads;
  const int d = a.d;
  const int ps = a.page_size;

  // the run of rows this block owns: r .. r1 - 1
  if (r % a.run_rows != 0 && joins(a, r)) return;
  int r1 = r + 1;
  while (r1 < a.T && r1 % a.run_rows != 0 && joins(a, r1)) ++r1;
  const int M = (r1 - r) * G;  // q vectors: row-major (row, head)
  const int max_len = a.lens[r1 - 1];
  if (max_len <= 0) {  // a zero row, always a run of one
    if (pj == 0)
      for (int i = tid; i < G * d; i += kThreads)
        store_f32(a.out,
                  (static_cast<int64_t>(r) * a.n_heads + kvh * G) * d + i,
                  0.f, a.q_dtype);
    return;
  }
  const int live = (max_len + ps - 1) / ps;
  const int p_begin = pj * a.part_pages;
  if (p_begin >= live) return;
  const int p_end = min(live, p_begin + a.part_pages);

  const int rb = row_bytes(sizeof(KV), d);
  const int stage_rows = a.stage_pages * ps;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv = smem;  // [stage][K | V][stage_rows][rb]
  float* q_s = reinterpret_cast<float*>(smem + 4ull * stage_rows * rb);
  float* s_s = q_s + a.max_q * d;  // [max_q][kMaxRows]: scores, then P
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
  const int chunk = (d * sizeof(KV)) % 16 == 0 ? 16 : 8;
  const int chunks = d * static_cast<int>(sizeof(KV)) / chunk;
  auto issue = [&](int p0, int st) {
    const int rows = min(a.stage_pages, p_end - p0) * ps;
    unsigned char* kd = kv + static_cast<size_t>(st) * 2 * stage_rows * rb;
    unsigned char* vd = kd + static_cast<size_t>(stage_rows) * rb;
    for (int i = tid; i < rows * chunks; i += kThreads) {
      const int rr = i / chunks;
      const int ch = i - rr * chunks;
      const int page = max(table[p0 + rr / ps], 0);
      const int64_t g = (static_cast<int64_t>(page) * ps + rr % ps) *
                            row_stride +
                        static_cast<int64_t>(kvh) * d * sizeof(KV) +
                        ch * chunk;
      cp_async(kd + rr * rb + ch * chunk,
               static_cast<const unsigned char*>(a.k_pages) + g, chunk);
      cp_async(vd + rr * rb + ch * chunk,
               static_cast<const unsigned char*>(a.v_pages) + g, chunk);
    }
    if (kQuant) {
      for (int i = tid; i < rows; i += kThreads) {
        const int64_t row =
            static_cast<int64_t>(max(table[p0 + i / ps], 0)) * ps + i % ps;
        cp_async(sc_s + (2 * st) * kMaxRows + i, a.k_scales + row, 4);
        cp_async(sc_s + (2 * st + 1) * kMaxRows + i, a.v_scales + row, 4);
      }
    }
    cp_async_commit();
  };

  issue(p_begin, 0);
  // q vectors in log2 units: exp(x) = exp2(x * log2 e)
  const float qscale = a.scale * kLog2e;
  for (int i = tid; i < M * d; i += kThreads) {
    const int m = i / d;
    const int c = i - m * d;
    const int64_t src =
        (static_cast<int64_t>(r + m / G) * a.n_heads + kvh * G + m % G) * d +
        c;
    q_s[i] = load_f32(a.q, src, a.q_dtype) * qscale;
  }
  if (tid < M) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  if (tid < r1 - r) len_s[tid] = a.lens[r + tid];
  float acc[kMaxItems];
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) acc[k] = 0.f;

  // QK: thread (kr, grp) scores page row kr. With at least as many q
  // vectors as groups, group grp takes q vectors grp + ngrp * i over the
  // whole head dim; with fewer (decode), the groups split the head dim
  // into dparts interleaved 8-column parts and the softmax sums them.
  const int ngrp = kThreads / stage_rows;
  const int kr = tid % stage_rows;
  const int grp = tid / stage_rows;
  const int dparts = M < ngrp ? min(ngrp, a.max_q) / M : 1;
  const bool qk_active = grp < (dparts > 1 ? M * dparts : ngrp);
  const int m0 = dparts > 1 ? grp % M : grp;
  const int qstep = dparts > 1 ? M : ngrp;
  const int dpart = dparts > 1 ? grp / M : 0;
  // PV: thread owns output element i = tid % (M d); with few elements
  // (decode), jsplit threads share one, each over every jsplit-th row
  const int items = M * d;
  const int jsplit = 2 * items <= kThreads ? min(4, kThreads / items) : 1;
  const int n_stages = (p_end - p_begin + a.stage_pages - 1) / a.stage_pages;
  for (int si = 0; si < n_stages; ++si) {
    const int p0 = p_begin + si * a.stage_pages;
    const int st = si & 1;
    if (si + 1 < n_stages) {
      issue(p0 + a.stage_pages, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(a.stage_pages, p_end - p0) * ps;
    const int pos0 = p0 * ps;
    const unsigned char* kd =
        kv + static_cast<size_t>(st) * 2 * stage_rows * rb;
    const unsigned char* vd = kd + static_cast<size_t>(stage_rows) * rb;
    const float* ksc = sc_s + (2 * st) * kMaxRows;
    const float* vsc = ksc + kMaxRows;

    // raw scores of page row kr (partial over the head dim if dparts > 1)
    if (qk_active && kr < rows) {
      float s[kMaxQ / 2];
#pragma unroll
      for (int i = 0; i < kMaxQ / 2; ++i) s[i] = 0.f;
      const unsigned char* krow = kd + kr * rb;
      for (int c = 8 * dpart; c < d; c += 8 * dparts) {
        float x[8];
        load8<KV>(x, krow + c * sizeof(KV));
#pragma unroll
        for (int i = 0; i < kMaxQ / 2; ++i) {
          const int m = m0 + qstep * i;
          if (m >= M) break;
          const float4 qa = *reinterpret_cast<const float4*>(q_s + m * d + c);
          const float4 qb =
              *reinterpret_cast<const float4*>(q_s + m * d + c + 4);
          s[i] += qa.x * x[0] + qa.y * x[1] + qa.z * x[2] + qa.w * x[3] +
                  qb.x * x[4] + qb.y * x[5] + qb.z * x[6] + qb.w * x[7];
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
      const int len = len_s[m / G];
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
    if (jsplit == 1 && kThreads % d == 0) {
      // d divides the block: the thread's elements share column c, so
      // a V element is read once for all of them, and P four rows at once
      const int c = tid % d;
      const int m0 = tid / d;
      const int mstep = kThreads / d;
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
          v[e] = to_f32(*reinterpret_cast<const KV*>(vcol + (j + e) * rb));
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
        const float v = to_f32(*reinterpret_cast<const KV*>(vcol + j * rb));
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
        const int m = i / d;
        const int c = i - m * d;
        const float* prow = s_s + m * kMaxRows;
        const unsigned char* vcol = vd + c * sizeof(KV);
        float x = acc[k] * al_s[m];
        for (int j = 0; j < rows; ++j)
          x += prow[j] * to_f32(*reinterpret_cast<const KV*>(vcol + j * rb));
        acc[k] = x;
      }
    } else {
      const int part = tid / items;
      const int i = tid - part * items;
      if (part < jsplit) {
        const int m = i / d;
        const int c = i - m * d;
        const float* prow = s_s + m * kMaxRows;
        const unsigned char* vcol = vd + c * sizeof(KV);
        float x = 0.f;
        for (int j = part; j < rows; j += jsplit)
          x += prow[j] * to_f32(*reinterpret_cast<const KV*>(vcol + j * rb));
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
  // partials for paged_attention_merge
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int i = tid + k * kThreads;
    if (i >= M * d) break;
    const int m = i / d;
    const int c = i - m * d;
    const int t = r + m / G;
    const int64_t th = static_cast<int64_t>(t) * a.n_heads + kvh * G + m % G;
    const int np = parts_of(a, len_s[m / G]);
    if (np <= 1) {
      if (pj == 0) {
        const float l = l_s[m];
        store_f32(a.out, th * d + c, l == 0.f ? 0.f : acc[k] / l,
                  a.q_dtype);
      }
    } else if (pj < np) {
      const int64_t slot = th * a.n_parts + pj;
      a.part_acc[slot * d + c] = acc[k];
      if (c == 0) {
        a.part_ml[2 * slot] = m_s[m];
        a.part_ml[2 * slot + 1] = l_s[m];
      }
    }
  }
}

// Combines the partitions of every row that spans more than one, in
// partition order; grid (row, kv head)
__global__ void __launch_bounds__(kThreads) paged_attention_merge(Args a) {
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = a.n_heads / a.kv_heads;
  const int np = parts_of(a, a.lens[t]);
  if (np <= 1) return;
  for (int i = threadIdx.x; i < G * a.d; i += kThreads) {
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
}

template <typename KV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      smem_bytes(sizeof(KV), a.d, a.stage_pages * a.page_size, a.max_q);
  auto kernel = paged_attention<KV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.n_parts, a.T, a.kv_heads), kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_parts == 1) return e;
  paged_attention_merge<<<dim3(a.T, a.kv_heads), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers
// of contiguous tensors; the stream is PyTorch's current stream.
// `part_pages` is the partition size in pages; `part_ml` [T, H, n_parts,
// 2] and `part_acc` [T, H, n_parts, head_dim] float32 are the workspace
// of rows that span more than one partition (n_parts = ceil(pages_per_seq
// / part_pages); null where n_parts is 1). Takes head_dim a multiple of 8
// up to 256, page_size up to 64, and group * head_dim up to 2048. Returns
// the cudaError_t of the launches (0 on success). Allocates nothing.
extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* k_pages, const void* v_pages,
    int kv_dtype, const void* k_scales, const void* v_scales,
    const void* tables, const void* lens, void* out, void* part_ml,
    void* part_acc, int num_tokens, int n_heads, int kv_heads, int head_dim,
    int page_size, int pages_per_seq, int part_pages, float scale,
    void* stream) {
  const int group = n_heads / kv_heads;
  if (head_dim <= 0 || head_dim % 8 || head_dim > 256 || page_size <= 0 ||
      page_size > kMaxRows || group * head_dim > kMaxElems ||
      group > kMaxQ || part_pages <= 0)
    return cudaErrorInvalidValue;
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
  a.pages_per_seq = pages_per_seq;
  a.part_pages = part_pages;
  a.n_parts = (pages_per_seq + part_pages - 1) / part_pages;
  // pages a stage holds: up to 64 rows, two stages within the budget
  const int fit = kStageBudget / (4 * page_size * row_bytes(kv_size, head_dim));
  a.stage_pages = max(1, min(min(kMaxRows / page_size, fit), part_pages));
  a.run_rows = max(1, min(kMaxRun, min(kMaxQ / group,
                                       kMaxElems / (group * head_dim))));
  a.max_q = a.run_rows * group;
  a.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      return launch<float>(a, st);
    case kBF16:
      return launch<__nv_bfloat16>(a, st);
    case kF16:
      return launch<__half>(a, st);
    case kI8:
      return launch<int8_t>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}
