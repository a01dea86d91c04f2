// Ragged paged attention for Hopper (sm_90a): kernel B4 of the port.
//
// Replaces paddle_tpu/ops/paged_attention.py::paged_attention_kernel, the
// Pallas TPU kernel behind ragged_paged_attention(impl="pallas").
//
// Function. Token row t of q [T, H, D] attends the first lens[t] cached
// positions of its own block table tables[t, :]: position p lives in page
// tables[t, p / page_size] at row p % page_size of the pools
// [num_pages, page_size, KVH, D]. The H / KVH q heads of one group share a
// kv head. int8 pools carry one float32 scale per page row ([num_pages,
// page_size]) and are dequantized as value * scale. lens[t] == 0 gives a
// zero row; -1 table entries are read as page 0. Scores and the softmax
// are float32; the output has q's dtype.
//
// Bound. Decode and chunked prefill read every K/V byte of every live
// page once and do ~4 flops per element read (QK and PV, per q head of
// the group), far below the card's ~20 flops/byte float32 ridge: the
// kernel is bound by the bytes of K/V it reads.
//
// Design against that bound. The TPU kernel walked a sequential grid axis
// over pages and carried acc/m/l in scratch; on Hopper blocks run in no
// order, so one CUDA block owns one (token row, kv head) and loops over
// that row's real pages only (pages past lens[t] are never touched, so
// traffic scales with the true context, not the table width). Each page's
// K and V rows are copied global->shared with 16-byte cp.async, double
// buffered: page j+1 is in flight while page j is scored, which hides the
// load latency that dominates a byte-bound loop. The GQA group's q rows
// are scored against one copy of the kv head's rows, so a K/V byte is
// read from device memory once per group, not once per q head. int8 pages
// move as int8 (a quarter of the f32 bytes) and are dequantized in
// registers. Splitting pages across blocks (flash-decoding), TMA and
// wgmma are later work (ROADMAP).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// dtype codes shared with paddle_tpu_torch/ops/paged_attention.py
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one block: two stages of (K page, V page) in the pool
// dtype, then float32 q rows, accumulators, scores and softmax state.
__host__ __device__ inline size_t smem_bytes(int kv_size, int head_dim,
                                             int page_size, int group) {
  return 4ull * page_size * head_dim * kv_size +
         4ull * (2 * group * head_dim + group * page_size + 3 * group);
}

template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attention(const void* __restrict__ q, int q_dtype,
                    const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lens, void* __restrict__ out,
                    int n_heads, int kv_heads, int page_size,
                    int pages_per_seq, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kChunk = 16 / sizeof(KV);  // elements per 16-byte copy
  constexpr int kChunksPerRow = D / kChunk;

  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = n_heads / kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int page_elems = page_size * D;

  extern __shared__ __align__(16) unsigned char smem[];
  KV* kv_buf = reinterpret_cast<KV*>(smem);  // [stage][k|v][page_elems]
  float* q_s = reinterpret_cast<float*>(smem + 4ull * page_elems *
                                                   sizeof(KV));
  float* acc = q_s + group * D;
  float* s = acc + group * D;  // [group][page_size]: scores, then probs
  float* m_s = s + group * page_size;
  float* l_s = m_s + group;
  float* alpha_s = l_s + group;

  // q rows kvh*group .. kvh*group+group-1 of token t; out has q's layout
  const int64_t base = (static_cast<int64_t>(t) * n_heads +
                        static_cast<int64_t>(kvh) * group) * D;
  const int len = lens[t];
  if (len <= 0) {
    for (int i = tid; i < group * D; i += kThreads) store_f32(out, base + i,
                                                             0.f, q_dtype);
    return;
  }
  for (int i = tid; i < group * D; i += kThreads) {
    q_s[i] = load_f32(q, base + i, q_dtype);
    acc[i] = 0.f;
  }
  if (tid < group) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int n_pages = (len + page_size - 1) / page_size;
  const int32_t* table = tables + static_cast<int64_t>(t) * pages_per_seq;
  const int64_t row_stride = static_cast<int64_t>(kv_heads) * D;

  auto page_of = [&](int j) {
    const int p = table[j];
    return p < 0 ? 0 : p;
  };
  auto issue = [&](int j, int stage) {
    const int64_t g0 = static_cast<int64_t>(page_of(j)) * page_size *
                           row_stride +
                       static_cast<int64_t>(kvh) * D;
    KV* kd = kv_buf + static_cast<size_t>(stage) * 2 * page_elems;
    KV* vd = kd + page_elems;
    for (int c = tid; c < page_size * kChunksPerRow; c += kThreads) {
      const int r = c / kChunksPerRow;
      const int col = (c % kChunksPerRow) * kChunk;
      const int64_t g = g0 + r * row_stride + col;
      cp_async16(kd + r * D + col, k_pages + g);
      cp_async16(vd + r * D + col, v_pages + g);
    }
    cp_async_commit();
  };

  issue(0, 0);
  for (int j = 0; j < n_pages; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_pages) {
      issue(j + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KV* kd = kv_buf + static_cast<size_t>(stage) * 2 * page_elems;
    const KV* vd = kd + page_elems;
    const int valid = min(page_size, len - j * page_size);
    const int64_t srow = static_cast<int64_t>(page_of(j)) * page_size;

    // scores: one (q row, page row) pair per warp step, lanes split D
    for (int p = warp; p < group * page_size; p += kWarps) {
      const int g = p / page_size;
      const int r = p - g * page_size;
      float dot = 0.f;
      if (r < valid) {
        const float ks = kQuant ? k_scales[srow + r] : 1.f;
#pragma unroll
        for (int c = lane; c < D; c += 32) {
          float kv = to_f32(kd[r * D + c]);
          if (kQuant) kv *= ks;
          dot += q_s[g * D + c] * kv;
        }
        dot = warp_sum(dot);
      }
      if (lane == 0) s[p] = r < valid ? dot * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax, one thread per q row of the group
    if (tid < group) {
      float* sg = s + tid * page_size;
      float mx = m_s[tid];
      for (int r = 0; r < valid; ++r) mx = fmaxf(mx, sg[r]);
      const float alpha = expf(m_s[tid] - mx);
      float sum = 0.f;
      for (int r = 0; r < valid; ++r) {
        const float pr = expf(sg[r] - mx);
        sg[r] = pr;
        sum += pr;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mx;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

    // acc = alpha * acc + P V; each thread owns fixed (q row, column)s
    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D;
      const int c = i - g * D;
      const float* pg = s + g * page_size;
      float a = acc[i] * alpha_s[g];
      for (int r = 0; r < valid; ++r) {
        float v = to_f32(vd[r * D + c]);
        if (kQuant) v *= v_scales[srow + r];
        a += pg[r] * v;
      }
      acc[i] = a;
    }
    __syncthreads();  // the stage is refilled two pages later
  }

  for (int i = tid; i < group * D; i += kThreads) {
    const float l = l_s[i / D];
    store_f32(out, base + i, l == 0.f ? 0.f : acc[i] / l, q_dtype);
  }
}

template <typename KV, int D>
cudaError_t launch(const void* q, int q_dtype, const void* k_pages,
                   const void* v_pages, const float* k_scales,
                   const float* v_scales, const int32_t* tables,
                   const int32_t* lens, void* out, int num_tokens,
                   int n_heads, int kv_heads, int page_size,
                   int pages_per_seq, float scale, cudaStream_t stream) {
  const size_t smem =
      smem_bytes(sizeof(KV), D, page_size, n_heads / kv_heads);
  auto kernel = paged_attention<KV, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(num_tokens, kv_heads), kThreads, smem, stream>>>(
      q, q_dtype, static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages), k_scales, v_scales, tables, lens,
      out, n_heads, kv_heads, page_size, pages_per_seq, scale);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_d(int head_dim, const void* q, int q_dtype,
                     const void* k_pages, const void* v_pages,
                     const float* k_scales, const float* v_scales,
                     const int32_t* tables, const int32_t* lens, void* out,
                     int num_tokens, int n_heads, int kv_heads,
                     int page_size, int pages_per_seq, float scale,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<KV, 64>(q, q_dtype, k_pages, v_pages, k_scales,
                            v_scales, tables, lens, out, num_tokens,
                            n_heads, kv_heads, page_size, pages_per_seq,
                            scale, stream);
    case 128:
      return launch<KV, 128>(q, q_dtype, k_pages, v_pages, k_scales,
                             v_scales, tables, lens, out, num_tokens,
                             n_heads, kv_heads, page_size, pages_per_seq,
                             scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers
// of contiguous tensors; the stream is PyTorch's current stream. Returns
// the cudaError_t of the launch (0 on success). Allocates nothing.
extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* k_pages, const void* v_pages,
    int kv_dtype, const void* k_scales, const void* v_scales,
    const void* tables, const void* lens, void* out, int num_tokens,
    int n_heads, int kv_heads, int head_dim, int page_size,
    int pages_per_seq, float scale, void* stream) {
  const auto* ks = static_cast<const float*>(k_scales);
  const auto* vs = static_cast<const float*>(v_scales);
  const auto* tb = static_cast<const int32_t*>(tables);
  const auto* ln = static_cast<const int32_t*>(lens);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      return launch_d<float>(head_dim, q, q_dtype, k_pages, v_pages, ks, vs,
                             tb, ln, out, num_tokens, n_heads, kv_heads,
                             page_size, pages_per_seq, scale, st);
    case kBF16:
      return launch_d<__nv_bfloat16>(head_dim, q, q_dtype, k_pages,
                                     v_pages, ks, vs, tb, ln, out,
                                     num_tokens, n_heads, kv_heads,
                                     page_size, pages_per_seq, scale, st);
    case kF16:
      return launch_d<__half>(head_dim, q, q_dtype, k_pages, v_pages, ks,
                              vs, tb, ln, out, num_tokens, n_heads,
                              kv_heads, page_size, pages_per_seq, scale,
                              st);
    case kI8:
      return launch_d<int8_t>(head_dim, q, q_dtype, k_pages, v_pages, ks,
                              vs, tb, ln, out, num_tokens, n_heads,
                              kv_heads, page_size, pages_per_seq, scale,
                              st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one launch needs, so the wrapper can refuse a
// shape before launching it.
extern "C" long long paged_attention_smem_bytes(int kv_dtype, int head_dim,
                                                int page_size, int group) {
  const int kv_size = kv_dtype == kF32 ? 4 : (kv_dtype == kI8 ? 1 : 2);
  return static_cast<long long>(
      smem_bytes(kv_size, head_dim, page_size, group));
}
