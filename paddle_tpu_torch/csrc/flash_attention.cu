// Flash attention for Hopper (sm_90a): kernels B1, B2 and B3 of the port.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/flash_attention.py:
//   B1 flash_fwd     <- _fwd_kernel (launched by _fwd)
//   B2 flash_bwd_dq  <- _bwd_dq_kernel (first pallas_call of _bwd)
//   B3 flash_bwd_dkv <- _bwd_dkv_kernel (second pallas_call of _bwd)
//
// Function. q [b, sq, hq, D], k and v [b, sk, hkv, D], BSHD with any
// (b, s, h) strides and unit stride on D; q head h reads kv head
// h / (hq / hkv). S = (q . k^T) * scale in float32. Under `causal` the mask
// is bottom-right aligned: query row i sees key j iff i + (sk - sq) >= j;
// masked scores take the finite value -0.7 * FLT_MAX, as on the TPU.
//   B1: O = softmax(S) V, with P rounded to V's dtype before P.V (as the
//       TPU kernel's p.astype(v.dtype)); O in q's dtype and the float32
//       log-sum-exp LSE [b, hq, sq]. A row whose sum stays 0 writes 0.
//   B2: P = exp(S - LSE) in float32, delta = rowsum(O * dO) from the stored
//       O, dS = P * (dP - delta) * scale with dP = dO . V^T, dQ = dS . K.
//   B3: dV = P^T . dO and dK = dS^T . Q, summed over the q heads of the
//       GQA group inside the block (the TPU kernel writes per-q-head f32
//       partials and sums them afterwards), written in k's / v's dtype.
// Every product and sum is float32; inputs are read as their dtype.
//
// Bound. At the training shapes (s = 1024, D = 64) each kernel does
// 4-8 flops per (query, key) pair per D element and reads each q/k/v row
// O(s / 64) times from L2 but once from device memory: far above the
// card's bytes/flop ridge, so the work is bound by operations.
//
// Design against that bound, simple first. One block of 256 threads owns a
// 64-row tile (B1, B2: q rows of one (b, q head); B3: k rows of one
// (b, kv head)) and loops over the 64-row tiles of the other side, staged
// in shared memory as float32 with a padded row (D + 1 floats) so that the
// 16 lanes of a row group hit distinct banks. Each thread keeps a 4 x 4 block
// of the 64 x 64 score tile and a 4 x D/16 block of the output tile in
// registers; a row's 16 owners reduce with shuffles. Tiles wholly above the
// causal diagonal are skipped; the loop runs tile 0 first, which every row
// sees, so the finite mask value never leaks into a result. The products
// are SIMT float32 FMAs: tensor cores (mma / wgmma), TMA staging and a
// persistent schedule are later work (ROADMAP, "B1-B3, make them fast").

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // rows of a q tile and of a k tile
constexpr int kLP = kTile + 1;      // padded row of a score tile in smem
constexpr float kMaskValue = -0.7f * FLT_MAX;

// dtype codes shared with paddle_tpu_torch/ops/flash_attention.py
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
// operand slots of Params::st
enum Slot : int { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kSlots };

struct Strides {
  long long b, s, h;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;           // B1 writes it, B2/B3 read it
  const void* dout;  // dO
  float* lse;        // [b, hq, sq], contiguous
  void* dq;
  void* dk;
  void* dv;
  Strides st[kSlots];
  int sq, sk, hq, hkv;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// x rounded to T and back: the TPU kernel's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reductions over the 16 lanes that share a row (lanes 0-15, 16-31)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// element (b, s, h, 0) of a BSHD operand
template <typename T>
__device__ __forceinline__ const T* row_ptr(const void* base,
                                            const Strides& st, int b, int s,
                                            int h) {
  return static_cast<const T*>(base) + b * st.b + s * st.s + h * st.h;
}

// Stage rows s0 .. s0+63 of (b, h) as float32, row stride D + 1.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const void* base,
                                          const Strides& st, int b, int s0,
                                          int h) {
  const T* src = row_ptr<T>(base, st, b, s0, h);
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * (D + 1) + c] = to_f32(src[r * st.s + c]);
  }
}

// delta[r] = rowsum(O * dO) of rows s0 .. s0+63, dO staged in smem:
// four lanes per row.
template <typename T, int D>
__device__ __forceinline__ void row_delta(float* delta, const Params& p,
                                          const float* dos, int b, int s0,
                                          int h) {
  const int r = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const T* o = row_ptr<T>(p.o, p.st[kO], b, s0 + r, h);
  float acc = 0.f;
  for (int c = part; c < D; c += 4) acc += to_f32(o[c]) * dos[r * (D + 1) + c];
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) delta[r] = acc;
}

// a[i][j] += A[row(i)] . B[col(j)] over D, for this thread's rows
// tr*4+i and columns tc+16j of a 64 x 64 tile
template <int D>
__device__ __forceinline__ void tile_dot(float (&a)[4][4], const float* A,
                                         const float* B, int tr, int tc) {
  constexpr int LD = D + 1;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[(tr * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = B[(tc + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(x[i], y[j], a[i][j]);
  }
}

// The last k tile a q tile starting at q0 sees (exclusive bound).
__device__ __forceinline__ int k_tiles_seen(const Params& p, int q0) {
  const int nk = p.sk / kTile;
  if (!p.causal) return nk;
  const int last = q0 + kTile - 1 + (p.sk - p.sq);
  return min(nk, last / kTile + 1);
}

// ---------------------------------------------------------------------------
// B1: forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;  // [64][kLP]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int offset = p.sk - p.sq;

  load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, h);
  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = k_tiles_seen(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps
    load_tile<T, D>(ks, p.k, p.st[kK], b, k0, kvh);
    load_tile<T, D>(vs, p.v, p.st[kV], b, k0, kvh);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<D>(s, qs, ks, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i + offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * p.scale;
        if (p.causal && row < k0 + tc + 16 * j) x = kMaskValue;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        ps[(tr * 4 + i) * kLP + tc + 16 * j] = round_to<T>(e);
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float x[4], y[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = ps[(tr * 4 + i) * kLP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) y[j] = vs[kk * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }

  T* o = static_cast<T*>(p.o);
  const Strides& so = p.st[kO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + b * so.b + r * so.s + h * so.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[tc + 16 * j] = from_f32<T>(acc[i][j] / l_safe);
    if (tc == 0)
      p.lse[(static_cast<long long>(b) * p.hq + h) * p.sq + r] =
          m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// B2: dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Params p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;  // [64][kLP]
  float* lse_s = dss + kTile * kLP;
  float* delta_s = lse_s + kTile;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int offset = p.sk - p.sq;

  load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, h);
  load_tile<T, D>(dos, p.dout, p.st[kDO], b, q0, h);
  if (threadIdx.x < kTile)
    lse_s[threadIdx.x] =
        p.lse[(static_cast<long long>(b) * p.hq + h) * p.sq + q0 +
              threadIdx.x];
  __syncthreads();
  row_delta<T, D>(delta_s, p, dos, b, q0, h);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = k_tiles_seen(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(ks, p.k, p.st[kK], b, k0, kvh);
    load_tile<T, D>(vs, p.v, p.st[kV], b, k0, kvh);
    __syncthreads();

    float s[4][4] = {};
    float dp[4][4] = {};
    tile_dot<D>(s, qs, ks, tr, tc);
    tile_dot<D>(dp, dos, vs, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const float lse = lse_s[r];
      const float delta = delta_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * p.scale;
        if (p.causal && q0 + r + offset < k0 + tc + 16 * j) x = kMaskValue;
        const float pr = expf(x - lse);
        dss[r * kLP + tc + 16 * j] = pr * (dp[i][j] - delta) * p.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float x[4], y[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = dss[(tr * 4 + i) * kLP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) y[j] = ks[kk * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }

  T* dq = static_cast<T*>(p.dq);
  const Strides& sd = p.st[kDQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dq + b * sd.b + (q0 + tr * 4 + i) * sd.s + h * sd.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tc + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// B3: dK and dV, the GQA group summed in the block
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(Params p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;  // [64 q][kLP]
  float* dss = ps + kTile * kLP;
  float* lse_s = dss + kTile * kLP;
  float* delta_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int offset = p.sk - p.sq;
  const int nq = p.sq / kTile;

  load_tile<T, D>(ks, p.k, p.st[kK], b, k0, kvh);
  load_tile<T, D>(vs, p.v, p.st[kV], b, k0, kvh);

  // this thread's output block: k rows tr*4+i, columns tc+16j
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (p.causal && q0 + kTile - 1 + offset < k0) continue;
      __syncthreads();  // the previous tile is done with qs/dos/ps/dss
      load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, h);
      load_tile<T, D>(dos, p.dout, p.st[kDO], b, q0, h);
      if (threadIdx.x < kTile)
        lse_s[threadIdx.x] =
            p.lse[(static_cast<long long>(b) * p.hq + h) * p.sq + q0 +
                  threadIdx.x];
      __syncthreads();
      row_delta<T, D>(delta_s, p, dos, b, q0, h);
      __syncthreads();

      // score tile with q rows tr*4+i and k columns tc+16j
      float s[4][4] = {};
      float dp[4][4] = {};
      tile_dot<D>(s, qs, ks, tr, tc);
      tile_dot<D>(dp, dos, vs, tr, tc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        const float lse = lse_s[r];
        const float delta = delta_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j] * p.scale;
          if (p.causal && q0 + r + offset < k0 + tc + 16 * j)
            x = kMaskValue;
          const float pr = expf(x - lse);
          ps[r * kLP + tc + 16 * j] = pr;
          dss[r * kLP + tc + 16 * j] = pr * (dp[i][j] - delta) * p.scale;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's 64 q rows
#pragma unroll 2
      for (int qq = 0; qq < kTile; ++qq) {
        float pk[4], sk_[4], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pk[i] = ps[qq * kLP + tr * 4 + i];
          sk_[i] = dss[qq * kLP + tr * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = dos[qq * LD + tc + 16 * j];
          qv[j] = qs[qq * LD + tc + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] = fmaf(pk[i], dov[j], dv[i][j]);
            dk[i][j] = fmaf(sk_[i], qv[j], dk[i][j]);
          }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
  const Strides& sdk = p.st[kDK];
  const Strides& sdv = p.st[kDV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + tr * 4 + i;
    T* krow = dkp + b * sdk.b + r * sdk.s + kvh * sdk.h;
    T* vrow = dvp + b * sdv.b + r * sdv.s + kvh * sdv.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      krow[tc + 16 * j] = from_f32<T>(dk[i][j]);
      vrow[tc + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Which : int { kFwd = 0, kBwdDq = 1, kBwdDkv = 2 };

template <int D>
constexpr size_t smem_floats(int which) {
  return which == kFwd     ? 3 * kTile * (D + 1) + kTile * kLP
         : which == kBwdDq ? 4 * kTile * (D + 1) + kTile * kLP + 2 * kTile
                           : 4 * kTile * (D + 1) + 2 * kTile * kLP +
                                 2 * kTile;
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, size_t smem,
                          const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(int which, int batch, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>(which) * sizeof(float);
  switch (which) {
    case kFwd:
      return launch_kernel(flash_fwd<T, D>,
                           dim3(p.sq / kTile, p.hq, batch), smem, p, stream);
    case kBwdDq:
      return launch_kernel(flash_bwd_dq<T, D>,
                           dim3(p.sq / kTile, p.hq, batch), smem, p, stream);
    case kBwdDkv:
      return launch_kernel(flash_bwd_dkv<T, D>,
                           dim3(p.sk / kTile, p.hkv, batch), smem, p,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int head_dim, int which, int batch, const Params& p,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(which, batch, p, stream);
    case 128:
      return launch<T, 128>(which, batch, p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `which`: 0 = B1 (writes o and
// lse), 1 = B2 (writes dq), 2 = B3 (writes dk and dv). `ptrs` holds the
// device pointers q, k, v, o, do, lse, dq, dk, dv (unused ones may be null);
// `strides` the (b, s, h) element strides of q, k, v, o, do, dq, dk, dv, in
// that order (unit stride on the head dim is the caller's check). Sequence
// lengths are multiples of 64. Returns the launch's cudaError_t (0 on
// success). Allocates nothing.
extern "C" int flash_attention_launch(int which, int dtype, int head_dim,
                                      void* const* ptrs,
                                      const long long* strides, int batch,
                                      int sq, int sk, int hq, int hkv,
                                      float scale, int causal, void* stream) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.o = ptrs[3];
  p.dout = ptrs[4];
  p.lse = static_cast<float*>(ptrs[5]);
  p.dq = ptrs[6];
  p.dk = ptrs[7];
  p.dv = ptrs[8];
  for (int i = 0; i < kSlots; ++i)
    p.st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.sq = sq;
  p.sk = sk;
  p.hq = hq;
  p.hkv = hkv;
  p.scale = scale;
  p.causal = causal;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_d<float>(head_dim, which, batch, p, st);
    case kBF16:
      return launch_d<__nv_bfloat16>(head_dim, which, batch, p, st);
    case kF16:
      return launch_d<__half>(head_dim, which, batch, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}
