// Flash attention for Hopper (sm_90a): kernels B1, B2 and B3 of the port.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/flash_attention.py:
//   B1 flash_fwd     <- _fwd_kernel (launched by _fwd)
//   B2 flash_bwd_dq  <- _bwd_dq_kernel (first pallas_call of _bwd)
//   B3 flash_bwd_dkv <- _bwd_dkv_kernel (second pallas_call of _bwd)
//
// Function. q [b, sq, hq, d], k and v [b, sk, hkv, d], BSHD with any
// (b, s, h) strides and unit stride on d; q head h reads kv head
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
// Every sum is float32; inputs are read as their dtype.
//
// Head dims. Each kernel is instantiated at a padded head dim D (64, 128,
// and 256 in the half types) and takes the operands' d <= D at run time:
// loads fill columns d..D-1 with zeros, which change neither q . k nor the
// columns < d of a product, and stores write columns < d only.
//
// Bound. Each kernel does 4-8 flops per visible (query, key) pair per
// head-dim element. At the gpt2-small train shape (s 1024, d 64, causal)
// in bf16, moving each input and output once through device memory takes
// about as long as the products at the tensor cores' peak (B1: 0.015 ms
// by bytes, 0.013 ms by operations); float32, without tensor cores, is
// bound by operations. Each block re-reads the other side's tiles from L2,
// s / 64 times per row, so the reachable rate rests on feeding the
// products from shared memory and registers.
//
// Two designs.
//
// bf16 / f16, B1 and B2 (flash_fwd_mma, flash_bwd_dq_mma): FlashAttention-2
// on the tensor cores. A block of 4 warps owns a 64-row q tile of one
// (b, q head), 16 rows a warp, and walks the 64-key tiles of K and V. The
// tiles stay in the input dtype in shared memory, in rows of 16-byte
// chunks whose chunk index is XORed with the row (so the 8 rows of one
// ldmatrix fall in 8 distinct bank groups), loaded by cp.async into two
// stages: tile kt+1 is in flight while tile kt is computed. Products are
// mma.sync m16n8k16 with float32 sums; operands come from ldmatrix (V and,
// in B2, K transposed by ldmatrix.trans). The score tile stays in
// registers: the online softmax reduces a row over its quad of lanes, and
// since the m16n8 accumulator layout is the m16n8k16 A-operand layout, the
// rounded P (B1) or dS (B2) feeds the next product without a trip through
// shared memory. B2 keeps dS . K at float32-level accuracy, as the TPU
// kernel's f32 product: dS is split into hi = round(dS) and
// lo = round(dS - hi) in the input dtype and both are multiplied by the
// exact K (about 16 mantissa bits of dS). Only the diagonal k tile is
// masked; tiles above it are skipped; q tiles are scheduled heaviest
// first (reverse order on the grid's slowest axis) to shorten the tail.
//
// float32 (B1, B2) and B3 in every dtype (flash_fwd, flash_bwd_dq,
// flash_bwd_dkv): SIMT float32 FMAs. One block of 256 threads owns a
// 64-row tile (B1, B2: q rows of one (b, q head); B3: k rows of one
// (b, kv head)) and loops over the 64-row tiles of the other side, staged
// in shared memory as float32 (B3 at D = 256: in the half dtype) in rows
// padded to an odd count of 32-bit words. Each thread keeps a 4 x 4 block
// of the 64 x 64 score tile and a 4 x D/16 block of the output tile in
// registers; a row's 16 owners reduce with shuffles. There is no
// full-float32 tensor-core product (TF32 keeps 10 mantissa bits).
//
// Both run k tile 0 first, which every row sees, so the finite mask value
// never leaks into a result.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;       // SIMT kernels
constexpr int kMmaThreads = 128;    // tensor-core kernels: 4 warps x 16 rows
constexpr int kTile = 64;           // rows of a q tile and of a k tile
constexpr int kLP = kTile + 1;      // padded row of a score tile in smem
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
  int d;             // the operands' head dim, <= the kernel's D
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

// The last k tile a q tile starting at q0 sees (exclusive bound).
__device__ __forceinline__ int k_tiles_seen(const Params& p, int q0) {
  const int nk = p.sk / kTile;
  if (!p.causal) return nk;
  const int last = q0 + kTile - 1 + (p.sk - p.sq);
  return min(nk, last / kTile + 1);
}

// ---------------------------------------------------------------------------
// SIMT kernels (float32 B1/B2, B3 in every dtype)
// ---------------------------------------------------------------------------

// The SIMT kernels stage their tiles in shared memory as float32 (type
// S = float), except B3 at D = 256 in the half types, whose tiles keep the
// input dtype: as float32 they would take 297 KB, above a block's 227 KB.
// A row is padded to an odd count of 32-bit words (D + 1 floats, D + 2
// halves), so that 16 lanes reading one column of 16 rows hit 16 banks.
template <typename T, int D>
using b3_stage_t =
    std::conditional_t<(D > 128 && !std::is_same<T, float>::value), T,
                       float>;

template <typename S, int D>
__host__ __device__ constexpr int stage_ld() {
  return sizeof(S) == sizeof(float) ? D + 1 : D + 2;
}

// Stage rows s0 .. s0+63 of (b, h) as S, with zeros in columns d .. D-1.
template <typename T, int D, typename S>
__device__ __forceinline__ void load_tile(S* dst, const void* base,
                                          const Strides& st, int b, int s0,
                                          int h, int d) {
  constexpr int LD = stage_ld<S, D>();
  const T* src = row_ptr<T>(base, st, b, s0, h);
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * LD + c] = from_f32<S>(c < d ? to_f32(src[r * st.s + c]) : 0.f);
  }
}

// delta[r] = rowsum(O * dO) of rows s0 .. s0+63, dO staged in smem:
// four lanes per row.
template <typename T, int D, typename S>
__device__ __forceinline__ void row_delta(float* delta, const Params& p,
                                          const S* dos, int b, int s0,
                                          int h) {
  constexpr int LD = stage_ld<S, D>();
  const int r = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const T* o = row_ptr<T>(p.o, p.st[kO], b, s0 + r, h);
  float acc = 0.f;
  for (int c = part; c < p.d; c += 4)
    acc += to_f32(o[c]) * to_f32(dos[r * LD + c]);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) delta[r] = acc;
}

// a[i][j] += A[row(i)] . B[col(j)] over D, for this thread's rows
// tr*4+i and columns tc+16j of a 64 x 64 tile
template <int D, typename S>
__device__ __forceinline__ void tile_dot(float (&a)[4][4], const S* A,
                                         const S* B, int tr, int tc) {
  constexpr int LD = stage_ld<S, D>();
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = to_f32(A[(tr * 4 + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = to_f32(B[(tc + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(x[i], y[j], a[i][j]);
  }
}

// B1, SIMT
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

  load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, h, p.d);
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
    load_tile<T, D>(ks, p.k, p.st[kK], b, k0, kvh, p.d);
    load_tile<T, D>(vs, p.v, p.st[kV], b, k0, kvh, p.d);
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
      if (tc + 16 * j < p.d)
        orow[tc + 16 * j] = from_f32<T>(acc[i][j] / l_safe);
    if (tc == 0)
      p.lse[(static_cast<long long>(b) * p.hq + h) * p.sq + r] =
          m[i] + logf(l_safe);
  }
}

// B2, SIMT
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

  load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, h, p.d);
  load_tile<T, D>(dos, p.dout, p.st[kDO], b, q0, h, p.d);
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
    load_tile<T, D>(ks, p.k, p.st[kK], b, k0, kvh, p.d);
    load_tile<T, D>(vs, p.v, p.st[kV], b, k0, kvh, p.d);
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
    for (int j = 0; j < NJ; ++j)
      if (tc + 16 * j < p.d) row[tc + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// B3: dK and dV, the GQA group summed in the block
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(Params p) {
  using S = b3_stage_t<T, D>;
  constexpr int LD = stage_ld<S, D>();
  constexpr int NJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ks = reinterpret_cast<S*>(smem_raw);
  S* vs = ks + kTile * LD;
  S* qs = vs + kTile * LD;
  S* dos = qs + kTile * LD;
  float* ps = reinterpret_cast<float*>(dos + kTile * LD);  // [64 q][kLP]
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

  load_tile<T, D>(ks, p.k, p.st[kK], b, k0, kvh, p.d);
  load_tile<T, D>(vs, p.v, p.st[kV], b, k0, kvh, p.d);

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
      load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, h, p.d);
      load_tile<T, D>(dos, p.dout, p.st[kDO], b, q0, h, p.d);
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
          dov[j] = to_f32(dos[qq * LD + tc + 16 * j]);
          qv[j] = to_f32(qs[qq * LD + tc + 16 * j]);
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
      if (tc + 16 * j < p.d) {
        krow[tc + 16 * j] = from_f32<T>(dk[i][j]);
        vrow[tc + 16 * j] = from_f32<T>(dv[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernels (bf16 / f16 B1 and B2)
// ---------------------------------------------------------------------------

// Element (r, c) of a [64][D] tile in shared memory: 16-byte chunk c / 8
// of row r sits at chunk (c / 8) ^ (r % 8).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, float32 sums
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const unsigned (&a)[4],
                                                   unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to T, packed as one 32-bit operand (x in the low half)
template <typename T>
__device__ __forceinline__ unsigned pack2(float x, float y);
template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<unsigned*>(&h);
}
template <>
__device__ __forceinline__ unsigned pack2<__half>(float x, float y) {
  __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<unsigned*>(&h);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(unsigned u);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(unsigned u) {
  return __half22float2(*reinterpret_cast<__half2*>(&u));
}

// hi = (x, y) rounded to T, lo = the remainders rounded to T
template <typename T>
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  hi = pack2<T>(x, y);
  const float2 r = unpack2<T>(hi);
  lo = pack2<T>(x - r.x, y - r.y);
}

// Rows s0 .. s0+63 of (b, h) into a swizzled [64][D] tile by cp.async,
// zeros in columns d .. D-1.
template <typename T, int D>
__device__ __forceinline__ void load_tile_async(T* dst, const void* base,
                                                const Strides& st, int b,
                                                int s0, int h, int d) {
  constexpr int C = D / 8;
  const T* src = row_ptr<T>(base, st, b, s0, h);
#pragma unroll
  for (int it = 0; it < kTile * C / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / C;
    const int ch = i - r * C;
    const bool full = ch * 8 < d;
    cp_async16(dst + swz<D>(r, ch * 8), src + r * st.s + (full ? ch * 8 : 0),
               full);
  }
}

// A fragments (m16 x k16 at column c0) of the warp's 16 rows from r0
template <int D, typename T>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const T* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, tile + swz<D>(r0 + (lane & 15), c0 + (lane >> 4) * 8));
}

// B fragments of two n8 tiles (rows n0 .. n0+15 of a row-major [n][k]
// tile, k16 at column c0): {b0, b1} of rows n0.., {b0, b1} of rows n0+8..
template <int D, typename T>
__device__ __forceinline__ void load_b(unsigned (&b)[4], const T* tile,
                                       int n0, int c0, int lane) {
  ldmatrix_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                              c0 + ((lane >> 3) & 1) * 8));
}

// B fragments of two n8 tiles (columns n0 .. n0+15) of a row-major [k][n]
// tile, k16 at row k0: ldmatrix.trans
template <int D, typename T>
__device__ __forceinline__ void load_b_trans(unsigned (&b)[4], const T* tile,
                                             int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + swz<D>(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    n0 + (lane >> 4) * 8));
}

// The warp's 16 output rows, held in the accumulator layout (rows g and
// g+8, columns 8j + 2t, +1), through its rows of a swizzled smem tile into
// 16-byte stores of columns < d.
template <typename T, int D>
__device__ __forceinline__ void store_rows(void* base, const Strides& st,
                                          int b, int s0, int h, T* tile,
                                          int r0, const float (&acc)[D / 8][4],
                                          float scale0, float scale1,
                                          int d, int lane) {
  constexpr int C = D / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // the warp's last reads of these rows are done
#pragma unroll
  for (int j = 0; j < C; ++j) {
    *reinterpret_cast<unsigned*>(tile + swz<D>(r0 + g, j * 8 + 2 * t)) =
        pack2<T>(acc[j][0] * scale0, acc[j][1] * scale0);
    *reinterpret_cast<unsigned*>(tile + swz<D>(r0 + g + 8, j * 8 + 2 * t)) =
        pack2<T>(acc[j][2] * scale1, acc[j][3] * scale1);
  }
  __syncwarp();
  T* dst = static_cast<T*>(base) + b * st.b + s0 * st.s + h * st.h;
#pragma unroll
  for (int it = 0; it < C / 2; ++it) {
    const int i = lane + it * 32;
    const int r = i / C;
    const int ch = i - r * C;
    if (ch * 8 < d)
      *reinterpret_cast<uint4*>(dst + r * st.s + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(r0 + r, ch * 8));
  }
}

// B1 on the tensor cores
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma(Params p) {
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kTile * D;      // two stages
  T* vs = ks + 2 * kTile * D;  // two stages

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int kvh = h / (p.hq / p.hkv);
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int g = lane >> 2, t = lane & 3;
  const int offset = p.sk - p.sq;
  const int nk = k_tiles_seen(p, q0);
  const float scale2 = p.scale * kLog2e;  // scores in log2 units

  load_tile_async<T, D>(qs, p.q, p.st[kQ], b, q0, h, p.d);
  load_tile_async<T, D>(ks, p.k, p.st[kK], b, 0, kvh, p.d);
  load_tile_async<T, D>(vs, p.v, p.st[kV], b, 0, kvh, p.d);
  cp_async_commit();

  // Q fragments stay in registers up to D = 128; at 256 they would take
  // 64 more registers a thread and are read from the q tile per step
  constexpr bool kQInRegs = D <= 128;
  unsigned qf[kQInRegs ? KD : 1][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; stage (kt+1)&1 is free
    if (kQInRegs && kt == 0) {
#pragma unroll
      for (int kd = 0; kd < (kQInRegs ? KD : 1); ++kd)
        load_a<D>(qf[kd], qs, r0, kd * 16, lane);
    }
    if (kt + 1 < nk) {
      const int next = ((kt + 1) & 1) * kTile * D;
      load_tile_async<T, D>(ks + next, p.k, p.st[kK], b, (kt + 1) * kTile,
                            kvh, p.d);
      load_tile_async<T, D>(vs + next, p.v, p.st[kV], b, (kt + 1) * kTile,
                            kvh, p.d);
      cp_async_commit();
    }
    const T* kb = ks + (kt & 1) * kTile * D;
    const T* vb = vs + (kt & 1) * kTile * D;
    const int k0 = kt * kTile;

    // S = Q K^T: rows g, g+8 and columns 8j + 2t, +1 of this lane
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      unsigned qa[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kd][i];
      } else {
        load_a<D>(qa, qs, r0, kd * 16, lane);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bk[4];
        load_b<D>(bk, kb, jp * 16, kd * 16, lane);
        mma<T>(s[2 * jp], qa, bk[0], bk[1]);
        mma<T>(s[2 * jp + 1], qa, bk[2], bk[3]);
      }
    }

    const bool diag = p.causal && k0 + kTile - 1 > q0 + offset;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (diag && q0 + r0 + g + (e >> 1) * 8 + offset <
                        k0 + j * 8 + 2 * t + (e & 1))
          x = kMaskValue;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += pe;  // the unrounded P, as the TPU kernel's l
        s[j][e] = pe;
      }
    }

    // O += P V, P rounded to T as the A operand (accumulator layout)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned a[4] = {
          pack2<T>(s[2 * kk][0], s[2 * kk][1]),
          pack2<T>(s[2 * kk][2], s[2 * kk][3]),
          pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < ND / 2; ++jp) {
        unsigned bv[4];
        load_b_trans<D>(bv, vb, kk * 16, jp * 16, lane);
        mma<T>(o[2 * jp], a, bv[0], bv[1]);
        mma<T>(o[2 * jp + 1], a, bv[2], bv[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
    inv[r] = 1.f / l[r];
  }
  // the warp's rows of the q tile are its own since its Q fragments
  store_rows<T, D>(p.o, p.st[kO], b, q0 + r0, h, qs, r0, o, inv[0], inv[1],
                   p.d, lane);
  if (t == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.hq + h) * p.sq +
                 q0 + r0 + g;
    lse[0] = m[0] * kLn2 + logf(l[0]);
    lse[8] = m[1] * kLn2 + logf(l[1]);
  }
}

// B2 on the tensor cores
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma(Params p) {
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kTile * D;
  T* ks = dos + kTile * D;     // two stages
  T* vs = ks + 2 * kTile * D;  // two stages

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int kvh = h / (p.hq / p.hkv);
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int offset = p.sk - p.sq;
  const int nk = k_tiles_seen(p, q0);
  const float scale2 = p.scale * kLog2e;

  load_tile_async<T, D>(qs, p.q, p.st[kQ], b, q0, h, p.d);
  load_tile_async<T, D>(dos, p.dout, p.st[kDO], b, q0, h, p.d);
  load_tile_async<T, D>(ks, p.k, p.st[kK], b, 0, kvh, p.d);
  load_tile_async<T, D>(vs, p.v, p.st[kV], b, 0, kvh, p.d);
  cp_async_commit();

  // lse (log2 units) and delta of rows g and g+8
  const float* lse = p.lse + (static_cast<long long>(b) * p.hq + h) * p.sq +
                     q0 + r0 + g;
  const float lse2[2] = {lse[0] * kLog2e, lse[8] * kLog2e};
  float delta[2] = {0.f, 0.f};
  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (kt == 0) {
      // delta = rowsum(O * dO) of the warp's 16 rows, two lanes a row
      const int r = lane >> 1;
      const T* orow = row_ptr<T>(p.o, p.st[kO], b, q0 + r0 + r, h);
      float acc = 0.f;
      for (int ch = lane & 1; ch * 8 < p.d; ch += 2) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + ch * 8);
        const uint4 dv =
            *reinterpret_cast<const uint4*>(dos + swz<D>(r0 + r, ch * 8));
        const unsigned ow[4] = {ov.x, ov.y, ov.z, ov.w};
        const unsigned dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 a = unpack2<T>(ow[w]);
          const float2 c = unpack2<T>(dw[w]);
          acc += a.x * c.x;
          acc += a.y * c.y;
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      delta[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
      delta[1] = __shfl_sync(0xffffffffu, acc, 2 * (g + 8));
    }
    if (kt + 1 < nk) {
      const int next = ((kt + 1) & 1) * kTile * D;
      load_tile_async<T, D>(ks + next, p.k, p.st[kK], b, (kt + 1) * kTile,
                            kvh, p.d);
      load_tile_async<T, D>(vs + next, p.v, p.st[kV], b, (kt + 1) * kTile,
                            kvh, p.d);
      cp_async_commit();
    }
    const T* kb = ks + (kt & 1) * kTile * D;
    const T* vb = vs + (kt & 1) * kTile * D;
    const int k0 = kt * kTile;

    // S = Q K^T and dP = dO V^T
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      unsigned qa[4], da[4];
      load_a<D>(qa, qs, r0, kd * 16, lane);
      load_a<D>(da, dos, r0, kd * 16, lane);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bk[4], bv[4];
        load_b<D>(bk, kb, jp * 16, kd * 16, lane);
        load_b<D>(bv, vb, jp * 16, kd * 16, lane);
        mma<T>(s[2 * jp], qa, bk[0], bk[1]);
        mma<T>(s[2 * jp + 1], qa, bk[2], bk[3]);
        mma<T>(dp[2 * jp], da, bv[0], bv[1]);
        mma<T>(dp[2 * jp + 1], da, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta) scale, P = exp(S - lse); masked entries 0
    const bool diag = p.causal && k0 + kTile - 1 > q0 + offset;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool masked = diag && q0 + r0 + g + (e >> 1) * 8 + offset <
                                        k0 + j * 8 + 2 * t + (e & 1);
        const float pe =
            masked ? 0.f : exp2f(s[j][e] * scale2 - lse2[e >> 1]);
        s[j][e] = pe * (dp[j][e] - delta[e >> 1]) * p.scale;
      }
    }

    // dQ += dS K, with dS = hi + lo in two products
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned hi[4], lo[4];
      split2<T>(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split2<T>(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int jp = 0; jp < ND / 2; ++jp) {
        unsigned bk[4];
        load_b_trans<D>(bk, kb, kk * 16, jp * 16, lane);
        mma<T>(dq[2 * jp], hi, bk[0], bk[1]);
        mma<T>(dq[2 * jp], lo, bk[0], bk[1]);
        mma<T>(dq[2 * jp + 1], hi, bk[2], bk[3]);
        mma<T>(dq[2 * jp + 1], lo, bk[2], bk[3]);
      }
    }
  }

  store_rows<T, D>(p.dq, p.st[kDQ], b, q0 + r0, h, qs, r0, dq, 1.f, 1.f, p.d,
                   lane);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Which : int { kFwd = 0, kBwdDq = 1, kBwdDkv = 2 };

template <typename T, int D>
constexpr size_t simt_smem_bytes(int which) {
  using S = b3_stage_t<T, D>;
  return which == kFwd
             ? sizeof(float) * (3 * kTile * (D + 1) + kTile * kLP)
         : which == kBwdDq
             ? sizeof(float) * (4 * kTile * (D + 1) + kTile * kLP + 2 * kTile)
             : sizeof(S) * 4 * kTile * stage_ld<S, D>() +
                   sizeof(float) * (2 * kTile * kLP + 2 * kTile);
}

// q tile (+ dO tile in B2) and two stages of K and V, in the input dtype
template <typename T, int D>
constexpr size_t mma_smem_bytes(int which) {
  return sizeof(T) * kTile * D * (which == kFwd ? 5 : 6);
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                          const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(int which, int batch, const Params& p,
                   cudaStream_t stream) {
  // bf16 / f16 B1 and B2 run on the tensor cores; grid (head, batch,
  // q tile) with the q tile on the slowest axis, heaviest first
  constexpr bool kMma = !std::is_same<T, float>::value;
  const dim3 simt_grid(p.sq / kTile, p.hq, batch);
  const dim3 mma_grid(p.hq, batch, p.sq / kTile);
  switch (which) {
    case kFwd:
      if constexpr (kMma)
        return launch_kernel(flash_fwd_mma<T, D>, mma_grid, kMmaThreads,
                             mma_smem_bytes<T, D>(kFwd), p, stream);
      else
        return launch_kernel(flash_fwd<T, D>, simt_grid, kThreads,
                             simt_smem_bytes<T, D>(kFwd), p, stream);
    case kBwdDq:
      if constexpr (kMma)
        return launch_kernel(flash_bwd_dq_mma<T, D>, mma_grid, kMmaThreads,
                             mma_smem_bytes<T, D>(kBwdDq), p, stream);
      else
        return launch_kernel(flash_bwd_dq<T, D>, simt_grid, kThreads,
                             simt_smem_bytes<T, D>(kBwdDq), p, stream);
    case kBwdDkv:
      return launch_kernel(flash_bwd_dkv<T, D>,
                           dim3(p.sk / kTile, p.hkv, batch), kThreads,
                           simt_smem_bytes<T, D>(kBwdDkv), p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int padded_dim, int which, int batch, const Params& p,
                     cudaStream_t stream) {
  switch (padded_dim) {
    case 64:
      return launch<T, 64>(which, batch, p, stream);
    case 128:
      return launch<T, 128>(which, batch, p, stream);
    case 256:  // the half types only: float32 B2 / B3 tiles would not fit
      if constexpr (!std::is_same<T, float>::value)
        return launch<T, 256>(which, batch, p, stream);
      else
        return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `which`: 0 = B1 (writes o and
// lse), 1 = B2 (writes dq), 2 = B3 (writes dk and dv). `head_dim` is the
// operands' d, `padded_dim` the instantiation D >= d (64, 128, or 256 in
// bf16 / f16; d a multiple of 8). `ptrs` holds the device pointers q, k, v, o, do, lse, dq,
// dk, dv (unused ones may be null); `strides` the (b, s, h) element strides
// of q, k, v, o, do, dq, dk, dv, in that order (unit stride on the head dim
// is the caller's check, as are rows that start on 16 bytes). Sequence
// lengths are multiples of 64. Returns the launch's cudaError_t (0 on
// success). Allocates nothing.
extern "C" int flash_attention_launch(int which, int dtype, int head_dim,
                                      int padded_dim, void* const* ptrs,
                                      const long long* strides, int batch,
                                      int sq, int sk, int hq, int hkv,
                                      float scale, int causal, void* stream) {
  if (head_dim <= 0 || head_dim > padded_dim || head_dim % 8)
    return cudaErrorInvalidValue;
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
  p.d = head_dim;
  p.scale = scale;
  p.causal = causal;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_d<float>(padded_dim, which, batch, p, st);
    case kBF16:
      return launch_d<__nv_bfloat16>(padded_dim, which, batch, p, st);
    case kF16:
      return launch_d<__half>(padded_dim, which, batch, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}
