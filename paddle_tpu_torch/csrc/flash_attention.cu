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
// Every sum is float32; inputs are read as their dtype. delta is computed
// once per (b, q head, q row) by flash_bwd_delta into a float32 buffer
// that B2 and B3 read (the TPU kernels recompute it per tile), in B2's
// launch; B3's launch runs it only when it is not handed the buffer.
//
// Sequence lengths: any sq >= 1 and sk >= 1 (the TPU kernel tiles by the
// largest power-of-two divisor, down to 1). The grids run ceil(s / 64)
// tiles (in blocks of two in the Hopper B2 / B3, of one or three in the
// Hopper B1); a partial last tile is loaded with zeros in its rows past
// the end, its score columns j >= sk take the mask value (P = 0), q rows
// past sq take P = 0 in B3 (which sums over q rows), and no row past the
// end is stored.
//
// Head dims: any multiple of 8. The tensor-core kernels are instantiated
// at a padded head dim D (the Hopper ones 64, 128; mma.sync 256) and take
// the operands' d <= D at run time: loads fill columns d..D-1 with zeros,
// which change neither q . k nor the columns < d of a product, and stores
// write columns < d only. The SIMT kernels take any d at D = 64 or 128
// by summing the score tiles over d in D-column slices (see "Split d"
// below).
//
// Bound. Each kernel does 4-8 flops per visible (query, key) pair per
// head-dim element. At the gpt2-small train shape (s 1024, d 64, causal)
// in bf16, moving each input and output once through device memory takes
// about as long as the products at the tensor cores' peak (B1: 0.015 ms
// by bytes, 0.013 ms by operations; B2: 0.023 / 0.020 ms; B3: 0.026 /
// 0.026 ms); float32, without tensor cores, is bound by operations. The
// hi/lo split below runs the products whose reference is float32 twice:
// B2 runs 4 and B3 6 m-n-k products per visible pair and head-dim
// element (2 x 6.45 GFLOP each at the train shape), 0.026 and 0.039 ms at
// the peak, so as run both are bound by operations. Each block re-reads
// the other side's tiles from L2, once per 64 (mma.sync, the Hopper B1
// at D = 64), 128 (the Hopper B2 / B3) or 192 (the Hopper B1 at D = 128)
// rows, so the reachable rate rests on feeding the products from shared
// memory and registers.
//
// Four designs.
//
// bf16 / f16 B1 up to d = 128 (flash_fwd_wgmma): Hopper. B1 does one
// exponential per visible pair; the SM's 16 ex2 a clock take as long as
// the pair's 4 x 64 flops at the bf16 tensor-core peak, so at d = 64 the
// softmax alone matches the products and the bytes (0.012-0.015 ms at
// the train shape each). What bounds it as built is latency: a block
// waits for its first TMA tiles and its stores, a warpgroup for each
// product and for its own softmax, and only other warpgroups on the SM
// fill those gaps. A block holds W consumer warpgroups of 64 q rows of
// one (b, q head), their Q tiles loaded once by TMA and resident, and a
// producer warpgroup one thread of which streams the K and V tiles of kv
// head h / group through a ring of full / empty mbarriers (no consumer
// spends registers or issue slots on addresses; setmaxnreg hands the
// producer's registers to the consumers). At D = 64 a block is one
// consumer warpgroup and four blocks share an SM (2 stages: 104
// registers a consumer thread); at D = 128 one block of three (3
// stages, 160 registers). S = Q K^T is wgmma with both operands K-major
// in shared memory; the online softmax runs in registers in log2 units
// (ex2 of the scores scaled by scale * log2 e, the row's max and sum as
// trees); P is rounded to T in registers, where the m64n64 accumulator
// layout is the register A fragment layout, and O += P V is an RS wgmma
// against the V tile read MN-major. O leaves the accumulators as pairs
// scaled by 1 / l; no atomics.
//
// bf16 / f16 B2 and B3 up to d = 128 (flash_bwd_dq_wgmma,
// flash_bwd_dkv_wgmma): Hopper. A block of three warpgroups owns 128 rows
// of one (b, head) (B2: q rows, B3: k rows of a kv head): consumer
// warpgroups 0 and 1 own 64 rows each and keep their two operand tiles
// (Q and dO, or K and V) resident in shared memory; one thread of
// warpgroup 2 (its registers handed to the consumers by setmaxnreg)
// streams the other side's 64-row tiles (K and V; or Q and dO with their
// lse and delta rows) by TMA through a ring of three stages, full and
// empty mbarriers between them. TMA reads each operand as a rank-4
// (d, h, s, b) tensor with the caller's strides in boxes of 64 columns
// (128 bytes, the 128-byte swizzle) and fills rows past the end and
// columns past d with zeros. The score products (S = Q K^T, dP = dO V^T;
// B3 their transposes) are wgmma m64n64k16 with both operands K-major in
// shared memory, committed as two groups so that P is taken while dP is
// still on the tensor cores. dS (B2), P^T and dS^T (B3) are split into
// hi and lo, written by each warpgroup into its own swizzled [64][64]
// panels and read by the accumulating wgmma with the streamed or resident
// tile as an MN-major B operand (the transpose bit): register A operands
// measured slower here. Every sum runs in a fixed order, with no atomics:
// two launches give the same bits. Only the diagonal band and a partial
// last tile take the masking branch; tiles beyond the diagonal are
// skipped, and the heaviest blocks are scheduled first. dQ, dK and dV
// leave the accumulators as pairs straight to global memory.
//
// bf16 / f16 B1, B2 and B3 from d = 136 to 256 (flash_fwd_mma,
// flash_bwd_dq_mma, flash_bwd_dkv_mma, at D = 256, where a Hopper
// consumer's registers would not hold the accumulators):
// FlashAttention-2 on the tensor cores. A block of 4 warps owns a 64-row
// tile (B1, B2: q rows of one (b, q head); B3: k rows of one (b, kv
// head)), 16 rows a warp, and walks the 64-row tiles of the other side.
// The tiles stay in the input dtype in shared memory, in rows of 16-byte
// chunks whose chunk index is XORed with the row (so the 8 rows of one
// ldmatrix fall in 8 distinct bank groups), loaded by cp.async into two
// stages: tile kt+1 is in flight
// while tile kt is computed. Products are mma.sync m16n8k16 with float32
// sums; operands come from ldmatrix (.trans where the tile is the B
// operand's k-major side). The score tile stays in registers: since the
// m16n8 accumulator layout is the m16n8k16 A-operand layout, the rounded
// P (B1), dS (B2) or P^T and dS^T (B3, which computes the transposed
// tiles K Q^T and V dO^T so that their rows are its k rows) feed the next
// product without a trip through shared memory. Where the reference's
// product is float32 (dS . K in B2, P^T . dO and dS^T . Q in B3), the
// score operand is split into hi = round(x) and lo = round(x - hi) in the
// input dtype and both are multiplied by the exact other operand (about
// 16 mantissa bits). Only the diagonal tile is masked; tiles beyond it
// are skipped; the heaviest tiles are scheduled first (the grid's slowest
// axis) to shorten the tail.
//
// float32, and the half types above d = 256 (flash_fwd, flash_bwd_dq,
// flash_bwd_dkv): SIMT float32 FMAs. One block of 256 threads owns a
// 64-row tile (B1, B2: q rows of one (b, q head); B3: k rows of one
// (b, kv head)) and loops over the 64-row tiles of the other side, staged
// in shared memory as float32 in rows padded to an odd count of 32-bit
// words. Each thread keeps a 4 x 4 block of the 64 x 64 score tile and a
// 4 x D/16 block of the output tile in registers; a row's 16 owners
// reduce with shuffles. There is no full-float32 tensor-core product
// (TF32 keeps 10 mantissa bits).
//
// B1 runs k tile 0 first, which every row sees, so the finite mask value
// never leaks into a result; B2 and B3 give masked entries P = 0.

#include <cuda.h>
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
  float* delta;      // [b, hq, sq], contiguous: rowsum(O * dO)
  void* dq;
  void* dk;
  void* dv;
  Strides st[kSlots];
  int sq, sk, hq, hkv;
  int d;             // the operands' head dim (any multiple of 8)
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

__host__ __device__ __forceinline__ int tiles(int s) {
  return (s + kTile - 1) / kTile;
}

// The last k tile a q tile starting at q0 sees (exclusive bound).
__device__ __forceinline__ int k_tiles_seen(const Params& p, int q0) {
  const int nk = tiles(p.sk);
  if (!p.causal) return nk;
  const int last = q0 + kTile - 1 + (p.sk - p.sq);
  return min(nk, last / kTile + 1);
}

// ---------------------------------------------------------------------------
// SIMT kernels (float32 B1/B2, B3 in every dtype)
// ---------------------------------------------------------------------------

// The SIMT kernels stage their tiles in shared memory as float32, in rows
// padded to D + 1 floats, so that 16 lanes reading one column of 16 rows
// hit 16 banks.
//
// Split d. A kernel instantiated at D takes any d: the score tiles S
// (and dP) are summed over the head dim in slices of D columns streamed
// through shared memory, and grid axis z runs over the D-column slices
// of the output, each block accumulating only its own slice of O, dQ or
// dK and dV. With d <= D there is one slice, and the block's own tiles
// stay resident; with d > D (D = 64: float32 above 128, the half types
// above 256) the tiles are re-staged slice by slice, so shared memory
// does not grow with d. Only the block of slice 0 writes the lse.

// Stage rows s0 .. s0+63 of (b, h), columns c0 .. c0+D-1, as float32
// with zeros in columns >= d and in rows s0 + r >= s (the sequence's end).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const void* base,
                                          const Strides& st, int b, int s0,
                                          int s, int h, int c0, int d) {
  constexpr int LD = D + 1;
  const T* src = row_ptr<T>(base, st, b, s0, h) + c0;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * LD + c] =
        c0 + c < d && s0 + r < s ? to_f32(src[r * st.s + c]) : 0.f;
  }
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

// acc[i][j] += sum_kk X[row(i)][kk] * Y[kk][col(j)], X a [64][kLP] score
// tile (row-major if !xt, else read as its transpose), Y a staged tile
template <int D, bool XT>
__device__ __forceinline__ void tile_product(float (&acc)[4][D / 16],
                                             const float* X, const float* Y,
                                             int tr, int tc) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int kk = 0; kk < kTile; ++kk) {
    float x[4], y[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = XT ? X[kk * kLP + tr * 4 + i] : X[(tr * 4 + i) * kLP + kk];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = Y[kk * LD + tc + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Rows of this thread's output block (rows s0 + tr*4+i < s, columns
// c0 + tc+16j < d) in T.
template <typename T, int D>
__device__ __forceinline__ void store_block(void* base, const Strides& st,
                                            int b, int s0, int s, int h,
                                            int c0, int d,
                                            const float (&acc)[4][D / 16],
                                            int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (s0 + tr * 4 + i >= s) break;
    T* row = static_cast<T*>(base) + b * st.b + (s0 + tr * 4 + i) * st.s +
             h * st.h + c0;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      if (c0 + tc + 16 * j < d) row[tc + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// delta[b, h, s] = rowsum(O * dO) in float32, read by B2 and B3 (the TPU
// kernels recompute it per tile). Each lane reads 16 bytes of a row at a
// time; a row takes 2^lanes_log2 lanes (the power of two that covers its
// 16-byte chunks, at most 32), so a warp sums 32 >> lanes_log2 rows.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(Params p,
                                                            int rows,
                                                            int lanes_log2) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte chunk
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int row = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
                      (32 >> lanes_log2) +
                  (lane >> lanes_log2);
  const int sub = lane & (lanes - 1);
  float acc = 0.f;
  if (row < rows) {
    const int s = row % p.sq;
    const int bh = row / p.sq;
    const T* o = row_ptr<T>(p.o, p.st[kO], bh / p.hq, s, bh % p.hq);
    const T* dout = row_ptr<T>(p.dout, p.st[kDO], bh / p.hq, s, bh % p.hq);
    for (int c = sub * E; c < p.d; c += lanes * E) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + c);
      const uint4 g = *reinterpret_cast<const uint4*>(dout + c);
      const T* x = reinterpret_cast<const T*>(&a);
      const T* y = reinterpret_cast<const T*>(&g);
#pragma unroll
      for (int e = 0; e < E; ++e) acc += to_f32(x[e]) * to_f32(y[e]);
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && row < rows) p.delta[row] = acc;
}

// B1, SIMT; grid (q tile, head + hq * batch, output slice)
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
  const int h = blockIdx.y % p.hq;
  const int b = blockIdx.y / p.hq;
  const int c0 = blockIdx.z * D;  // this block's output columns
  const int kvh = h / (p.hq / p.hkv);
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int offset = p.sk - p.sq;
  const int nsl = (p.d + D - 1) / D;  // slices of the score's sum over d
  const bool resident = nsl == 1;

  if (resident) load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, p.sq, h, 0, p.d);
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
    float s[4][4] = {};
    for (int sl = 0; sl < nsl; ++sl) {
      __syncthreads();  // the previous products are done with the tiles
      if (!resident)
        load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, p.sq, h, sl * D, p.d);
      load_tile<T, D>(ks, p.k, p.st[kK], b, k0, p.sk, kvh, sl * D, p.d);
      if (sl == 0)
        load_tile<T, D>(vs, p.v, p.st[kV], b, k0, p.sk, kvh, c0, p.d);
      __syncthreads();
      tile_dot<D>(s, qs, ks, tr, tc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i + offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        float x = s[i][j] * p.scale;
        if ((p.causal && row < col) || col >= p.sk) x = kMaskValue;
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
    tile_product<D, false>(acc, ps, vs, tr, tc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] /= l_safe;
    if (tc == 0 && blockIdx.z == 0 && q0 + tr * 4 + i < p.sq)
      p.lse[(static_cast<long long>(b) * p.hq + h) * p.sq + q0 + tr * 4 + i] =
          m[i] + logf(l_safe);
  }
  store_block<T, D>(p.o, p.st[kO], b, q0, p.sq, h, c0, p.d, acc, tr, tc);
}

// B2, SIMT; grid as B1's
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
  const int h = blockIdx.y % p.hq;
  const int b = blockIdx.y / p.hq;
  const int c0 = blockIdx.z * D;
  const int kvh = h / (p.hq / p.hkv);
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int offset = p.sk - p.sq;
  const int nsl = (p.d + D - 1) / D;
  const bool resident = nsl == 1;

  if (resident) {
    load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, p.sq, h, 0, p.d);
    load_tile<T, D>(dos, p.dout, p.st[kDO], b, q0, p.sq, h, 0, p.d);
  }
  if (threadIdx.x < kTile) {
    const bool in = q0 + static_cast<int>(threadIdx.x) < p.sq;
    const long long i =
        (static_cast<long long>(b) * p.hq + h) * p.sq + q0 + threadIdx.x;
    lse_s[threadIdx.x] = in ? p.lse[i] : 0.f;
    delta_s[threadIdx.x] = in ? p.delta[i] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = k_tiles_seen(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    float s[4][4] = {};
    float dp[4][4] = {};
    for (int sl = 0; sl < nsl; ++sl) {
      __syncthreads();
      if (!resident) {
        load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, p.sq, h, sl * D, p.d);
        load_tile<T, D>(dos, p.dout, p.st[kDO], b, q0, p.sq, h, sl * D, p.d);
      }
      load_tile<T, D>(ks, p.k, p.st[kK], b, k0, p.sk, kvh, sl * D, p.d);
      load_tile<T, D>(vs, p.v, p.st[kV], b, k0, p.sk, kvh, sl * D, p.d);
      __syncthreads();
      tile_dot<D>(s, qs, ks, tr, tc);
      tile_dot<D>(dp, dos, vs, tr, tc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const float lse = lse_s[r];
      const float delta = delta_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        float x = s[i][j] * p.scale;
        if ((p.causal && q0 + r + offset < col) || col >= p.sk)
          x = kMaskValue;
        const float pr = expf(x - lse);
        dss[r * kLP + tc + 16 * j] = pr * (dp[i][j] - delta) * p.scale;
      }
    }
    __syncthreads();
    if (!resident) {  // this block's slice of K for dS . K
      load_tile<T, D>(ks, p.k, p.st[kK], b, k0, p.sk, kvh, c0, p.d);
      __syncthreads();
    }
    tile_product<D, false>(acc, dss, ks, tr, tc);
  }
  store_block<T, D>(p.dq, p.st[kDQ], b, q0, p.sq, h, c0, p.d, acc, tr, tc);
}

// B3, SIMT: dK and dV, the GQA group summed in the block; grid (k tile,
// kv head + hkv * batch, output slice)
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
  const int kvh = blockIdx.y % p.hkv;
  const int b = blockIdx.y / p.hkv;
  const int c0 = blockIdx.z * D;
  const int group = p.hq / p.hkv;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int offset = p.sk - p.sq;
  const int nq = tiles(p.sq);
  const int nsl = (p.d + D - 1) / D;
  const bool resident = nsl == 1;

  if (resident) {
    load_tile<T, D>(ks, p.k, p.st[kK], b, k0, p.sk, kvh, 0, p.d);
    load_tile<T, D>(vs, p.v, p.st[kV], b, k0, p.sk, kvh, 0, p.d);
  }

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
      // score tile with q rows tr*4+i and k columns tc+16j
      float s[4][4] = {};
      float dp[4][4] = {};
      for (int sl = 0; sl < nsl; ++sl) {
        __syncthreads();  // the previous products are done with the tiles
        if (!resident) {
          load_tile<T, D>(ks, p.k, p.st[kK], b, k0, p.sk, kvh, sl * D, p.d);
          load_tile<T, D>(vs, p.v, p.st[kV], b, k0, p.sk, kvh, sl * D, p.d);
        }
        load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, p.sq, h, sl * D, p.d);
        load_tile<T, D>(dos, p.dout, p.st[kDO], b, q0, p.sq, h, sl * D, p.d);
        if (sl == 0 && threadIdx.x < kTile) {
          const bool in = q0 + static_cast<int>(threadIdx.x) < p.sq;
          const long long i =
              (static_cast<long long>(b) * p.hq + h) * p.sq + q0 +
              threadIdx.x;
          lse_s[threadIdx.x] = in ? p.lse[i] : 0.f;
          delta_s[threadIdx.x] = in ? p.delta[i] : 0.f;
        }
        __syncthreads();
        tile_dot<D>(s, qs, ks, tr, tc);
        tile_dot<D>(dp, dos, vs, tr, tc);
      }
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
          // a q row past the end adds nothing to dK or dV
          const float pr = q0 + r < p.sq ? expf(x - lse) : 0.f;
          ps[r * kLP + tc + 16 * j] = pr;
          dss[r * kLP + tc + 16 * j] = pr * (dp[i][j] - delta) * p.scale;
        }
      }
      __syncthreads();
      if (!resident) {  // this block's slices of Q and dO
        load_tile<T, D>(qs, p.q, p.st[kQ], b, q0, p.sq, h, c0, p.d);
        load_tile<T, D>(dos, p.dout, p.st[kDO], b, q0, p.sq, h, c0, p.d);
        __syncthreads();
      }
      // dV += P^T dO, dK += dS^T Q over the tile's 64 q rows
      tile_product<D, true>(dv, ps, dos, tr, tc);
      tile_product<D, true>(dk, dss, qs, tr, tc);
    }
  }
  store_block<T, D>(p.dk, p.st[kDK], b, k0, p.sk, kvh, c0, p.d, dk, tr, tc);
  store_block<T, D>(p.dv, p.st[kDV], b, k0, p.sk, kvh, c0, p.d, dv, tr, tc);
}

// ---------------------------------------------------------------------------
// mma.sync kernels (bf16 / f16 B1, B2 and B3 at D = 256)
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
// 4 bytes from global to shared memory, or 4 zero bytes if !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
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

// hi = (x, y) rounded to T, lo = the remainders rounded to T
template <typename T>
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo);
template <>
__device__ __forceinline__ void split2<__half>(float x, float y,
                                               unsigned& hi, unsigned& lo) {
  hi = pack2<__half>(x, y);
  const float2 r = __half22float2(*reinterpret_cast<__half2*>(&hi));
  lo = pack2<__half>(x - r.x, y - r.y);
}
// a bf16 is the top half of its float: the rounded values are bit masks
template <>
__device__ __forceinline__ void split2<__nv_bfloat16>(float x, float y,
                                                      unsigned& hi,
                                                      unsigned& lo) {
  hi = pack2<__nv_bfloat16>(x, y);
  lo = pack2<__nv_bfloat16>(x - __uint_as_float(hi << 16),
                            y - __uint_as_float(hi & 0xffff0000u));
}

// Rows s0 .. s0+63 of (b, h) into a swizzled [64][D] tile by cp.async,
// zeros in columns d .. D-1 and in rows s0 + r >= s (the sequence's end).
template <typename T, int D>
__device__ __forceinline__ void load_tile_async(T* dst, const void* base,
                                                const Strides& st, int b,
                                                int s0, int s, int h, int d) {
  constexpr int C = D / 8;
  const T* src = row_ptr<T>(base, st, b, s0, h);
#pragma unroll
  for (int it = 0; it < kTile * C / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / C;
    const int ch = i - r * C;
    const bool full = ch * 8 < d && s0 + r < s;
    cp_async16(dst + swz<D>(r, ch * 8), full ? src + r * st.s + ch * 8 : src,
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
// g+8, columns 8j + 2t, +1 of an NC-column slice), through its rows of a
// swizzled [64][D] smem tile into 16-byte stores of columns c0 + c < d of
// rows s0 + r < s.
template <typename T, int D, int NC = D>
__device__ __forceinline__ void store_rows(void* base, const Strides& st,
                                          int b, int s0, int s, int h, T* tile,
                                          int r0, const float (&acc)[NC / 8][4],
                                          float scale0, float scale1, int c0,
                                          int d, int lane) {
  constexpr int C = NC / 8;
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
  T* dst = static_cast<T*>(base) + b * st.b + s0 * st.s + h * st.h + c0;
#pragma unroll
  for (int it = 0; it < C / 2; ++it) {
    const int i = lane + it * 32;
    const int r = i / C;
    const int ch = i - r * C;
    if (c0 + ch * 8 < d && s0 + r < s)
      *reinterpret_cast<uint4*>(dst + r * st.s + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(r0 + r, ch * 8));
  }
}

// Entries of a warp's score tile in the accumulator layout (rows g and
// g+8, columns 8j + 2t, +1) that the causal mask or the sequence's end
// hides, set to `value`: `row` is the absolute row g plus the causal
// offset sk - sq, `col0` the absolute column 2t of the tile.
__device__ __forceinline__ void mask_scores(float (&s)[8][4], int row,
                                            int col0, bool causal, int sk,
                                            float value) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + j * 8 + (e & 1);
      if ((causal && row + (e >> 1) * 8 < col) || col >= sk) s[j][e] = value;
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

  load_tile_async<T, D>(qs, p.q, p.st[kQ], b, q0, p.sq, h, p.d);
  load_tile_async<T, D>(ks, p.k, p.st[kK], b, 0, p.sk, kvh, p.d);
  load_tile_async<T, D>(vs, p.v, p.st[kV], b, 0, p.sk, kvh, p.d);
  cp_async_commit();

  // Q fragments are read from the q tile per step: at D = 256 they would
  // take 64 more registers a thread
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; stage (kt+1)&1 is free
    if (kt + 1 < nk) {
      const int next = ((kt + 1) & 1) * kTile * D;
      load_tile_async<T, D>(ks + next, p.k, p.st[kK], b, (kt + 1) * kTile,
                            p.sk, kvh, p.d);
      load_tile_async<T, D>(vs + next, p.v, p.st[kV], b, (kt + 1) * kTile,
                            p.sk, kvh, p.d);
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
      load_a<D>(qa, qs, r0, kd * 16, lane);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bk[4];
        load_b<D>(bk, kb, jp * 16, kd * 16, lane);
        mma<T>(s[2 * jp], qa, bk[0], bk[1]);
        mma<T>(s[2 * jp + 1], qa, bk[2], bk[3]);
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    // only the diagonal tile, and a last tile that runs past sk, are
    // masked (a warp-uniform branch: whole tiles skip it)
    const bool diag = p.causal && k0 + kTile - 1 > q0 + offset;
    if (diag || k0 + kTile > p.sk)
      mask_scores(s, q0 + r0 + g + offset, k0 + 2 * t, diag, p.sk,
                  kMaskValue);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
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
  // the warp's rows of the q tile are read by this warp only
  store_rows<T, D>(p.o, p.st[kO], b, q0 + r0, p.sq, h, qs, r0, o, inv[0],
                   inv[1], 0, p.d, lane);
  if (t == 0) {
    const int row = q0 + r0 + g;
    float* lse = p.lse + (static_cast<long long>(b) * p.hq + h) * p.sq + row;
    if (row < p.sq) lse[0] = m[0] * kLn2 + logf(l[0]);
    if (row + 8 < p.sq) lse[8] = m[1] * kLn2 + logf(l[1]);
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

  load_tile_async<T, D>(qs, p.q, p.st[kQ], b, q0, p.sq, h, p.d);
  load_tile_async<T, D>(dos, p.dout, p.st[kDO], b, q0, p.sq, h, p.d);
  load_tile_async<T, D>(ks, p.k, p.st[kK], b, 0, p.sk, kvh, p.d);
  load_tile_async<T, D>(vs, p.v, p.st[kV], b, 0, p.sk, kvh, p.d);
  cp_async_commit();

  // lse (log2 units) and delta of rows g and g+8 (0 past the end: those
  // rows are not stored)
  const long long row = (static_cast<long long>(b) * p.hq + h) * p.sq + q0 +
                        r0 + g;
  const bool in0 = q0 + r0 + g < p.sq, in1 = q0 + r0 + g + 8 < p.sq;
  const float lse2[2] = {in0 ? p.lse[row] * kLog2e : 0.f,
                         in1 ? p.lse[row + 8] * kLog2e : 0.f};
  const float delta[2] = {in0 ? p.delta[row] : 0.f,
                          in1 ? p.delta[row + 8] : 0.f};
  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < nk) {
      const int next = ((kt + 1) & 1) * kTile * D;
      load_tile_async<T, D>(ks + next, p.k, p.st[kK], b, (kt + 1) * kTile,
                            p.sk, kvh, p.d);
      load_tile_async<T, D>(vs + next, p.v, p.st[kV], b, (kt + 1) * kTile,
                            p.sk, kvh, p.d);
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
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2f(s[j][e] * scale2 - lse2[e >> 1]);
    const bool diag = p.causal && k0 + kTile - 1 > q0 + offset;
    if (diag || k0 + kTile > p.sk)
      mask_scores(s, q0 + r0 + g + offset, k0 + 2 * t, diag, p.sk, 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * (dp[j][e] - delta[e >> 1]) * p.scale;

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

  store_rows<T, D>(p.dq, p.st[kDQ], b, q0 + r0, p.sq, h, qs, r0, dq, 1.f, 1.f,
                   0, p.d, lane);
}

// Output columns of one B3 tensor-core block: the whole head dim up to
// 128; at D = 256 two blocks take 128 columns each (both recompute the
// score tiles), so the dK and dV accumulators stay at 128 floats a lane.
template <int D>
__host__ __device__ constexpr int dkv_cols() {
  return D < 128 ? D : 128;
}

// B3 on the tensor cores: dK and dV of one 64-row k tile of one
// (b, kv head), summed over the GQA group; grid (kv head + hkv * column
// slice, batch, k tile), k tile 0 (the heaviest under the causal mask)
// first.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkv_mma(Params p) {
  constexpr int KD = D / 16;
  constexpr int NC = dkv_cols<D>();
  constexpr int NN = NC / 8;  // n8 tiles of the warp's dK / dV rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kTile * D;
  T* qs = vs + kTile * D;       // two stages
  T* dos = qs + 2 * kTile * D;  // two stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile * D);  // 2 x 64
  float* delta_s = lse_s + 2 * kTile;                             // 2 x 64

  const int kvh = blockIdx.x % p.hkv;
  const int c0 = blockIdx.x / p.hkv * NC;  // this block's output columns
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;
  const int group = p.hq / p.hkv;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's k rows in the tile
  const int g = lane >> 2, t = lane & 3;
  const int offset = p.sk - p.sq;
  const float scale2 = p.scale * kLog2e;  // scores in log2 units
  // q tiles that see this k tile: from the first one that reaches it
  const int qt0 = p.causal ? max(0, k0 - offset) / kTile : 0;
  const int nqt = tiles(p.sq) - qt0;
  const int n_it = group * nqt;  // (q head, q tile) pairs

  // Q, dO, lse and delta of pair `it` into stage it & 1
  auto issue = [&](int it) {
    const int h = kvh * group + it / nqt;
    const int q0 = (qt0 + it % nqt) * kTile;
    const int st = it & 1;
    load_tile_async<T, D>(qs + st * kTile * D, p.q, p.st[kQ], b, q0, p.sq, h,
                          p.d);
    load_tile_async<T, D>(dos + st * kTile * D, p.dout, p.st[kDO], b, q0,
                          p.sq, h, p.d);
    {  // lse (threads 0-63) and delta (64-127), one float a thread, 0 past
       // the end (a row of any length starts on 4 bytes only)
      const int r = threadIdx.x & (kTile - 1);
      const long long row = (static_cast<long long>(b) * p.hq + h) * p.sq + q0;
      const float* src = (threadIdx.x < kTile ? p.lse : p.delta) + row;
      float* dst = (threadIdx.x < kTile ? lse_s : delta_s) + st * kTile + r;
      const bool in = q0 + r < p.sq;
      cp_async4(dst, in ? src + r : src, in);
    }
  };

  load_tile_async<T, D>(ks, p.k, p.st[kK], b, k0, p.sk, kvh, p.d);
  load_tile_async<T, D>(vs, p.v, p.st[kV], b, k0, p.sk, kvh, p.d);
  if (n_it > 0) issue(0);
  cp_async_commit();

  float dk[NN][4], dv[NN][4];
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();  // pair it landed; stage (it+1)&1 is free
    if (it + 1 < n_it) {
      issue(it + 1);
      cp_async_commit();
    }
    const int st = it & 1;
    const T* qb = qs + st * kTile * D;
    const T* db = dos + st * kTile * D;
    const float* lse = lse_s + st * kTile;
    const float* delta = delta_s + st * kTile;
    const int q0 = (qt0 + it % nqt) * kTile;

    // S^T = K Q^T and dP^T = V dO^T: rows g, g+8 of the warp's k rows,
    // q columns 8j + 2t, +1 of this lane
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      unsigned ka[4], va[4];
      load_a<D>(ka, ks, r0, kd * 16, lane);
      load_a<D>(va, vs, r0, kd * 16, lane);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bq[4], bd[4];
        load_b<D>(bq, qb, jp * 16, kd * 16, lane);
        load_b<D>(bd, db, jp * 16, kd * 16, lane);
        mma<T>(s[2 * jp], ka, bq[0], bq[1]);
        mma<T>(s[2 * jp + 1], ka, bq[2], bq[3]);
        mma<T>(dp[2 * jp], va, bd[0], bd[1]);
        mma<T>(dp[2 * jp + 1], va, bd[2], bd[3]);
      }
    }

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta) scale; masked 0,
    // and 0 in the q columns past sq (they add nothing to dK or dV)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2f(s[j][e] * scale2 -
                        lse[j * 8 + 2 * t + (e & 1)] * kLog2e);
    const bool diag = p.causal && q0 + offset < k0 + kTile - 1;
    if (diag || q0 + kTile > p.sq) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + j * 8 + 2 * t + (e & 1);
          if ((diag && q + offset < k0 + r0 + g + (e >> 1) * 8) ||
              q >= p.sq)
            s[j][e] = 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - delta[j * 8 + 2 * t + (e & 1)]) *
                   p.scale;

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T as hi + lo (the
    // reference's products are float32), straight from the accumulator
    // layout into the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned phi[4], plo[4], shi[4], slo[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        split2<T>(s[2 * kk + i][0], s[2 * kk + i][1], phi[2 * i],
                  plo[2 * i]);
        split2<T>(s[2 * kk + i][2], s[2 * kk + i][3], phi[2 * i + 1],
                  plo[2 * i + 1]);
        split2<T>(dp[2 * kk + i][0], dp[2 * kk + i][1], shi[2 * i],
                  slo[2 * i]);
        split2<T>(dp[2 * kk + i][2], dp[2 * kk + i][3], shi[2 * i + 1],
                  slo[2 * i + 1]);
      }
#pragma unroll
      for (int jp = 0; jp < NN / 2; ++jp) {
        unsigned bo[4], bq[4];
        load_b_trans<D>(bo, db, kk * 16, c0 + jp * 16, lane);
        mma<T>(dv[2 * jp], phi, bo[0], bo[1]);
        mma<T>(dv[2 * jp], plo, bo[0], bo[1]);
        mma<T>(dv[2 * jp + 1], phi, bo[2], bo[3]);
        mma<T>(dv[2 * jp + 1], plo, bo[2], bo[3]);
        load_b_trans<D>(bq, qb, kk * 16, c0 + jp * 16, lane);
        mma<T>(dk[2 * jp], shi, bq[0], bq[1]);
        mma<T>(dk[2 * jp], slo, bq[0], bq[1]);
        mma<T>(dk[2 * jp + 1], shi, bq[2], bq[3]);
        mma<T>(dk[2 * jp + 1], slo, bq[2], bq[3]);
      }
    }
  }

  // the warp's rows of the K and V tiles are its own: they stage the
  // warp's dK and dV rows on their way out
  store_rows<T, D, NC>(p.dk, p.st[kDK], b, k0 + r0, p.sk, kvh, ks, r0, dk,
                       1.f, 1.f, c0, p.d, lane);
  store_rows<T, D, NC>(p.dv, p.st[kDV], b, k0 + r0, p.sk, kvh, vs, r0, dv,
                       1.f, 1.f, c0, p.d, lane);
}

// ---------------------------------------------------------------------------
// Hopper kernels: bf16 / f16 B2 and B3 at D = 64 and 128 (TMA, wgmma)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kPanel = 64;       // columns of one 128-byte swizzled panel
constexpr int kPanelBytes = kTile * kPanel * 2;  // 8 KB, 1024-aligned

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// an arrival that also expects `bytes` more from TMA copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed; a wait of more than
// ~2^35 cycles (~17 s) traps, so that a fault in the protocol ends the
// launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
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

// One [64 rows][64 columns] panel of a rank-4 (d, h, s, b) operand by TMA,
// 128-byte swizzled, rows past the end and columns past d zero-filled;
// completion is counted on `bar`.
__device__ __forceinline__ void tma_panel(void* dst, const CUtensorMap* map,
                                          int c, int h, int s, int b,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(s), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}
// rows s0 .. s0+63 of (b, h), all D columns: D / 64 panels
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, int h,
                                         int s0, int b, uint64_t* bar) {
#pragma unroll
  for (int pn = 0; pn < D / kPanel; ++pn)
    tma_panel(dst + pn * kPanelBytes, map, pn * kPanel, h, s0, b, bar);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at p (rows
// of 128 bytes, 8-row groups 1024 bytes apart). K-major operands step
// through a panel's k16 slices by +32 bytes, MN-major ones by +2048 (16
// rows); a 64-wide operand spans one swizzle atom, so the leading offset
// is not read and is given the group stride too.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t{1024 >> 4} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// orders the compiler's accesses of wgmma accumulators against the
// fence / wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define FLASH_WG_D                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FLASH_WG_OPS(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// m64n64k16 products with float32 sums: `ss` with A and B K-major in
// shared memory (d = A B, or d += A B if acc); `ss_t` with B MN-major
// (the transpose bit), accumulating; `rs_t` the same with A from
// registers (four 32-bit registers of the m16n8k16 A-fragment layout in
// each warp's 16 rows).
template <typename T>
struct Wgmma;
#define FLASH_WGMMA(T, TY)                                                  \
  template <>                                                               \
  struct Wgmma<T> {                                                         \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,   \
                                              uint64_t b, int acc) {        \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"             \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY  \
                   " " FLASH_WG_D ", %32, %33, p, 1, 1, 0, 0;\n}\n"         \
                   : FLASH_WG_OPS(d)                                        \
                   : "l"(a), "l"(b), "r"(acc));                             \
    }                                                                       \
    static __device__ __forceinline__ void ss_t(float (&d)[32], uint64_t a, \
                                                uint64_t b) {               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"             \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY  \
                   " " FLASH_WG_D ", %32, %33, p, 1, 1, 0, 1;\n}\n"         \
                   : FLASH_WG_OPS(d)                                        \
                   : "l"(a), "l"(b), "r"(1));                               \
    }                                                                       \
    static __device__ __forceinline__ void rs_t(float (&d)[32],             \
                                                const unsigned (&a)[4],     \
                                                uint64_t b) {               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"             \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY  \
                   " " FLASH_WG_D ", {%32, %33, %34, %35}, %36, p, 1, 1, "  \
                   "1;\n}\n"                                                \
                   : FLASH_WG_OPS(d)                                        \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                     "r"(1));                                               \
    }                                                                       \
  };
FLASH_WGMMA(__nv_bfloat16, "bf16")
FLASH_WGMMA(__half, "f16")
#undef FLASH_WGMMA
#undef FLASH_WG_OPS
#undef FLASH_WG_D

// S (or S^T) = A B^T over the head dim: A rows and B rows are 64-row
// tiles of D / 64 panels, both K-major
template <typename T, int D>
__device__ __forceinline__ void wg_scores(float (&s)[32],
                                          const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int off = (kd / 4) * kPanelBytes + (kd % 4) * 32;
    Wgmma<T>::ss(s, wg_desc(a + off), wg_desc(b + off), kd > 0);
  }
}

// This thread's byte offsets in a [64][64] panel in the 128-byte swizzle
// (a K-major A operand): row 16 warp + g, 16-byte chunk j; row + 8 is
// 1024 bytes on, in the same chunk order.
__device__ __forceinline__ void split_offsets(int (&off)[8], int warp, int g,
                                              int t) {
  const int r = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) off[j] = r * 128 + ((j ^ (r & 7)) << 4) + 4 * t;
}

// An m64n64 accumulator x, split into hi = round(x) and lo = round(x -
// hi), into two [64][64] panels at this thread's offsets: rows 16 warp + g
// and + 8, columns 8 j + 2 t, +1.
template <typename T>
__device__ __forceinline__ void stage_split(const float (&x)[32],
                                            unsigned char* hi,
                                            unsigned char* lo,
                                            const int (&off)[8]) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned h, l;
      split2<T>(x[4 * j + 2 * half], x[4 * j + 2 * half + 1], h, l);
      *reinterpret_cast<unsigned*>(hi + off[j] + 1024 * half) = h;
      *reinterpret_cast<unsigned*>(lo + off[j] + 1024 * half) = l;
    }
}

// The split panels written by the whole warpgroup, visible to its wgmma
// (the async proxy).
__device__ __forceinline__ void publish_split(int wg) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);
}

// acc[pn] += X B over a 64-row k tile: X = hi + lo, two [64][64] K-major
// panels (hi before lo in each k16 step), B a 64-row tile read MN-major
// (its columns are the output's)
template <typename T, int NP>
__device__ __forceinline__ void wg_accumulate(float (&acc)[NP][32],
                                              const unsigned char* hi,
                                              const unsigned char* lo,
                                              const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      const uint64_t bd = wg_desc(b + pn * kPanelBytes + kk * 16 * 128);
      Wgmma<T>::ss_t(acc[pn], wg_desc(hi + kk * 32), bd);
      Wgmma<T>::ss_t(acc[pn], wg_desc(lo + kk * 32), bd);
    }
}

// rows row and row + 8 (those < s) of an m64 accumulator over D columns
// (those < d), as pairs in T
template <typename T, int NP>
__device__ __forceinline__ void store_acc(void* base, const Strides& st,
                                          int b, int h, int row, int s,
                                          int d, int t,
                                          const float (&acc)[NP][32]) {
  T* out = static_cast<T*>(base) + b * st.b + h * st.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= s) continue;
    T* dst = out + r * st.s;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = pn * kPanel + 8 * j + 2 * t;
        if (col < d)
          *reinterpret_cast<unsigned*>(dst + col) = pack2<T>(
              acc[pn][4 * j + 2 * half], acc[pn][4 * j + 2 * half + 1]);
      }
  }
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const unsigned a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

constexpr int kStages = 3;  // the ring of streamed tiles

// Shared memory of a Hopper kernel: the two resident 64-row tiles of each
// of two operands, kStages streamed tiles of each of two operands, the
// split panels of the two consumer warpgroups (B2: dS hi, lo; B3: P^T and
// dS^T hi, lo), B3's staged lse and delta rows, the barriers, and slack
// for 1024-alignment. B3 at D = 128 takes 231,992 of the 232,448 bytes a
// block may have.
template <bool kDkv, int D>
struct WgShape {
  static constexpr int kTileBytes = D / kPanel * kPanelBytes;
  static constexpr size_t kSmem =
      static_cast<size_t>(kTileBytes) * (4 + 2 * kStages) +
      static_cast<size_t>(kPanelBytes) * 2 * (kDkv ? 4 : 2) +
      (kDkv ? 2 * kStages * kTile * sizeof(float) : 0) +
      (2 * kStages + 1) * sizeof(uint64_t) + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

// The mbarriers of a Hopper kernel: the full and empty barriers of a ring
// of S stages and the resident tiles'. A full barrier completes when its
// TMA bytes have landed (and, in B3, when the producer's 32 lanes have
// staged their lse and delta rows); an empty one when every consumer
// warpgroup is done with the stage.
template <int S>
struct Ring {
  uint64_t full[S], empty[S], resident;

  __device__ void init(unsigned full_count, unsigned consumers) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], full_count);
      mbar_init(&empty[i], consumers);
    }
    mbar_init(&resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// B2 on Hopper: dQ of 128 q rows of one (b, q head); grid (q head, batch,
// 128-row q block), the heaviest block first. Warpgroups 0 and 1 own 64
// q rows each, with their Q and dO tiles resident; one thread of
// warpgroup 2 streams the K and V tiles through the ring.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma(const Params p, const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo) {
  constexpr int NP = D / kPanel;
  constexpr int kTileBytes = WgShape<false, D>::kTileBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);  // rows of warpgroup 0, 1
  unsigned char* dos = qs + 2 * kTileBytes;
  unsigned char* ks = dos + 2 * kTileBytes;  // the ring
  unsigned char* vs = ks + kStages * kTileBytes;
  unsigned char* split = vs + kStages * kTileBytes;  // 2 panels a warpgroup
  auto* bar = reinterpret_cast<Ring<kStages>*>(split + 4 * kPanelBytes);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 2 * kTile;
  const int kvh = h / (p.hq / p.hkv);
  const int offset = p.sk - p.sq;
  // k tiles that q rows r0 .. r0+63 see (0 past the end)
  auto seen = [&](int r0) {
    if (r0 >= p.sq) return 0;
    if (!p.causal) return tiles(p.sk);
    return min(tiles(p.sk), (min(r0 + kTile, p.sq) - 1 + offset) / kTile + 1);
  };
  const int nk = max(seen(q0), seen(q0 + kTile));

  if (threadIdx.x == 0) bar->init(1, 2);  // consumers: warpgroups 0, 1
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_arrive_tx(&bar->resident, 4 * kTileBytes);
      for (int w = 0; w < 2; ++w) {
        tma_tile<D>(qs + w * kTileBytes, &tq, h, q0 + w * kTile, b,
                    &bar->resident);
        tma_tile<D>(dos + w * kTileBytes, &tdo, h, q0 + w * kTile, b,
                    &bar->resident);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&bar->empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_tx(&bar->full[st], 2 * kTileBytes);
        tma_tile<D>(ks + st * kTileBytes, &tk, kvh, kt * kTile, b,
                    &bar->full[st]);
        tma_tile<D>(vs + st * kTileBytes, &tv, kvh, kt * kTile, b,
                    &bar->full[st]);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * kTile;  // the warpgroup's first q row
    const int nkw = seen(r0);
    const int row = r0 + warp * 16 + g;  // this thread's rows: +0, +8
    const float scale2 = p.scale * kLog2e;
    // lse (log2 units) and delta of rows row, row + 8 (0 past the end:
    // those rows are not stored); delta scaled: dS = P (dP scale - delta
    // scale)
    const long long li = (static_cast<long long>(b) * p.hq + h) * p.sq + row;
    const bool in0 = row < p.sq, in1 = row + 8 < p.sq;
    const float lse2[2] = {in0 ? p.lse[li] * kLog2e : 0.f,
                           in1 ? p.lse[li + 8] * kLog2e : 0.f};
    const float dscaled[2] = {in0 ? p.delta[li] * p.scale : 0.f,
                              in1 ? p.delta[li + 8] * p.scale : 0.f};
    unsigned char* ds_hi = split + 2 * wg * kPanelBytes;
    unsigned char* ds_lo = ds_hi + kPanelBytes;
    int off[8];
    split_offsets(off, warp, g, t);
    const unsigned char* qw = qs + wg * kTileBytes;
    const unsigned char* dw = dos + wg * kTileBytes;
    float dq[NP][32];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[pn][e] = 0.f;

    mbar_wait(&bar->resident, 0);
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % kStages;
      mbar_wait(&bar->full[st], (kt / kStages) & 1);
      if (kt < nkw) {  // a tile this warpgroup's rows see
        const unsigned char* kb = ks + st * kTileBytes;
        const unsigned char* vb = vs + st * kTileBytes;
        const int k0 = kt * kTile;
        const bool diag = p.causal && k0 + kTile - 1 > r0 + offset;
        const bool edge = diag || k0 + kTile > p.sk;
        // S = Q K^T and dP = dO V^T, one commit group each: P is taken
        // while dP is still on the tensor cores
        float s[32], dp[32];
        wg_fence();
        wg_scores<T, D>(s, qw, kb);
        wg_commit();
        wg_scores<T, D>(dp, dw, vb);
        wg_commit();
        wg_wait<1>();
        fence_regs(s);
        // P = exp(S - lse); masked entries 0 (a branch of its own: only
        // the diagonal band and a last partial tile take it)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = ex2(s[e] * scale2 - lse2[(e >> 1) & 1]);
        if (edge) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int col = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
            if ((diag && row + ((e >> 1) & 1) * 8 + offset < col) ||
                col >= p.sk)
              s[e] = 0.f;
          }
        }
        wg_wait<0>();
        fence_regs(dp);
        // dS = P (dP - delta) scale, staged as hi + lo (the reference's
        // dS K is float32)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] *= fmaf(dp[e], p.scale, -dscaled[(e >> 1) & 1]);
        stage_split<T>(s, ds_hi, ds_lo, off);
        publish_split(wg);

        // dQ += dS K
        wg_fence();
        wg_accumulate<T, NP>(dq, ds_hi, ds_lo, kb);
        wg_commit();
        wg_wait<0>();
      }
      if (tid == 0) mbar_arrive(&bar->empty[st]);  // done with the stage
    }
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_regs(dq[pn]);
    store_acc<T, NP>(p.dq, p.st[kDQ], b, h, row, p.sq, p.d, t, dq);
  }
}

// B3 on Hopper: dK and dV of 128 k rows of one (b, kv head), summed over
// the GQA group; grid (kv head, batch, 128-row k block), block 0 (the
// heaviest under the causal mask) first. Warpgroups 0 and 1 own 64 k
// rows each, with their K and V tiles resident; warp 0 of warpgroup 2
// streams the (q head, q tile) pairs' Q and dO tiles by TMA and stages
// their lse (log2 units) and delta (times the scale) rows with plain
// loads.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma(const Params p, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo) {
  constexpr int NP = D / kPanel;
  constexpr int kTileBytes = WgShape<true, D>::kTileBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);  // rows of warpgroup 0, 1
  unsigned char* vs = ks + 2 * kTileBytes;
  unsigned char* qs = vs + 2 * kTileBytes;  // the ring
  unsigned char* dos = qs + kStages * kTileBytes;
  unsigned char* split = dos + kStages * kTileBytes;  // 4 panels a warpgroup
  float* lse_s = reinterpret_cast<float*>(split + 8 * kPanelBytes);
  float* delta_s = lse_s + kStages * kTile;
  auto* bar = reinterpret_cast<Ring<kStages>*>(delta_s + kStages * kTile);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * 2 * kTile;
  const int group = p.hq / p.hkv;
  const int offset = p.sk - p.sq;
  // q tiles that see this k block: from the first one that reaches it
  const int qt0 = p.causal ? max(0, k0 - offset) / kTile : 0;
  const int nqt = tiles(p.sq) - qt0;
  const int n_it = group * nqt;  // (q head, q tile) pairs

  if (threadIdx.x == 0) bar->init(32, 2);  // producer warp's lanes; 2 WGs
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 256 + 32) {
      if (lane == 0) {
        mbar_arrive_tx(&bar->resident, 4 * kTileBytes);
        for (int w = 0; w < 2; ++w) {
          tma_tile<D>(ks + w * kTileBytes, &tk, kvh, k0 + w * kTile, b,
                      &bar->resident);
          tma_tile<D>(vs + w * kTileBytes, &tv, kvh, k0 + w * kTile, b,
                      &bar->resident);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int h = kvh * group + it / nqt;
        const int q0 = (qt0 + it % nqt) * kTile;
        // this lane's rows lane, lane + 32, loaded before the stage is
        // free
        const long long base =
            (static_cast<long long>(b) * p.hq + h) * p.sq + q0;
        float l[2], dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = q0 + lane + 32 * e < p.sq;
          l[e] = in ? p.lse[base + lane + 32 * e] * kLog2e : 0.f;
          dl[e] = in ? p.delta[base + lane + 32 * e] * p.scale : 0.f;
        }
        mbar_wait(&bar->empty[st], ((it / kStages) & 1) ^ 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lse_s[st * kTile + lane + 32 * e] = l[e];
          delta_s[st * kTile + lane + 32 * e] = dl[e];
        }
        if (lane == 0) {
          mbar_arrive_tx(&bar->full[st], 2 * kTileBytes);
          tma_tile<D>(qs + st * kTileBytes, &tq, h, q0, b, &bar->full[st]);
          tma_tile<D>(dos + st * kTileBytes, &tdo, h, q0, b, &bar->full[st]);
        } else {
          mbar_arrive(&bar->full[st]);
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kr0 = k0 + wg * kTile;  // the warpgroup's first k row
    const int row = kr0 + warp * 16 + g;  // this thread's k rows: +0, +8
    const float scale2 = p.scale * kLog2e;
    const unsigned char* kw = ks + wg * kTileBytes;
    const unsigned char* vw = vs + wg * kTileBytes;
    unsigned char* p_hi = split + 4 * wg * kPanelBytes;
    unsigned char* p_lo = p_hi + kPanelBytes;
    unsigned char* ds_hi = p_lo + kPanelBytes;
    unsigned char* ds_lo = ds_hi + kPanelBytes;
    int off[8];
    split_offsets(off, warp, g, t);
    float dk[NP][32], dv[NP][32];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[pn][e] = dv[pn][e] = 0.f;

    mbar_wait(&bar->resident, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int q0 = (qt0 + it % nqt) * kTile;
      mbar_wait(&bar->full[st], (it / kStages) & 1);
      // skip a pair the causal mask hides from all of this warpgroup's
      // rows, and rows past the end
      if (kr0 < p.sk && !(p.causal && q0 + kTile - 1 + offset < kr0)) {
        const unsigned char* qb = qs + st * kTileBytes;
        const unsigned char* db = dos + st * kTileBytes;
        const float* lse = lse_s + st * kTile;
        const float* dl = delta_s + st * kTile;
        const bool diag = p.causal && q0 + offset < kr0 + kTile - 1;
        const bool edge = diag || q0 + kTile > p.sq;
        // S^T = K Q^T and dP^T = V dO^T (k rows, q columns), one commit
        // group each: P^T is taken while dP^T is still on the tensor cores
        float s[32], dp[32];
        wg_fence();
        wg_scores<T, D>(s, kw, qb);
        wg_commit();
        wg_scores<T, D>(dp, vw, db);
        wg_commit();
        wg_wait<1>();
        fence_regs(s);
        // P^T = exp(S^T - lse); masked 0, and 0 in the q columns past sq
        // (they add nothing): a branch of its own, as in B2
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse + 8 * c + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * c + e] =
                ex2(s[4 * c + e] * scale2 - ((e & 1) ? l2.y : l2.x));
        }
        if (edge) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int q = q0 + (e >> 2) * 8 + 2 * t + (e & 1);
            if (q >= p.sq || (diag && q + offset < row + ((e >> 1) & 1) * 8))
              s[e] = 0.f;
          }
        }
        stage_split<T>(s, p_hi, p_lo, off);
        wg_wait<0>();
        fence_regs(dp);
        // dS^T = P^T (dP^T - delta) scale, delta staged scaled
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(dl + 8 * c + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * c + e] = s[4 * c + e] * fmaf(dp[4 * c + e], p.scale,
                                                -((e & 1) ? d2.y : d2.x));
        }
        stage_split<T>(dp, ds_hi, ds_lo, off);
        publish_split(wg);

        // dV += P^T dO and dK += dS^T Q, P^T and dS^T as hi + lo (the
        // reference's products are float32)
        wg_fence();
        wg_accumulate<T, NP>(dv, p_hi, p_lo, db);
        wg_accumulate<T, NP>(dk, ds_hi, ds_lo, qb);
        wg_commit();
        wg_wait<0>();
      }
      if (tid == 0) mbar_arrive(&bar->empty[st]);  // done with the stage
    }
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      fence_regs(dv[pn]);
      fence_regs(dk[pn]);
    }
    store_acc<T, NP>(p.dk, p.st[kDK], b, kvh, row, p.sk, p.d, t, dk);
    store_acc<T, NP>(p.dv, p.st[kDV], b, kvh, row, p.sk, p.d, t, dv);
  }
}

// ---------------------------------------------------------------------------
// Hopper kernel: bf16 / f16 B1 at D = 64 and 128 (TMA, wgmma)
// ---------------------------------------------------------------------------

// The Hopper B1's block at D 64 and at D 128, chosen by runs in turns
// (PERF.md): S ring stages of a K and a V tile, W consumer warpgroups of
// 64 q rows and a producer warpgroup, C blocks an SM (at D 64 four blocks
// of one warpgroup beat bigger blocks: one block's TMA waits and stores
// overlap the others' products). Registers a thread at launch (multiples
// of 8), the producer's 24 after setmaxnreg and the consumers' share of
// the rest; shared memory: the W resident 64-row Q tiles, S stages of a K
// and a V tile, the barriers, and slack for 1024-alignment.
// setmaxnreg.inc takes the consumers' registers from the block's launch
// share, so ptxas must give the kernel exactly kEntryRegs a thread (64 at
// D 64, 128 at D 128; __launch_bounds__ caps it there): a build with
// fewer lets more blocks onto an SM, and its consumers would wait in
// setmaxnreg forever. chip_smoke.py's build phase fails on such a build.
template <int D>
struct FwdShape {
  static_assert(D == 64 || D == 128, "the Hopper B1 is built at D 64, 128");
  static constexpr int S = D == 64 ? 2 : 3;
  static constexpr int W = D == 64 ? 1 : 3;
  static constexpr int C = D == 64 ? 4 : 1;
  static constexpr int kThreads = (W + 1) * 128;
  static constexpr int kEntryRegs = 65536 / C / kThreads / 8 * 8;
  static constexpr int kConsumerRegs = (kEntryRegs * (W + 1) - 24) / W / 8 * 8;
  static constexpr int kTileBytes = D / kPanel * kPanelBytes;
  static constexpr size_t kSmem = static_cast<size_t>(kTileBytes) *
                                      (W + 2 * S) +
                                  sizeof(Ring<S>) + 1024;
  // an SM has 228 KB, of which each block reserves 1 KB
  static_assert((kSmem + 1024) * C <= 228 * 1024,
                "more shared memory than an SM has");
  static_assert(kConsumerRegs <= 240, "setmaxnreg takes at most 240 here");
};

// O += P V over a 64-row k tile: P in registers as four A fragments, V a
// 64-row tile of D / 64 panels read MN-major (its columns are O's)
template <typename T, int NP>
__device__ __forceinline__ void wg_pv(float (&o)[NP][32],
                                      const unsigned (&a)[4][4],
                                      const unsigned char* v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
      Wgmma<T>::rs_t(o[pn], a[kk], wg_desc(v + pn * kPanelBytes + kk * 2048));
}

// The online softmax of one 64-column score tile in this thread's rows
// (row and row + 8 of the accumulator layout: s[4 j + 2 r + c] is row
// + 8 r, column k0 + 8 j + 2 t + c): S scaled to log2 units, masked only
// where the tile reaches past the causal diagonal of the warpgroup's
// first row (row0_off: that row plus the offset sk - sq) or past sk,
// then P against the running max m, l rescaled and summed over the
// unrounded P (the TPU kernel's l); alpha is O's rescale. The row's max
// and sum are taken as trees, so their dependency chains stay short.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               float scale2, int k0,
                                               int row0_off, int row_off,
                                               int t, int causal, int sk) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] *= scale2;
  const bool diag = causal && k0 + kTile - 1 > row0_off;
  if (diag || k0 + kTile > sk) {  // a branch uniform over the warpgroup
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
      if ((diag && row_off + ((e >> 1) & 1) * 8 < col) || col >= sk)
        s[e] = kMaskValue;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = fmaxf(fmaxf(s[8 * i + 2 * r], s[8 * i + 2 * r + 1]),
                   fmaxf(s[8 * i + 4 + 2 * r], s[8 * i + 5 + 2 * r]));
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[r], mx);
    alpha[r] = ex2(m[r] - mx);
    m[r] = mx;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = ex2(s[e] - m[(e >> 1) & 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = (s[8 * i + 2 * r] + s[8 * i + 2 * r + 1]) +
             (s[8 * i + 4 + 2 * r] + s[8 * i + 5 + 2 * r]);
    l[r] = l[r] * alpha[r] + ((x[0] + x[1]) + (x[2] + x[3]));
  }
}

// rows row (f[0]) and row + 8 (f[1]) of an m64 accumulator times f
template <int NP>
__device__ __forceinline__ void scale_rows(float (&o)[NP][32],
                                           const float (&f)[2]) {
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[pn][e] *= f[(e >> 1) & 1];
}

// P rounded to T as the A fragments of P V's k16 steps: the accumulator
// layout (rows g, g + 8; columns 8 j + 2 t, +1) is the A-fragment layout,
// so no value leaves its thread
template <typename T>
__device__ __forceinline__ void pack_p(unsigned (&a)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// B1 on Hopper: O and lse of 64 W q rows of one (b, q head); grid (q
// head, batch, q block), the heaviest block first; C blocks an SM.
// Consumer warpgroups 0 .. W-1 own 64 q rows each, with their Q tile
// resident; one thread of warpgroup W (its registers handed to the
// consumers by setmaxnreg) streams the K and V tiles of kv head h / group
// through the ring. The k tiles run in order from tile 0, which every row
// of a causal launch sees, so the finite mask value never sets a row's
// running max.
template <typename T, int D>
__global__ void __launch_bounds__(FwdShape<D>::kThreads, FwdShape<D>::C)
    flash_fwd_wgmma(const Params p, const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv) {
  using Shape = FwdShape<D>;
  constexpr int S = Shape::S, W = Shape::W;
  constexpr int NP = D / kPanel;
  constexpr int kTileBytes = Shape::kTileBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);  // rows of warpgroup 0 .. W-1
  unsigned char* ks = qs + W * kTileBytes;   // the ring
  unsigned char* vs = ks + S * kTileBytes;
  auto* bar = reinterpret_cast<Ring<S>*>(vs + S * kTileBytes);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * W * kTile;
  const int kvh = h / (p.hq / p.hkv);
  const int offset = p.sk - p.sq;
  // k tiles that q rows r0 .. r0+63 see (0 past the end)
  auto seen = [&](int r0) {
    if (r0 >= p.sq) return 0;
    if (!p.causal) return tiles(p.sk);
    return min(tiles(p.sk), (min(r0 + kTile, p.sq) - 1 + offset) / kTile + 1);
  };
  // the block's last warpgroup with rows sees the most
  const int nk = seen(min(q0 + (W - 1) * kTile, (p.sq - 1) / kTile * kTile));

  if (threadIdx.x == 0) bar->init(1, W);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == W) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == W * 128) {
      mbar_arrive_tx(&bar->resident, W * kTileBytes);
      for (int w = 0; w < W; ++w)
        tma_tile<D>(qs + w * kTileBytes, &tq, h, q0 + w * kTile, b,
                    &bar->resident);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % S;
        mbar_wait(&bar->empty[st], ((kt / S) & 1) ^ 1);
        mbar_arrive_tx(&bar->full[st], 2 * kTileBytes);
        tma_tile<D>(ks + st * kTileBytes, &tk, kvh, kt * kTile, b,
                    &bar->full[st]);
        tma_tile<D>(vs + st * kTileBytes, &tv, kvh, kt * kTile, b,
                    &bar->full[st]);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Shape::kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * kTile;  // the warpgroup's first q row
    const int nkw = seen(r0);
    const int row = r0 + warp * 16 + g;  // this thread's rows: +0, +8
    const float scale2 = p.scale * kLog2e;  // scores in log2 units
    const unsigned char* qw = qs + wg * kTileBytes;
    float o[NP][32];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[pn][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's part of the row sums
    float alpha[2];           // O's rescale for the newest tile
    float s[32];              // S, then P, of one k tile
    unsigned a[4][4];         // P rounded to T: P V's A fragments

    mbar_wait(&bar->resident, 0);
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % S;
      mbar_wait(&bar->full[st], (kt / S) & 1);
      if (kt < nkw) {  // a tile this warpgroup's rows see
        // S = Q K^T; the softmax; O += P V with P from registers
        wg_fence();
        wg_scores<T, D>(s, qw, ks + st * kTileBytes);
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        online_softmax(s, m, l, alpha, scale2, kt * kTile, r0 + offset,
                       row + offset, t, p.causal, p.sk);
        scale_rows<NP>(o, alpha);
        pack_p<T>(a, s);
        wg_fence();
        wg_pv<T, NP>(o, a, vs + st * kTileBytes);
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) fence_regs(o[pn]);
      }
      if (tid == 0) mbar_arrive(&bar->empty[st]);  // done with the stage
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (l[r] == 0.f) l[r] = 1.f;
      inv[r] = 1.f / l[r];
    }
    scale_rows<NP>(o, inv);
    store_acc<T, NP>(p.o, p.st[kO], b, h, row, p.sq, p.d, t, o);
    if (t == 0) {
      float* lse =
          p.lse + (static_cast<long long>(b) * p.hq + h) * p.sq + row;
      if (row < p.sq) lse[0] = m[0] * kLn2 + logf(l[0]);
      if (row + 8 < p.sq) lse[8] = m[1] * kLn2 + logf(l[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Which : int { kFwd = 0, kBwdDq = 1, kBwdDkv = 2 };
// kernel designs, as ops/flash_attention.py::kernel_route names them
enum Design : int { kSimt = 0, kMma = 1, kWgmma = 2 };

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

// A BSHD operand as a rank-4 (d, h, s, b) tensor with the caller's
// strides, read in boxes of 64 columns x 64 rows of one (b, h), 128-byte
// swizzled; out-of-bounds columns and rows read as zeros. A dimension of
// size 1 is never stepped: its stride is taken as if it were packed.
template <typename T>
bool make_map(CUtensorMap* map, const void* base, const Strides& st, int d,
              int heads, int seq, int batch) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const long long given[3] = {st.h, st.s, st.b};
  cuuint64_t strides[3];
  cuuint64_t packed = (d * sizeof(T) + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed : given[i] * sizeof(T);
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {kPanel, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// B1, B2 and B3 on Hopper: q, do [b, sq, hq, d] and k, v [b, sk, hkv, d]
// as tensor maps (do for B2 and B3 only); B1 in blocks of FwdShape's
// W x 64 q rows, B2 and B3 in 128-row blocks
template <typename T, int D>
cudaError_t launch_wgmma(int which, int batch, const Params& p,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map<T>(&tq, p.q, p.st[kQ], p.d, p.hq, p.sq, batch) ||
      !make_map<T>(&tk, p.k, p.st[kK], p.d, p.hkv, p.sk, batch) ||
      !make_map<T>(&tv, p.v, p.st[kV], p.d, p.hkv, p.sk, batch) ||
      (which != kFwd &&
       !make_map<T>(&tdo, p.dout, p.st[kDO], p.d, p.hq, p.sq, batch)))
    return cudaErrorInvalidValue;
  // B2 / B3: one block a 128-row block of (q head or kv head, batch)
  constexpr int kBlockRows = 2 * kTile;
  if (which == kFwd) {
    using Shape = FwdShape<D>;
    constexpr int kRows = Shape::W * kTile;  // q rows a block
    auto kernel = flash_fwd_wgmma<T, D>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Shape::kSmem));
    if (e == cudaSuccess && Shape::C > 1)  // room for C blocks an SM
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(p.hq, batch, (p.sq + kRows - 1) / kRows), Shape::kThreads,
             Shape::kSmem, stream>>>(p, tq, tk, tv);
    return cudaGetLastError();
  }
  const bool dq = which == kBwdDq;
  auto kernel = dq ? flash_bwd_dq_wgmma<T, D> : flash_bwd_dkv_wgmma<T, D>;
  const size_t smem = dq ? WgShape<false, D>::kSmem : WgShape<true, D>::kSmem;
  const dim3 grid =
      dq ? dim3(p.hq, batch, (p.sq + kBlockRows - 1) / kBlockRows)
         : dim3(p.hkv, batch, (p.sk + kBlockRows - 1) / kBlockRows);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kWgThreads, smem, stream>>>(p, tq, tk, tv, tdo);
  return cudaGetLastError();
}

template <int D>
constexpr size_t simt_smem_bytes(int which) {
  return sizeof(float) *
         (which == kFwd ? 3 * kTile * (D + 1) + kTile * kLP
          : which == kBwdDq
              ? 4 * kTile * (D + 1) + kTile * kLP + 2 * kTile
              : 4 * kTile * (D + 1) + 2 * kTile * kLP + 2 * kTile);
}

// B1: q tile and two stages of K and V; B2: q and dO tiles and two
// stages of K and V; B3: K and V tiles, two stages of Q and dO, and two
// stages of the q tile's lse and delta
template <typename T, int D>
constexpr size_t mma_smem_bytes(int which) {
  return sizeof(T) * kTile * D * (which == kFwd ? 5 : 6) +
         (which == kBwdDkv ? sizeof(float) * 4 * kTile : 0);
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

// The design kernel_route picked: kWgmma (bf16 / f16 B1, B2 and B3, D 64
// or 128), kMma (bf16 / f16 with d <= D at D 256: B1, B2 and B3), kSimt
// (float32, and at D = 64 the half types above 256: split d).
template <typename T, int D>
cudaError_t launch(int design, int which, int batch, const Params& p,
                   cudaStream_t stream) {
  constexpr bool kHalf = !std::is_same<T, float>::value;
  if constexpr (kHalf && D <= 128) {
    if (design == kWgmma) {
      if (p.d > D) return cudaErrorInvalidValue;
      return launch_wgmma<T, D>(which, batch, p, stream);
    }
  }
  if constexpr (kHalf) {
    if (design == kMma) {
      if (p.d > D) return cudaErrorInvalidValue;
      // mma.sync only above d 128
      if constexpr (D == 256) {
        if (which == kFwd)  // grid (head, batch, q tile), heaviest first
          return launch_kernel(flash_fwd_mma<T, D>,
                               dim3(p.hq, batch, tiles(p.sq)), kMmaThreads,
                               mma_smem_bytes<T, D>(kFwd), p, stream);
        if (which == kBwdDq)
          return launch_kernel(flash_bwd_dq_mma<T, D>,
                               dim3(p.hq, batch, tiles(p.sq)), kMmaThreads,
                               mma_smem_bytes<T, D>(kBwdDq), p, stream);
        if (which == kBwdDkv)
          return launch_kernel(flash_bwd_dkv_mma<T, D>,
                               dim3(p.hkv * (D / dkv_cols<D>()), batch,
                                    tiles(p.sk)),
                               kMmaThreads, mma_smem_bytes<T, D>(kBwdDkv), p,
                               stream);
      }
      return cudaErrorInvalidValue;
    }
  }
  if constexpr (!kHalf || D == 64) {
    if (design != kSimt) return cudaErrorInvalidValue;
    const int slices = (p.d + D - 1) / D;
    switch (which) {
      case kFwd:
        return launch_kernel(flash_fwd<T, D>,
                             dim3(tiles(p.sq), p.hq * batch, slices),
                             kThreads, simt_smem_bytes<D>(kFwd), p, stream);
      case kBwdDq:
        return launch_kernel(flash_bwd_dq<T, D>,
                             dim3(tiles(p.sq), p.hq * batch, slices),
                             kThreads, simt_smem_bytes<D>(kBwdDq), p, stream);
      case kBwdDkv:
        return launch_kernel(flash_bwd_dkv<T, D>,
                             dim3(tiles(p.sk), p.hkv * batch, slices),
                             kThreads, simt_smem_bytes<D>(kBwdDkv), p,
                             stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_delta(int batch, const Params& p, cudaStream_t stream) {
  const int rows = batch * p.hq * p.sq;
  const int chunks = p.d / (16 / static_cast<int>(sizeof(T)));
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < chunks) ++lanes_log2;
  const int per_block = (kThreads / 32) * (32 >> lanes_log2);
  flash_bwd_delta<T><<<(rows + per_block - 1) / per_block, kThreads, 0,
                       stream>>>(p, rows, lanes_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int design, int padded_dim, int which, int batch,
                     int delta_ready, const Params& p, cudaStream_t stream) {
  if (which != kFwd && !delta_ready) {
    const cudaError_t e = launch_delta<T>(batch, p, stream);
    if (e != cudaSuccess) return e;
  }
  switch (padded_dim) {
    case 64:
      return launch<T, 64>(design, which, batch, p, stream);
    case 128:
      return launch<T, 128>(design, which, batch, p, stream);
    case 256:  // the tensor-core kernels only
      if constexpr (!std::is_same<T, float>::value)
        return launch<T, 256>(design, which, batch, p, stream);
      else
        return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `which`: 0 = B1 (writes o and
// lse), 1 = B2 (writes dq), 2 = B3 (writes dk and dv). `design`: 0 the
// SIMT kernels, 1 the mma.sync kernels, 2 the Hopper kernels (wgmma,
// TMA); a design the kernel or the dtype does not have is refused.
// `head_dim` is the operands' d (a multiple of 8), `padded_dim` the
// instantiation D: the tensor-core kernels (bf16 / f16, d <= 256) take
// D = 64 or 128 >= d (Hopper) or 256 (mma.sync); the SIMT kernels
// D = 64 or 128, summing over d in D-column slices where d > D. `ptrs`
// holds the device pointers q, k, v, o, do, lse, delta, dq, dk, dv
// (unused ones may be null); `strides` the (b, s, h) element strides of
// q, k, v, o, do, dq, dk, dv, in that order (unit stride on the head dim
// is the caller's check, as are rows that start on 16 bytes, 16-byte
// strides and no stride 0 over a dimension longer than 1, which TMA
// needs). B2 and B3 read delta = rowsum(O * dO) [b, hq, sq] from `delta`;
// unless `delta_ready`, a first kernel writes it there. Sequence lengths
// are any sq, sk >= 1. Returns the launches' cudaError_t (0 on success).
// Allocates nothing.
extern "C" int flash_attention_launch(int which, int design, int dtype,
                                      int head_dim, int padded_dim,
                                      void* const* ptrs,
                                      const long long* strides, int batch,
                                      int sq, int sk, int hq, int hkv,
                                      float scale, int causal,
                                      int delta_ready, void* stream) {
  if (head_dim <= 0 || head_dim % 8) return cudaErrorInvalidValue;
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.o = ptrs[3];
  p.dout = ptrs[4];
  p.lse = static_cast<float*>(ptrs[5]);
  p.delta = static_cast<float*>(ptrs[6]);
  p.dq = ptrs[7];
  p.dk = ptrs[8];
  p.dv = ptrs[9];
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
      return launch_d<float>(design, padded_dim, which, batch, delta_ready, p,
                             st);
    case kBF16:
      return launch_d<__nv_bfloat16>(design, padded_dim, which, batch,
                                     delta_ready, p, st);
    case kF16:
      return launch_d<__half>(design, padded_dim, which, batch, delta_ready,
                              p, st);
    default:
      return cudaErrorInvalidValue;
  }
}
