// Kernel B1 as the registered op paddle_tpu_torch::flash_attention_fwd,
// defined once, here, so that the same op serves a Python process
// (ops/flash_attention.py loads this library at import), a program that
// torch.export recorded (jit.load) and the native runner with no Python
// at all (native/predictor.cc, ptserve).
//
//   flash_attention_fwd(Tensor q, Tensor k, Tensor v, float sm_scale,
//                       bool causal) -> (Tensor o, Tensor lse)
//
// q [b, sq, hq, d], k/v [b, sk, hkv, d] with hq % hkv == 0 (grouped-query
// attention), o [b, sq, hq, d] in q's dtype, lse [b, hq, sq] float32.
//
// CPU: the plain twin of ops/flash_attention.py::flash_attention_fwd_torch
// in ATen, op for op (dense f32 scores, the bottom-right causal mask at
// the kernels' finite mask value, P rounded to v's dtype before P.V), so
// that it gives that function's bits.
//
// CUDA (built with -DPT_WITH_CUDA): kernel B1, csrc/flash_attention.cu's
// flash_attention_launch, in the nvcc-built library, on the current
// stream. It picks the design as kernel_route does, checks what the
// kernel takes as _check_cuda_args does and raises on the rest, copies an
// operand whose rows do not start on 16 bytes (as _aligned does), and
// adds one to the launch counter per launch. With the plain switch on
// (ptop_set_plain, the Python module's impl = "plain") the twin runs on
// the card instead, and nothing is counted. The launcher comes from the
// resolver the Python module installs (it builds the library on first
// use), else from the library path this file was built with
// (PT_FLASH_LIB): a standalone process such as ptserve finds it there.
//
// C ABI (ctypes):
//   ptop_b1_launches() / ptop_set_b1_launches(n) / ptop_add_b1_launches(n)
//     (the eager wrapper, which launches B1 itself, adds its launches)
//   ptop_set_plain(on)
//   ptop_set_flash_resolver(fn)    fn() -> flash_attention_launch's address

// Per-op headers and Tensor methods (not ATen/ATen.h or the operators of
// ATen/TensorOperators.h, which parse every op's declaration): the
// library builds when the port is first imported.
#include <ATen/core/Tensor.h>
#include <ATen/ops/einsum.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/exp.h>
#include <ATen/ops/log.h>
#include <ATen/ops/ones.h>
#include <ATen/ops/ones_like.h>
#include <ATen/ops/where.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <limits>
#include <mutex>
#include <string>
#include <tuple>

#ifdef PT_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <dlfcn.h>
#endif

namespace {

std::atomic<int64_t> g_b1_launches{0};
std::atomic<bool> g_plain{false};

const double kMaskValue =
    -0.7 * static_cast<double>(std::numeric_limits<float>::max());

at::Tensor ExpandKv(const at::Tensor& x, int64_t hq) {
  const int64_t group = hq / x.size(2);
  return group == 1 ? x : x.repeat_interleave(group, 2);
}

std::tuple<at::Tensor, at::Tensor> FlashFwdPlain(const at::Tensor& q,
                                                 const at::Tensor& k_in,
                                                 const at::Tensor& v_in,
                                                 double sm_scale,
                                                 bool causal) {
  const int64_t hq = q.size(2);
  const at::Tensor k = ExpandKv(k_in, hq);
  const at::Tensor v = ExpandKv(v_in, hq);
  at::Tensor s = at::einsum("bqhd,bkhd->bhqk",
                            {q.to(at::kFloat), k.to(at::kFloat)})
                     .mul(sm_scale);
  if (causal) {
    const int64_t sq = q.size(1), sk = k.size(1);
    const at::Tensor seen =
        at::ones({sq, sk}, q.options().dtype(at::kBool)).tril(sk - sq);
    s = s.masked_fill(seen.bitwise_not(), kMaskValue);
  }
  const at::Tensor m = s.amax({-1}, true);
  const at::Tensor e = at::exp(s.sub(m));
  const at::Tensor l = e.sum({-1}, true);
  const at::Tensor l_safe = at::where(l.eq(0.0), at::ones_like(l), l);
  const at::Tensor pv = at::einsum(
      "bhqk,bkhd->bqhd", {e.to(v.scalar_type()).to(at::kFloat),
                          v.to(at::kFloat)});
  const at::Tensor o = pv.div(l_safe.permute({0, 2, 1, 3}));
  const at::Tensor lse = m.add(at::log(l_safe)).select(-1, 0);
  return {o.to(q.scalar_type()), lse};
}

#ifdef PT_WITH_CUDA

using LaunchFn = int (*)(int, int, int, int, int, void* const*,
                         const long long*, int, int, int, int, int, float,
                         int, int, void*);
using ResolverFn = void* (*)();

std::atomic<LaunchFn> g_launch{nullptr};
std::atomic<ResolverFn> g_resolver{nullptr};
std::mutex g_resolve_mu;

#ifndef PT_FLASH_LIB
#define PT_FLASH_LIB ""
#endif

LaunchFn Launcher() {
  LaunchFn fn = g_launch.load();
  if (fn) return fn;
  std::lock_guard<std::mutex> lock(g_resolve_mu);
  fn = g_launch.load();
  if (fn) return fn;
  std::string why;
  if (ResolverFn resolve = g_resolver.load()) {
    fn = reinterpret_cast<LaunchFn>(resolve());
    if (!fn) why = "the resolver found no flash_attention_launch";
  } else {
    void* dl = dlopen(PT_FLASH_LIB, RTLD_NOW | RTLD_LOCAL);
    if (!dl) {
      const char* e = dlerror();
      why = std::string("dlopen ") + PT_FLASH_LIB + ": " + (e ? e : "?");
    } else {
      fn = reinterpret_cast<LaunchFn>(dlsym(dl, "flash_attention_launch"));
      if (!fn) why = "no flash_attention_launch in " PT_FLASH_LIB;
    }
  }
  TORCH_CHECK(fn, "kernel B1's library could not be loaded (", why,
              "); build it with paddle_tpu_torch.ops._kernels.build_all()");
  g_launch.store(fn);
  return fn;
}

// ops/flash_attention.py's codes: dtypes of csrc/flash_attention.cu, and
// its designs (simt and split 0, mma 1, wgmma 2)
int DtypeCode(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return 0;
    case at::kBFloat16: return 1;
    case at::kHalf: return 2;
    default: return -1;
  }
}

// kernel_route: (design code, padded head dim D)
std::pair<int, int> KernelRoute(int64_t d, at::ScalarType t) {
  if (t != at::kFloat && d <= 256) {
    const int D = d <= 64 ? 64 : d <= 128 ? 128 : 256;
    return {D <= 128 ? 2 : 1, D};
  }
  if (t == at::kFloat && d <= 128) return {0, d <= 64 ? 64 : 128};
  return {0, 64};
}

void CheckCudaArgs(const at::Tensor& q, const at::Tensor& k,
                   const at::Tensor& v) {
  TORCH_CHECK_VALUE(k.device() == q.device() && v.device() == q.device(),
                    "flash attention operands must all be on ", q.device());
  TORCH_CHECK_VALUE(q.dim() == 4 && k.dim() == 4 && v.sizes() == k.sizes(),
                    "q [b, sq, hq, d] and matching k/v [b, sk, hkv, d] "
                    "expected, got ", q.sizes(), ", ", k.sizes(), ", ",
                    v.sizes());
  TORCH_CHECK_VALUE(DtypeCode(q.scalar_type()) >= 0 &&
                        k.scalar_type() == q.scalar_type() &&
                        v.scalar_type() == q.scalar_type(),
                    "q/k/v must share one of float32/bfloat16/float16, got ",
                    q.scalar_type(), ", ", k.scalar_type(), ", ",
                    v.scalar_type());
  TORCH_CHECK_VALUE(k.size(0) == q.size(0) && k.size(3) == q.size(3) &&
                        q.size(2) % k.size(2) == 0,
                    "k/v ", k.sizes(), " do not match q ", q.sizes());
  const int64_t d = q.size(3);
  TORCH_CHECK_NOT_IMPLEMENTED(d > 0 && d % 8 == 0,
                              "the flash kernels take head dims that are "
                              "positive multiples of 8, got ", d);
  for (const at::Tensor* x : {&q, &k, &v})
    TORCH_CHECK_VALUE(x->stride(-1) == 1,
                      "flash attention operands need unit stride on the "
                      "head dim");
}

// the operand itself if its rows start on 16 bytes and no dimension
// longer than 1 repeats rows, else a contiguous copy (_aligned)
at::Tensor Aligned(const at::Tensor& x) {
  bool ok = reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0;
  for (int i = 0; i < 3 && ok; ++i) {
    const int64_t st = x.stride(i);
    ok = (st * x.element_size()) % 16 == 0 && (st != 0 || x.size(i) == 1);
  }
  return ok ? x : x.clone(at::MemoryFormat::Contiguous);
}

std::tuple<at::Tensor, at::Tensor> FlashFwdCuda(const at::Tensor& q_in,
                                                const at::Tensor& k_in,
                                                const at::Tensor& v_in,
                                                double sm_scale,
                                                bool causal) {
  if (g_plain.load()) return FlashFwdPlain(q_in, k_in, v_in, sm_scale, causal);
  CheckCudaArgs(q_in, k_in, v_in);
  const c10::cuda::CUDAGuard guard(q_in.device());
  const at::Tensor q = Aligned(q_in), k = Aligned(k_in), v = Aligned(v_in);
  const int64_t b = q.size(0), sq = q.size(1), hq = q.size(2), d = q.size(3);
  at::Tensor o = at::empty({b, sq, hq, d}, q.options());
  at::Tensor lse = at::empty({b, hq, sq}, q.options().dtype(at::kFloat));
  void* ptrs[10] = {q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    nullptr, lse.data_ptr(), nullptr, nullptr, nullptr,
                    nullptr};
  long long strides[24] = {0};
  const at::Tensor* with_strides[4] = {&q, &k, &v, &o};  // do, dq, dk, dv: 0
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) strides[3 * t + i] = with_strides[t]->stride(i);
  const auto route = KernelRoute(d, q.scalar_type());
  const int err = Launcher()(
      0, route.first, DtypeCode(q.scalar_type()), static_cast<int>(d),
      route.second, ptrs, strides, static_cast<int>(b),
      static_cast<int>(sq), static_cast<int>(k.size(1)),
      static_cast<int>(hq), static_cast<int>(k.size(2)),
      static_cast<float>(sm_scale), causal ? 1 : 0, 0,
      c10::cuda::getCurrentCUDAStream(q.device().index()).stream());
  TORCH_CHECK(err == 0, "flash attention kernel 0 launch failed: cudaError ",
              err);
  g_b1_launches.fetch_add(1);
  return {o, lse};
}

#endif  // PT_WITH_CUDA

}  // namespace

TORCH_LIBRARY(paddle_tpu_torch, m) {
  m.def("flash_attention_fwd(Tensor q, Tensor k, Tensor v, float sm_scale, "
        "bool causal) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(paddle_tpu_torch, CPU, m) {
  m.impl("flash_attention_fwd", &FlashFwdPlain);
}

#ifdef PT_WITH_CUDA
TORCH_LIBRARY_IMPL(paddle_tpu_torch, CUDA, m) {
  m.impl("flash_attention_fwd", &FlashFwdCuda);
}
#endif

extern "C" {

int64_t ptop_b1_launches() { return g_b1_launches.load(); }

void ptop_set_b1_launches(int64_t n) { g_b1_launches.store(n); }

void ptop_add_b1_launches(int64_t n) { g_b1_launches.fetch_add(n); }

void ptop_set_plain(int on) { g_plain.store(on != 0); }

void ptop_set_flash_resolver(void* fn) {
#ifdef PT_WITH_CUDA
  g_resolver.store(reinterpret_cast<ResolverFn>(fn));
#else
  (void)fn;
#endif
}

}  // extern "C"
