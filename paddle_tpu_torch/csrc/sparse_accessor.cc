// Fused sparse-row accessor rules for the host embedding table.
//
// The C++ twin of the reference's per-row PS update rules
// (paddle/fluid/distributed/ps/table/sparse_sgd_rule.cc SparseAdaGradSGDRule
// / StdAdaGradSGDRule — the reference keeps this path native in
// memory_sparse_table.h for the same reason): the numpy expression of
// the adagrad push makes ~6 full passes over [rows, dim] with
// temporaries (gather acc, where, g*g, add, sqrt, divide, scatter);
// this kernel is ONE cache-resident pass per row, multithreaded over
// row chunks. Called through ctypes on arrays the Python side owns —
// the pools are plain numpy buffers, so there is no copy at the
// boundary.
//
// Contract (matches HostOffloadedEmbedding._apply_push's numpy twin):
//   slots[i] < 0        -> skipped (never-pulled or padding row)
//   adagrad: acc = (acc_set[s] ? acc[s,:] : init_acc) + g*g
//            vals[s,:] -= lr * g / sqrt(acc);  acc_set[s] = 1
//   sgd:     vals[s,:] -= lr * g
// Grads for duplicate ids are merged by the caller first (the
// communicator's merge-before-push), so each slot appears once.

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Args {
  float* vals;
  float* acc;
  uint8_t* acc_set;
  const int64_t* slots;
  const float* grads;
  int64_t n_rows;
  int64_t dim;
  float lr;
  float init_acc;
};

void adagrad_chunk(const Args& a, int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t s = a.slots[i];
    if (s < 0) continue;
    float* v = a.vals + s * a.dim;
    float* ac = a.acc + s * a.dim;
    const float* g = a.grads + i * a.dim;
    const bool has = a.acc_set[s] != 0;
    if (has) {
      for (int64_t d = 0; d < a.dim; ++d) {
        const float acc = ac[d] + g[d] * g[d];
        ac[d] = acc;
        v[d] -= a.lr * g[d] / std::sqrt(acc);
      }
    } else {
      for (int64_t d = 0; d < a.dim; ++d) {
        const float acc = a.init_acc + g[d] * g[d];
        ac[d] = acc;
        v[d] -= a.lr * g[d] / std::sqrt(acc);
      }
      a.acc_set[s] = 1;
    }
  }
}

void sgd_chunk(const Args& a, int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t s = a.slots[i];
    if (s < 0) continue;
    float* v = a.vals + s * a.dim;
    const float* g = a.grads + i * a.dim;
    for (int64_t d = 0; d < a.dim; ++d) v[d] -= a.lr * g[d];
  }
}

template <typename F>
void run_chunked(const Args& a, F fn) {
  // distinct slots per row (caller merges duplicates), so chunks never
  // touch the same pool row: lock-free parallelism
  const int64_t kMinRowsPerThread = 2048;
  unsigned hw = std::thread::hardware_concurrency();
  int64_t want = (a.n_rows + kMinRowsPerThread - 1) / kMinRowsPerThread;
  int64_t n_threads = want < 1 ? 1 : want;
  if (hw && n_threads > (int64_t)hw) n_threads = hw;
  if (n_threads <= 1) {
    fn(a, 0, a.n_rows);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t per = (a.n_rows + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min(a.n_rows, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&a, fn, lo, hi] { fn(a, lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

void ptsa_adagrad_push(float* vals, float* acc, uint8_t* acc_set,
                       const int64_t* slots, const float* grads,
                       int64_t n_rows, int64_t dim, float lr,
                       float init_acc) {
  Args a{vals, acc, acc_set, slots, grads, n_rows, dim, lr, init_acc};
  run_chunked(a, adagrad_chunk);
}

void ptsa_sgd_push(float* vals, const int64_t* slots, const float* grads,
                   int64_t n_rows, int64_t dim, float lr) {
  Args a{vals, nullptr, nullptr, slots, grads, n_rows, dim, lr, 0.0f};
  run_chunked(a, sgd_chunk);
}

}  // extern "C"
