// Native data-feed engine: threaded file reading, record parsing, batch
// assembly, bounded hand-off queue (the port's own copy of the JAX
// package's feed: plain host code, no torch).
//
// Replaces the reference's C++ DataFeed family
// (reference: paddle/fluid/framework/data_feed.h:779 `DataFeed`,
// :969 `InMemoryDataFeed` — channel-based multi-threaded readers feeding
// device workers; MultiSlotDataFeed text parsing; shuffle in
// framework/data_set.h Dataset). One engine with N reader threads feeds
// the host loop that copies batches to the card — the hot path (parse +
// assemble) stays native and off the GIL.
//
// Record format ("dense schema"): text lines, fields separated by `sep`
// (default ','). Schema string like "f32:784,i64:1" declares column
// groups: 784 float32 cells then 1 int64 cell per line. Batches are
// assembled contiguous [batch, width] per group, C order. Each reader
// thread takes whole files; a shuffle window draws from std::mt19937_64
// seeded with seed + thread index.
//
// C ABI (consumed via ctypes from paddle_tpu_torch/io/native_feed.py):
//   ptdf_create(schema, sep, batch, nthreads, qcap, shuffle, seed)
//   ptdf_add_file(h, path)
//   ptdf_start(h)
//   ptdf_next(h, out_ptrs[])              -> rows filled, 0 = end
//   ptdf_destroy(h)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <memory>
#include <mutex>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

enum class DType { kF32, kI64 };

struct Group {
  DType dtype;
  int width;
};

struct Schema {
  std::vector<Group> groups;
  int total_cells = 0;
};

Schema ParseSchema(const std::string& s) {
  Schema out;
  std::stringstream ss(s);
  std::string item;
  while (std::getline(ss, item, ',')) {
    auto pos = item.find(':');
    std::string ty = item.substr(0, pos);
    int width = std::stoi(item.substr(pos + 1));
    Group g;
    g.dtype = (ty == "i64") ? DType::kI64 : DType::kF32;
    g.width = width;
    out.groups.push_back(g);
    out.total_cells += width;
  }
  return out;
}

// one parsed record: cells laid out group-after-group
struct Record {
  std::vector<float> f32;
  std::vector<int64_t> i64;
};

struct Batch {
  std::vector<std::vector<float>> f32;    // per f32-group contiguous
  std::vector<std::vector<int64_t>> i64;  // per i64-group contiguous
  int rows = 0;
};

class BoundedQueue {
 public:
  explicit BoundedQueue(size_t cap) : cap_(cap) {}

  void Push(Batch&& b) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return;
    q_.push_back(std::move(b));
    not_empty_.notify_one();
  }

  bool Pop(Batch* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || done_ || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void SetDone() {
    std::lock_guard<std::mutex> lk(mu_);
    done_ = true;
    not_empty_.notify_all();
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<Batch> q_;
  size_t cap_;
  bool done_ = false;
  bool closed_ = false;
};

class Engine {
 public:
  Engine(const std::string& schema, char sep, int batch, int nthreads,
         int qcap, int shuffle_window, uint64_t seed)
      : schema_(ParseSchema(schema)),
        sep_(sep),
        batch_(batch),
        nthreads_(nthreads),
        shuffle_window_(shuffle_window),
        seed_(seed),
        queue_(qcap) {}

  ~Engine() { Stop(); }

  void AddFile(const std::string& path) { files_.push_back(path); }

  void Start() {
    next_file_.store(0);
    active_readers_.store(nthreads_);
    for (int i = 0; i < nthreads_; ++i) {
      threads_.emplace_back([this, i] { ReaderLoop(i); });
    }
  }

  void Stop() {
    queue_.Close();
    for (auto& t : threads_)
      if (t.joinable()) t.join();
    threads_.clear();
  }

  bool Next(Batch* out) { return queue_.Pop(out); }

  const Schema& schema() const { return schema_; }
  int batch() const { return batch_; }

 private:
  bool ParseLine(const std::string& line, Record* rec) {
    rec->f32.clear();
    rec->i64.clear();
    const char* p = line.c_str();
    char* end = nullptr;
    for (const auto& g : schema_.groups) {
      for (int i = 0; i < g.width; ++i) {
        while (*p == sep_ || *p == ' ') ++p;
        if (*p == '\0') return false;
        if (g.dtype == DType::kF32) {
          rec->f32.push_back(strtof(p, &end));
        } else {
          rec->i64.push_back(strtoll(p, &end, 10));
        }
        if (end == p) return false;
        p = end;
      }
    }
    return true;
  }

  void EmitBatch(std::vector<Record>& rows) {
    if (rows.empty()) return;
    Batch b;
    b.rows = static_cast<int>(rows.size());
    int fi = 0, ii = 0;
    for (const auto& g : schema_.groups) {
      if (g.dtype == DType::kF32) {
        b.f32.emplace_back();
        b.f32.back().reserve(rows.size() * g.width);
      } else {
        b.i64.emplace_back();
        b.i64.back().reserve(rows.size() * g.width);
      }
    }
    for (auto& r : rows) {
      size_t fo = 0, io = 0;
      fi = 0;
      ii = 0;
      for (const auto& g : schema_.groups) {
        if (g.dtype == DType::kF32) {
          auto& dst = b.f32[fi++];
          dst.insert(dst.end(), r.f32.begin() + fo,
                     r.f32.begin() + fo + g.width);
          fo += g.width;
        } else {
          auto& dst = b.i64[ii++];
          dst.insert(dst.end(), r.i64.begin() + io,
                     r.i64.begin() + io + g.width);
          io += g.width;
        }
      }
    }
    rows.clear();
    queue_.Push(std::move(b));
  }

  void ReaderLoop(int tid) {
    std::mt19937_64 rng(seed_ + tid);
    std::vector<Record> pending;   // batch under assembly
    std::vector<Record> window;    // shuffle window
    Record rec;
    for (;;) {
      size_t idx = next_file_.fetch_add(1);
      if (idx >= files_.size()) break;
      std::ifstream in(files_[idx]);
      if (!in.good()) {
        std::fprintf(stderr, "[ptdf] cannot open %s\n",
                     files_[idx].c_str());
        continue;
      }
      std::string line;
      while (std::getline(in, line)) {
        if (line.empty()) continue;
        if (!ParseLine(line, &rec)) continue;
        if (shuffle_window_ > 1) {
          // reservoir-style windowed shuffle (InMemoryDataFeed's
          // LocalShuffle analog, bounded memory)
          window.push_back(rec);
          if (static_cast<int>(window.size()) >= shuffle_window_) {
            std::uniform_int_distribution<size_t> d(0, window.size() - 1);
            size_t j = d(rng);
            pending.push_back(window[j]);
            window[j] = window.back();
            window.pop_back();
          }
        } else {
          pending.push_back(rec);
        }
        if (static_cast<int>(pending.size()) >= batch_) EmitBatch(pending);
      }
    }
    // drain shuffle window
    while (!window.empty()) {
      std::uniform_int_distribution<size_t> d(0, window.size() - 1);
      size_t j = d(rng);
      pending.push_back(window[j]);
      window[j] = window.back();
      window.pop_back();
      if (static_cast<int>(pending.size()) >= batch_) EmitBatch(pending);
    }
    EmitBatch(pending);  // final partial batch
    if (active_readers_.fetch_sub(1) == 1) queue_.SetDone();
  }

  Schema schema_;
  char sep_;
  int batch_;
  int nthreads_;
  int shuffle_window_;
  uint64_t seed_;
  BoundedQueue queue_;
  std::vector<std::string> files_;
  std::vector<std::thread> threads_;
  std::atomic<size_t> next_file_{0};
  std::atomic<int> active_readers_{0};
};

}  // namespace

extern "C" {

void* ptdf_create(const char* schema, char sep, int batch, int nthreads,
                  int qcap, int shuffle_window, uint64_t seed) {
  return new Engine(schema, sep, batch, nthreads, qcap, shuffle_window,
                    seed);
}

void ptdf_add_file(void* h, const char* path) {
  static_cast<Engine*>(h)->AddFile(path);
}

void ptdf_start(void* h) { static_cast<Engine*>(h)->Start(); }

// out_ptrs: one destination buffer per schema group, each sized
// batch*width*sizeof(cell). Returns rows filled (0 = end of data).
int ptdf_next(void* h, void** out_ptrs) {
  Engine* e = static_cast<Engine*>(h);
  Batch b;
  if (!e->Next(&b)) return 0;
  int fi = 0, ii = 0, gi = 0;
  for (const auto& g : e->schema().groups) {
    if (g.dtype == DType::kF32) {
      const auto& src = b.f32[fi++];
      std::memcpy(out_ptrs[gi], src.data(), src.size() * sizeof(float));
    } else {
      const auto& src = b.i64[ii++];
      std::memcpy(out_ptrs[gi], src.data(), src.size() * sizeof(int64_t));
    }
    ++gi;
  }
  return b.rows;
}

void ptdf_destroy(void* h) { delete static_cast<Engine*>(h); }

}  // extern "C"
