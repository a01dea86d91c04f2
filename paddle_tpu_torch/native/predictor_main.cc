// Standalone native serving binary: zero Python in the process.
//
// The reference ships C++ demo mains over its C API
// (reference: paddle/fluid/inference/api/demo_ci/*.cc and
// capi_exp/pd_inference_api.h consumers); this is the same proof for
// the port's libtorch runner (predictor.cc): load a
// paddle_tpu_torch.jit.save artifact, feed .npy inputs, time concurrent
// requests. Its attention runs kernel B1 through the op library the
// runner loads, and the last line counts B1's launches.
//
// Built by paddle_tpu_torch.inference.build_ptserve() into
// build/paddle_tpu_torch/, linked against the runner library:
//   g++ -O2 -std=c++17 -pthread predictor_main.cc -o ptserve \
//       -L<dir> -l:<predictor library> -Wl,-rpath,<dir>
// Run:
//   ./ptserve <backend> <options> <model_dir> <in0.npy> ... \
//             [--threads N] [--iters M] [--parse-only]
// backend: cuda, cuda:N or cpu; options: "" or "num_threads=i:N".
//
// Minimal NPY v1/v2 reader: C-order, little-endian f32/f64/i32/i64.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>
#include <atomic>
#include <chrono>

extern "C" {
void* ptpred_create(const char*, const char*, const char*, char*, size_t);
void* ptpred_run2(void*, const void**, const uint32_t*, const uint32_t*,
                  const int64_t*, int, char*, size_t);
int ptres_num_outputs(void*);
int ptres_ndim(void*, int);
int64_t ptres_dim(void*, int, int);
uint32_t ptres_dtype(void*, int);
const void* ptres_data(void*, int);
int64_t ptres_nbytes(void*, int);
void ptres_destroy(void*);
void ptpred_destroy(void*);
int64_t ptpred_b1_launches();
}

namespace {

struct NpyArray {
  uint32_t dtype_code = 0;  // codes shared with jit/__init__.py
  std::vector<int64_t> dims;
  std::vector<char> data;
};

bool ParseNpy(const std::string& path, NpyArray* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char magic[8];
  f.read(magic, 8);
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  uint32_t hlen = 0;
  if (magic[6] == 1) {
    uint16_t h16;
    f.read(reinterpret_cast<char*>(&h16), 2);
    hlen = h16;
  } else {
    f.read(reinterpret_cast<char*>(&hlen), 4);
  }
  std::string header(hlen, '\0');
  f.read(header.data(), hlen);
  auto find_val = [&](const std::string& key) -> std::string {
    auto p = header.find("'" + key + "'");
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    auto e = header.find_first_of(",}", p);
    return header.substr(p + 1, e - p - 1);
  };
  std::string descr = find_val("descr");
  if (descr.find("<f4") != std::string::npos) out->dtype_code = 0;
  else if (descr.find("<f8") != std::string::npos) out->dtype_code = 1;
  else if (descr.find("<i4") != std::string::npos) out->dtype_code = 2;
  else if (descr.find("<i8") != std::string::npos) out->dtype_code = 3;
  else return false;
  if (find_val("fortran_order").find("True") != std::string::npos)
    return false;
  // shape is a parenthesized tuple — find_val's comma-split would
  // truncate multi-dim shapes, so extract (...) directly
  std::string shape;
  {
    auto sp = header.find("'shape'");
    if (sp == std::string::npos) return false;
    auto lp = header.find('(', sp);
    auto rp = header.find(')', lp);
    if (lp == std::string::npos || rp == std::string::npos) return false;
    shape = header.substr(lp + 1, rp - lp - 1);
  }
  int64_t count = 1;
  const char* p = shape.c_str();
  while (*p) {
    if (*p >= '0' && *p <= '9') {
      int64_t d = std::strtoll(p, const_cast<char**>(&p), 10);
      out->dims.push_back(d);
      count *= d;
    } else {
      ++p;
    }
  }
  size_t esize = (out->dtype_code == 0 || out->dtype_code == 2) ? 4 : 8;
  out->data.resize(count * esize);
  f.read(out->data.data(), out->data.size());
  return bool(f);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: %s <backend> <options> <model_dir> <in.npy>"
                 "... [--threads N] [--iters M] [--parse-only]\n",
                 argv[0]);
    return 2;
  }
  int threads = 1, iters = 8;
  bool parse_only = false;
  std::vector<NpyArray> inputs;
  for (int i = 4; i < argc; ++i) {
    if (std::strcmp(argv[i], "--threads") == 0 && i + 1 < argc) {
      threads = std::atoi(argv[++i]);
    } else if (std::strcmp(argv[i], "--iters") == 0 && i + 1 < argc) {
      iters = std::atoi(argv[++i]);
    } else if (std::strcmp(argv[i], "--parse-only") == 0) {
      parse_only = true;  // hardware-free NPY reader check
    } else {
      NpyArray a;
      if (!ParseNpy(argv[i], &a)) {
        std::fprintf(stderr, "cannot read npy %s\n", argv[i]);
        return 2;
      }
      inputs.push_back(std::move(a));
    }
  }

  if (parse_only) {
    for (auto& a : inputs) {
      std::printf("{\"dtype_code\": %u, \"dims\": [", a.dtype_code);
      for (size_t d = 0; d < a.dims.size(); ++d)
        std::printf("%s%lld", d ? ", " : "",
                    static_cast<long long>(a.dims[d]));
      std::printf("], \"nbytes\": %zu}\n", a.data.size());
    }
    return 0;
  }

  char err[4096] = {0};
  void* pred = ptpred_create(argv[1], argv[2], argv[3], err, sizeof(err));
  if (!pred) {
    std::fprintf(stderr, "create failed: %s\n", err);
    return 1;
  }

  std::vector<const void*> ptrs;
  std::vector<uint32_t> dtypes, ndims;
  std::vector<int64_t> dims_flat;
  for (auto& a : inputs) {
    ptrs.push_back(a.data.data());
    dtypes.push_back(a.dtype_code);
    ndims.push_back(static_cast<uint32_t>(a.dims.size()));
    dims_flat.insert(dims_flat.end(), a.dims.begin(), a.dims.end());
  }

  std::atomic<int> failures{0};
  double first_sum = 0.0;
  auto serve = [&](int tid, bool record) {
    char terr[4096] = {0};
    for (int it = 0; it < iters; ++it) {
      void* res = ptpred_run2(pred, ptrs.data(), dtypes.data(),
                              ndims.data(), dims_flat.data(),
                              static_cast<int>(inputs.size()), terr,
                              sizeof(terr));
      if (!res) {
        std::fprintf(stderr, "[t%d] run failed: %s\n", tid, terr);
        failures.fetch_add(1);
        return;
      }
      if (record && it == 0) {
        // checksum of output 0 so runs are comparable to Python
        uint32_t code = ptres_dtype(res, 0);
        int64_t nb = ptres_nbytes(res, 0);
        const void* d = ptres_data(res, 0);
        double s = 0.0;
        if (code == 0) {        // f32
          for (int64_t k = 0; k < nb / 4; ++k)
            s += static_cast<const float*>(d)[k];
        } else if (code == 1) {  // f64
          for (int64_t k = 0; k < nb / 8; ++k)
            s += static_cast<const double*>(d)[k];
        } else if (code == 2) {  // i32
          for (int64_t k = 0; k < nb / 4; ++k)
            s += static_cast<const int32_t*>(d)[k];
        } else if (code == 3) {  // i64
          for (int64_t k = 0; k < nb / 8; ++k)
            s += static_cast<const int64_t*>(d)[k];
        } else {
          std::fprintf(stderr, "out0 dtype code %u not summed\n", code);
        }
        first_sum = s;
      }
      ptres_destroy(res);
    }
  };

  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(serve, t, false);
  serve(0, true);
  for (auto& th : pool) th.join();
  double secs = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - t0).count();

  if (failures.load()) {
    ptpred_destroy(pred);
    return 1;
  }
  std::printf("{\"requests\": %d, \"threads\": %d, \"secs\": %.3f, "
              "\"req_per_sec\": %.1f, \"out0_sum\": %.6f, "
              "\"b1_launches\": %lld}\n",
              threads * iters, threads, secs,
              threads * iters / secs, first_sum,
              static_cast<long long>(ptpred_b1_launches()));
  ptpred_destroy(pred);
  return 0;
}
