// Native serving predictor over libtorch: runs a paddle_tpu_torch.jit.save
// artifact with no Python in the loop.
//
// The port's counterpart of the JAX package's PJRT predictor, with the
// same C ABI. In place of StableHLO compiled by a PJRT plugin, the
// artifact's program is the torch.export graph in program.pt2, and this
// file interprets it node by node through the dispatcher: every node is
// the same ATen kernel that eager code and jit.load run, and attention is
// the op paddle_tpu_torch::flash_attention_fwd (csrc/torch_ops.cc), which
// launches kernel B1 on the card. The graph is read once at create, each
// node bound to its operator handle and its arguments resolved against
// the operator's schema; the state is cast to the dtypes the program
// traced and moved to the device once.
//
// Artifact layout (written by paddle_tpu_torch/jit/__init__.py save()):
//   program.pt2   torch.export archive; read here: models/model.json
//                 (the serialized graph: nodes, tensor metadata, the
//                 signature and the input pytree spec, whose two dicts
//                 name the state tensors in the program's order)
//   params.pbin   "PTP1" binary: the state (params then buffers, each
//                 sorted by name), bound to the program by name
//   meta.json     n_state_args, exported_inputs, ...
// An encrypted artifact has no params.pbin and is refused.
//
// C ABI (ctypes from paddle_tpu_torch/inference/__init__.py, or the
// standalone main in predictor_main.cc):
//   ptpred_create(backend, options, model_dir, err, errlen) -> handle
//     backend "cuda", "cuda:N" or "cpu"; options "key=t:value;..." with
//     the one key num_threads=i:N (CPU intra-op threads)
//   ptpred_num_outputs(handle)
//   ptpred_run(handle, in_ptrs, in_dtypes, in_ndims, in_dims, n_inputs,
//              err, errlen)
//   ptpred_out_ndim/out_dim/out_dtype/out_data/out_nbytes(handle, i)
//   ptpred_run2(handle, ins..., err, errlen) -> result handle | NULL
//   ptres_num_outputs/ndim/dim/dtype/data/nbytes(result, ...)
//   ptres_destroy(result)
//   ptpred_destroy(handle)
//   ptpred_b1_launches()   kernel B1's launch counter (the op library's)
//
// Concurrency: the program, the operator handles and the resident state
// are read-only after create, and each request interprets the graph
// over its own value table, so ptpred_run2 is safe from any number of
// threads; each result is owned by its caller. The legacy ptpred_run /
// ptpred_out_* family stores results on the predictor behind a mutex.

#include <ATen/ATen.h>
#include <ATen/Parallel.h>
#include <ATen/ScalarOps.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <c10/core/InferenceMode.h>
#include <caffe2/serialize/inline_container.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
#include <sstream>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

#ifndef PT_TORCH_OPS_LIB
#define PT_TORCH_OPS_LIB ""
#endif

namespace {

struct ErrOut {
  char* buf;
  size_t len;
  void set(const std::string& m) {
    if (buf && len) std::snprintf(buf, len, "%s", m.c_str());
  }
};

[[noreturn]] void Fail(const std::string& m) { throw std::runtime_error(m); }

bool ReadFile(const std::string& path, std::string* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::ostringstream ss;
  ss << f.rdbuf();
  *out = ss.str();
  return true;
}

// ---------------------------------------------------------------------------
// a small JSON reader (model.json, meta.json): the wheel ships none
// ---------------------------------------------------------------------------

struct Json {
  enum Kind { kNull, kBool, kNum, kStr, kArr, kObj } kind = kNull;
  bool b = false;
  double num = 0.0;
  int64_t inum = 0;
  bool is_int = false;
  std::string str;
  std::vector<Json> arr;
  std::vector<std::pair<std::string, Json>> obj;

  const Json* find(const std::string& k) const {
    for (auto& kv : obj)
      if (kv.first == k) return &kv.second;
    return nullptr;
  }
  const Json& at(const std::string& k) const {
    const Json* v = find(k);
    if (!v) Fail("model.json: missing key '" + k + "'");
    return *v;
  }
  const Json& at(size_t i) const {
    if (kind != kArr || i >= arr.size()) Fail("model.json: bad index");
    return arr[i];
  }
  int64_t as_int() const {
    if (kind != kNum) Fail("model.json: number expected");
    return is_int ? inum : static_cast<int64_t>(num);
  }
  const std::string& as_str() const {
    if (kind != kStr) Fail("model.json: string expected");
    return str;
  }
  // the one key of a union object ({"as_tensor": ...})
  const std::pair<std::string, Json>& only() const {
    if (kind != kObj || obj.empty()) Fail("model.json: union expected");
    return obj.front();
  }
};

class JsonReader {
 public:
  explicit JsonReader(const std::string& s) : s_(s) {}
  Json Parse() {
    Json v = Value();
    Ws();
    if (p_ != s_.size()) Fail("json: trailing characters");
    return v;
  }

 private:
  const std::string& s_;
  size_t p_ = 0;

  void Ws() {
    while (p_ < s_.size() && (s_[p_] == ' ' || s_[p_] == '\n' ||
                              s_[p_] == '\t' || s_[p_] == '\r'))
      ++p_;
  }
  char Peek() {
    Ws();
    if (p_ >= s_.size()) Fail("json: unexpected end");
    return s_[p_];
  }
  void Expect(char c) {
    if (Peek() != c) Fail(std::string("json: expected '") + c + "'");
    ++p_;
  }
  bool Lit(const char* w) {
    const size_t n = std::strlen(w);
    if (s_.compare(p_, n, w) == 0) {
      p_ += n;
      return true;
    }
    return false;
  }
  static void Utf8(uint32_t cp, std::string* o) {
    if (cp < 0x80) {
      o->push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      o->push_back(static_cast<char>(0xC0 | (cp >> 6)));
      o->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      o->push_back(static_cast<char>(0xE0 | (cp >> 12)));
      o->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      o->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      o->push_back(static_cast<char>(0xF0 | (cp >> 18)));
      o->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
      o->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      o->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
  }
  uint32_t Hex4() {
    if (p_ + 4 > s_.size()) Fail("json: bad \\u escape");
    uint32_t v = static_cast<uint32_t>(
        std::stoul(s_.substr(p_, 4), nullptr, 16));
    p_ += 4;
    return v;
  }
  std::string Str() {
    Expect('"');
    std::string o;
    while (true) {
      if (p_ >= s_.size()) Fail("json: unterminated string");
      char c = s_[p_++];
      if (c == '"') break;
      if (c != '\\') {
        o.push_back(c);
        continue;
      }
      if (p_ >= s_.size()) Fail("json: bad escape");
      char e = s_[p_++];
      switch (e) {
        case 'n': o.push_back('\n'); break;
        case 't': o.push_back('\t'); break;
        case 'r': o.push_back('\r'); break;
        case 'b': o.push_back('\b'); break;
        case 'f': o.push_back('\f'); break;
        case 'u': {
          uint32_t cp = Hex4();
          if (cp >= 0xD800 && cp < 0xDC00 && Lit("\\u")) {
            cp = 0x10000 + ((cp - 0xD800) << 10) + (Hex4() - 0xDC00);
          }
          Utf8(cp, &o);
          break;
        }
        default: o.push_back(e);  // \" \\ \/
      }
    }
    return o;
  }
  Json Value() {
    Json v;
    char c = Peek();
    if (c == '{') {
      ++p_;
      v.kind = Json::kObj;
      if (Peek() == '}') {
        ++p_;
        return v;
      }
      while (true) {
        std::string k = Str();
        Expect(':');
        v.obj.emplace_back(std::move(k), Value());
        if (Peek() == ',') {
          ++p_;
          continue;
        }
        Expect('}');
        return v;
      }
    }
    if (c == '[') {
      ++p_;
      v.kind = Json::kArr;
      if (Peek() == ']') {
        ++p_;
        return v;
      }
      while (true) {
        v.arr.push_back(Value());
        if (Peek() == ',') {
          ++p_;
          continue;
        }
        Expect(']');
        return v;
      }
    }
    if (c == '"') {
      v.kind = Json::kStr;
      v.str = Str();
      return v;
    }
    if (Lit("true")) {
      v.kind = Json::kBool;
      v.b = true;
      return v;
    }
    if (Lit("false")) {
      v.kind = Json::kBool;
      return v;
    }
    if (Lit("null")) return v;
    if (Lit("NaN")) {
      v.kind = Json::kNum;
      v.num = std::numeric_limits<double>::quiet_NaN();
      return v;
    }
    if (Lit("Infinity")) {
      v.kind = Json::kNum;
      v.num = std::numeric_limits<double>::infinity();
      return v;
    }
    if (Lit("-Infinity")) {
      v.kind = Json::kNum;
      v.num = -std::numeric_limits<double>::infinity();
      return v;
    }
    const size_t start = p_;
    while (p_ < s_.size() && std::strchr("+-0123456789.eE", s_[p_])) ++p_;
    if (start == p_) Fail("json: unexpected character");
    const std::string tok = s_.substr(start, p_ - start);
    v.kind = Json::kNum;
    v.num = std::strtod(tok.c_str(), nullptr);
    if (tok.find_first_of(".eE") == std::string::npos) {
      v.is_int = true;
      v.inum = std::strtoll(tok.c_str(), nullptr, 10);
    }
    return v;
  }
};

Json ParseJson(const std::string& text) { return JsonReader(text).Parse(); }

// a float argument: the serializer writes the non-finite ones as strings
double AsDouble(const Json& v) {
  if (v.kind == Json::kStr) {
    if (v.str == "Infinity") return std::numeric_limits<double>::infinity();
    if (v.str == "-Infinity")
      return -std::numeric_limits<double>::infinity();
    if (v.str == "NaN") return std::numeric_limits<double>::quiet_NaN();
    Fail("model.json: bad float '" + v.str + "'");
  }
  if (v.kind != Json::kNum) Fail("model.json: number expected");
  return v.num;
}

// ---------------------------------------------------------------------------
// dtype codes
// ---------------------------------------------------------------------------

// the facade's codes, shared with jit/__init__.py _DTYPE_CODES
const at::ScalarType kByCode[] = {
    at::kFloat, at::kDouble, at::kInt,   at::kLong,   at::kBFloat16,
    at::kHalf,  at::kByte,   at::kChar,  at::kBool,   at::kUInt32,
    at::kUInt64, at::kShort, at::kUInt16};

at::ScalarType FromCode(uint32_t code) {
  if (code >= sizeof(kByCode) / sizeof(kByCode[0]))
    Fail("unknown dtype code " + std::to_string(code));
  return kByCode[code];
}

uint32_t ToCode(at::ScalarType t) {
  for (uint32_t i = 0; i < sizeof(kByCode) / sizeof(kByCode[0]); ++i)
    if (kByCode[i] == t) return i;
  Fail(std::string("no dtype code for ") + c10::toString(t));
}

// the export schema's ScalarType enum (torch/_export/serde/schema.py),
// which is not c10::ScalarType's
at::ScalarType FromExportScalarType(int64_t v) {
  switch (v) {
    case 1: return at::kByte;
    case 2: return at::kChar;
    case 3: return at::kShort;
    case 4: return at::kInt;
    case 5: return at::kLong;
    case 6: return at::kHalf;
    case 7: return at::kFloat;
    case 8: return at::kDouble;
    case 9: return at::kComplexHalf;
    case 10: return at::kComplexFloat;
    case 11: return at::kComplexDouble;
    case 12: return at::kBool;
    case 13: return at::kBFloat16;
    case 28: return at::kUInt16;
    case 29: return at::kFloat8_e4m3fn;
    case 30: return at::kFloat8_e5m2;
    case 31: return at::kFloat8_e4m3fnuz;
    case 32: return at::kFloat8_e5m2fnuz;
    case 34: return at::kUInt32;
    case 35: return at::kUInt64;
    default: Fail("unsupported export scalar type " + std::to_string(v));
  }
}

at::Layout FromExportLayout(int64_t v) {
  switch (v) {
    case 1: return at::kSparse;
    case 2: return at::kSparseCsr;
    case 3: return at::kSparseCsc;
    case 4: return at::kSparseBsr;
    case 5: return at::kSparseBsc;
    case 6: return at::kMkldnn;
    case 7: return at::kStrided;
    default: Fail("unsupported export layout " + std::to_string(v));
  }
}

at::MemoryFormat FromExportMemoryFormat(int64_t v) {
  switch (v) {
    case 1: return at::MemoryFormat::Contiguous;
    case 2: return at::MemoryFormat::ChannelsLast;
    case 3: return at::MemoryFormat::ChannelsLast3d;
    case 4: return at::MemoryFormat::Preserve;
    default: Fail("unsupported export memory format " + std::to_string(v));
  }
}

struct HostArray {
  uint32_t dtype_code = 0;
  std::vector<int64_t> dims;
  std::string data;
};

// one output on the host: a contiguous CPU tensor (pinned memory when the
// program ran on the card), so that the caller copies it out once
struct OutArray {
  uint32_t dtype_code = 0;
  std::vector<int64_t> dims;
  at::Tensor data;
  const void* ptr() const { return data.data_ptr(); }
  int64_t nbytes() const { return static_cast<int64_t>(data.nbytes()); }
};

void LoadPbin(const std::string& path,
              std::vector<std::pair<std::string, HostArray>>* out) {
  std::string raw;
  if (!ReadFile(path, &raw))
    Fail("cannot read " + path +
         " (an encrypted artifact has none: the native runner serves "
         "plaintext artifacts only)");
  const char* p = raw.data();
  const char* end = p + raw.size();
  auto need = [&](size_t n) {
    if (p + n > end) Fail("params.pbin is truncated");
  };
  need(8);
  if (std::memcmp(p, "PTP1", 4) != 0) Fail("bad params.pbin magic");
  p += 4;
  uint32_t count;
  std::memcpy(&count, p, 4);
  p += 4;
  for (uint32_t i = 0; i < count; ++i) {
    uint32_t name_len, ndim;
    need(4);
    std::memcpy(&name_len, p, 4);
    p += 4;
    need(name_len);
    std::string name(p, name_len);
    p += name_len;
    HostArray arr;
    need(8);
    std::memcpy(&arr.dtype_code, p, 4);
    std::memcpy(&ndim, p + 4, 4);
    p += 8;
    need(8 * (static_cast<size_t>(ndim) + 1));
    arr.dims.resize(ndim);
    for (uint32_t d = 0; d < ndim; ++d, p += 8)
      std::memcpy(&arr.dims[d], p, 8);
    uint64_t nbytes;
    std::memcpy(&nbytes, p, 8);
    p += 8;
    need(nbytes);
    arr.data.assign(p, nbytes);
    p += nbytes;
    out->emplace_back(std::move(name), std::move(arr));
  }
}

// ---------------------------------------------------------------------------
// the program: nodes bound to operators, arguments resolved at create
// ---------------------------------------------------------------------------

// where one argument of a call comes from
struct ArgSrc {
  enum Kind {
    kConst,         // a constant (or the schema's default)
    kSlot,          // one value of the table
    kTensorList,    // Tensor[] from slots
    kOptTensorList, // Tensor?[] from slots (-1: None)
    kIntList,       // int[] / SymInt[]: constants and slots (symbolic sizes)
  } kind = kConst;
  c10::IValue value;
  int slot = -1;
  std::vector<int> slots;
  std::vector<int64_t> ints;   // kIntList: constant entries
  bool scalar = false;         // kIntList: one SymInt, not a list
};

enum class NodeKind { kOp, kSymSize, kPyOp };

struct Node {
  NodeKind kind = NodeKind::kOp;
  std::string target;
  std::optional<c10::OperatorHandle> op;
  std::vector<ArgSrc> args;
  // kOp: per schema return, its slot (-1: unused), or, for one list
  // return, the slots of its elements
  std::vector<int> outs;
  bool list_out = false;
  std::string pyop;            // kPyOp: add, sub, mul, floordiv, mod, neg
  std::vector<int> release;    // slots whose last use is this node
};

struct Predictor {
  c10::Device device{c10::kCPU};
  std::vector<Node> nodes;
  size_t num_slots = 0;
  std::vector<std::pair<int, at::Tensor>> state;   // resident, read-only
  std::vector<int> input_slots;
  std::vector<at::ScalarType> input_dtypes;
  std::vector<std::vector<int64_t>> input_dims;    // -1: symbolic
  std::vector<int> output_slots;
  size_t num_outputs = 0;
  std::vector<OutArray> outputs;    // last ptpred_run's results
  std::mutex out_mu;
  std::unordered_map<std::string, int> slot_of;

  int Slot(const std::string& name) {
    auto it = slot_of.find(name);
    if (it != slot_of.end()) return it->second;
    const int s = static_cast<int>(num_slots++);
    slot_of.emplace(name, s);
    return s;
  }
  int Existing(const std::string& name) const {
    auto it = slot_of.find(name);
    if (it == slot_of.end()) Fail("model.json: value '" + name +
                                  "' used before it is defined");
    return it->second;
  }
};

// qualified name and overload of "torch.ops.<ns>.<op>.<overload>"
bool SplitTarget(const std::string& t, std::string* qual,
                 std::string* overload) {
  const std::string pre = "torch.ops.";
  if (t.rfind(pre, 0) != 0) return false;
  const std::string rest = t.substr(pre.size());
  const size_t a = rest.find('.');
  const size_t b = rest.rfind('.');
  if (a == std::string::npos || a == b) return false;
  *qual = rest.substr(0, a) + "::" + rest.substr(a + 1, b - a - 1);
  *overload = rest.substr(b + 1);
  if (*overload == "default") overload->clear();
  return true;
}

const Json* NamedInput(const Json& node, const std::string& name) {
  for (auto& in : node.at("inputs").arr)
    if (in.at("name").as_str() == name) return &in.at("arg");
  return nullptr;
}

// one int of an as_sym_int(s) entry: {"as_name": n} or {"as_int": v}
void SymIntEntry(Predictor& pred, const Json& e, ArgSrc* src) {
  const auto& u = e.only();
  if (u.first == "as_name") {
    src->slots.push_back(pred.Existing(u.second.as_str()));
    src->ints.push_back(0);
  } else if (u.first == "as_int") {
    src->slots.push_back(-1);
    src->ints.push_back(u.second.as_int());
  } else {
    Fail("model.json: unsupported symbolic int " + u.first);
  }
}

// a number where the schema takes a Tensor (aten.add.Tensor(x, 1e-5)):
// a 0-dim "wrapped number", as Python's argument parser makes it
c10::IValue WrappedNumber(const at::Scalar& s) {
  at::Tensor t = at::scalar_to_tensor(s);
  t.unsafeGetTensorImpl()->set_wrapped_number(true);
  return c10::IValue(t);
}

ArgSrc ResolveArg(Predictor& pred, const Json& arg, const c10::Argument* sa) {
  const auto& u = arg.only();
  const std::string& k = u.first;
  const Json& v = u.second;
  const bool tensor_param =
      sa && sa->type()->kind() == c10::TypeKind::TensorType;
  ArgSrc src;
  if (k == "as_none") {
    src.value = c10::IValue();
  } else if (k == "as_tensor") {
    src.kind = ArgSrc::kSlot;
    src.slot = pred.Existing(v.at("name").as_str());
  } else if (k == "as_optional_tensor") {
    const auto& ou = v.only();
    if (ou.first == "as_tensor") {
      src.kind = ArgSrc::kSlot;
      src.slot = pred.Existing(ou.second.at("name").as_str());
    }
  } else if (k == "as_tensors" || k == "as_optional_tensors") {
    bool optional_elems = k == "as_optional_tensors";
    if (sa) {
      const auto& ty = sa->type();
      if (ty->kind() == c10::TypeKind::ListType)
        optional_elems = ty->expectRef<c10::ListType>()
                             .getElementType()->kind() ==
                         c10::TypeKind::OptionalType;
    }
    src.kind = optional_elems ? ArgSrc::kOptTensorList : ArgSrc::kTensorList;
    for (auto& e : v.arr) {
      if (k == "as_tensors") {
        src.slots.push_back(pred.Existing(e.at("name").as_str()));
      } else {
        const auto& eu = e.only();
        src.slots.push_back(eu.first == "as_tensor"
                                ? pred.Existing(eu.second.at("name").as_str())
                                : -1);
      }
    }
    if (src.kind == ArgSrc::kTensorList)
      for (int s : src.slots)
        if (s < 0) Fail("model.json: None in a Tensor[] argument");
  } else if (k == "as_int") {
    src.value = c10::IValue(v.as_int());
    if (tensor_param) src.value = WrappedNumber(at::Scalar(v.as_int()));
  } else if (k == "as_ints") {
    std::vector<int64_t> xs;
    for (auto& e : v.arr) xs.push_back(e.as_int());
    src.value = c10::IValue(xs);
  } else if (k == "as_float") {
    src.value = c10::IValue(AsDouble(v));
    if (tensor_param) src.value = WrappedNumber(at::Scalar(AsDouble(v)));
  } else if (k == "as_floats") {
    std::vector<double> xs;
    for (auto& e : v.arr) xs.push_back(AsDouble(e));
    src.value = c10::IValue(xs);
  } else if (k == "as_bool") {
    src.value = c10::IValue(v.b);
    if (tensor_param) src.value = WrappedNumber(at::Scalar(v.b));
  } else if (k == "as_bools") {
    c10::List<bool> xs;
    for (auto& e : v.arr) xs.push_back(e.b);
    src.value = c10::IValue(xs);
  } else if (k == "as_string") {
    src.value = c10::IValue(v.as_str());
  } else if (k == "as_strings") {
    std::vector<std::string> xs;
    for (auto& e : v.arr) xs.push_back(e.as_str());
    src.value = c10::IValue(xs);
  } else if (k == "as_scalar_type") {
    src.value = c10::IValue(FromExportScalarType(v.as_int()));
  } else if (k == "as_layout") {
    src.value = c10::IValue(FromExportLayout(v.as_int()));
  } else if (k == "as_memory_format") {
    src.value = c10::IValue(FromExportMemoryFormat(v.as_int()));
  } else if (k == "as_device") {
    // the exporting device is baked into the graph: every device is the
    // predictor's, as move_to_device_pass makes it for jit.load
    src.value = c10::IValue(pred.device);
  } else if (k == "as_sym_int") {
    src.kind = ArgSrc::kIntList;
    src.scalar = true;
    SymIntEntry(pred, v, &src);
  } else if (k == "as_sym_ints") {
    src.kind = ArgSrc::kIntList;
    for (auto& e : v.arr) SymIntEntry(pred, e, &src);
  } else {
    Fail("model.json: unsupported argument kind " + k);
  }
  return src;
}

c10::IValue Materialize(const ArgSrc& a, const std::vector<c10::IValue>& env) {
  switch (a.kind) {
    case ArgSrc::kConst:
      return a.value;
    case ArgSrc::kSlot:
      return env[a.slot];
    case ArgSrc::kTensorList: {
      c10::List<at::Tensor> l;
      l.reserve(a.slots.size());
      for (int s : a.slots) l.push_back(env[s].toTensor());
      return c10::IValue(l);
    }
    case ArgSrc::kOptTensorList: {
      c10::List<std::optional<at::Tensor>> l;
      l.reserve(a.slots.size());
      for (int s : a.slots)
        l.push_back(s < 0 ? std::optional<at::Tensor>()
                          : std::optional<at::Tensor>(env[s].toTensor()));
      return c10::IValue(l);
    }
    case ArgSrc::kIntList: {
      std::vector<int64_t> xs(a.ints);
      for (size_t i = 0; i < xs.size(); ++i)
        if (a.slots[i] >= 0) xs[i] = env[a.slots[i]].toInt();
      if (a.scalar) return c10::IValue(xs.at(0));
      return c10::IValue(xs);
    }
  }
  return c10::IValue();
}

void BindOutputs(Predictor& pred, const Json& node, Node* n,
                 size_t n_returns, bool list_return) {
  const auto& outs = node.at("outputs").arr;
  if (list_return && outs.size() == 1 && outs[0].only().first == "as_tensors") {
    n->list_out = true;
    for (auto& e : outs[0].only().second.arr)
      n->outs.push_back(pred.Slot(e.at("name").as_str()));
    return;
  }
  if (outs.size() > n_returns)
    Fail("model.json: node " + n->target + " has more outputs than its "
         "schema returns");
  n->outs.assign(n_returns, -1);
  for (size_t i = 0; i < outs.size(); ++i) {
    const auto& u = outs[i].only();
    if (u.first == "as_tensor") {
      n->outs[i] = pred.Slot(u.second.at("name").as_str());
    } else if (u.first == "as_sym_int") {
      n->outs[i] = pred.Slot(u.second.only().second.as_str());
    } else if (u.first != "as_none") {
      Fail("model.json: unsupported output kind " + u.first + " of " +
           n->target);
    }
  }
}

void EnsureOpsLibrary() {
  // the program's attention op lives in the op library; a process that
  // has not loaded it (ptserve) loads it here
  if (c10::Dispatcher::singleton()
          .findSchema({"paddle_tpu_torch::flash_attention_fwd", ""})
          .has_value())
    return;
  if (!dlopen(PT_TORCH_OPS_LIB, RTLD_NOW | RTLD_GLOBAL)) {
    const char* e = dlerror();
    Fail(std::string("cannot load the op library ") + PT_TORCH_OPS_LIB +
         ": " + (e ? e : "?"));
  }
}

void BuildNode(Predictor& pred, const Json& node) {
  Node n;
  n.target = node.at("target").as_str();
  // symbolic-size arithmetic (torch.export writes it as Python operators)
  static const char* kPyOps[] = {"add", "sub", "mul", "floordiv", "mod",
                                 "neg"};
  if (n.target == "torch.ops.aten.sym_size.int") {
    // a symbolic size: a host int in the value table
    n.kind = NodeKind::kSymSize;
    const Json* self = NamedInput(node, "self");
    const Json* dim = NamedInput(node, "dim");
    if (!self || !dim) Fail("model.json: sym_size.int without self / dim");
    n.args.push_back(ResolveArg(pred, *self, nullptr));
    n.args.push_back(ResolveArg(pred, *dim, nullptr));
    n.outs.push_back(pred.Slot(
        node.at("outputs").at(0).only().second.only().second.as_str()));
    pred.nodes.push_back(std::move(n));
    return;
  }
  if (n.target.rfind("_operator.", 0) == 0) {
    n.kind = NodeKind::kPyOp;
    n.pyop = n.target.substr(10);
    bool known = false;
    for (const char* o : kPyOps) known = known || n.pyop == o;
    if (!known) Fail("model.json: unsupported target " + n.target);
    for (auto& in : node.at("inputs").arr)
      n.args.push_back(ResolveArg(pred, in.at("arg"), nullptr));
    n.outs.push_back(pred.Slot(
        node.at("outputs").at(0).only().second.only().second.as_str()));
    pred.nodes.push_back(std::move(n));
    return;
  }
  std::string qual, overload;
  if (!SplitTarget(n.target, &qual, &overload))
    Fail("model.json: unsupported target " + n.target);
  auto handle = c10::Dispatcher::singleton().findSchema({qual, overload});
  if (!handle.has_value())
    Fail("operator " + qual + (overload.empty() ? "" : "." + overload) +
         " is not registered");
  n.op = *handle;
  const c10::FunctionSchema& schema = handle->schema();
  for (const auto& sa : schema.arguments()) {
    const Json* arg = NamedInput(node, sa.name());
    if (arg) {
      n.args.push_back(ResolveArg(pred, *arg, &sa));
    } else if (sa.default_value().has_value()) {
      ArgSrc d;
      d.value = *sa.default_value();
      n.args.push_back(std::move(d));
    } else {
      Fail("model.json: " + n.target + " lacks argument " + sa.name());
    }
  }
  const auto& rets = schema.returns();
  const bool list_return =
      rets.size() == 1 && rets[0].type()->kind() == c10::TypeKind::ListType;
  BindOutputs(pred, node, &n, rets.size(), list_return);
  pred.nodes.push_back(std::move(n));
}

int64_t PyOp(const std::string& op, const std::vector<int64_t>& x) {
  if (op == "neg") return -x.at(0);
  const int64_t a = x.at(0), b = x.at(1);
  if (op == "add") return a + b;
  if (op == "sub") return a - b;
  if (op == "mul") return a * b;
  if (b == 0) Fail("symbolic size: division by zero");
  if (op == "floordiv") {
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
    return q;
  }
  int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// The names of the state tensors in the program's input order: the two
// dicts (params, buffers) that lead the pytree spec of the traced
// forward's arguments, ((params, buffers, *inputs), {}).
std::vector<std::string> StateNames(const Json& gm) {
  const Json& mcg = gm.at("module_call_graph");
  if (mcg.kind != Json::kArr || mcg.arr.empty())
    Fail("model.json: no module_call_graph");
  const Json spec = ParseJson(mcg.at(0).at("signature").at("in_spec")
                                  .as_str());
  const Json& root = spec.at(1);
  const Json& args = root.at("children_spec").at(0);
  std::vector<std::string> names;
  for (size_t i = 0; i < 2; ++i) {
    const Json& d = args.at("children_spec").at(i);
    if (d.at("type").as_str() != "builtins.dict")
      Fail("model.json: the program does not take (params, buffers, "
           "*inputs): not a jit.save artifact of this package");
    const Json keys = ParseJson(d.at("context").as_str());
    for (auto& k : keys.arr) names.push_back(k.as_str());
  }
  return names;
}

c10::Device ParseBackend(const std::string& backend) {
  c10::Device dev = backend.empty() ? c10::Device(c10::kCUDA)
                                    : c10::Device(backend);
  if (dev.is_cuda()) {
    const bool has = c10::impl::hasDeviceGuardImpl(c10::DeviceType::CUDA);
    const int n = has ? c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)
                            ->deviceCount()
                      : 0;
    if (n == 0) Fail("backend " + backend + ": no CUDA device");
    if (!dev.has_index()) dev = c10::Device(c10::kCUDA, 0);
    if (dev.index() >= n)
      Fail("backend " + backend + ": only " + std::to_string(n) +
           " CUDA device(s)");
  } else if (!dev.is_cpu()) {
    Fail("backend must be cuda, cuda:N or cpu, got " + backend);
  }
  return dev;
}

void ApplyOptions(const std::string& spec) {
  std::stringstream ss(spec);
  std::string item;
  while (std::getline(ss, item, ';')) {
    if (item.empty()) continue;
    const auto eq = item.find('=');
    if (eq == std::string::npos || eq + 3 > item.size() ||
        item[eq + 2] != ':')
      Fail("bad option '" + item + "' (key=t:value)");
    const std::string key = item.substr(0, eq);
    const std::string val = item.substr(eq + 3);
    if (key == "num_threads" && item[eq + 1] == 'i') {
      at::set_num_threads(static_cast<int>(std::stoll(val)));
    } else {
      Fail("unknown option '" + key + "'");
    }
  }
}

std::unique_ptr<Predictor> Create(const std::string& backend,
                                  const std::string& options,
                                  const std::string& dir) {
  auto pred = std::make_unique<Predictor>();
  pred->device = ParseBackend(backend);
  ApplyOptions(options);
  EnsureOpsLibrary();

  std::string meta_text;
  if (!ReadFile(dir + "/meta.json", &meta_text))
    Fail("cannot read " + dir + "/meta.json");
  const Json meta = ParseJson(meta_text);
  const size_t n_state = static_cast<size_t>(meta.at("n_state_args").as_int());

  std::vector<std::pair<std::string, HostArray>> pbin;
  LoadPbin(dir + "/params.pbin", &pbin);

  std::string model_text;
  {
    caffe2::serialize::PyTorchStreamReader reader(dir + "/program.pt2");
    if (!reader.hasRecord("models/model.json"))
      Fail("program.pt2 holds no models/model.json");
    auto rec = reader.getRecord("models/model.json");
    model_text.assign(static_cast<const char*>(std::get<0>(rec).get()),
                      std::get<1>(rec));
  }
  const Json model = ParseJson(model_text);
  const Json& gm = model.at("graph_module");
  const Json& graph = gm.at("graph");
  const Json& sig = gm.at("signature");

  // inputs: the state (bound by name), then the request's
  const auto& in_specs = sig.at("input_specs").arr;
  std::vector<std::string> in_names;
  for (auto& s : in_specs) {
    const auto& u = s.only();
    if (u.first != "user_input")
      Fail("model.json: input kind " + u.first + " (a jit.save artifact "
           "takes its state as user inputs)");
    in_names.push_back(u.second.at("arg").at("as_tensor").at("name")
                           .as_str());
  }
  const std::vector<std::string> state_names = StateNames(gm);
  if (state_names.size() != n_state || in_names.size() < n_state)
    Fail("the program's state (" + std::to_string(state_names.size()) +
         " tensors) does not match meta.json's n_state_args (" +
         std::to_string(n_state) + ")");
  std::map<std::string, const HostArray*> by_name;
  for (auto& kv : pbin) by_name[kv.first] = &kv.second;
  const Json& tv = graph.at("tensor_values");
  const c10::InferenceMode guard;
  for (size_t i = 0; i < in_names.size(); ++i) {
    const int slot = pred->Slot(in_names[i]);
    const Json& meta_t = tv.at(in_names[i]);
    const at::ScalarType traced = FromExportScalarType(
        meta_t.at("dtype").as_int());
    if (i < n_state) {
      auto it = by_name.find(state_names[i]);
      if (it == by_name.end())
        Fail("params.pbin has no tensor " + state_names[i]);
      const HostArray& a = *it->second;
      // bfloat16 state was written as float32: cast to the traced dtype
      at::Tensor host = at::from_blob(
          const_cast<char*>(a.data.data()), a.dims,
          at::TensorOptions().dtype(FromCode(a.dtype_code)));
      pred->state.emplace_back(slot, host.to(pred->device, traced,
                                             false, /*copy=*/true));
    } else {
      std::vector<int64_t> dims;
      for (auto& d : meta_t.at("sizes").arr)
        dims.push_back(d.only().first == "as_int" ? d.only().second.as_int()
                                                  : -1);
      pred->input_slots.push_back(slot);
      pred->input_dtypes.push_back(traced);
      pred->input_dims.push_back(std::move(dims));
    }
  }
  for (auto& node : graph.at("nodes").arr) BuildNode(*pred, node);
  for (auto& s : sig.at("output_specs").arr) {
    const auto& u = s.only();
    const auto& au = u.second.at("arg").only();
    if (au.first != "as_tensor")
      Fail("model.json: output " + u.first + " of kind " + au.first +
           " (tensor outputs only)");
    pred->output_slots.push_back(pred->Existing(au.second.at("name")
                                                    .as_str()));
  }
  pred->num_outputs = pred->output_slots.size();

  // release each intermediate after its last use, as eager code frees it
  std::vector<int> last(pred->num_slots, -1);
  auto use = [&](int slot, int at) {
    if (slot >= 0) last[slot] = at;
  };
  for (size_t i = 0; i < pred->nodes.size(); ++i) {
    for (auto& a : pred->nodes[i].args) {
      use(a.slot, static_cast<int>(i));
      for (int s : a.slots) use(s, static_cast<int>(i));
    }
  }
  for (auto& kv : pred->state) last[kv.first] = -1;
  for (int s : pred->output_slots) last[s] = -1;
  for (size_t s = 0; s < last.size(); ++s)
    if (last[s] >= 0) pred->nodes[last[s]].release.push_back(
        static_cast<int>(s));
  return pred;
}

// Upload inputs, interpret the graph, download outputs into `result`.
// Touches only read-only predictor state plus per-call locals.
void RunImpl(Predictor* pred, const void** in_ptrs, const uint32_t* in_dtypes,
             const uint32_t* in_ndims, const int64_t* in_dims_flat,
             int n_inputs, std::vector<OutArray>* result) {
  if (static_cast<size_t>(n_inputs) != pred->input_slots.size())
    Fail("expected " + std::to_string(pred->input_slots.size()) +
         " inputs, got " + std::to_string(n_inputs));
  const c10::InferenceMode mode;
  const c10::DeviceGuard device_guard(pred->device);
  std::vector<c10::IValue> env(pred->num_slots);
  for (auto& kv : pred->state) env[kv.first] = kv.second;
  size_t dim_ofs = 0;
  for (int i = 0; i < n_inputs; ++i) {
    std::vector<int64_t> dims(in_dims_flat + dim_ofs,
                              in_dims_flat + dim_ofs + in_ndims[i]);
    dim_ofs += in_ndims[i];
    const auto& want = pred->input_dims[i];
    bool ok = dims.size() == want.size();
    for (size_t d = 0; ok && d < dims.size(); ++d)
      ok = want[d] < 0 || want[d] == dims[d];
    if (!ok) Fail("input " + std::to_string(i) + ": shape " +
                  c10::str(at::IntArrayRef(dims)) +
                  " does not match the program's " +
                  c10::str(at::IntArrayRef(want)) + " (-1: any)");
    at::Tensor host = at::from_blob(
        const_cast<void*>(in_ptrs[i]), dims,
        at::TensorOptions().dtype(FromCode(in_dtypes[i])));
    env[pred->input_slots[i]] = host.to(pred->device, pred->input_dtypes[i],
                                        false, /*copy=*/true);
  }
  torch::jit::Stack stack;
  for (const Node& n : pred->nodes) {
    switch (n.kind) {
      case NodeKind::kSymSize:
        env[n.outs[0]] = env[n.args[0].slot].toTensor().size(
            Materialize(n.args[1], env).toInt());
        break;
      case NodeKind::kPyOp: {
        std::vector<int64_t> xs;
        for (auto& a : n.args) xs.push_back(Materialize(a, env).toInt());
        env[n.outs[0]] = PyOp(n.pyop, xs);
        break;
      }
      case NodeKind::kOp: {
        stack.clear();
        for (auto& a : n.args) stack.push_back(Materialize(a, env));
        n.op->callBoxed(stack);
        if (n.list_out) {
          auto l = stack.at(0).toList();
          if (l.size() != n.outs.size())
            Fail(n.target + " returned " + std::to_string(l.size()) +
                 " tensors, the program expects " +
                 std::to_string(n.outs.size()));
          for (size_t i = 0; i < n.outs.size(); ++i) env[n.outs[i]] = l.get(i);
        } else {
          for (size_t i = 0; i < n.outs.size() && i < stack.size(); ++i)
            if (n.outs[i] >= 0) env[n.outs[i]] = std::move(stack[i]);
        }
        break;
      }
    }
    for (int s : n.release) env[s] = c10::IValue();
  }
  result->clear();
  result->resize(pred->num_outputs);
  for (size_t i = 0; i < pred->num_outputs; ++i) {
    const at::Tensor t = env[pred->output_slots[i]].toTensor();
    OutArray& o = (*result)[i];
    o.dtype_code = ToCode(t.scalar_type());
    o.dims.assign(t.sizes().begin(), t.sizes().end());
    if (t.is_cpu()) {
      o.data = t.contiguous();
    } else {
      o.data = at::empty(t.sizes(), t.options().device(c10::kCPU)
                                        .pinned_memory(true));
      o.data.copy_(t);   // waits for the copy: the caller reads it next
    }
  }
}

std::string Message(const std::exception& e) {
  if (auto* ce = dynamic_cast<const c10::Error*>(&e))
    return ce->what_without_backtrace();
  return e.what();
}

// One request's host-side results; owned by the caller of ptpred_run2.
struct RunResult {
  std::vector<OutArray> outputs;
};

}  // namespace

extern "C" {

void* ptpred_create(const char* backend, const char* options,
                    const char* model_dir, char* errbuf, size_t errlen) {
  ErrOut err{errbuf, errlen};
  try {
    return Create(backend ? backend : "", options ? options : "",
                  model_dir ? model_dir : "").release();
  } catch (const std::exception& e) {
    err.set(Message(e));
    return nullptr;
  }
}

int ptpred_num_outputs(void* h) {
  return static_cast<int>(static_cast<Predictor*>(h)->num_outputs);
}

int ptpred_run(void* h, const void** in_ptrs, const uint32_t* in_dtypes,
               const uint32_t* in_ndims, const int64_t* in_dims_flat,
               int n_inputs, char* errbuf, size_t errlen) {
  ErrOut err{errbuf, errlen};
  auto* pred = static_cast<Predictor*>(h);
  std::vector<OutArray> result;
  try {
    RunImpl(pred, in_ptrs, in_dtypes, in_ndims, in_dims_flat, n_inputs,
            &result);
  } catch (const std::exception& e) {
    err.set(Message(e));
    return 1;
  }
  std::lock_guard<std::mutex> lock(pred->out_mu);
  pred->outputs = std::move(result);
  return 0;
}

void* ptpred_run2(void* h, const void** in_ptrs, const uint32_t* in_dtypes,
                  const uint32_t* in_ndims, const int64_t* in_dims_flat,
                  int n_inputs, char* errbuf, size_t errlen) {
  ErrOut err{errbuf, errlen};
  auto res = std::make_unique<RunResult>();
  try {
    RunImpl(static_cast<Predictor*>(h), in_ptrs, in_dtypes, in_ndims,
            in_dims_flat, n_inputs, &res->outputs);
  } catch (const std::exception& e) {
    err.set(Message(e));
    return nullptr;
  }
  return res.release();
}

int ptres_num_outputs(void* r) {
  return static_cast<int>(static_cast<RunResult*>(r)->outputs.size());
}

int ptres_ndim(void* r, int i) {
  return static_cast<int>(
      static_cast<RunResult*>(r)->outputs.at(i).dims.size());
}

int64_t ptres_dim(void* r, int i, int d) {
  return static_cast<RunResult*>(r)->outputs.at(i).dims.at(d);
}

uint32_t ptres_dtype(void* r, int i) {
  return static_cast<RunResult*>(r)->outputs.at(i).dtype_code;
}

const void* ptres_data(void* r, int i) {
  return static_cast<RunResult*>(r)->outputs.at(i).ptr();
}

int64_t ptres_nbytes(void* r, int i) {
  return static_cast<RunResult*>(r)->outputs.at(i).nbytes();
}

void ptres_destroy(void* r) { delete static_cast<RunResult*>(r); }

int ptpred_out_ndim(void* h, int i) {
  return static_cast<int>(
      static_cast<Predictor*>(h)->outputs.at(i).dims.size());
}

int64_t ptpred_out_dim(void* h, int i, int d) {
  return static_cast<Predictor*>(h)->outputs.at(i).dims.at(d);
}

uint32_t ptpred_out_dtype(void* h, int i) {
  return static_cast<Predictor*>(h)->outputs.at(i).dtype_code;
}

const void* ptpred_out_data(void* h, int i) {
  return static_cast<Predictor*>(h)->outputs.at(i).ptr();
}

int64_t ptpred_out_nbytes(void* h, int i) {
  return static_cast<Predictor*>(h)->outputs.at(i).nbytes();
}

void ptpred_destroy(void* h) { delete static_cast<Predictor*>(h); }

int64_t ptpred_b1_launches() {
  void* dl = dlopen(PT_TORCH_OPS_LIB, RTLD_NOW | RTLD_NOLOAD);
  if (!dl) return -1;
  auto fn = reinterpret_cast<int64_t (*)()>(dlsym(dl, "ptop_b1_launches"));
  const int64_t n = fn ? fn() : -1;
  dlclose(dl);
  return n;
}

}  // extern "C"
