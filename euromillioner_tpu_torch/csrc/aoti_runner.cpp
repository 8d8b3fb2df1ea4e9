// The native runner: an executable with no Python in its process that
// loads one AOTInductor package (core/export.py's compiled program) and
// runs it on one device, K1 and K4a reached through the emtpu:: ops that
// emtpu_ops.cpp registers in C++. The counterpart of the JAX package's
// native/pjrt_runner.cpp; core/native_runner.py builds and drives it.
//
//   emtpu_aoti_runner --abi-version
//   emtpu_aoti_runner PACKAGE DEVICE [--kernel SOURCE=LIBRARY ...]
//
// DEVICE is "cpu" or "cuda:N". Each --kernel loads the library that
// ops/common.build_library built from csrc/SOURCE (CUDA devices need
// fused_lstm.cu's and wide_onehot.cu's).
//
// Protocol, over stdin (requests) and stdout (replies), little-endian,
// u32/i32/i64/f64 fixed-width; a string is u32 length + bytes. Anything
// else the process prints goes to stderr.
//
//   ready (once, after the load):  u32 magic 'EMTR', u32 abi, u32 status;
//     status 0: f64 load_ms, str out_spec (the pytree spec of the
//               package's outputs);
//     status 1: str error, then the process exits 1.
//   request:  u32 op
//     op 1 execute: u32 n, n x tensor  -> u32 status; 0: u32 n, n x tensor;
//                                                     1: str error
//     op 2 stats:                      -> u32 0, str JSON {load_ms, device,
//                                         executes, launches, cpu_calls}
//   tensor:   i32 dtype (0 float32, 1 int32), u32 ndim, ndim x i64 dims,
//             the contiguous data
//
// End of input: exit 0.

#include <ATen/ATen.h>
#include <c10/util/Exception.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <unistd.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "emtpu_ops.h"

namespace {

// Must match _ABI_VERSION in core/native_runner.py.
constexpr uint32_t kAbiVersion = 1;
constexpr uint32_t kMagic = 0x52544D45;  // "EMTR"
constexpr uint32_t kExecute = 1, kStats = 2;

struct Eof {};

FILE* g_in = nullptr;
FILE* g_out = nullptr;

void read_bytes(void* p, size_t n) {
  if (n && std::fread(p, 1, n, g_in) != n) throw Eof{};
}

template <typename T>
T read_val() {
  T v;
  read_bytes(&v, sizeof v);
  return v;
}

void write_bytes(const void* p, size_t n) {
  if (n && std::fwrite(p, 1, n, g_out) != n) throw std::runtime_error("stdout closed");
}

template <typename T>
void write_val(T v) {
  write_bytes(&v, sizeof v);
}

void write_str(const std::string& s) {
  write_val<uint32_t>((uint32_t)s.size());
  write_bytes(s.data(), s.size());
}

std::string message(const std::exception& e) {
  if (auto* c10e = dynamic_cast<const c10::Error*>(&e)) return c10e->what_without_backtrace();
  return e.what();
}

at::ScalarType scalar_type(int32_t code) {
  if (code == 0) return at::kFloat;
  if (code == 1) return at::kInt;
  throw std::runtime_error("unsupported tensor dtype code " + std::to_string(code) +
                           " (0 float32, 1 int32)");
}

// a tensor of the request; its dtype code is checked by the caller, after
// the whole request is read, so a refused one leaves the stream in step
at::Tensor read_tensor(int32_t* code_out) {
  const int32_t code = *code_out = read_val<int32_t>();
  const uint32_t ndim = read_val<uint32_t>();
  std::vector<int64_t> dims(ndim);
  for (auto& d : dims) d = read_val<int64_t>();
  const size_t item = 4;  // float32 and int32 alike
  int64_t numel = 1;
  for (auto d : dims) numel *= d;
  at::Tensor t = at::empty(dims, at::TensorOptions().dtype(code == 1 ? at::kInt : at::kFloat));
  read_bytes(t.data_ptr(), (size_t)numel * item);
  return t;
}

void write_tensor(const at::Tensor& t) {
  const at::Tensor c = t.to(at::kCPU).contiguous();
  int32_t code;
  if (c.scalar_type() == at::kFloat)
    code = 0;
  else if (c.scalar_type() == at::kInt)
    code = 1;
  else
    throw std::runtime_error(std::string("unsupported output dtype ") +
                             c10::toString(c.scalar_type()) + " (float32 and int32 only)");
  write_val<int32_t>(code);
  write_val<uint32_t>((uint32_t)c.dim());
  for (auto d : c.sizes()) write_val<int64_t>(d);
  write_bytes(c.data_ptr(), (size_t)c.numel() * 4);
}

std::string counts_json(const std::map<std::string, long long>& m) {
  std::ostringstream s;
  s << "{";
  bool first = true;
  for (const auto& [k, v] : m) {
    s << (first ? "" : ", ") << "\"" << k << "\": " << v;
    first = false;
  }
  s << "}";
  return s.str();
}

int usage() {
  std::fprintf(stderr,
               "usage: emtpu_aoti_runner --abi-version\n"
               "       emtpu_aoti_runner PACKAGE DEVICE [--kernel SOURCE=LIBRARY ...]\n");
  return 2;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc == 2 && std::strcmp(argv[1], "--abi-version") == 0) {
    std::printf("%u\n", kAbiVersion);
    return 0;
  }
  if (argc < 3 || (argc - 3) % 2) return usage();
  // the protocol owns the real stdout; whatever else prints goes to stderr
  const int proto = dup(1);
  if (proto < 0 || dup2(2, 1) < 0) return 1;
  g_out = fdopen(proto, "wb");
  g_in = stdin;
  const std::string package = argv[1], device_arg = argv[2];

  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  double load_ms = 0;
  std::vector<std::string> spec;
  at::Device device(at::kCPU);
  try {
    write_val<uint32_t>(kMagic);
    write_val<uint32_t>(kAbiVersion);
    device = at::Device(device_arg);
    TORCH_CHECK(device.is_cpu() || device.is_cuda(), "unsupported device ", device_arg);
    TORCH_CHECK(device.is_cpu() || emtpu::with_cuda(), "this runner was built without CUDA; ",
                "it cannot run on ", device_arg);
    for (int i = 3; i < argc; i += 2) {
      const std::string flag = argv[i], val = argv[i + 1];
      const auto eq = val.find('=');
      TORCH_CHECK(flag == "--kernel" && eq != std::string::npos, "bad argument ", flag, " ",
                  val);
      emtpu::load_kernel_library(val.substr(0, eq), val.substr(eq + 1));
    }
    const auto t0 = std::chrono::steady_clock::now();
    try {
      loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
          package, "model", false, 1, device.is_cuda() ? device.index() : (c10::DeviceIndex)-1);
    } catch (const std::exception& e) {
      TORCH_CHECK(false, "cannot load ", package, " on ", device_arg, ": ", message(e));
    }
    load_ms = std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0)
                  .count();
    const auto meta = loader->get_metadata();
    const auto it = meta.find("AOTI_DEVICE_KEY");
    const std::string package_device = it == meta.end() ? "" : it->second;
    TORCH_CHECK(package_device == c10::DeviceTypeName(device.type(), true), package,
                " was compiled for ", package_device.empty() ? "no device" : package_device,
                "; this runner runs on ", device_arg);
    spec = loader->get_call_spec();
    TORCH_CHECK(spec.size() == 2, "the package's call spec has ", spec.size(), " parts");
  } catch (const std::exception& e) {
    write_val<uint32_t>(1);
    write_str(message(e));
    std::fflush(g_out);
    return 1;
  }
  write_val<uint32_t>(0);
  write_val<double>(load_ms);
  write_str(spec[1]);
  std::fflush(g_out);

  long long executes = 0;
  try {
    for (;;) {
      const uint32_t op = read_val<uint32_t>();
      if (op == kExecute) {
        std::vector<at::Tensor> inputs(read_val<uint32_t>());
        std::vector<int32_t> codes(inputs.size());
        for (size_t i = 0; i < inputs.size(); ++i) inputs[i] = read_tensor(&codes[i]);
        std::vector<at::Tensor> outs;
        try {
          for (size_t i = 0; i < inputs.size(); ++i) {
            scalar_type(codes[i]);
            inputs[i] = inputs[i].to(device);
          }
          outs = loader->run(inputs);
          for (auto& o : outs) o = o.to(at::kCPU).contiguous();
          ++executes;
        } catch (const std::exception& e) {
          write_val<uint32_t>(1);
          write_str(message(e));
          std::fflush(g_out);
          continue;
        }
        write_val<uint32_t>(0);
        write_val<uint32_t>((uint32_t)outs.size());
        for (const auto& o : outs) write_tensor(o);
      } else if (op == kStats) {
        std::ostringstream s;
        s << "{\"load_ms\": " << load_ms << ", \"device\": \"" << device_arg
          << "\", \"executes\": " << executes
          << ", \"launches\": " << counts_json(emtpu::launch_counts())
          << ", \"cpu_calls\": " << counts_json(emtpu::cpu_calls()) << "}";
        write_val<uint32_t>(0);
        write_str(s.str());
      } else {
        write_val<uint32_t>(1);
        write_str("unknown request " + std::to_string(op));
        std::fflush(g_out);
        return 1;
      }
      std::fflush(g_out);
    }
  } catch (const Eof&) {
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "emtpu_aoti_runner: %s\n", message(e).c_str());
    return 1;
  }
}
