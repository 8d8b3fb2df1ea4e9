// K1 and K4a as the custom ops emtpu::lstm_sequence and
// emtpu::wide_onehot_fwd, registered in C++ for a process with no Python:
// the native runner (aoti_runner.cpp), whose AOTInductor packages call the
// ops by name through torch's dispatcher.
//
// The schemas are those the Python side infers from its
// torch.library.custom_op definitions (ops/fused_lstm.py lstm_sequence_op,
// ops/wide_onehot.py wide_onehot_fwd_op). A process holds one definition
// of a namespace's op, so this file is never loaded into a Python process
// that imported the port.
//
// CPU: the plain versions in ATen, in the order of operations of
// lstm_sequence_reference and wide_onehot_fwd_reference.
// CUDA (built with EMTPU_WITH_CUDA): the wrappers' checks, the launch plan
// from plans.h, and one launch of the kernel's C entry point on the current
// ATen CUDA stream, from the library ops/common.build_library built from
// csrc/fused_lstm.cu or csrc/wide_onehot.cu. A CUDA call never reaches the
// CPU implementation; a refused plan or launch raises.

#include "emtpu_ops.h"

#include <ATen/ATen.h>
#include <dlfcn.h>
#include <torch/library.h>

#include <atomic>
#include <mutex>
#include <vector>

#include "plans.h"

#ifdef EMTPU_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

namespace emtpu {
namespace {

std::atomic<long long> g_lstm_launches{0}, g_onehot_launches{0};
std::atomic<long long> g_lstm_cpu{0}, g_onehot_cpu{0};

// -- shape checks (ops/fused_lstm.py _check, ops/wide_onehot.py) ------------

void check_lstm(const at::Tensor& x_proj, const at::Tensor& wh, const at::Tensor& peep) {
  TORCH_CHECK(x_proj.dim() == 3 && x_proj.size(2) % 4 == 0,
              "x_proj must be (T, B, 4H), got ", x_proj.sizes());
  const int64_t h = x_proj.size(2) / 4;
  TORCH_CHECK(wh.dim() == 2 && wh.size(0) == h && wh.size(1) == 4 * h, "wh must be (", h,
              ", ", 4 * h, "), got ", wh.sizes());
  TORCH_CHECK(peep.dim() == 2 && peep.size(0) == 4 && peep.size(1) == h, "peep must be (4, ",
              h, "), got ", peep.sizes());
}

void check_onehot(const at::Tensor& w, const at::Tensor& ids) {
  TORCH_CHECK(w.scalar_type() == at::kFloat || w.scalar_type() == at::kBFloat16,
              "the wide one-hot kernels take float32 or bfloat16 tables, not ",
              w.scalar_type());
  TORCH_CHECK(w.dim() == 3, "w must be (K, V, E), got ", w.sizes());
  TORCH_CHECK(ids.dim() == 2, "ids must be (B, K), got ", ids.sizes());
  TORCH_CHECK(ids.scalar_type() == at::kInt, "ids must be int32, got ", ids.scalar_type());
  TORCH_CHECK(ids.size(1) == w.size(0), "ids have ", ids.size(1), " positions, w has ",
              w.size(0));
  TORCH_CHECK(w.device() == ids.device(), "tensors on ", w.device(), " and ", ids.device());
}

// -- CPU: the plain versions ------------------------------------------------

at::Tensor lstm_sequence_cpu(const at::Tensor& x_proj, const at::Tensor& wh,
                             const at::Tensor& peep, bool peepholes) {
  check_lstm(x_proj, wh, peep);
  ++g_lstm_cpu;
  const int64_t t = x_proj.size(0), b = x_proj.size(1), h = x_proj.size(2) / 4;
  const auto dt = x_proj.scalar_type();
  const at::Tensor p = peep.to(at::kFloat);
  const at::Tensor wh_f = wh.to(at::kFloat);
  at::Tensor h_prev = at::zeros({b, h}, x_proj.options().dtype(at::kFloat));
  at::Tensor c_prev = at::zeros_like(h_prev);
  std::vector<at::Tensor> hs;
  hs.reserve(t);
  for (int64_t k = 0; k < t; ++k) {
    // nn/recurrent.lstm_cell on the f32 carry, h rounded to wh's dtype
    const at::Tensor gates =
        x_proj[k].to(at::kFloat) + at::mm(h_prev.to(wh.scalar_type()).to(at::kFloat), wh_f);
    auto parts = gates.split(h, -1);
    at::Tensor i = parts[0], f = parts[1], g = parts[2], o = parts[3];
    if (peepholes) {
      i = i + c_prev * p[0];
      f = f + c_prev * p[1];
    }
    i = at::sigmoid(i);
    f = at::sigmoid(f);
    g = at::tanh(g);
    const at::Tensor c = f * c_prev + i * g;
    if (peepholes) o = o + c * p[2];
    o = at::sigmoid(o);
    h_prev = o * at::tanh(c);
    c_prev = c;
    hs.push_back(h_prev.to(dt));
  }
  return at::stack(hs);
}

at::Tensor wide_onehot_fwd_cpu(const at::Tensor& w, const at::Tensor& ids) {
  check_onehot(w, ids);
  ++g_onehot_cpu;
  const int64_t k = w.size(0), v = w.size(1), e = w.size(2);
  at::Tensor out = at::zeros({ids.size(0), e}, w.options().dtype(at::kFloat));
  for (int64_t j = 0; j < k; ++j) {
    const at::Tensor col = ids.select(1, j).to(at::kLong);
    const at::Tensor valid = (col >= 0) & (col < v);
    const at::Tensor rows = w[j].index_select(0, col.clamp(0, v - 1)).to(at::kFloat);
    out = out + at::where(valid.unsqueeze(1), rows, at::zeros_like(rows));
  }
  return out;
}

// -- CUDA: the kernels ------------------------------------------------------

struct Library {
  void* handle = nullptr;
  std::string path;
};
std::mutex g_libs_mu;
std::map<std::string, Library> g_libs;  // by source

// a C entry point of the library built from `source`
void* kernel_symbol(const std::string& source, const char* symbol) {
  std::lock_guard<std::mutex> lock(g_libs_mu);
  auto it = g_libs.find(source);
  TORCH_CHECK(it != g_libs.end(), "no kernel library for ", source,
              " was loaded (the runner's --kernel ", source, "=PATH)");
  void* fn = dlsym(it->second.handle, symbol);
  TORCH_CHECK(fn != nullptr, it->second.path, " has no ", symbol);
  return fn;
}

#ifdef EMTPU_WITH_CUDA
using ErrorStringFn = const char* (*)(int);
using LstmFwdFn = int (*)(const void*, const void*, const void*, void*, void*, void*, int, int,
                          int, int, int, int, int, int, int, int, int, int, int, int, void*);
using OnehotFwdFn = int (*)(const void*, const int*, float*, int, int, int, int, int, int, int,
                            int, int, int, int, void*);

void check_launch(const std::string& source, const char* symbol, int code) {
  if (code == 0) return;
  auto errstr = reinterpret_cast<ErrorStringFn>(kernel_symbol(source, "emt_cuda_error_string"));
  TORCH_CHECK(false, symbol, " launch failed: CUDA error ", code, " (", errstr(code), ")");
}

at::Tensor lstm_sequence_cuda(const at::Tensor& x_proj, const at::Tensor& wh,
                              const at::Tensor& peep, bool peepholes) {
  check_lstm(x_proj, wh, peep);
  // ops/fused_lstm.py _check_cuda: one compute dtype, peep in f32, one
  // device, dense; never casts
  const auto dtype = x_proj.scalar_type();
  TORCH_CHECK(dtype == at::kFloat || dtype == at::kBFloat16,
              "the fused LSTM kernels take float32 or bfloat16; x_proj is ", dtype);
  const std::pair<const char*, const at::Tensor*> named[] = {
      {"x_proj", &x_proj}, {"wh", &wh}, {"peep", &peep}};
  for (const auto& [name, a] : named) {
    const auto want = a == &peep ? at::kFloat : dtype;
    TORCH_CHECK(a->scalar_type() == want, name, " is ", a->scalar_type(),
                "; the fused LSTM kernels take it as ", want, " with x_proj in ", dtype);
    TORCH_CHECK(a->device() == x_proj.device(), name, " is on ", a->device(), ", expected ",
                x_proj.device());
    TORCH_CHECK(a->is_contiguous(), name, " must be contiguous");
  }
  const int64_t t = x_proj.size(0), b = x_proj.size(1), h = x_proj.size(2) / 4;
  const bool bf16 = dtype == at::kBFloat16;
  const LstmPlan plan = lstm_plan(bf16, (int)b, (int)h);
  static const int max_hidden = lstm_max_hidden();
  TORCH_CHECK(plan.ok && h <= max_hidden, "hidden ", h,
              " exceeds the kernel's shared-memory cap ", max_hidden);
  const c10::cuda::CUDAGuard guard(x_proj.device());
  at::Tensor hs = at::empty({t, b, h}, x_proj.options());
  if (t && b) {
    const char* symbol = bf16 ? "emt_lstm_fwd_bf16" : "emt_lstm_fwd_f32";
    auto fn = reinterpret_cast<LstmFwdFn>(kernel_symbol("fused_lstm.cu", symbol));
    const int dev = x_proj.device().index();
    const int code =
        fn(x_proj.data_ptr(), wh.data_ptr(), peep.data_ptr(), hs.data_ptr(), nullptr, nullptr,
           (int)t, (int)b, (int)h, peepholes ? 1 : 0, plan.cluster, plan.rows, plan.units,
           plan.k_pad, plan.ktile, plan.slots, plan.splits, plan.threads, plan.smem, dev,
           c10::cuda::getCurrentCUDAStream(dev).stream());
    check_launch("fused_lstm.cu", symbol, code);
    ++g_lstm_launches;
  }
  return hs;
}

at::Tensor wide_onehot_fwd_cuda(const at::Tensor& w, const at::Tensor& ids) {
  check_onehot(w, ids);
  TORCH_CHECK(w.is_contiguous() && ids.is_contiguous(),
              "the wide one-hot kernels take contiguous tensors");
  const int64_t k = w.size(0), v = w.size(1), e = w.size(2), b = ids.size(0);
  const c10::cuda::CUDAGuard guard(w.device());
  at::Tensor out = at::empty({b, e}, w.options().dtype(at::kFloat));
  // a fresh allocation is aligned to 512 bytes: only w limits the vector
  const int itemsize = (int)w.element_size();
  const int vec = onehot_vec(e, itemsize, reinterpret_cast<std::uintptr_t>(w.data_ptr()));
  const OnehotPlan plan = onehot_fwd_plan(itemsize, b, e, vec);
  TORCH_CHECK(plan.ok, "K4a has no plan for (B, K, V, E) = (", b, ", ", k, ", ", v, ", ", e,
              ")");
  auto fn = reinterpret_cast<OnehotFwdFn>(kernel_symbol("wide_onehot.cu", "emt_wide_onehot_fwd"));
  const int dev = w.device().index();
  const int code = fn(w.data_ptr(), ids.data_ptr<int>(), out.data_ptr<float>(), (int)b, (int)k,
                      (int)v, (int)e, w.scalar_type() == at::kFloat ? 0 : 1, plan.vec, plan.rows,
                      plan.group, plan.threads, plan.blocks, dev,
                      c10::cuda::getCurrentCUDAStream(dev).stream());
  check_launch("wide_onehot.cu", "emt_wide_onehot_fwd", code);
  ++g_onehot_launches;
  return out;
}
#endif  // EMTPU_WITH_CUDA

}  // namespace

void load_kernel_library(const std::string& source, const std::string& path) {
  std::lock_guard<std::mutex> lock(g_libs_mu);
  void* handle = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  TORCH_CHECK(handle != nullptr, "cannot load the kernel library ", path, " (", source,
              "): ", dlerror());
  g_libs[source] = Library{handle, path};
}

std::map<std::string, long long> launch_counts() {
  return {{"lstm_sequence", g_lstm_launches.load()},
          {"wide_onehot_fwd", g_onehot_launches.load()}};
}

std::map<std::string, long long> cpu_calls() {
  return {{"lstm_sequence", g_lstm_cpu.load()}, {"wide_onehot_fwd", g_onehot_cpu.load()}};
}

bool with_cuda() {
#ifdef EMTPU_WITH_CUDA
  return true;
#else
  return false;
#endif
}

}  // namespace emtpu

TORCH_LIBRARY(emtpu, m) {
  m.def("lstm_sequence(Tensor x_proj, Tensor wh, Tensor peep, bool peepholes) -> Tensor");
  m.def("wide_onehot_fwd(Tensor w, Tensor ids) -> Tensor");
}

TORCH_LIBRARY_IMPL(emtpu, CPU, m) {
  m.impl("lstm_sequence", &emtpu::lstm_sequence_cpu);
  m.impl("wide_onehot_fwd", &emtpu::wide_onehot_fwd_cpu);
}

#ifdef EMTPU_WITH_CUDA
TORCH_LIBRARY_IMPL(emtpu, CUDA, m) {
  m.impl("lstm_sequence", &emtpu::lstm_sequence_cuda);
  m.impl("wide_onehot_fwd", &emtpu::wide_onehot_fwd_cuda);
}
#endif
