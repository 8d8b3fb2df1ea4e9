// The emtpu:: custom ops registered in C++ (emtpu_ops.cpp), for a process
// with no Python: what the runner (aoti_runner.cpp) sets and reads.

#pragma once

#include <map>
#include <string>

namespace emtpu {

// Load a kernel library that ops/common.build_library built from
// csrc/<source> ("fused_lstm.cu" or "wide_onehot.cu"); throws on failure.
// Without it, a CUDA call of the op whose kernel it holds raises.
void load_kernel_library(const std::string& source, const std::string& path);

// Kernel launches made by each op's CUDA implementation, by op name
// ("lstm_sequence", "wide_onehot_fwd"), counted after each launch
// succeeds.
std::map<std::string, long long> launch_counts();

// Calls of each op's CPU implementation (the plain version), by op name.
std::map<std::string, long long> cpu_calls();

// Whether this build registers the CUDA implementations.
bool with_cuda();

}  // namespace emtpu
