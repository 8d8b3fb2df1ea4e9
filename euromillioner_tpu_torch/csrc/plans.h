// The launch plans of K1 (the LSTM sequence forward, fused_lstm.cu) and
// K4a (the wide one-hot forward, wide_onehot.cu) as plain host C++, for a
// process that launches the kernels without Python (aoti_runner.cpp through
// emtpu_ops.cpp).
//
// Each function is a line-for-line copy of its Python counterpart, which
// stays the source of truth:
//   lstm_plan / lstm_plan_on / lstm_fwd_smem / lstm_max_hidden
//     = ops/fused_lstm.py lstm_plan / _plan / _smem / MAX_HIDDEN (forward)
//   onehot_vec / onehot_fwd_plan
//     = ops/wide_onehot.py _vec / fwd_plan
// A plan that differs from the Python wrapper's is not an error the kernels
// can see: it launches another tiling, whose sums may round otherwise. So
// tests/test_torch_native_runner.py holds these against the Python plans
// over a grid of shapes. No torch, no CUDA: the header compiles with any
// C++17 compiler.

#pragma once

#include <cstdint>

namespace emtpu {

// -- K1 ---------------------------------------------------------------------
constexpr int kSmemPerBlock = 232448;  // the H100's opt-in shared memory
constexpr int kMaxCluster = 16;        // non-portable cluster size
constexpr int kWarpsBf16 = 16;         // a bf16 CTA's warps
constexpr int kMaxThreadsF32 = 256;

struct LstmPlan {
  bool ok = false;  // false: no plan fits a block (Python's None)
  int cluster = 0, rows = 0, units = 0, k_pad = 0;
  bool resident = false;
  int ktile = 0, slots = 0, splits = 0, threads = 0, smem = 0, tiles = 0;
};

// Python's _ceil: n rounded up to a multiple of m (n >= 0)
inline long long ceil_to(long long n, long long m) { return (n + m - 1) / m * m; }
inline long long cdiv(long long n, long long m) { return (n + m - 1) / m; }

// shared memory per CTA of K1, in bytes, as fused_lstm.cu lays it out
inline long long lstm_fwd_smem(bool bf16, long long rows, long long units,
                               long long k_pad, long long ktile,
                               long long slots, long long splits) {
  const long long u4 = 4 * units;
  if (bf16)
    return 2 * (rows * (k_pad + 8) + slots * ktile * u4 + 6 * rows * units);
  return 4 * (k_pad * rows + slots * ktile * u4 + (splits - 1) * rows * u4);
}

// K1's plan on a given cluster of CTAs (Python's _plan, backward=False)
inline LstmPlan lstm_plan_on(bool bf16, int batch, int hidden, int cluster) {
  LstmPlan none;
  const long long units = ceil_to(cdiv(hidden, cluster), 8);
  const long long u4 = 4 * units;
  const long long ktile =
      bf16 ? (64 < ceil_to(cluster * units, 16) ? 64 : ceil_to(cluster * units, 16))
           : (32 < ceil_to(cluster * units, 16) ? 32 : ceil_to(cluster * units, 16));
  const long long k_pad = ceil_to(cluster * units, ktile);
  const long long tiles_k = k_pad / ktile;
  const long long b1 = batch > 1 ? batch : 1;
  long long candidates[8];
  int n_cand = 0;
  if (bf16) {
    if (units / 8 > kWarpsBf16) return none;
    long long r = 4;
    if (kWarpsBf16 / (units / 8) < r) r = kWarpsBf16 / (units / 8);
    if (cdiv(b1, 16) < r) r = cdiv(b1, 16);
    candidates[n_cand++] = 16 * r;
  } else {
    const long long rows = ceil_to(b1, 8) < 64 ? ceil_to(b1, 8) : 64;
    for (long long r = rows; r > 0; r -= 8) candidates[n_cand++] = r;
  }
  for (int c = 0; c < n_cand; ++c) {
    const long long rows = candidates[c];
    long long threads, splits = 1;
    if (bf16) {
      threads = 32 * kWarpsBf16;
    } else {
      const long long base = rows / 8 * units;
      if (base > kMaxThreadsF32) continue;
      while (splits < 8 && 2 * splits * base <= 256 && ktile % (8 * splits) == 0)
        splits *= 2;
      threads = splits * base;
    }
    // the wh slice resident (all its tiles), else a ring of 6 down to 2
    const long long ways[6][2] = {{1, tiles_k}, {0, 6}, {0, 5}, {0, 4}, {0, 3}, {0, 2}};
    for (const auto& w : ways) {
      const long long smem = lstm_fwd_smem(bf16, rows, units, k_pad, ktile, w[1], splits);
      if (smem <= kSmemPerBlock) {
        LstmPlan p;
        p.ok = true;
        p.cluster = cluster;
        p.rows = (int)rows;
        p.units = (int)units;
        p.k_pad = (int)k_pad;
        p.resident = w[0] != 0;
        p.ktile = (int)ktile;
        p.slots = (int)w[1];
        p.splits = (int)splits;
        p.threads = (int)threads;
        p.smem = (int)smem;
        p.tiles = (int)cdiv(b1, rows);
        return p;
      }
    }
  }
  return none;
}

// K1's plan for a call of batch x hidden (Python's lstm_plan, forward)
inline LstmPlan lstm_plan(bool bf16, int batch, int hidden) {
  int cluster = 1;
  while (cluster < kMaxCluster && cluster * 8 < hidden) cluster *= 2;
  return lstm_plan_on(bf16, batch, hidden, cluster);
}

// the widest H both dtypes plan for at the smallest batch tile (MAX_HIDDEN)
inline int lstm_max_hidden() {
  int lo = 8, hi = 4096;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (lstm_plan(false, 8, mid).ok && lstm_plan(true, 8, mid).ok)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// -- K4a --------------------------------------------------------------------
constexpr int kSms = 132;                 // the H100 SXM's SMs
constexpr int kFwdThreads = 128;          // K4a's widest block
constexpr long long kFwdResident = kSms * 512;

struct OnehotPlan {
  bool ok = false;  // false: (rows, group) is not one of K4a's ways
  int vec = 0, rows = 0, group = 0, threads = 0, blocks = 0;
};

// the widest column vector (16 bytes at most) dividing E and the address
inline int onehot_vec(long long e, int itemsize, std::uintptr_t addr) {
  int vec = 16 / itemsize;
  while (vec > 1 && (e % vec || addr % (std::uintptr_t)(vec * itemsize)))
    vec /= 2;
  return vec;
}

inline bool onehot_fwd_way(int rows, int group) {
  return (rows == 1 && (group == 24 || group == 8)) || (rows == 2 && group == 8) ||
         (rows == 4 && group == 4) || (rows == 8 && group == 1);
}

// K4a's plan for (B, K, V, E) with a table of `itemsize` bytes (4: float32,
// 2: bfloat16) whose vector is `vec` (Python's fwd_plan with defaults)
inline OnehotPlan onehot_fwd_plan(int itemsize, long long batch, long long width, int vec) {
  OnehotPlan plan;
  const long long nvec = width / vec > 1 ? width / vec : 1;
  const bool large = batch * nvec > kFwdResident;
  const int max_rows = itemsize == 4 ? 8 : 1;
  int rows = 1;
  while (rows < max_rows && batch * nvec > rows * kFwdResident) rows *= 2;
  const int group = rows == 2 ? 8 : rows == 4 ? 4 : rows == 8 ? 1 : large ? 8 : 24;
  if (!onehot_fwd_way(rows, group)) return plan;
  auto blocks = [&](long long threads, long long v) {
    return cdiv(cdiv(batch, rows) * (width / v), threads);
  };
  long long threads = kFwdThreads;
  while (threads > 32 && blocks(threads, vec) < kSms) threads /= 2;
  while (vec > 1 && 0 < blocks(threads, vec) && blocks(threads, vec) <= kSms / 4) vec /= 2;
  plan.ok = true;
  plan.vec = vec;
  plan.rows = rows;
  plan.group = group;
  plan.threads = (int)threads;
  plan.blocks = (int)blocks(threads, vec);
  return plan;
}

}  // namespace emtpu
