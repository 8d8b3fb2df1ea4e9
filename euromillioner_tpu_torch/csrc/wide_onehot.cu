// Wide one-hot contraction of the Wide&Deep wide tower, for sm_90a: the
// forward gather-sum (K4a) and the dense table gradient (K4b), in f32 or
// bf16 tables, f32 sums.
//
// Replaces the Pallas TPU kernels of euromillioner_tpu/ops/wide_onehot.py:
//  * K4a, _fwd_kernel (:86, pallas_call :114):
//      out[b, :] = sum_k w[k, ids[b, k], :]                  (B, E) f32
//    for w (K, V, E) stacked per-position tables and ids (B, K) int32;
//  * K4b, _dw_kernel (:97, pallas_call :137):
//      dw[k, v, :] = sum_{b : ids[b, k] == v} dh[b, :]       (K, V, E)
//    with dh (B, E) already in w's dtype, the sums in f32, each row written
//    once in w's dtype.
// An id outside [0, V) adds nothing, as its one-hot row on the TPU is zero.
//
// What changes from the TPU. The TPU has no cheap gather, so its kernel
// builds the (rb, V) one-hot in registers and feeds it to the matrix unit:
// B*V*E multiply-adds to move B*K rows. The card gathers rows directly, so
// K4a is a gather-sum and K4b a segmented sum, and neither does a matrix
// product. The TPU's sequential grid carries a VMEM accumulator across
// position steps (forward) or batch steps (dW); here blocks run in no
// order, so each output element is owned by one thread, which adds its
// terms in the plain version's order: positions ascending from zero (K4a),
// batch order within an id (K4b). No float atomics: reruns are
// bit-identical, and both are bit-equal to the plain versions.
//
// What bounds them, and the design. Both move bytes and do one add per
// element read; neither needs the tensor cores. Launch plans come from
// ops/wide_onehot.py (fwd_plan, dw_plan); the entry points recompute what
// follows from a plan and refuse one they would lay out otherwise.
//  * K4a reads the distinct table rows the ids name and writes (B, E) f32:
//    at bench.py's B=8192 in bf16, 358 MB gathered from 64 MB of distinct
//    rows, 34 MB written (bound 0.029 ms at 3.35 TB/s). Repeated rows come
//    from L2, so the gather is bound by L2-to-SM traffic, not HBM (an
//    L2-flushed launch is ~10% slower on an H100 80GB HBM3 at 700 W), and
//    by how many loads are in flight. A thread owns one 16-byte column
//    vector of `rows` batch rows and issues the loads of `group` positions
//    for them before their adds (the earlier design: 1 row, 4 at a time).
//    At small B (serving, training: B <= 128) the call is latency: one row
//    a thread, the loads of all 21 positions in flight at once, and the
//    plan narrows blocks (then vectors) until more than a quarter of the
//    SMs have work. At large B the plan takes the way that measured
//    fastest (chip_smoke.py's "K4a ways"): 8 rows a thread walking the
//    positions one at a time in f32, so the resident threads move through
//    the position slabs together; one row with 8 positions at a time in
//    bf16, whose 8-row sums would take 64 registers a thread. Outputs are
//    stored evict-first so they do not push table rows out of L2.
//  * K4b must write the dense (K, V, E) block: 178.9 MB in bf16 at full
//    width (0.053 ms at 3.35 TB/s), and reads dh's rows once for each
//    position they feed (358 MB from L2 at B=8192 in bf16; dh itself, 17
//    MB, stays in L2). The earlier design wrote the block twice (the
//    wrapper's zero fill, then the touched rows), sorted each position's
//    keys in one block (21 blocks on 132 SMs, log2(B)^2/2 passes, at most
//    32768 rows) and ran a thread per (sorted key, column vector), most of
//    which found no run to start. Here:
//    (1) a counting sort: each (tile, position) block counts its tile's
//        ids over V+1 bins (the last for ids outside [0, V)) in shared
//        memory; then each (tile, position) block scans its position's
//        counts (every tile's, a bin a thread: 16 KiB a tile at V=4096,
//        at most 8 tiles at the main paths' batches) into exclusive
//        offsets, tile 0's block listing the non-empty ids with their
//        runs, and one warp places the tile's rows in order, 32 at a
//        time, ranked by comparing the lanes' bins. Equal ids are ranked
//        by tile and by that walk, never by the order of atomics; the
//        result is each position's batch rows sorted by id, batch order
//        within an id. Any B and V: bins go in passes when they do not
//        fit beside the tile. A batch of one tile (every serving and
//        training batch) is counted by its placing block: one launch;
//    (2) one row writer launch with two kinds of blocks: run blocks
//        stride over the non-empty (k, v) rows, two column vectors a
//        thread, and sum each run's dh rows in
//        batch order in f32 (the run's row numbers are known, so 4 rows'
//        loads go out together; a long run is spread over threads by
//        columns, never split into partial sums); zeroing blocks store
//        zeros in the empty rows. Every row is stored once, evict-first,
//        16 bytes a store. The run sums are bound by L2-to-SM traffic (dh
//        re-read once per position). Staging dh's column slices in shared
//        memory (read from L2 once) was tried and lost: one 128 KiB block
//        an SM walking ~30 runs a thread is bound by its chains of loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstring>

namespace {

constexpr int kFwdThreads = 128;
constexpr int kSortThreads = 256;
constexpr int kPlaceThreads = 1024;  // a bin a thread while scanning
constexpr int kWriteThreads = 256;
constexpr int kRunBatch = 4;
constexpr int kMaxTileRows = 8192;
constexpr int kMaxSortSmem = 64 * 1024;  // a placing block's tile and cursors
constexpr int kMaxPositions = 1024;  // K: the row writer's list offsets
constexpr unsigned kFull = 0xffffffffu;

// K4b's parts (the wrapper's DW_COUNT, DW_PLACE, DW_WRITE)
constexpr int kPartCount = 1;
constexpr int kPartPlace = 2;
constexpr int kPartWrite = 4;

// K4a's (rows per thread, positions whose loads go out before the adds)
// pairs, as ops/wide_onehot.py's FWD_WAYS
__host__ __device__ constexpr bool fwd_way(int rows, int group) {
  return (rows == 1 && (group == 24 || group == 8)) ||
         (rows == 2 && group == 8) || (rows == 4 && group == 4) ||
         (rows == 8 && group == 1);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the integer type one vector of VEC elements is loaded and stored as
template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> {
  using type = uint4;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};
template <>
struct RawOf<2> {
  using type = unsigned short;
};

template <typename T, int VEC, typename R>
__device__ __forceinline__ void add_raw(float (&acc)[VEC], const R& raw) {
  static_assert(sizeof(R) == sizeof(T) * VEC, "vector size");
  T v[VEC];
  memcpy(v, &raw, sizeof(R));
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] += to_f32(v[j]);
}

template <typename T, int VEC, typename R>
__device__ __forceinline__ R pack_raw(const float (&acc)[VEC]) {
  T v[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = from_f32<T>(acc[j]);
  R raw;
  memcpy(&raw, v, sizeof(R));
  return raw;
}

// VEC f32 sums stored evict-first (st.global.cs)
template <int VEC>
__device__ __forceinline__ void store_f32_cs(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 8) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(a[4], a[5], a[6], a[7]));
  } else if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
  } else {
    __stcs(p, a[0]);
  }
}

// -- K4a --------------------------------------------------------------------

// A thread owns column vector c of batch rows [g*ROWS, g*ROWS + ROWS) and
// adds positions in ascending order, issuing the loads of KG positions for
// its rows before their adds; threads are numbered (g, c) with c fastest,
// so a warp reads 512 contiguous bytes of a row.
template <typename T, int VEC, int ROWS, int KG>
__global__ void __launch_bounds__(kFwdThreads, 4)
wide_fwd_kernel(const T* __restrict__ w,      // (K, V, E)
                const int* __restrict__ ids,  // (B, K)
                float* __restrict__ out,      // (B, E)
                int B, int K, int V, int E) {
  using R = typename RawOf<sizeof(T) * VEC>::type;
  const int nvec = E / VEC;
  const long long unit = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long units = ((long long)B + ROWS - 1) / ROWS * nvec;
  if (unit >= units) return;
  const int g = (int)(unit / nvec);
  const int c = (int)(unit - (long long)g * nvec) * VEC;
  const int b0 = g * ROWS;
  float acc[ROWS][VEC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KG) {
    R raw[ROWS][KG];
#pragma unroll
    for (int j = 0; j < KG; ++j) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int k = k0 + j;
        const int b = b0 + r;
        int id = -1;
        if (k < K && b < B) id = __ldg(ids + (size_t)b * K + k);
        raw[r][j] = R{};
        if (id >= 0 && id < V)
          raw[r][j] = __ldg(reinterpret_cast<const R*>(
              w + ((size_t)k * V + id) * E + c));
      }
    }
    // a missing term adds +0, which leaves a sum started at +0 unchanged
#pragma unroll
    for (int j = 0; j < KG; ++j)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) add_raw<T, VEC>(acc[r], raw[r][j]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (b0 + r < B) store_f32_cs<VEC>(out + (size_t)(b0 + r) * E + c, acc[r]);
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* w, const int* ids, float* out, int B,
                       int K, int V, int E, int rows, int group, int threads,
                       int blocks, cudaStream_t s) {
  const T* wt = static_cast<const T*>(w);
#define EMT_FWD_WAY(R_, G_)                                         \
  if (rows == R_ && group == G_) {                                  \
    wide_fwd_kernel<T, VEC, R_, G_><<<blocks, threads, 0, s>>>(     \
        wt, ids, out, B, K, V, E);                                  \
    return cudaGetLastError();                                      \
  }
  EMT_FWD_WAY(1, 24)
  EMT_FWD_WAY(1, 8)
  EMT_FWD_WAY(2, 8)
  EMT_FWD_WAY(4, 4)
  EMT_FWD_WAY(8, 1)
#undef EMT_FWD_WAY
  return cudaErrorInvalidValue;
}

// -- K4b: the counting sort ---------------------------------------------------

__device__ __forceinline__ int bin_of(int id, int V) {
  return id >= 0 && id < V ? id : V;
}

// Exclusive block-wide scans of two values at once (every thread of the
// block must call it; at most 32 warps): each thread's exclusive prefix of
// a and of b, and both totals.
__device__ __forceinline__ void block_scan2(int a, int b, int& excl_a,
                                            int& excl_b, int& total_a,
                                            int& total_b) {
  __shared__ int sums_a[32];
  __shared__ int sums_b[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int sa = a, sb = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ya = __shfl_up_sync(kFull, sa, off);
    const int yb = __shfl_up_sync(kFull, sb, off);
    if (lane >= off) {
      sa += ya;
      sb += yb;
    }
  }
  if (lane == 31) {
    sums_a[warp] = sa;
    sums_b[warp] = sb;
  }
  __syncthreads();
  if (warp == 0) {
    int wa = lane < warps ? sums_a[lane] : 0;
    int wb = lane < warps ? sums_b[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ya = __shfl_up_sync(kFull, wa, off);
      const int yb = __shfl_up_sync(kFull, wb, off);
      if (lane >= off) {
        wa += ya;
        wb += yb;
      }
    }
    sums_a[lane] = wa;
    sums_b[lane] = wb;
  }
  __syncthreads();
  excl_a = (warp ? sums_a[warp - 1] : 0) + sa - a;
  excl_b = (warp ? sums_b[warp - 1] : 0) + sb - b;
  total_a = sums_a[warps - 1];
  total_b = sums_b[warps - 1];
  __syncthreads();
}

// One warp places rows [r0, r1) in batch order: order[cursor[bin] + rank]
// = b, rank counting the earlier rows of the same bin — inside a 32-row
// chunk by comparing every lane's bin with every other's, the chunks in
// order; bins outside [0, n) are another pass's.
__device__ __forceinline__ void place_rows(const int* row_bins, int r0,
                                           int r1, int v0, int n,
                                           int* cursor, int* order) {
  const int lane = threadIdx.x & 31;
  for (int base = r0; base < r1; base += 32) {
    const int b = base + lane;
    const int bin = b < r1 ? row_bins[b - r0] - v0 : -1;
    const bool mine = bin >= 0 && bin < n;
    const int key = mine ? bin : -1;
    int rank = 0, same = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool eq = __shfl_sync(kFull, key, j) == key;
      same += eq;
      rank += eq && j < lane;
    }
    const int pos = mine ? cursor[bin] : 0;
    __syncwarp();
    if (mine && rank == 0) cursor[bin] = pos + same;
    if (mine) order[pos + rank] = b;
    __syncwarp();
  }
}

// counts[k, tile, v] = how many of the tile's rows have bin v at position
// k; bins in passes of bin_range
__global__ void __launch_bounds__(kSortThreads)
wide_dw_count_kernel(const int* __restrict__ ids, int* __restrict__ counts,
                     int B, int K, int V, int tile_rows, int tiles,
                     int bin_range) {
  extern __shared__ int hist[];
  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int r0 = tile * tile_rows;
  const int r1 = min(B, r0 + tile_rows);
  const int bins = V + 1;
  int* out = counts + ((size_t)k * tiles + tile) * bins;
  for (int v0 = 0; v0 < bins; v0 += bin_range) {
    const int n = min(bin_range, bins - v0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int b = r0 + threadIdx.x; b < r1; b += blockDim.x) {
      const int bin = bin_of(__ldg(ids + (size_t)b * K + k), V) - v0;
      if (bin >= 0 && bin < n) atomicAdd(&hist[bin], 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[v0 + i] = hist[i];
    __syncthreads();
  }
}

// Scans one position's bins [v0, v0 + n), a bin a thread, carrying the
// running totals across calls: the bin's total over the tiles and, of it,
// the tiles before `tile`; cursor[v - v0] = where the tile's rows of bin v
// go in the flat (K, B) order (bins in order, tiles in order within a
// bin). The block of tile 0 also writes starts[k, v] and, for non-empty
// bins v < V, runs[k, i] = (v, start, end). `counts` holds the position's
// (tiles, V + 1) counts.
__device__ __forceinline__ void scan_bins(const int* counts, int tiles,
                                          int tile, int bins, int V, int v0,
                                          int n, int* cursor, int* starts,
                                          int4* runs, int& carry,
                                          int& listed) {
  for (int base = 0; base < n; base += blockDim.x) {
    const int v = v0 + base + threadIdx.x;
    int total = 0, before = 0;
    if (base + threadIdx.x < n)
      for (int t = 0; t < tiles; ++t) {
        const int c = counts[(size_t)t * bins + v];
        total += c;
        before += t < tile ? c : 0;
      }
    const int flag = v < V && total > 0;
    int excl, excl_flag, sum, flags;
    block_scan2(total, flag, excl, excl_flag, sum, flags);
    if (base + threadIdx.x < n) {
      const int start = carry + excl;
      cursor[base + threadIdx.x] = start + before;
      if (tile == 0) {
        starts[v] = start;
        if (flag) runs[listed + excl_flag] = make_int4(v, start, start + total,
                                                       0);
      }
    }
    carry += sum;
    listed += flags;
  }
}

// scan_bins for a one-tile batch whose counts are in shared memory
// (cursor[v] for v < bins, one pass): each thread takes ceil(bins /
// blockDim.x) consecutive bins, so one block scan covers them all, and
// turns the counts into cursors in place.
__device__ __forceinline__ void scan_local_bins(int bins, int V, int* cursor,
                                                int* starts, int4* runs,
                                                int carry, int& listed) {
  const int per = (bins + blockDim.x - 1) / blockDim.x;
  const int v0 = threadIdx.x * per;
  int sum = 0, flags = 0;
  for (int v = v0; v < min(bins, v0 + per); ++v) {
    sum += cursor[v];
    flags += v < V && cursor[v] > 0;
  }
  int excl, excl_flag, total, total_flags;
  block_scan2(sum, flags, excl, excl_flag, total, total_flags);
  int start = carry + excl;
  int at = excl_flag;
  for (int v = v0; v < min(bins, v0 + per); ++v) {
    const int n = cursor[v];
    cursor[v] = start;
    starts[v] = start;
    if (v < V && n > 0) runs[at++] = make_int4(v, start, start + n, 0);
    start += n;
  }
  listed = total_flags;
}

// Sorts each position's rows by bin, batch order within a bin: block
// (tile, k) scans the position's counts (every block of the position does
// it; its tiles' counts are few), then one warp places the tile's rows in
// order at their bins' cursors (place_rows), bin_range bins a pass. A
// one-tile batch (every serving and training batch) needs no count kernel:
// its block counts in shared memory first. Block (0, k) writes the
// position's starts, runs and run count nnz[k].
__global__ void __launch_bounds__(kPlaceThreads)
wide_dw_place_kernel(const int* __restrict__ ids,
                     const int* __restrict__ counts, int* __restrict__ starts,
                     int4* __restrict__ runs, int* __restrict__ nnz,
                     int* __restrict__ order, int B, int K, int V,
                     int tile_rows, int tiles, int bin_range, int cap) {
  extern __shared__ int smem[];
  int* row_bins = smem;            // tile_rows
  int* cursor = smem + tile_rows;  // bin_range: counts, then cursors
  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int r0 = tile * tile_rows;
  const int r1 = min(B, r0 + tile_rows);
  const int bins = V + 1;
  for (int b = r0 + threadIdx.x; b < r1; b += blockDim.x)
    row_bins[b - r0] = bin_of(__ldg(ids + (size_t)b * K + k), V);
  int carry = k * B;
  int listed = 0;
  for (int v0 = 0; v0 < bins; v0 += bin_range) {
    const int n = min(bin_range, bins - v0);
    if (counts == nullptr) {  // one tile, one pass: count here
      for (int i = threadIdx.x; i < n; i += blockDim.x) cursor[i] = 0;
      __syncthreads();
      for (int b = threadIdx.x; b < r1; b += blockDim.x)
        atomicAdd(&cursor[row_bins[b]], 1);
      __syncthreads();
      scan_local_bins(bins, V, cursor, starts + (size_t)k * bins,
                      runs + (size_t)k * cap, carry, listed);
    } else {
      scan_bins(counts + (size_t)k * tiles * bins, tiles, tile, bins, V, v0,
                n, cursor, starts + (size_t)k * bins, runs + (size_t)k * cap,
                carry, listed);
    }
    __syncthreads();
    if (threadIdx.x < 32) place_rows(row_bins, r0, r1, v0, n, cursor, order);
    __syncthreads();
  }
  if (tile == 0 && threadIdx.x == 0) nnz[k] = listed;
}

// -- K4b: the row writer ------------------------------------------------------

// Two roles by block. The first run_blocks blocks stride over units of the
// positions' lists of non-empty ids (runs[k, i] = (v, start, end)): a unit
// is one entry's column vectors p and p + upr (upr = ceil(E / VEC / 2), so
// a warp's lanes read contiguous vectors of both halves); it sums the run's
// dh rows in batch order in f32, kRunBatch rows' loads at a time, and
// stores its vectors of the row once. The other blocks own zero_rows (k, v)
// rows each of the flat K x V and store zeros in the rows whose run is
// empty. Every row is written once.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWriteThreads)
wide_dw_write_kernel(const T* __restrict__ dh,        // (B, E)
                     const int* __restrict__ order,   // (K, B)
                     const int4* __restrict__ runs,   // (K, cap)
                     const int* __restrict__ nnz,     // (K,)
                     const int* __restrict__ starts,  // (K, V + 1)
                     T* __restrict__ dw,              // (K, V, E)
                     int K, int V, int E, int cap, int zero_rows,
                     int run_blocks) {
  using R = typename RawOf<sizeof(T) * VEC>::type;
  const int nvec = E / VEC;
  if ((int)blockIdx.x < run_blocks) {
    __shared__ int first[kMaxPositions + 1];  // entries before position k
    if (threadIdx.x == 0) {
      int n = 0;
      for (int k = 0; k < K; ++k) {
        first[k] = n;
        n += nnz[k];
      }
      first[K] = n;
    }
    __syncthreads();
    const int upr = (nvec + 1) / 2;
    const long long units = (long long)first[K] * upr;
    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u < units; u += (long long)run_blocks * blockDim.x) {
      const int entry = (int)(u / upr);
      const int p = (int)(u - (long long)entry * upr);
      const bool two = p + upr < nvec;
      int k = 0;
      while (first[k + 1] <= entry) ++k;
      const int4 run = __ldg(runs + (size_t)k * cap + entry - first[k]);
      const T* src = dh + p * VEC;
      float acc0[VEC], acc1[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc0[j] = acc1[j] = 0.f;
      for (int i = run.y; i < run.z; i += kRunBatch) {
        R raw0[kRunBatch], raw1[kRunBatch];
#pragma unroll
        for (int j = 0; j < kRunBatch; ++j) {
          raw0[j] = raw1[j] = R{};
          if (i + j < run.z) {
            const T* row = src + (size_t)__ldg(order + i + j) * E;
            raw0[j] = __ldg(reinterpret_cast<const R*>(row));
            if (two)
              raw1[j] = __ldg(reinterpret_cast<const R*>(row + upr * VEC));
          }
        }
        // past the run's end a term is +0, which leaves the sum unchanged
#pragma unroll
        for (int j = 0; j < kRunBatch; ++j) {
          add_raw<T, VEC>(acc0, raw0[j]);
          add_raw<T, VEC>(acc1, raw1[j]);
        }
      }
      T* out = dw + ((size_t)k * V + run.x) * E + p * VEC;
      __stcs(reinterpret_cast<R*>(out), pack_raw<T, VEC, R>(acc0));
      if (two)
        __stcs(reinterpret_cast<R*>(out + upr * VEC),
               pack_raw<T, VEC, R>(acc1));
    }
    return;
  }
  const int row0 = ((int)blockIdx.x - run_blocks) * zero_rows;
  const int units = min(zero_rows, K * V - row0) * nvec;
#pragma unroll 4
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int r = u / nvec;
    const int row = row0 + r;
    const int k = row / V;
    const int* st = starts + (size_t)k * (V + 1) + (row - k * V);
    if (__ldg(st) == __ldg(st + 1))
      __stcs(reinterpret_cast<R*>(dw + (size_t)row * E + (u - r * nvec) * VEC),
             R{});
  }
}

template <typename T, int VEC>
cudaError_t launch_write(const void* dh, const int* order, const int4* runs,
                         const int* nnz, const int* starts, void* dw, int K,
                         int V, int E, int cap, int zero_rows,
                         int zero_blocks, int run_blocks, cudaStream_t s) {
  wide_dw_write_kernel<T, VEC>
      <<<run_blocks + zero_blocks, kWriteThreads, 0, s>>>(
          static_cast<const T*>(dh), order, runs, nnz, starts,
          static_cast<T*>(dw), K, V, E, cap, zero_rows, run_blocks);
  return cudaGetLastError();
}

// cudaSetDevice only when `device` is not already the calling thread's:
// the entry points run once a call, and the call is host-bound at the
// serving and training batches
cudaError_t use_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device)
    return cudaSuccess;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16; vec is the column vector width (16
// bytes at most), which the plan picks to divide E and the pointers'
// alignment. Each returns cudaGetLastError() (0 = ok); a plan the entry
// would not lay out so, or an unsupported (dtype, vec), is
// cudaErrorInvalidValue.
//
// K4a on `stream` of CUDA device `device`, launched as fwd_plan says:
// `rows` batch rows per thread, the loads of `group` positions in flight
// before their adds, `threads` per block, `blocks` blocks.
int emt_wide_onehot_fwd(const void* w, const int* ids, float* out, int B,
                        int K, int V, int E, int dtype, int vec, int rows,
                        int group, int threads, int blocks, int device,
                        void* stream) {
  if (B <= 0 || E <= 0) return 0;
  if (K < 0 || V < 0 || vec <= 0 || E % vec || !fwd_way(rows, group) ||
      threads < 32 || threads > kFwdThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  const long long units = ((long long)B + rows - 1) / rows * (E / vec);
  if (blocks != (units + threads - 1) / threads)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
#define EMT_FWD(T_, VEC_)                                                \
  return (int)launch_fwd<T_, VEC_>(w, ids, out, B, K, V, E, rows, group, \
                                   threads, blocks, s)
  if (dtype == 0) {
    switch (vec) {
      case 4: EMT_FWD(float, 4);
      case 2: EMT_FWD(float, 2);
      case 1: EMT_FWD(float, 1);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 8: EMT_FWD(__nv_bfloat16, 8);
      case 4: EMT_FWD(__nv_bfloat16, 4);
      case 2: EMT_FWD(__nv_bfloat16, 2);
      case 1: EMT_FWD(__nv_bfloat16, 1);
    }
  }
#undef EMT_FWD
  return (int)cudaErrorInvalidValue;
}

// K4b on `stream` of CUDA device `device`, launched as dw_plan says. `dw`
// (K, V, E) may hold anything: every row is written. `scratch` holds
// scratch_ints int32, 16-byte aligned: the (K, min(V, B)) runs (v, start,
// end, 0) of the non-empty ids; the (K, tiles, V+1) counts (none when the
// batch is one tile and its bins one pass: the placing block counts); the
// (K, V+1) run starts; the (K, B) order; the K run counts. `parts` (bits:
// 1 count, 2 scan and place, 4 write) runs some parts alone, for timing
// them, on what earlier calls left in scratch.
int emt_wide_onehot_dw(const int* ids, const void* dh, void* dw, int* scratch,
                       int B, int K, int V, int E, int dtype, int vec,
                       int tile_rows, int tiles, int bin_range, int sort_smem,
                       int zero_rows, int zero_blocks, int run_blocks,
                       int scratch_ints, int parts, int device,
                       void* stream) {
  if (K <= 0 || V <= 0 || E <= 0) return 0;  // the block is empty
  if (B < 0 || vec <= 0 || E % vec || K > kMaxPositions || tile_rows < 32 ||
      tile_rows > kMaxTileRows || tile_rows % 32)
    return (int)cudaErrorInvalidValue;
  const long long bins = (long long)V + 1;
  const long long rows = (long long)K * V;
  const long long want_tiles =
      B > 0 ? ((long long)B + tile_rows - 1) / tile_rows : 1;
  const long long room = kMaxSortSmem / (int)sizeof(int) - tile_rows;
  const bool one_block = tiles == 1 && bins <= bin_range;
  const int cap = V < B ? V : B;
  const long long counts = one_block ? 0 : (long long)K * tiles * bins;
  const long long starts = (long long)K * bins;
  const long long order = (long long)K * B;
  const long long listed = (long long)K * cap * 4;
  if (tiles != want_tiles || bin_range != (bins < room ? bins : room) ||
      sort_smem != (tile_rows + bin_range) * (int)sizeof(int) ||
      rows > INT_MAX || zero_rows < 1 ||
      (long long)zero_rows * (E / vec) > INT_MAX ||
      zero_blocks != (rows + zero_rows - 1) / zero_rows || run_blocks < 1 ||
      scratch_ints != listed + counts + starts + order + K ||
      (long long)K * B > INT_MAX || parts < 1 || parts > 7)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  int4* rn = reinterpret_cast<int4*>(scratch);
  int* cnt = scratch + listed;
  int* st = cnt + counts;
  int* ord = st + starts;
  int* nz = ord + order;
  const dim3 grid(tiles, K);
  if ((parts & kPartCount) && !one_block) {
    const int smem = bin_range * (int)sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          wide_dw_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
    }
    wide_dw_count_kernel<<<grid, kSortThreads, smem, s>>>(
        ids, cnt, B, K, V, tile_rows, tiles, bin_range);
  }
  if (parts & kPartPlace) {
    if (sort_smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          wide_dw_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          sort_smem);
      if (e != cudaSuccess) return (int)e;
    }
    wide_dw_place_kernel<<<grid, kPlaceThreads, sort_smem, s>>>(
        ids, one_block ? nullptr : cnt, st, rn, nz, ord, B, K, V, tile_rows,
        tiles, bin_range, cap);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !(parts & kPartWrite)) return (int)e;
#define EMT_WRITE(T_, VEC_)                                                \
  return (int)launch_write<T_, VEC_>(dh, ord, rn, nz, st, dw, K, V, E, cap, \
                                     zero_rows, zero_blocks, run_blocks, s)
  if (dtype == 0) {
    switch (vec) {
      case 4: EMT_WRITE(float, 4);
      case 2: EMT_WRITE(float, 2);
      case 1: EMT_WRITE(float, 1);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 8: EMT_WRITE(__nv_bfloat16, 8);
      case 4: EMT_WRITE(__nv_bfloat16, 4);
      case 2: EMT_WRITE(__nv_bfloat16, 2);
      case 1: EMT_WRITE(__nv_bfloat16, 1);
    }
  }
#undef EMT_WRITE
  return (int)cudaErrorInvalidValue;
}

const char* emt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
