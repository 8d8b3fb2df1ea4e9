// Per-level split-finder histogram of the tree trainers, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel euromillioner_tpu/ops/fused_histogram.py:140
// (_hist_kernel, driven by fused_histogram at :184). It computes
//   out[f, 2*node + s, bin] = sum_i [binned[i, f] == bin] * [local[i] == node]
//                                   * (s == 0 ? gw[i] : hw[i])
// for every feature f, node in [0, n_nodes) and bin in [0, n_bins), as exact
// f32 sums in a fixed order: two runs on the same inputs give the same bits.
// Rows whose node or bin lies outside those ranges add nothing.
//
// Sets. The random forest calls the same histogram for every (tree, class
// pair) or (tree, moment pair) of a level, on one shared `binned`
// (euromillioner_tpu/trees/random_forest.py:95 and :183, which the JAX
// package runs one tree after another). Here one launch does them all: set s
// reads local, gw and hw at offset s * N and writes out at offset
// s * F * 2K * bins, and `sets_per_block` sets share a block, walking its
// staged columns of binned. Every field of the plan that orders a set's sums
// is that of one set (ops/fused_histogram.py order_fields), so set s adds in
// the same order whatever the number of sets: it is bit-identical to a
// one-set launch on its inputs. The GBT entry point is the one-set case.
//
// Why deterministic. A GBT tree is decided by the argmax of split gains, and
// near-tied gains are common (the JAX package's own golden trajectory moved
// when XLA changed its f32 summation order). Float atomics add in whatever
// order the hardware retires them, so a run could grow another tree than the
// run before it. Every sum here is taken in an order fixed by the plan and
// the data alone.
//
// Design ("owner computes"). The TPU kernel zeroes its output at grid step 0
// and accumulates across a sequential row grid; here blocks run in no order,
// so the rows are cut into `chunks` contiguous chunks:
//  0. transpose_kernel, at deep levels whose features come in several groups
//     only: binned to (F, N), so that a group's columns load contiguously.
//  1. hist_partial_kernel, one block of 16 warps per (set group, node tile,
//     bin tile, feature group, chunk). The block keeps, in shared memory,
//     the tile of every feature of its group: the nodes of its node tile x
//     2 stats x the bins of its bin tile. The node tile holds every node of
//     the level unless one bin of all of them does not fit (past ~27k
//     nodes), so each row of the chunk is read once for all the level's
//     nodes (the earlier design read it once per tile of 12 nodes). It
//     streams the chunk through shared memory in tiles of `rows` rows with
//     cp.async, double-buffered: the group's columns of binned (whole rows
//     when the group holds every feature) and each set's local, gw, hw.
//     The warps are copies x owners x feature slots (powers of two). Copy c
//     holds its own tiles and takes the rows of the 32-row groups g of the
//     chunk with g % copies == c; within a copy, owner o takes the rows
//     whose node n has n % owners == o (or, with one feature in the block,
//     whose cell id has cell_owner == o); slot s takes the block's features
//     j with j % slots == s. So every (node, bin) cell of a feature in a copy
//     has exactly one owning warp, and no two warps ever write one word.
//     A warp adds its rows in one of three ways, fixed by the plan:
//     - lanes on rows, one owner (shallow levels, small tiles): the warp
//       takes its copy's groups as they are;
//     - lanes on rows, several owners (deep levels: one feature's tile fills
//       the block): the block first splits each staged tile's rows among
//       the owners, stably (each warp counts its groups' rows per owner,
//       scans its column of counts, and each row is written to its owner's
//       list in row order);
//       in both, a warp adds 32 rows at a time (two groups' latencies
//       overlapped): the lanes that hit one cell, found with one ballot per
//       bit of the warp's cell keys, are summed in lane order by the lowest
//       such lane, which alone adds the sum into the tile;
//     - lanes on features (few bins, where 32 rows of a feature pile into
//       few cells): the warp walks its rows one at a time in row order, lane
//       j adding the row into feature j's tile; no two lanes share a cell.
//     At the end the copies are added in copy order and the tile is
//     written to partial[set][chunk] (to out[set] itself when chunks == 1).
//  2. hist_reduce_kernel: out[set] = sum over chunks of partial[set], in
//     chunk order.
// No bf16 split and no one-hot: the TPU needed both for its matrix unit;
// this kernel adds the f32 values themselves, and takes any bin and node
// count (a tile that does not fit is cut into bin tiles, then node tiles,
// each of which re-reads the rows).
// The wrapper (ops/fused_histogram.py launch_plan) chooses the plan; the
// shared memory it takes is smem_bytes() below, mirrored there.
//
// Bound. The function reads binned (N*F int32), local, gw and hw (N*12 B)
// once and writes the (F, 2K, bins) output once: at N=200k, F=28, depth 6
// (K=64 nodes, 256 bins) ~28.5 MB, ~8.5 us at 3.35 TB/s; it does ~2*N*F adds,
// nothing next to the bytes. At the reference shape (1193 x 10, 44 bins) it
// is ~0.1 MB, far below a microsecond, so launch latency sets its time. This
// design reads local, gw and hw once per feature group and binned once per
// set group, splits each staged tile among the owners in two passes at deep
// levels, resolves a group's shared cells with up to 14 ballots, and sends
// the partials of `chunks` chunks through device memory once more; with one
// block of 16 warps per SM, the dependent shared-memory loads, ballots and
// shuffles of a 32-row group bound it more than the bytes (PERF.md §6).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kWarpBits = 4;  // log2(kWarps)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 232448;  // the most a block may use on sm_90
constexpr unsigned kAll = 0xffffffffu;

struct Plan {
  int N, F, n_bins, n_nodes, sets;
  int chunks, features, copies, owners, lanes_by_feature, bin_tile,
      node_tile, rows, sets_per_block;
};

// Dynamic shared memory per block, in bytes: 4 x the words of the tiles
// (sets_per_block x features x copies x 2 node_tile x bin_tile floats), of
// two stages
// of staged rows (rows x (odd column stride + 3 per set) words), and of the
// split of one staged tile among the warps (a count per (32-row group,
// warp), each row's place, the row list).
size_t smem_bytes(const Plan& p) {
  const size_t cells = 2 * (size_t)p.node_tile * p.bin_tile;
  const size_t tiles = (size_t)p.sets_per_block * p.features * p.copies *
                       cells;
  const size_t stage =
      (size_t)p.rows * ((p.features | 1) + 3 * p.sets_per_block);
  const size_t split = (size_t)p.rows / 32 * kWarps + 2 * p.rows + kWarps;
  return 4 * (tiles + 2 * stage + split);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Issues the copies of rows [t0, t0 + n) into one stage: the group's
// columns f0 .. f0 + nf - 1 of binned (row r's at r * gs, gs odd so that a
// column's words fall in distinct banks), then each set's local, gw, hw.
// When the wrapper passes binned_t (binned transposed to (F, N)), the
// columns come from it, so that a column's loads are contiguous.
__device__ void stage_rows(const Plan& p, int* st, const int* binned,
                           const int* binned_t, const int* local,
                           const float* gw, const float* hw, int s0, int ns,
                           int f0, int nf, int t0, int n) {
  const int gs = p.features | 1;
  if (binned_t != nullptr) {
    for (int j = 0; j < nf; ++j) {
      const int* col = binned_t + (size_t)(f0 + j) * p.N + t0;
      for (int r = threadIdx.x; r < n; r += kThreads) {
        cp_async4(st + r * gs + j, col + r);
      }
    }
  } else {
    const int per_pass = kThreads / nf;
    const int j = threadIdx.x % nf;
    if (threadIdx.x < per_pass * nf) {
      for (int r = threadIdx.x / nf; r < n; r += per_pass) {
        cp_async4(st + r * gs + j, binned + (size_t)(t0 + r) * p.F + f0 + j);
      }
    }
  }
  for (int sb = 0; sb < ns; ++sb) {
    int* loc = st + p.rows * (gs + 3 * sb);
    const size_t off = (size_t)(s0 + sb) * p.N + t0;
    for (int r = threadIdx.x; r < n; r += kThreads) {
      cp_async4(loc + r, local + off + r);
      cp_async4(loc + p.rows + r, gw + off + r);
      cp_async4(loc + 2 * p.rows + r, hw + off + r);
    }
  }
  cp_async_commit();
}

// The lanes whose `key` equals this lane's, among the lanes in `valid`:
// one ballot per bit of the keys, which lie in [0, 2^bits) (the valid ones).
__device__ __forceinline__ unsigned same_key(int key, int bits,
                                             unsigned valid) {
  unsigned peers = valid;
  for (int b = 0; b < bits; ++b) {
    const bool bit = (key >> b) & 1;
    const unsigned set = __ballot_sync(kAll, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// Adds rows r[0] and then r[1] (one each per lane, -1 for none; their
// nodes lie in the block's node tile, which starts at k0) of one set into
// the warp's tiles (feature j's at tile + j * feature_stride), for the
// features j = first, first + step, ... of the block. Per feature and row
// group, the lanes of one cell are summed in lane order by the lowest of
// them, which alone writes, group 0 before group 1; a lane's cell key is
// its cell's index among the warp's cells (see row_owner), `bits` bits.
// Every lane walks its own peers in step k, so the warp runs as many steps
// as its largest group holds lanes. The two groups' loads, ballots and
// shuffles are independent, so their latencies overlap.
__device__ __forceinline__ void add_rows(const int (&r)[2], const int* bins,
                                         int gs, const int* loc,
                                         const float* gv, const float* hv,
                                         float* tile, int feature_stride,
                                         int nf, int first, int step, int k0,
                                         int b0, int nb, int shift, int bits,
                                         int by_cell, int lane) {
  int node[2];
  float g[2], h[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    node[u] = r[u] >= 0 ? loc[r[u]] - k0 : 0;
    g[u] = r[u] >= 0 ? gv[r[u]] : 0.f;
    h[u] = r[u] >= 0 ? hv[r[u]] : 0.f;
  }
  for (int j = first; j < nf; j += step) {
    int key[2], bin[2];
    unsigned peers[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      key[u] = -1;
      bin[u] = r[u] >= 0 ? bins[r[u] * gs + j] - b0 : -1;
      if ((unsigned)bin[u] < (unsigned)nb) {
        key[u] = by_cell ? (node[u] * nb + bin[u]) >> shift
                         : (node[u] >> shift) * nb + bin[u];
      }
      peers[u] = __ballot_sync(kAll, key[u] >= 0);
    }
    if ((peers[0] | peers[1]) == 0u) continue;
    for (int b = 0; b < bits; ++b) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const bool bit = (key[u] >> b) & 1;
        const unsigned set = __ballot_sync(kAll, bit);
        peers[u] &= bit ? set : ~set;
      }
    }
    const int steps = __reduce_max_sync(
        kAll, max(key[0] >= 0 ? __popc(peers[0]) : 0,
                  key[1] >= 0 ? __popc(peers[1]) : 0));
    unsigned rest[2] = {peers[0], peers[1]};
    float sg[2] = {0.f, 0.f}, sh[2] = {0.f, 0.f};
    for (int k = 0; k < steps; ++k) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int src = rest[u] ? __ffs(rest[u]) - 1 : lane;
        const float gj = __shfl_sync(kAll, g[u], src);
        const float hj = __shfl_sync(kAll, h[u], src);
        if (rest[u]) {
          sg[u] += gj;
          sh[u] += hj;
          rest[u] &= rest[u] - 1;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (key[u] >= 0 && lane == __ffs(peers[u]) - 1) {
        float* t = tile + j * feature_stride + 2 * node[u] * nb + bin[u];
        t[0] += sg[u];
        t[nb] += sh[u];
      }
      __syncwarp();
    }
  }
}

// Adds one set's rows of a staged tile with the lanes on features: the
// warp walks its copy's 32-row groups (group g0 + g of the chunk belongs to
// copy (g0 + g) % C) and, in row order, each row whose node lies in the
// block's node tile [k0, k0 + nk) and is its own ((node - k0) % owners ==
// owner); lane j adds the row into feature j's tile (j, j + 32,
// ...). No two lanes share a cell, so no grouping is needed, and a cell adds
// its rows one by one in row order. For few bins, where 32 rows of one
// feature would pile into a few cells.
__device__ __forceinline__ void add_rows_by_feature(
    const int* loc, const float* gv, const float* hv, const int* bins,
    int gs, int n, int g0, int copy, int C, int owners, int owner, int k0,
    int nk, float* tile, int feature_stride, int nf, int b0, int nb,
    int lane) {
  for (int g = (copy - g0 % C + C) % C; g * 32 < n; g += C) {
    const int r = g * 32 + lane;
    bool own = false;
    if (r < n) {
      const int node = loc[r] - k0;
      own = (unsigned)node < (unsigned)nk && (node & (owners - 1)) == owner;
    }
    for (unsigned m = __ballot_sync(kAll, own); m; m &= m - 1) {
      const int row = g * 32 + __ffs(m) - 1;
      const int node = loc[row] - k0;
      const float gr = gv[row];
      const float hr = hv[row];
      for (int j = lane; j < nf; j += 32) {
        const int bin = bins[row * gs + j] - b0;
        if ((unsigned)bin < (unsigned)nb) {
          float* t = tile + j * feature_stride + 2 * node * nb + bin;
          t[0] += gr;
          t[nb] += hr;
        }
      }
    }
  }
}

// The owner of cell id (node * nb + bin) in a one-feature block: its low
// bits xor the next ones, so that rows piled on a few bins of one node
// still spread over the warps, and one warp's cells spread over the banks
// (a warp's cells are then told apart by id >> shift alone). owners =
// 2^shift.
__device__ __forceinline__ int cell_owner(int id, int owners, int shift) {
  return (id ^ (id >> shift)) & (owners - 1);
}

// The owner of row r of a staged tile in its copy: its node's place in the
// block's node tile [k0, k0 + nk) modulo owners or, with one feature in the
// block (by_cell), its cell's owner; -1 for a row that adds nothing here.
// owners is a power of two.
__device__ __forceinline__ int row_owner(const int* loc, const int* bins,
                                         int gs, int r, int n, int k0,
                                         int nk, int owners, int shift,
                                         int by_cell, int b0, int nb) {
  if (r >= n) return -1;
  const int node = loc[r] - k0;
  if ((unsigned)node >= (unsigned)nk) return -1;
  if (!by_cell) return node & (owners - 1);
  const int bin = bins[r * gs] - b0;
  if ((unsigned)bin >= (unsigned)nb) return -1;
  return cell_owner(node * nb + bin, owners, shift);
}

__global__ void __launch_bounds__(kThreads, 1)
hist_partial_kernel(const int* __restrict__ binned,  // (N, F)
                    const int* __restrict__ binned_t,  // (F, N) or null
                    const int* __restrict__ local,   // (sets, N)
                    const float* __restrict__ gw,    // (sets, N)
                    const float* __restrict__ hw,    // (sets, N)
                    float* __restrict__ partial,  // (sets, chunks, F, 2K, bins)
                    Plan p) {
  extern __shared__ float smem[];
  const int K = p.n_nodes;
  const int fgroups = (p.F + p.features - 1) / p.features;
  const int bin_tiles = (p.n_bins + p.bin_tile - 1) / p.bin_tile;
  const int node_tiles = (K + p.node_tile - 1) / p.node_tile;
  int b = blockIdx.x;
  const int chunk = b % p.chunks;
  b /= p.chunks;
  const int fg = b % fgroups;
  b /= fgroups;
  const int bt = b % bin_tiles;
  b /= bin_tiles;
  const int nt = b % node_tiles;
  const int s0 = (b / node_tiles) * p.sets_per_block;
  const int ns = min(p.sets_per_block, p.sets - s0);
  const int f0 = fg * p.features;
  const int nf = min(p.features, p.F - f0);
  const int b0 = bt * p.bin_tile;
  const int nb = min(p.bin_tile, p.n_bins - b0);
  const int k0 = nt * p.node_tile;
  const int nk = min(p.node_tile, K - k0);
  // a tile's extent; rows of nb bins, node k0 + i's at row 2 i
  const int cells = 2 * p.node_tile * p.bin_tile;
  const int C = p.copies;
  const int owners = p.owners;
  const int slots = kWarps / (C * owners);  // feature slots
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = warp % slots;  // with several owners, slots == 1
  const int copy = warp / (slots * owners);
  const int shift = __ffs(owners) - 1;
  const int by_cell = nf == 1;
  // a warp's cell keys: its cells' ids (node * nb + bin) >> shift, or its
  // nodes (node >> shift) x the tile's bins
  const int span = by_cell ? (nk * nb + owners - 1) >> shift
                           : ((nk + owners - 1) >> shift) * nb;
  const int bits = span > 1 ? 32 - __clz(span - 1) : 0;
  const int gs = p.features | 1;
  const int stage_words = p.rows * (gs + 3 * p.sets_per_block);

  float* tiles = smem;
  const int tile_words = p.sets_per_block * p.features * C * cells;
  int* stages = reinterpret_cast<int*>(smem + tile_words);
  int* counts = stages + 2 * stage_words;  // [rows / 32][kWarps]
  int* place = counts + p.rows / 32 * kWarps;  // [rows]: target | rank << 8
  int* list = place + p.rows;  // [rows]
  int* totals = list + p.rows;  // [kWarps]
  for (int i = threadIdx.x; i < tile_words; i += kThreads) tiles[i] = 0.f;

  const int per_chunk = (p.N + p.chunks - 1) / p.chunks;
  const int r0 = min(p.N, chunk * per_chunk);
  const int r1 = min(p.N, r0 + per_chunk);
  const int ntiles = (r1 - r0 + p.rows - 1) / p.rows;
  if (ntiles > 0) {
    stage_rows(p, stages, binned, binned_t, local, gw, hw, s0, ns, f0, nf,
               r0, min(p.rows, r1 - r0));
  }
  const unsigned below = (1u << lane) - 1;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = r0 + t * p.rows;
    const int n = min(p.rows, r1 - t0);
    if (t + 1 < ntiles) {
      stage_rows(p, stages + ((t + 1) & 1) * stage_words, binned, binned_t,
                 local, gw, hw, s0, ns, f0, nf, t0 + p.rows,
                 min(p.rows, r1 - t0 - p.rows));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int* st = stages + (t & 1) * stage_words;
    const int g0 = (t0 - r0) / 32;  // the tile's first group in the chunk
    const int groups = (n + 31) / 32;
    for (int sb = 0; sb < ns; ++sb) {
      const int* loc = st + p.rows * (gs + 3 * sb);
      const float* gv = reinterpret_cast<const float*>(loc + p.rows);
      const float* hv = gv + p.rows;
      float* tile = tiles + (sb * p.features * C + copy) * cells;
      if (p.lanes_by_feature) {
        add_rows_by_feature(loc, gv, hv, st, gs, n, g0, copy, C, owners,
                            warp % owners, k0, nk, tile, C * cells, nf, b0,
                            nb, lane);
        continue;
      }
      if (owners == 1) {
        // the copy's groups, as they are, two at a time
        for (int g = (copy - g0 % C + C) % C; g < groups; g += 2 * C) {
          int r[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            r[u] = (g + u * C) * 32 + lane;
            if (r[u] >= n || (unsigned)(loc[r[u]] - k0) >= (unsigned)nk) {
              r[u] = -1;
            }
          }
          add_rows(r, st, gs, loc, gv, hv, tile, C * cells, nf, slot, slots,
                   k0, b0, nb, shift, bits, by_cell, lane);
        }
        continue;
      }
      // 1. each group's rows per target (copy, owner; one slot per target),
      // and each row's target and rank among its group's rows of that
      // target
      for (int g = warp; g < groups; g += kWarps) {
        const int r = g * 32 + lane;
        const int o =
            row_owner(loc, st, gs, r, n, k0, nk, owners, shift, by_cell, b0,
                      nb);
        const int tg = o < 0 ? -1 : ((g0 + g) & (C - 1)) * owners + o;
        const unsigned peers =
            same_key(tg, kWarpBits, __ballot_sync(kAll, tg >= 0));
        if (r < n) place[r] = tg < 0 ? -1 : tg | __popc(peers & below) << 8;
        if (lane < kWarps) counts[g * kWarps + lane] = 0;
        __syncwarp();
        if (tg >= 0 && lane == __ffs(peers) - 1) {
          counts[g * kWarps + tg] = __popc(peers);
        }
      }
      __syncthreads();
      // 2. warp w: where each group's rows start in target w's list, and
      // its total
      int total = 0;
      for (int base = 0; base < groups; base += 32) {
        const int g = base + lane;
        const int c = g < groups ? counts[g * kWarps + warp] : 0;
        int incl = c;
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(kAll, incl, d);
          if (lane >= d) incl += v;
        }
        if (g < groups) counts[g * kWarps + warp] = total + incl - c;
        total += __shfl_sync(kAll, incl, 31);
      }
      if (lane == 0) totals[warp] = total;
      __syncthreads();
      // lane l < kWarps: the start of target l's list, the lists in order
      const int total_l = lane < kWarps ? totals[lane] : 0;
      int start_l = total_l;
      for (int d = 1; d < kWarps; d <<= 1) {
        const int v = __shfl_up_sync(kAll, start_l, d);
        if (lane >= d) start_l += v;
      }
      start_l -= total_l;
      // 3. every row to its target's list, in row order
      for (int g = warp; g < groups; g += kWarps) {
        const int r = g * 32 + lane;
        const int at = r < n ? place[r] : -1;
        const int tg = at < 0 ? 0 : at & 0xff;
        const int start = __shfl_sync(kAll, start_l, tg);
        if (at >= 0) list[start + counts[g * kWarps + tg] + (at >> 8)] = r;
      }
      __syncthreads();
      // 4. this warp's list (target = warp: one slot) into its tiles, 32
      // rows a group, two groups at a time
      const int mine = __shfl_sync(kAll, total_l, warp);
      const int* own = list + __shfl_sync(kAll, start_l, warp);
      for (int i = 0; i < mine; i += 64) {
        const int r[2] = {i + lane < mine ? own[i + lane] : -1,
                          i + 32 + lane < mine ? own[i + 32 + lane] : -1};
        add_rows(r, st, gs, loc, gv, hv, tile, C * cells, nf, 0, 1, k0, b0,
                 nb, shift, bits, by_cell, lane);
      }
      __syncthreads();  // the counts and the list serve the next set
    }
    __syncthreads();  // the next tile's copies refill this stage
  }

  __syncthreads();  // the tiles are zeroed, even when the chunk is empty
  for (int sb = 0; sb < ns; ++sb) {
    for (int j = 0; j < nf; ++j) {
      const float* src = tiles + (sb * p.features + j) * C * cells;
      float* dst = partial +
                   ((((size_t)(s0 + sb) * p.chunks + chunk) * p.F + f0 + j) *
                        K + k0) * 2 * p.n_bins +
                   b0;
      for (int row = warp; row < 2 * nk; row += kWarps) {
        for (int bin = lane; bin < nb; bin += 32) {
          float s = src[row * nb + bin];
          for (int c = 1; c < C; ++c) s += src[c * cells + row * nb + bin];
          dst[(size_t)row * p.n_bins + bin] = s;
        }
      }
    }
  }
}

// binned_t = binned transposed, (N, F) -> (F, N), through a 32 x 32 tile of
// shared memory (blocks of 32 x 8 threads).
__global__ void transpose_kernel(const int* __restrict__ binned,
                                 int* __restrict__ binned_t, int N, int F) {
  __shared__ int tile[32][33];
  const int r0 = blockIdx.x * 32, f0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, f = f0 + threadIdx.x;
    if (r < N && f < F) tile[i][threadIdx.x] = binned[(size_t)r * F + f];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int f = f0 + i, r = r0 + threadIdx.x;
    if (r < N && f < F) binned_t[(size_t)f * N + r] = tile[threadIdx.x][i];
  }
}

// out[set, i] = sum over c of partial[set, c, i], c in order; `size` is one
// set's output size. The loads of eight chunks are issued before their adds,
// so a thread waits on memory once per eight chunks, not once per chunk; the
// adds keep chunk order.
__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, size_t size,
                                   int sets, int chunks) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= size * sets) return;
  const size_t set = j / size;
  const float* src = partial + set * chunks * size + j % size;
  float s = src[0];
  int c = 1;
  for (; c + 8 <= chunks; c += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = src[(size_t)(c + u) * size];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; c < chunks; ++c) s += src[(size_t)c * size];
  out[j] = s;
}

// Raises the partial kernel's dynamic shared-memory limit to kMaxSmem, once
// per device.
cudaError_t allow_smem(int device) {
  static bool done[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      hist_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  done[device] = e == cudaSuccess;
  return e;
}

int launch_histogram(const int* binned, int* binned_t, const int* local,
                     const float* gw, const float* hw, float* out,
                     float* partial, const Plan& p, int device,
                     void* stream) {
  if (p.F <= 0 || p.n_bins <= 0 || p.n_nodes <= 0 || p.sets <= 0) return 0;
  // copies x owners divides the warps (powers of two), and fills them when
  // there are several owners, which the split gives one warp each
  const int warps = p.copies * p.owners;
  if (p.N < 0 || p.chunks < 1 || p.features < 1 || p.features > 64 ||
      p.copies < 1 || p.owners < 1 || warps > kWarps || kWarps % warps ||
      p.node_tile < 1 ||
      (p.copies & (p.copies - 1)) || (p.owners & (p.owners - 1)) ||
      ((p.owners > 1 || p.lanes_by_feature) && warps != kWarps) ||
      p.bin_tile < 1 || p.rows < 32 ||
      p.rows % 32 != 0 || p.sets_per_block < 1 || smem_bytes(p) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks =
      (long long)((p.sets + p.sets_per_block - 1) / p.sets_per_block) *
      ((p.n_nodes + p.node_tile - 1) / p.node_tile) *
      ((p.n_bins + p.bin_tile - 1) / p.bin_tile) *
      ((p.F + p.features - 1) / p.features) * p.chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (binned_t != nullptr && p.N > 0) {
    transpose_kernel<<<dim3((p.N + 31) / 32, (p.F + 31) / 32), dim3(32, 8), 0,
                       s>>>(binned, binned_t, p.N, p.F);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  hist_partial_kernel<<<(unsigned)blocks, kThreads, smem_bytes(p), s>>>(
      binned, binned_t, local, gw, hw, p.chunks == 1 ? out : partial, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.chunks == 1) return (int)e;
  const size_t size = (size_t)p.F * 2 * p.n_nodes * p.n_bins;
  const int threads = 256;
  hist_reduce_kernel<<<(unsigned)((size * p.sets + threads - 1) / threads),
                       threads, 0, s>>>(partial, out, size, p.sets,
                                        p.chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernels on `stream` of CUDA device `device`. `binned_t`, if
// not null, holds N * F ints for binned transposed (the wrapper passes it at
// deep levels with several feature groups); `partial` holds chunks * F * 2 *
// n_nodes * n_bins floats (unused when chunks == 1). The wrapper
// (ops/fused_histogram.py launch_plan) chooses chunks, the feature group,
// the copies and owners, which lanes take (rows or features), the bin and
// node tiles and the rows per staged tile. Returns cudaGetLastError()
// (0 = ok).
int emt_fused_histogram_f32(const int* binned, int* binned_t,
                            const int* local, const float* gw,
                            const float* hw, float* out, float* partial,
                            int N, int F, int n_bins,
                            int n_nodes, int chunks, int features, int copies,
                            int owners, int lanes_by_feature, int bin_tile,
                            int node_tile, int rows, int device,
                            void* stream) {
  const Plan p{N,        F,      n_bins, n_nodes,          1,
               chunks,   features, copies, owners, lanes_by_feature,
               bin_tile, node_tile, rows, 1};
  return launch_histogram(binned, binned_t, local, gw, hw, out, partial, p,
                          device, stream);
}

// The same for `sets` sets on one `binned`: local, gw and hw are (sets, N),
// out is (sets, F, 2 * n_nodes, n_bins) and `partial` holds sets times the
// one-set size. The plan is one set's; `sets_per_block` sets share a block
// and walk its staged columns of binned.
int emt_fused_histogram_sets_f32(const int* binned, int* binned_t,
                                 const int* local, const float* gw,
                                 const float* hw, float* out, float* partial,
                                 int N, int F, int n_bins,
                                 int n_nodes, int sets, int chunks,
                                 int features, int copies, int owners,
                                 int lanes_by_feature, int bin_tile,
                                 int node_tile, int rows, int sets_per_block,
                                 int device, void* stream) {
  const Plan p{N,        F,      n_bins, n_nodes,          sets,
               chunks,   features, copies, owners, lanes_by_feature,
               bin_tile, node_tile, rows, sets_per_block};
  return launch_histogram(binned, binned_t, local, gw, hw, out, partial, p,
                          device, stream);
}

const char* emt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
