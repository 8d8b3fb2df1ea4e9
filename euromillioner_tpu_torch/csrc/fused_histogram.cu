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
// s * F * 2K * bins. The set index is folded into grid.x (chunks * sets
// blocks; grid.z caps at 65535, and a forest of 100 trees and 6 classes has
// 300 sets). Chunks and tiles are those of one set, so set s adds in the same
// order whatever the number of sets: it is bit-identical to a one-set launch
// on its inputs. The GBT entry point is the one-set case of the same code.
//
// Why deterministic. A GBT tree is decided by the argmax of split gains, and
// near-tied gains are common (the JAX package's own golden trajectory moved
// when XLA changed its f32 summation order). Float atomics add in whatever
// order the hardware retires them, so a run could grow another tree than the
// run before it. Every sum here is taken in an order fixed by the launch
// shape alone.
//
// Design. The TPU kernel zeroes its output at grid step 0 and accumulates
// across a sequential row grid; here blocks run in no order, so the rows are
// cut into `chunks` contiguous chunks and the work is two kernels:
//  1. hist_partial_kernel, grid (chunks x sets, F, node tiles x bin tiles),
//     4 warps.
//     Each warp owns a private copy, in shared memory, of the block's tile of
//     cells (node_tile nodes x 2 stats x bin_tile bins). A warp takes 32 rows
//     at a time (rows warp, warp + 4, ... of the chunk, in 32-row groups);
//     lanes that hit the same cell (found with __match_any_sync) are summed
//     in lane order by the lowest such lane, which alone adds the group's
//     sum into the warp's copy: no two threads ever write one shared-memory
//     word at once, and the order is fixed. At the end the four copies are
//     added in warp order and the tile is written to partial[set][chunk] (to
//     out[set] itself when chunks == 1).
//  2. hist_reduce_kernel: out[set] = sum over chunks of partial[set], in
//     chunk order.
// No bf16 split and no one-hot: the TPU needed both for its matrix unit;
// this kernel adds the f32 values themselves, and takes any bin count (a bin
// count wider than the tile is cut into bin tiles).
//
// Bound. The function reads binned (N*F int32), local, gw and hw (N*12 B)
// once and writes the (F, 2K, bins) output once: at N=200k, F=28, depth 6
// (K=64 nodes, 256 bins) ~28.5 MB, ~8.5 us at 3.35 TB/s; it does ~2*N*F adds,
// nothing next to the bytes. At the reference shape (1193 x 10, 44 bins) it
// is ~0.1 MB, far below a microsecond, so launch latency sets its time. This
// simple design is bound by neither: each 32-row group costs a match, a
// reduce and a few shuffles per (feature, node tile), binned is read with a
// stride of F words across a warp, and every node tile re-reads the chunk's
// rows. With sets, each set's rows are read apart, and binned once per set.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const int* __restrict__ binned,  // (N, F)
                    const int* __restrict__ local,   // (sets, N)
                    const float* __restrict__ gw,    // (sets, N)
                    const float* __restrict__ hw,    // (sets, N)
                    float* __restrict__ partial,  // (sets, chunks, F, 2K, bins)
                    int N, int F, int n_bins, int n_nodes, int chunks,
                    int node_tile, int bin_tile) {
  extern __shared__ float smem[];  // [kWarps][node_tile * 2 * bin_tile]
  const int chunk = blockIdx.x % chunks;
  const int set = blockIdx.x / chunks;
  local += (size_t)set * N;
  gw += (size_t)set * N;
  hw += (size_t)set * N;
  const int f = blockIdx.y;
  const int bin_tiles = (n_bins + bin_tile - 1) / bin_tile;
  const int node0 = (blockIdx.z / bin_tiles) * node_tile;
  const int bin0 = (blockIdx.z % bin_tiles) * bin_tile;
  const int nn = min(node_tile, n_nodes - node0);
  const int nb = min(bin_tile, n_bins - bin0);
  const int cells = nn * 2 * nb;  // cell = node * 2nb + stat * nb + bin
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kWarps * cells; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const int per_chunk = (N + chunks - 1) / chunks;
  const int r0 = chunk * per_chunk;
  const int r1 = min(N, r0 + per_chunk);
  float* mine = smem + warp * cells;
  for (int base = r0 + 32 * warp; base < r1; base += 32 * kWarps) {
    const int r = base + lane;
    int cell = -1;
    float g = 0.f, h = 0.f;
    if (r < r1) {
      const int node = local[r] - node0;
      const int bin = binned[(size_t)r * F + f] - bin0;
      if (node >= 0 && node < nn && bin >= 0 && bin < nb) {
        cell = node * 2 * nb + bin;
        g = gw[r];
        h = hw[r];
      }
    }
    if (__ballot_sync(0xffffffffu, cell >= 0) == 0u) continue;
    // lanes of one cell (its peers): the lowest sums them in lane order,
    // starting with its own value, and alone writes the sum. Every lane
    // walks its own peers in step k, so the warp runs as many steps as
    // its largest group holds lanes.
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    const int steps =
        __reduce_max_sync(0xffffffffu, cell >= 0 ? __popc(peers) : 0);
    unsigned rest = peers;
    float sg = 0.f, sh = 0.f;
    for (int k = 0; k < steps; ++k) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      const float gj = __shfl_sync(0xffffffffu, g, src);
      const float hj = __shfl_sync(0xffffffffu, h, src);
      if (rest) {
        sg += gj;
        sh += hj;
        rest &= rest - 1;
      }
    }
    if (cell >= 0 && lane == __ffs(peers) - 1) {
      mine[cell] += sg;
      mine[cell + nb] += sh;
    }
  }
  __syncthreads();

  float* dst =
      partial + ((size_t)set * chunks + chunk) * F * 2 * n_nodes * n_bins;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    float s = smem[i];
    for (int w = 1; w < kWarps; ++w) s += smem[w * cells + i];
    const int node = i / (2 * nb);
    const int stat = (i / nb) % 2;
    const int bin = i % nb;
    dst[((size_t)f * 2 * n_nodes + 2 * (node0 + node) + stat) * n_bins + bin0 +
        bin] = s;
  }
}

// out[set, i] = sum over c of partial[set, c, i], c in order; `size` is one
// set's output size.
__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, size_t size,
                                   int sets, int chunks) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= size * sets) return;
  const size_t set = j / size;
  const float* src = partial + set * chunks * size + j % size;
  float s = src[0];
  for (int c = 1; c < chunks; ++c) s += src[(size_t)c * size];
  out[j] = s;
}

int launch_histogram(const int* binned, const int* local, const float* gw,
                     const float* hw, float* out, float* partial, int N,
                     int F, int n_bins, int n_nodes, int sets, int chunks,
                     int node_tile, int bin_tile, int device, void* stream) {
  if (F <= 0 || n_bins <= 0 || n_nodes <= 0 || sets <= 0) return 0;
  if (chunks < 1 || node_tile < 1 || bin_tile < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const size_t smem =
      (size_t)kWarps * node_tile * 2 * bin_tile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int node_tiles = (n_nodes + node_tile - 1) / node_tile;
  const int bin_tiles = (n_bins + bin_tile - 1) / bin_tile;
  const dim3 grid((unsigned)chunks * sets, F, node_tiles * bin_tiles);
  cudaStream_t s = (cudaStream_t)stream;
  hist_partial_kernel<<<grid, kThreads, smem, s>>>(
      binned, local, gw, hw, chunks == 1 ? out : partial, N, F, n_bins,
      n_nodes, chunks, node_tile, bin_tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return (int)e;
  const size_t size = (size_t)F * 2 * n_nodes * n_bins;
  const int threads = 256;
  hist_reduce_kernel<<<(unsigned)((size * sets + threads - 1) / threads),
                       threads, 0, s>>>(partial, out, size, sets, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` of CUDA device `device`; `partial` holds
// chunks * F * 2 * n_nodes * n_bins floats (unused when chunks == 1). The
// wrapper (ops/fused_histogram.py launch_plan) chooses chunks and the tile
// sizes; shared memory per block is kWarps * node_tile * 2 * bin_tile floats.
// Returns cudaGetLastError() (0 = ok).
int emt_fused_histogram_f32(const int* binned, const int* local,
                            const float* gw, const float* hw, float* out,
                            float* partial, int N, int F, int n_bins,
                            int n_nodes, int chunks, int node_tile,
                            int bin_tile, int device, void* stream) {
  return launch_histogram(binned, local, gw, hw, out, partial, N, F, n_bins,
                          n_nodes, 1, chunks, node_tile, bin_tile, device,
                          stream);
}

// The same for `sets` sets on one `binned`: local, gw and hw are (sets, N),
// out is (sets, F, 2 * n_nodes, n_bins) and `partial` holds sets times the
// one-set size. `chunks`, `node_tile` and `bin_tile` are one set's plan.
int emt_fused_histogram_sets_f32(const int* binned, const int* local,
                                 const float* gw, const float* hw, float* out,
                                 float* partial, int N, int F, int n_bins,
                                 int n_nodes, int sets, int chunks,
                                 int node_tile, int bin_tile, int device,
                                 void* stream) {
  return launch_histogram(binned, local, gw, hw, out, partial, N, F, n_bins,
                          n_nodes, sets, chunks, node_tile, bin_tile, device,
                          stream);
}

const char* emt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
