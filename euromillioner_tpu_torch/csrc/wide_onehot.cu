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
// order, so each output element is owned by one thread, which walks its
// terms in a fixed order:
//  * K4a: thread per (row b, vector of VEC columns): f32 sums from zero,
//    positions k = 0..K-1 in order, rows read as VEC-wide vector loads (16
//    bytes when E allows). The plain version adds in the same order, so the
//    two are bit-equal.
//  * K4b, two kernels: (1) one block per position k sorts the keys
//    id * B + b of its valid rows in shared memory (bitonic; keys are
//    unique, so the order is ids ascending, batch order within an id);
//    (2) a thread per (k, sorted position, column vector) that starts a run
//    of equal ids sums that run's dh rows in batch order in f32 registers
//    and writes the row once, cast to w's dtype. Rows no example touched
//    stay as the wrapper's zeros. This is the plain version's order
//    (index_add_ of the batch in order), with no f32 scratch table and no
//    float atomics, so reruns are bit-identical.
//
// Bound. Both move bytes and do next to no arithmetic (one add per element
// read). K4a reads B*K rows of E (at most the distinct rows, at least) and
// writes B*E f32: at B=8192, K=21, E=1040 in bf16, 358 MB gathered, 179 MB
// of distinct rows at most, 34 MB written, 0.06-0.12 ms at 3.35 TB/s; at
// the serving and training batches (B <= 128) launch latency. K4b must
// write the dense (K, V, E) block: 178.9 MB in bf16 at full width, ~0.053
// ms (0.107 ms in f32), here through the wrapper's zero fill plus the
// touched rows. This design spends extra on K4b's sort (one block per
// position, log2(B)^2 / 2 passes) and on threads of the runs kernel that
// find no run to start.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kSortThreads = 1024;
constexpr int kMaxBlocks = 132 * 64;

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

// VEC consecutive elements, aligned so one load or store moves them all
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const T* __restrict__ w,      // (K, V, E)
                const int* __restrict__ ids,  // (B, K)
                float* __restrict__ out,      // (B, E)
                int B, int K, int V, int E) {
  const int nvec = E / VEC;
  const long long total = (long long)B * nvec;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(t / nvec);
    const int c = (int)(t % nvec) * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    const int* row_ids = ids + (size_t)b * K;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int id = __ldg(row_ids + k);
      if (id < 0 || id >= V) continue;
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
          w + ((size_t)k * V + id) * E + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += to_f32(p.v[j]);
    }
    float* o = out + (size_t)b * E + c;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = acc[j];
  }
}

// keys[k, :] = the valid rows' id * B + b in ascending order, INT_MAX after
// them; n is the power of two at or above B that the sort runs over
__global__ void __launch_bounds__(kSortThreads)
wide_dw_sort_kernel(const int* __restrict__ ids,  // (B, K)
                    int* __restrict__ keys,       // (K, B)
                    int B, int K, int V, int n) {
  extern __shared__ int s[];
  const int k = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int key = INT_MAX;
    if (i < B) {
      const int id = ids[(size_t)i * K + k];
      if (id >= 0 && id < V) key = id * B + i;
    }
    s[i] = key;
  }
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const int a = s[i];
          const int c = s[j];
          const bool up = (i & size) == 0;
          if ((a > c) == up) {
            s[i] = c;
            s[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    keys[(size_t)k * B + i] = s[i];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
wide_dw_runs_kernel(const int* __restrict__ keys,  // (K, B) sorted
                    const T* __restrict__ dh,      // (B, E)
                    T* __restrict__ dw,            // (K, V, E), zeroed
                    int B, int K, int V, int E) {
  const int nvec = E / VEC;
  const long long total = (long long)K * B * nvec;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(t % nvec) * VEC;
    const long long kb = t / nvec;
    const int i = (int)(kb % B);
    const int k = (int)(kb / B);
    const int* ks = keys + (size_t)k * B;
    const int key = ks[i];
    if (key == INT_MAX) continue;
    const int id = key / B;
    // keys ascend, so the one before a valid key is valid too
    if (i > 0 && ks[i - 1] / B == id) continue;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int r = i; r < B; ++r) {
      const int kr = ks[r];
      if (kr == INT_MAX || kr / B != id) break;
      const int b = kr - id * B;
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(dh + (size_t)b * E + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += to_f32(p.v[j]);
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(acc[j]);
    *reinterpret_cast<Pack<T, VEC>*>(dw + ((size_t)k * V + id) * E + c) = o;
  }
}

unsigned blocks_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* w, const int* ids, float* out, int B,
                       int K, int V, int E, cudaStream_t s) {
  const long long total = (long long)B * (E / VEC);
  wide_fwd_kernel<T, VEC><<<blocks_for(total), kThreads, 0, s>>>(
      static_cast<const T*>(w), ids, out, B, K, V, E);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_runs(const int* keys, const void* dh, void* dw, int B,
                        int K, int V, int E, cudaStream_t s) {
  const long long total = (long long)K * B * (E / VEC);
  wide_dw_runs_kernel<T, VEC><<<blocks_for(total), kThreads, 0, s>>>(
      keys, static_cast<const T*>(dh), static_cast<T*>(dw), B, K, V, E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16; vec is the column vector width, which
// the wrapper picks to divide E and the pointers' alignment.
//
// K4a on `stream` of CUDA device `device`. Returns cudaGetLastError()
// (0 = ok); an unsupported (dtype, vec) pair is cudaErrorInvalidValue.
int emt_wide_onehot_fwd(const void* w, const int* ids, float* out, int B,
                        int K, int V, int E, int dtype, int vec, int device,
                        void* stream) {
  if (B <= 0 || E <= 0) return 0;
  if (E % vec) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (vec) {
      case 4: return (int)launch_fwd<float, 4>(w, ids, out, B, K, V, E, s);
      case 2: return (int)launch_fwd<float, 2>(w, ids, out, B, K, V, E, s);
      case 1: return (int)launch_fwd<float, 1>(w, ids, out, B, K, V, E, s);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 8:
        return (int)launch_fwd<__nv_bfloat16, 8>(w, ids, out, B, K, V, E, s);
      case 4:
        return (int)launch_fwd<__nv_bfloat16, 4>(w, ids, out, B, K, V, E, s);
      case 2:
        return (int)launch_fwd<__nv_bfloat16, 2>(w, ids, out, B, K, V, E, s);
      case 1:
        return (int)launch_fwd<__nv_bfloat16, 1>(w, ids, out, B, K, V, E, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// K4b on `stream` of CUDA device `device`: `dw` (K, V, E) must hold zeros;
// `keys` is (K, B) int32 scratch. The sort keeps pow2(B) ints in shared
// memory, so B <= 32768 and V * B < 2^31 (the wrapper checks both).
int emt_wide_onehot_dw(const int* ids, const void* dh, void* dw, int* keys,
                       int B, int K, int V, int E, int dtype, int vec,
                       int device, void* stream) {
  if (B <= 0 || K <= 0 || E <= 0) return 0;
  if (E % vec || B > 32768) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  int n = 1;
  while (n < B) n <<= 1;
  const size_t smem = (size_t)n * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wide_dw_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wide_dw_sort_kernel<<<K, kSortThreads, smem, s>>>(ids, keys, B, K, V, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0) {
    switch (vec) {
      case 4: return (int)launch_runs<float, 4>(keys, dh, dw, B, K, V, E, s);
      case 2: return (int)launch_runs<float, 2>(keys, dh, dw, B, K, V, E, s);
      case 1: return (int)launch_runs<float, 1>(keys, dh, dw, B, K, V, E, s);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 8:
        return (int)launch_runs<__nv_bfloat16, 8>(keys, dh, dw, B, K, V, E, s);
      case 4:
        return (int)launch_runs<__nv_bfloat16, 4>(keys, dh, dw, B, K, V, E, s);
      case 2:
        return (int)launch_runs<__nv_bfloat16, 2>(keys, dh, dw, B, K, V, E, s);
      case 1:
        return (int)launch_runs<__nv_bfloat16, 1>(keys, dh, dw, B, K, V, E, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* emt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
