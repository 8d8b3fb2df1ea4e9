// Fused peephole-LSTM backward over a whole sequence, f32 or bf16, for
// sm_90a.
//
// Replaces the Pallas TPU kernel euromillioner_tpu/ops/fused_lstm.py:175
// (_bwd_kernel, pallas_call at :270, driven by _bwd at :245). From the
// forward's residuals (hs, cs and the activated gates [i, f, g, o], as
// csrc/fused_lstm.cu writes them) and the incoming g_hs, walking time in
// reverse from zero dh/dc carries, per timestep:
//   dh  = g_hs[t] + dh_carry            tc = tanh(c)
//   do  = dh * tc * o * (1 - o)
//   dc  = dh * o * (1 - tc^2) + dc_carry (+ do * p_o)
//   di  = dc * g * i * (1 - i)          df = dc * c_prev * f * (1 - f)
//   dg  = dc * i * (1 - g^2)
//   dc_carry = dc * f (+ di * p_i + df * p_f)
//   dh_carry = [di, df, dg, do] . wh^T  (f32 accumulation)
// with c_prev = cs[t-1] (zero at t = 0). Outputs: dxp = [di, df, dg, do]
// (T, B, 4H); dwh = sum_t h_prev^T . dxp[t] (H, 4H) with h_prev = hs[t-1]
// (zero at t = 0); dpeep (4, H) = sum over (t, b) of di * c_prev,
// df * c_prev, do * c, and a zero fourth row.
//
// Element type E (float or __nv_bfloat16) is that of g_hs, hs, cs, gates,
// wh, dxp and dwh; peep and dpeep are always f32. As in the Pallas kernel
// (:175-242): the residuals and g_hs are read up to f32, the gate
// gradients, the dc carry and the dpeep sums are f32, dxp is stored
// rounded to E, the dh carry is dgates rounded to E times wh^T summed in
// f32, and dwh is the f32 sum of h_prev^T . dxp over the STORED (rounded)
// dxp, rounded to E at the end. Two C entry points, emt_lstm_bwd_f32 and
// emt_lstm_bwd_bf16, one per E.
//
// Bound at the training main-path shape B=64, T=64, H=512, f32: the dh
// carry is 2*(T-1)*B*H*4H = 8.46 GFLOP and dwh the same again (the t = 0
// terms are zero and skipped), 16.9 GFLOP on the FP32 (non-tensor) pipe,
// 0.25 ms at the H100 SXM's 67 TFLOP/s; the bytes (g_hs, hs, cs, gates, wh
// in; dxp, dwh out) are ~101 MB, ~30 us at 3.35 TB/s. So the function is
// compute-bound, and latency-bound by T-1 dependent steps.
//
// Design: three kernels and a small reduction, in stream order.
// 1. transpose: wh (H, 4H) -> wh_t (4H, H) in scratch, through a padded
//    32 x 32 shared-memory tile. The dh carry reads row k of wh for unit
//    k, which in wh's own layout is a 4H-stride walk across a warp; in
//    wh_t the warp's threads (units k..k+31) read consecutive words, the
//    same coalesced pattern as the forward kernel's wh reads.
// 2. recurrence: as in the forward kernel, one CTA owns kRows batch rows
//    and runs the whole reverse time loop (rows are independent: no
//    barrier across the grid). A thread owns hidden unit j (and
//    j + blockDim, ...) for all kRows rows. Per step it forms the gate
//    gradients of its units from the residuals, writes them to dxp and to
//    the tile's dgates in shared memory ([4H][kRows], n-major, 64 KiB at
//    H=512, so one 16-byte broadcast load gives four rows' dgates[n]),
//    then, after one __syncthreads(), computes its units' dh carry
//    sum_n dgates[r][n] * wh_t[n][k] for all kRows rows, streaming wh_t
//    from L2 (4 MiB at H=512 stays resident there). The dh and dc carries
//    and the tile's dpeep sums live in shared memory, each (row, unit)
//    touched only by its owner thread. c_prev is read in place as
//    cs[t-1]: no shifted copy. Each CTA writes its dpeep sums to a
//    partials buffer.
// 3. dwh: a tiled f32 product over the (T-1)*B rows, dwh = A^T . D with
//    A = hs[0 .. T-2] and D = dxp[1 .. T-1] read in place (h_prev is hs
//    shifted by one step). 64 x 64 output tile per CTA, 256 threads with
//    4 x 4 outputs each, 16-row slabs of A and D staged in shared memory.
// 4. dpeep: sums the per-CTA partials in CTA order.
// No float atomics anywhere: every sum has one fixed order, so two runs
// give bit-identical gradients.
//
// In bf16 at bench.py's B=2048, T=64, H=512: the bytes (g_hs, hs, cs
// 134 MB each and gates 537 MB in, dxp 537 MB out, wh and dwh 2 MiB
// each) take 0.44 ms at 3.35 TB/s, the 2 x 270 GFLOP of the dh carry and
// dwh 0.55 ms at the 989 TFLOP/s bf16 tensor-core rate: operations bound
// it. This design runs both products on the FP32 pipe (dwh as a plain
// tiled product): expect tens of milliseconds at that shape.
//
// Expected: the recurrence costs what the forward kernel does, since each
// CTA again streams 4 MiB of weights from L2 per step with B/kRows CTAs
// on the card's 132 SMs — milliseconds, not the bound. The fast design (a
// later change) splits wh across a thread-block cluster so it stays on
// chip, and uses the tensor cores for the dh carry and dwh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kRows = 8;          // batch rows per recurrence CTA
constexpr int kMaxThreads = 512;  // recurrence threads (hidden units in flight)
constexpr int kTr = 32;           // transpose tile
constexpr int kTile = 64;         // dwh output tile (units x gate columns)
constexpr int kSlab = 16;         // dwh rows staged per step
constexpr int kGemmThreads = 256;

// element loads and stores in f32, through the conversion intrinsics
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// v rounded to the element type of `like`
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// moves raw element bits (float, or unsigned short for bf16)
template <typename Bits>
__global__ void transpose_kernel(const Bits* __restrict__ in,
                                 Bits* __restrict__ out, int rows, int cols) {
  __shared__ Bits tile[kTr][kTr + 1];
  const int c0 = blockIdx.x * kTr;
  const int r0 = blockIdx.y * kTr;
  for (int i = threadIdx.y; i < kTr; i += blockDim.y) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = in[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kTr; i += blockDim.y) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < rows) out[(size_t)c * rows + r] = tile[threadIdx.x][i];
  }
}

template <typename E>
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_recurrence_kernel(const E* __restrict__ g_hs,       // (T, B, H)
                           const E* __restrict__ cs,         // (T, B, H)
                           const E* __restrict__ gates,      // (T, B, 4H)
                           const E* __restrict__ wh_t,       // (4H, H)
                           const float* __restrict__ peep,   // (4, H)
                           E* __restrict__ dxp,              // (T, B, 4H)
                           float* __restrict__ dpeep_part,   // (tiles, 3, H)
                           int T, int B, int H, int peepholes) {
  extern __shared__ __align__(16) float smem[];
  // [4H][kRows] this step's dgates, rounded to E: the dh carry's operand
  float* dgs = smem;
  float* dhc = smem + 4 * kRows * H;       // [kRows][H] dh carry
  float* dcc = dhc + kRows * H;            // [kRows][H] dc carry
  float* dps = dcc + kRows * H;            // [3][H] this tile's dpeep sums
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const size_t H4 = 4 * (size_t)H;
  const size_t step = (size_t)B * H;       // cs[t] -> cs[t-1]
  for (int n = threadIdx.x; n < (6 * kRows + 3) * H; n += blockDim.x)
    smem[n] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * B + b0;  // first (t, b) row of the tile
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float p_i = peepholes ? peep[j] : 0.f;
      const float p_f = peepholes ? peep[H + j] : 0.f;
      const float p_o = peepholes ? peep[2 * H + j] : 0.f;
      float s_i = 0.f, s_f = 0.f, s_o = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float di = 0.f, df = 0.f, dg = 0.f, dout = 0.f;
        if (r < rows) {
          const size_t hr = (row0 + r) * H + j;
          const E* gt = gates + (row0 + r) * H4;
          const float ig = ld(gt + j);
          const float fg = ld(gt + H + j);
          const float gg = ld(gt + 2 * H + j);
          const float og = ld(gt + 3 * H + j);
          const float c = ld(cs + hr);
          const float c_prev = t > 0 ? ld(cs + hr - step) : 0.f;
          const float tc = tanhf(c);
          const float dh = ld(g_hs + hr) + dhc[r * H + j];
          dout = dh * tc * og * (1.f - og);
          float dc = dh * og * (1.f - tc * tc) + dcc[r * H + j];
          if (peepholes) dc += dout * p_o;
          di = dc * gg * ig * (1.f - ig);
          df = dc * c_prev * fg * (1.f - fg);
          dg = dc * ig * (1.f - gg * gg);
          float dc_prev = dc * fg;
          if (peepholes) {
            dc_prev += di * p_i + df * p_f;
            s_i += di * c_prev;
            s_f += df * c_prev;
            s_o += dout * c;
          }
          dcc[r * H + j] = dc_prev;
          E* dx = dxp + (row0 + r) * H4;
          st(dx + j, di);
          st(dx + H + j, df);
          st(dx + 2 * H + j, dg);
          st(dx + 3 * H + j, dout);
        }
        dgs[(size_t)j * kRows + r] = round_as(di, wh_t);
        dgs[(size_t)(H + j) * kRows + r] = round_as(df, wh_t);
        dgs[(size_t)(2 * H + j) * kRows + r] = round_as(dg, wh_t);
        dgs[(size_t)(3 * H + j) * kRows + r] = round_as(dout, wh_t);
      }
      if (peepholes) {
        dps[j] += s_i;
        dps[H + j] += s_f;
        dps[2 * H + j] += s_o;
      }
    }
    if (t == 0) break;  // the carry out of step 0 is never used
    __syncthreads();    // step t's dgates are all in dgs
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const E* w = wh_t + k;
#pragma unroll 4
      for (int n = 0; n < (int)H4; ++n) {
        const float wk = ldg(w + (size_t)n * H);
        const float4 d03 = *reinterpret_cast<const float4*>(dgs + n * kRows);
        const float4 d47 =
            *reinterpret_cast<const float4*>(dgs + n * kRows + 4);
        acc[0] = fmaf(d03.x, wk, acc[0]);
        acc[1] = fmaf(d03.y, wk, acc[1]);
        acc[2] = fmaf(d03.z, wk, acc[2]);
        acc[3] = fmaf(d03.w, wk, acc[3]);
        acc[4] = fmaf(d47.x, wk, acc[4]);
        acc[5] = fmaf(d47.y, wk, acc[5]);
        acc[6] = fmaf(d47.z, wk, acc[6]);
        acc[7] = fmaf(d47.w, wk, acc[7]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dhc[r * H + k] = acc[r];
    }
    __syncthreads();  // every read of dgs is done before step t-1 rewrites it
  }
  __syncthreads();  // dps rows were written by their units' owners
  float* part = dpeep_part + (size_t)blockIdx.x * 3 * H;
  for (int n = threadIdx.x; n < 3 * H; n += blockDim.x) part[n] = dps[n];
}

// dwh[k][n] = sum_{r < R} hs[r][k] * dxp[B + r][n], R = (T-1) * B: the
// rows of step t >= 1 against h_prev = hs[t-1], both read in place and
// summed in f32; the sum is rounded to E when stored.
template <typename E>
__global__ void __launch_bounds__(kGemmThreads)
lstm_bwd_dwh_kernel(const E* __restrict__ hs, const E* __restrict__ dxp,
                    E* __restrict__ dwh, int R, int B, int H) {
  __shared__ __align__(16) float as[kSlab][kTile];
  __shared__ __align__(16) float ds[kSlab][kTile];
  const int H4 = 4 * H;
  const int n0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int tn = threadIdx.x % (kTile / 4);
  const int tk = threadIdx.x / (kTile / 4);
  const E* d = dxp + (size_t)B * H4;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int r0 = 0; r0 < R; r0 += kSlab) {
    for (int e = threadIdx.x; e < kSlab * kTile; e += kGemmThreads) {
      const int rr = e / kTile, cc = e % kTile, r = r0 + rr;
      as[rr][cc] =
          (r < R && k0 + cc < H) ? ld(hs + (size_t)r * H + k0 + cc) : 0.f;
      ds[rr][cc] =
          (r < R && n0 + cc < H4) ? ld(d + (size_t)r * H4 + n0 + cc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kSlab; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&as[rr][tk * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ds[rr][tn * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + tk * 4 + i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tn * 4 + jj;
      if (k < H && n < H4) st(dwh + (size_t)k * H4 + n, acc[i][jj]);
    }
  }
}

// dpeep rows i, f, o: the recurrence CTAs' partials summed in CTA order;
// row 3 is zero.
__global__ void lstm_bwd_dpeep_kernel(const float* __restrict__ part,
                                      float* __restrict__ dpeep, int tiles,
                                      int H) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= 4 * H) return;
  float s = 0.f;
  if (n < 3 * H)
    for (int c = 0; c < tiles; ++c) s += part[(size_t)c * 3 * H + n];
  dpeep[n] = s;
}

// Launches the four kernels for element type E on `stream` of CUDA device
// `device`; wh_t (4H * H elements of E) and dpeep_part (ceil(B / 8) * 3 *
// H floats) are scratch the caller allocates. Returns cudaGetLastError()
// (0 = ok).
template <typename E>
int launch_bwd(const E* g_hs, const E* hs, const E* cs, const E* gates,
               const E* wh, const float* peep, E* dxp, E* dwh, float* dpeep,
               E* wh_t, float* dpeep_part, int T, int B, int H, int peepholes,
               int device, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  const int H4 = 4 * H;

  using Bits = typename std::conditional<sizeof(E) == 2, unsigned short,
                                         float>::type;
  transpose_kernel<Bits><<<dim3((H4 + kTr - 1) / kTr, (H + kTr - 1) / kTr),
                           dim3(kTr, 8), 0, s>>>(
      reinterpret_cast<const Bits*>(wh), reinterpret_cast<Bits*>(wh_t), H, H4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = (6 * (size_t)kRows + 3) * H * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(lstm_bwd_recurrence_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (B + kRows - 1) / kRows;
  const int threads = std::min(kMaxThreads, ((H + 31) / 32) * 32);
  lstm_bwd_recurrence_kernel<E><<<tiles, threads, smem, s>>>(
      g_hs, cs, gates, wh_t, peep, dxp, dpeep_part, T, B, H, peepholes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  lstm_bwd_dwh_kernel<E>
      <<<dim3((H4 + kTile - 1) / kTile, (H + kTile - 1) / kTile),
         kGemmThreads, 0, s>>>(hs, dxp, dwh, (T - 1) * B, B, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  lstm_bwd_dpeep_kernel<<<(H4 + 255) / 256, 256, 0, s>>>(dpeep_part, dpeep,
                                                         tiles, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int emt_lstm_bwd_f32(const float* g_hs, const float* hs, const float* cs,
                     const float* gates, const float* wh, const float* peep,
                     float* dxp, float* dwh, float* dpeep, float* wh_t,
                     float* dpeep_part, int T, int B, int H, int peepholes,
                     int device, void* stream) {
  return launch_bwd(g_hs, hs, cs, gates, wh, peep, dxp, dwh, dpeep, wh_t,
                    dpeep_part, T, B, H, peepholes, device, stream);
}

// g_hs, hs, cs, gates, wh, dxp, dwh and wh_t are bf16; peep, dpeep and
// dpeep_part are f32
int emt_lstm_bwd_bf16(const void* g_hs, const void* hs, const void* cs,
                      const void* gates, const void* wh, const float* peep,
                      void* dxp, void* dwh, float* dpeep, void* wh_t,
                      float* dpeep_part, int T, int B, int H, int peepholes,
                      int device, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch_bwd(
      static_cast<const bf16*>(g_hs), static_cast<const bf16*>(hs),
      static_cast<const bf16*>(cs), static_cast<const bf16*>(gates),
      static_cast<const bf16*>(wh), peep, static_cast<bf16*>(dxp),
      static_cast<bf16*>(dwh), dpeep, static_cast<bf16*>(wh_t), dpeep_part,
      T, B, H, peepholes, device, stream);
}

const char* emt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
