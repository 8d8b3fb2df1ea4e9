// Fused peephole-LSTM forward over a whole sequence, f32 or bf16, for
// sm_90a.
//
// Replaces the Pallas TPU kernel euromillioner_tpu/ops/fused_lstm.py:88
// (_fwd_kernel, driven by _fwd at :130). From a zero carry, per timestep:
//   gates = x_proj[t] + h_prev . wh          (f32 accumulation)
//   i = sig(i_pre + c_prev * p_i)   f = sig(f_pre + c_prev * p_f)
//   g = tanh(g_pre)                 c = f * c_prev + i * g
//   o = sig(o_pre + c * p_o)        h = o * tanh(c)
// with gates in the order i, f, g, o. hs is always written; cs and the
// activated gates [i, f, g, o] only when their pointers are non-null (the
// training residuals — serving passes null and skips those writes).
//
// Element type E (float or __nv_bfloat16) is that of x_proj, wh, hs, cs
// and gates; peep is always f32. As in the Pallas kernel, everything in
// between is f32: x_proj[t] is read up to f32, the (h, c) carry stays f32
// on chip, the gate math and peepholes are f32, and the recurrent product
// takes h_prev rounded to E (the h buffer holds that rounded value) times
// wh in E, summed in f32. hs, cs and gates are rounded to E when stored.
// Two C entry points, emt_lstm_fwd_f32 and emt_lstm_fwd_bf16, one per E.
//
// Design. Batch rows are independent, so each CTA owns a tile of kRows
// batch rows and runs the whole time loop itself: no barrier across the
// grid. The tile's h carry lives in shared memory, double-buffered
// ([2][H][kRows], k-major so one 16-byte broadcast load gives four rows'
// h[k]); the c carry lives in shared memory too, but each (row, unit) is
// read and written by one thread only. A thread owns hidden unit j (and
// j + blockDim, ...) for all kRows rows: per k it loads the four gate
// weights wh[k, {0,1,2,3}H + j] once (coalesced across the warp, served
// from L2, where the 4 MiB of wh at H=512 stays resident) and does
// 4 x kRows FMAs with them. The recurrent product h_prev . wh is thus the
// kernel's own loop, not a library GEMM between launches. One
// __syncthreads() per step: step t reads h buffer t&1 and writes the
// other, so the barrier after step t both publishes h_t and retires every
// read of the buffer step t+1 overwrites.
//
// Bound at the serving main-path shape B=128, T=64, H=512, f32: the work
// is 2*T*B*H*4H = 17.2 GFLOP on the FP32 (non-tensor) pipe, 0.26 ms at the
// H100 SXM's 67 TFLOP/s; the bytes (x_proj in, wh, hs out) are ~88 MB,
// ~26 us at 3.35 TB/s. So the function is compute-bound, and latency-bound
// by 64 dependent steps. THIS design is bound by neither: B/kRows = 16
// CTAs use 16 of 132 SMs, and each re-reads all of wh from L2 every step
// (16 x 64 x 4 MiB), so per step one SM does 4*kRows*H*H FMAs and pulls
// 4 MiB from L2 — both ~65k SM cycles. Expect milliseconds, not the bound.
// The fast design (a later change) splits wh across a thread-block
// cluster so it stays on chip, and uses the tensor cores.
//
// In bf16 at bench.py's training shape B=2048, T=64, H=512 with the
// residuals written, the bytes (x_proj in 537 MB, gates 537 MB, hs and cs
// 134 MB each out) take 0.40 ms at 3.35 TB/s and the 275 GFLOP product
// 0.28 ms at the 989 TFLOP/s bf16 tensor-core rate: bytes bound it. This
// design halves the L2 stream (wh is 2 MiB in bf16) but still runs the
// product on the FP32 pipe, 256 CTAs of 8 rows in two waves: expect
// several milliseconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kRows = 8;          // batch rows per CTA
constexpr int kMaxThreads = 512;  // threads per CTA (hidden units in flight)

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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
// v rounded to the element type of `like` (the recurrent product's operand)
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename E>
__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const E* __restrict__ x_proj,      // (T, B, 4H)
                const E* __restrict__ wh,          // (H, 4H)
                const float* __restrict__ peep,    // (4, H): i, f, o, pad
                E* __restrict__ hs,                // (T, B, H)
                E* __restrict__ cs,                // (T, B, H) or null
                E* __restrict__ gates,             // (T, B, 4H) or null
                int T, int B, int H, int peepholes) {
  extern __shared__ __align__(16) float smem[];
  float* hbuf0 = smem;                  // [H][kRows]
  float* hbuf1 = smem + kRows * H;      // [H][kRows]
  float* cbuf = smem + 2 * kRows * H;   // [kRows][H]
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const size_t H4 = 4 * (size_t)H;
  for (int n = threadIdx.x; n < 3 * kRows * H; n += blockDim.x) smem[n] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hprev = (t & 1) ? hbuf1 : hbuf0;
    float* hnext = (t & 1) ? hbuf0 : hbuf1;
    const size_t row0 = (size_t)t * B + b0;  // first (t, b) row of the tile
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float ai[kRows], af[kRows], ag[kRows], ao[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) ai[r] = af[r] = ag[r] = ao[r] = 0.f;
      const E* w = wh + j;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const E* wk = w + (size_t)k * H4;
        const float wi = ldg(wk);
        const float wf = ldg(wk + H);
        const float wg = ldg(wk + 2 * H);
        const float wo = ldg(wk + 3 * H);
        const float4 h03 = *reinterpret_cast<const float4*>(hprev + k * kRows);
        const float4 h47 =
            *reinterpret_cast<const float4*>(hprev + k * kRows + 4);
        const float hk[kRows] = {h03.x, h03.y, h03.z, h03.w,
                                 h47.x, h47.y, h47.z, h47.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          ai[r] = fmaf(hk[r], wi, ai[r]);
          af[r] = fmaf(hk[r], wf, af[r]);
          ag[r] = fmaf(hk[r], wg, ag[r]);
          ao[r] = fmaf(hk[r], wo, ao[r]);
        }
      }
      const float p_i = peepholes ? peep[j] : 0.f;
      const float p_f = peepholes ? peep[H + j] : 0.f;
      const float p_o = peepholes ? peep[2 * H + j] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const E* xp = x_proj + (row0 + r) * H4;
          float i_pre = ld(xp + j) + ai[r];
          float f_pre = ld(xp + H + j) + af[r];
          const float g_pre = ld(xp + 2 * H + j) + ag[r];
          float o_pre = ld(xp + 3 * H + j) + ao[r];
          const float c_prev = cbuf[r * H + j];
          if (peepholes) {
            i_pre += c_prev * p_i;
            f_pre += c_prev * p_f;
          }
          const float ig = sigmoid_f(i_pre);
          const float fg = sigmoid_f(f_pre);
          const float gg = tanhf(g_pre);
          const float c = fg * c_prev + ig * gg;
          if (peepholes) o_pre += c * p_o;
          const float og = sigmoid_f(o_pre);
          const float h = og * tanhf(c);
          cbuf[r * H + j] = c;
          hnext[j * kRows + r] = round_as(h, wh);
          const size_t out = (row0 + r) * H + j;
          st(hs + out, h);
          if (cs != nullptr) st(cs + out, c);
          if (gates != nullptr) {
            E* gt = gates + (row0 + r) * H4;
            st(gt + j, ig);
            st(gt + H + j, fg);
            st(gt + 2 * H + j, gg);
            st(gt + 3 * H + j, og);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Launches lstm_fwd_kernel<E> on `stream` of CUDA device `device` (this
// library links its own CUDA runtime, whose current device is not the
// caller's); returns cudaGetLastError() (0 = ok).
template <typename E>
int launch_fwd(const E* x_proj, const E* wh, const float* peep, E* hs,
               E* cs, E* gates, int T, int B, int H, int peepholes,
               int device, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const size_t smem = 3 * (size_t)kRows * H * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_fwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = std::min(kMaxThreads, ((H + 31) / 32) * 32);
  const int grid = (B + kRows - 1) / kRows;
  lstm_fwd_kernel<E><<<grid, threads, smem, (cudaStream_t)stream>>>(
      x_proj, wh, peep, hs, cs, gates, T, B, H, peepholes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int emt_lstm_fwd_f32(const float* x_proj, const float* wh, const float* peep,
                     float* hs, float* cs, float* gates, int T, int B, int H,
                     int peepholes, int device, void* stream) {
  return launch_fwd(x_proj, wh, peep, hs, cs, gates, T, B, H, peepholes,
                    device, stream);
}

// x_proj, wh, hs, cs and gates are bf16; peep is f32
int emt_lstm_fwd_bf16(const void* x_proj, const void* wh, const float* peep,
                      void* hs, void* cs, void* gates, int T, int B, int H,
                      int peepholes, int device, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch_fwd(static_cast<const bf16*>(x_proj),
                    static_cast<const bf16*>(wh), peep,
                    static_cast<bf16*>(hs), static_cast<bf16*>(cs),
                    static_cast<bf16*>(gates), T, B, H, peepholes, device,
                    stream);
}

const char* emt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
