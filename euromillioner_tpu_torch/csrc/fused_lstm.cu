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
// takes h_prev rounded to E times wh in E, summed in f32. hs, cs and gates
// are rounded to E when stored. Two C entry points, emt_lstm_fwd_f32 and
// emt_lstm_fwd_bf16, one per E.
//
// Bound. At the serving main-path shape B=128, T=64, H=512, f32: the
// product is 2*T*B*H*4H = 17.2 GFLOP on the FP32 (non-tensor) pipe, 0.26
// ms at the H100 SXM's 67 TFLOP/s; the bytes (x_proj in, wh, hs out) are
// ~88 MB, ~26 us at 3.35 TB/s: operations bound it, and 64 dependent
// steps. In bf16 at bench.py's training shape B=2048, T=64, H=512 with the
// residuals written, the bytes (x_proj in 537 MB, gates 537 MB, hs and cs
// 134 MB each out) take 0.40 ms at 3.35 TB/s and the 275 GFLOP product
// 0.28 ms on the tensor cores (989 TFLOP/s): bytes bound it.
//
// Design (ops/fused_lstm.lstm_plan gives every size). Batch rows are
// independent, so a batch tile of `rows` rows runs the whole time loop on
// one thread-block cluster of C CTAs (C = 16 at H = 512, a non-portable
// cluster size), with no barrier across the grid. wh is split over the
// cluster by hidden unit: CTA c owns units [c*U, (c+1)*U) and computes all
// four gates of each, so its operand B is the 4U columns of wh for its
// units (K = H deep), kept in shared memory for the whole call (resident:
// 128 KiB at H=512 in bf16) or, where that does not fit (f32 at H=512: 256
// KiB), streamed from L2 in k-tiles through a ring of cp.async stages.
// Per step:
//   1. A = h_{t-1} (rows x H, rounded to E): the rows of hs[t-1] that the
//      cluster's CTAs wrote before the last cluster barrier, read back
//      from L2 with cp.async (the barrier's release/acquire orders the
//      writes before the reads). hs must be written anyway, so the
//      exchange needs no copy of h kept in shared memory for the peers;
//      pulling it from the peers' shared memory over DSMEM is the
//      alternative, not measured by a committed script (PERF.md §7). The
//      cluster gives the CTAs co-scheduling and its hardware barrier;
//   2. product: bf16 on the tensor cores (mma.sync m16n8k16, f32 sums;
//      one warp per 16-row x 8-unit tile, its four gates), f32 as FP32
//      FMAs (a thread owns 8 rows x 1 unit x 4 gates; where that leaves
//      the SM under-filled, `splits` thread groups split the depth and
//      add in a fixed order through shared memory);
//   3. gate epilogue in registers for the thread's own (row, unit) cells,
//      c carry in registers, x_proj[t] loaded into registers one step
//      ahead (issued before the barrier, used after the product);
//   4. hs/cs/gates to memory (rows past B and padded units masked; bf16
//      staged through shared memory into 16-byte stores), then one
//      cluster barrier.
// No float atomics: every sum has one fixed order, so reruns are
// bit-identical. The earlier design (one 8-row CTA streaming all of wh
// from L2 every step on the FP32 pipe) is what this replaces.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kWarpsBf16 = 16;  // a bf16 CTA: one warp per 16 x 8 tile

// mirrors ops/fused_lstm.Plan (the forward's fields)
struct Plan {
  int cluster, rows, units, kpad, ktile, slots, splits, threads, smem;
};

// shared-memory byte offsets of one CTA, as ops/fused_lstm._smem counts
struct Layout {
  size_t a, w, own, red, total;
};

__host__ __device__ inline Layout layout(const Plan& p, bool is_bf16) {
  Layout L;
  const size_t u4 = 4 * (size_t)p.units, es = is_bf16 ? 2 : 4;
  size_t off = 0;
  L.a = off;  // h_prev: bf16 [rows][kpad + 8], f32 [rows][kpad]
  off += es * p.rows * (size_t)(p.kpad + (is_bf16 ? 8 : 0));
  L.w = off;  // weight tiles [slots][ktile][4U]
  off += es * p.slots * (size_t)p.ktile * u4;
  L.own = off;  // bf16: the step's h [rows][U], staged for 16-byte stores
  off += is_bf16 ? es * (size_t)p.rows * p.units : 0;
  L.red = off;  // f32 split partials [splits - 1][rows][4U]; bf16: the
               // step's c and gates [rows][5U], staged for 16-byte stores
  off += is_bf16 ? es * (size_t)p.rows * 5 * p.units
                 : 4 * (size_t)(p.splits - 1) * p.rows * u4;
  L.total = off;
  return L;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
template <typename E>
__device__ __forceinline__ E zero_e() {
  return E(0);
}
template <>
__device__ __forceinline__ bf16 zero_e<bf16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0 .. 6) groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the bf16 weight tile's 16-byte chunk `ch` of row `k`, XOR-swizzled so
// that ldmatrix's eight rows of one chunk column hit eight bank groups
__device__ __forceinline__ int swz(int k, int ch, int chunks) {
  return ch ^ (k & ((chunks & 7) == 0 ? 7 : 3));
}

// k-tile `kt` of this CTA's weight slice into `dst` [ktile][4U]: row k,
// column g*U + u is wh[k][g*H + c0 + u], zero past H (k or unit)
template <typename E>
__device__ void load_wtile(E* dst, const E* __restrict__ wh, int kt,
                           const Plan& p, int H, int c0, bool aligned) {
  constexpr int per = 16 / sizeof(E);
  const int U = p.units, u4 = 4 * U, chunks = u4 / per;
  const size_t H4 = 4 * (size_t)H;
  for (int i = threadIdx.x; i < p.ktile * chunks; i += blockDim.x) {
    const int kk = i / chunks, ch = i % chunks;
    const int k = kt * p.ktile + kk;
    const int n = ch * per, g = n / U, col = c0 + n % U;
    const int pch = sizeof(E) == 2 ? swz(kk, ch, chunks) : ch;
    E* d = dst + (size_t)kk * u4 + pch * per;
    const E* src = wh + (size_t)k * H4 + (size_t)g * H + col;
    if (k < H && aligned && col + per <= H) {
      cp_async16(d, src);
    } else {
      for (int e = 0; e < per; ++e)
        d[e] = (k < H && col + e < H) ? src[e] : zero_e<E>();
    }
  }
}

// The ring of weight tiles: resident (all tiles loaded once, before the
// time loop) or streamed (slots of a continuous sequence of tiles, step
// after step, one tile in flight per slot beyond the current one).
template <typename E>
struct WeightRing {
  E* base;
  const E* wh;
  const Plan* p;
  int H, c0, ntk;
  bool aligned, resident;
  long long next, end;  // streamed: the next tile to compute, the last

  __device__ void start(int T) {
    if (resident) {
      for (int kt = 0; kt < ntk; ++kt)
        load_wtile(base + (size_t)kt * p->ktile * 4 * p->units, wh, kt, *p,
                   H, c0, aligned);
      cp_async_commit();
      cp_async_wait(0);
      __syncthreads();
      return;
    }
    next = 0;
    end = (long long)T * ntk;
    for (int q = 0; q < p->slots - 1; ++q) {
      if (q < end) issue(q);
      cp_async_commit();
    }
  }
  __device__ void issue(long long j) {
    load_wtile(base + (size_t)(j % p->slots) * p->ktile * 4 * p->units, wh,
               (int)(j % ntk), *p, H, c0, aligned);
  }
  // the tile kt of this step, ready for every thread of the CTA
  __device__ const E* acquire(int kt) {
    if (resident) return base + (size_t)kt * p->ktile * 4 * p->units;
    cp_async_wait(p->slots - 2);
    __syncthreads();  // the slot refilled below was last read by tile next-1
    const long long ahead = next + p->slots - 1;
    if (ahead < end) issue(ahead);
    cp_async_commit();
    const E* tile = base + (size_t)(next % p->slots) * p->ktile * 4 * p->units;
    ++next;
    return tile;
  }
};

// ---------------------------------------------------------------- bf16 ---

// A = h_{t-1}: the tile's rows of hs[t-1] (all H units, rounded to E), which
// the cluster's CTAs wrote before the last cluster barrier, read from L2
// with cp.async into shared memory (row stride lda), rows past B skipped
template <typename E>
__device__ void gather_h(E* A, int lda, const E* __restrict__ hs, int t,
                         int B, int H, int b0, int rows, bool aligned) {
  constexpr int per = 16 / sizeof(E);
  const int chunks = (H + per - 1) / per;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, k = (i % chunks) * per;
    if (b0 + r >= B) continue;
    const E* src = hs + ((size_t)t * B + b0 + r) * H + k;
    E* dst = A + (size_t)r * lda + k;
    if (aligned && k + per <= H) {
      cp_async16(dst, src);
    } else {
      for (int e = 0; e < per && k + e < H; ++e) dst[e] = __ldcg(src + e);
    }
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
}

// parts [first, last) of step t's output rows of this CTA's units, 16
// bytes a store: 0 h (from `own`), 1 c, 2..5 the gates i, f, g, o (from
// `stage`); rows past B and units past H masked
__device__ void store_staged(int t, const bf16* own, const bf16* stage,
                             bf16* hs, bf16* cs, bf16* gates, int B, int H,
                             int b0, int c0, int rows, int U, int first,
                             int last, bool aligned) {
  const size_t H4 = 4 * (size_t)H;
  const int cpu = U / 8, row_chunks = (last - first) * cpu;
  for (int i = threadIdx.x; i < rows * row_chunks; i += blockDim.x) {
    const int row = i / row_chunks, q = i % row_chunks, b = b0 + row;
    const int part = first + q / cpu, u = (q % cpu) * 8, unit = c0 + u;
    if (b >= B || unit >= H) continue;
    const bf16* src = part == 0 ? own + (size_t)row * U + u
                                : stage + (size_t)row * 5 * U +
                                      (part - 1) * U + u;
    bf16* dst = part == 0 ? hs + ((size_t)t * B + b) * H + unit
                : part == 1 ? cs + ((size_t)t * B + b) * H + unit
                            : gates + ((size_t)t * B + b) * H4 +
                                  (size_t)(part - 2) * H + unit;
    if (aligned && unit + 8 <= H) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && unit + e < H; ++e) dst[e] = src[e];
    }
  }
}

__device__ void fwd_bf16(const bf16* __restrict__ x_proj,
                         const bf16* __restrict__ wh,
                         const float* __restrict__ peep, bf16* hs,
                         bf16* __restrict__ cs, bf16* __restrict__ gates,
                         int T, int B, int H, int peepholes, const Plan& p,
                         bool aligned, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout(p, true);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int U = p.units, u4 = 4 * U;
  const int c0 = (int)cluster.block_rank() * U;
  const int b0 = (blockIdx.x / p.cluster) * p.rows;
  const size_t H4 = 4 * (size_t)H;
  const int lda = p.kpad + 8;
  bf16* A = reinterpret_cast<bf16*>(smem + L.a);        // [rows][lda]
  bf16* own = reinterpret_cast<bf16*>(smem + L.own);    // [rows][U]: h_t
  bf16* stage = reinterpret_cast<bf16*>(smem + L.red);  // [rows][5U]: c, gates

  for (size_t i = tid; i < L.total / 16; i += nthr)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  WeightRing<bf16> ring{reinterpret_cast<bf16*>(smem + L.w), wh, &p, H, c0,
                        p.kpad / p.ktile, aligned,
                        p.slots == p.kpad / p.ktile, 0, 0};
  ring.start(T);

  // this warp's tile and this thread's cells: rows rA, rA + 8, units
  // uA, uA + 1 (local), all four gates — the mma accumulator layout
  const int rblocks = p.rows / 16;
  const bool active = warp < rblocks * (U / 8);
  const int r0 = (warp % rblocks) * 16, u0 = (warp / rblocks) * 8;
  const int rA = r0 + (lane >> 2), uA = u0 + 2 * (lane & 3);
  const int chunks = u4 / 8;
  float c[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float pi[2], pf[2], po[2];
  for (int u = 0; u < 2; ++u) {
    const int unit = c0 + uA + u;
    const bool ok = active && peepholes && unit < H;
    pi[u] = ok ? peep[unit] : 0.f;
    pf[u] = ok ? peep[H + unit] : 0.f;
    po[u] = ok ? peep[2 * H + unit] : 0.f;
  }
  float x[2][2][4];
  auto fetch_x = [&](int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int b = b0 + rA + 8 * r, unit = c0 + uA + u;
        const bool ok = active && t < T && b < B && unit < H;
        const bf16* xp = x_proj + ((size_t)t * B + b) * H4 + unit;
#pragma unroll
        for (int g = 0; g < 4; ++g) x[r][u][g] = ok ? ld(xp + g * H) : 0.f;
      }
  };
  fetch_x(0);

  const uint32_t a_base = smem_addr(A);
  for (int t = 0; t < T; ++t) {
    if (t > 0) gather_h(A, lda, hs, t - 1, B, H, b0, p.rows, aligned);

    float acc[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
    for (int kt = 0; kt < ring.ntk; ++kt) {
      const bf16* W = ring.acquire(kt);
      if (!active) continue;
      const uint32_t w_base = smem_addr(W);
      for (int kk = 0; kk < p.ktile; kk += 16) {
        const int mi = lane >> 3;
        uint32_t a[4];
        ldsm_x4(a, a_base + 2u * (uint32_t)((r0 + (lane & 7) + (mi & 1) * 8) *
                                                lda +
                                            kt * p.ktile + kk +
                                            (mi >> 1) * 8));
        const int krow = kk + (mi & 1) * 8 + (lane & 7);
#pragma unroll
        for (int gp = 0; gp < 2; ++gp) {
          const int ch = ((2 * gp + (mi >> 1)) * U + u0) / 8;
          uint32_t b[4];
          ldsm_x4_t(b, w_base + 2u * (uint32_t)(krow * u4 +
                                                swz(krow, ch, chunks) * 8));
          mma_bf16(acc[2 * gp], a, b[0], b[1]);
          mma_bf16(acc[2 * gp + 1], a, b[2], b[3]);
        }
      }
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = rA + 8 * r, unit = c0 + uA + u;
          const int e = 2 * r + u;
          float i_pre = x[r][u][0] + acc[0][e];
          float f_pre = x[r][u][1] + acc[1][e];
          const float g_pre = x[r][u][2] + acc[2][e];
          float o_pre = x[r][u][3] + acc[3][e];
          const float c_prev = c[r][u];
          if (peepholes) {
            i_pre += c_prev * pi[u];
            f_pre += c_prev * pf[u];
          }
          const float ig = sigmoid_f(i_pre);
          const float fg = sigmoid_f(f_pre);
          const float gg = tanhf(g_pre);
          const float cn = fg * c_prev + ig * gg;
          if (peepholes) o_pre += cn * po[u];
          const float og = sigmoid_f(o_pre);
          const float h = og * tanhf(cn);
          c[r][u] = cn;
          own[(size_t)row * U + uA + u] = __float2bfloat16(unit < H ? h : 0.f);
          bf16* sg = stage + (size_t)row * 5 * U + uA + u;
          sg[0] = __float2bfloat16(cn);
          sg[U] = __float2bfloat16(ig);
          sg[2 * U] = __float2bfloat16(fg);
          sg[3 * U] = __float2bfloat16(gg);
          sg[4 * U] = __float2bfloat16(og);
        }
    }
    fetch_x(t + 1);
    __syncthreads();
    // hs of step t, which the cluster reads back, before the barrier; cs
    // and the gates after it (the next epilogue rewrites the stage only
    // after the next product)
    store_staged(t, own, stage, hs, cs, gates, B, H, b0, c0, p.rows, U, 0, 1,
                 aligned);
    cluster.sync();
    if (gates != nullptr)
      store_staged(t, own, stage, hs, cs, gates, B, H, b0, c0, p.rows, U, 1,
                   6, aligned);
  }
}

// ----------------------------------------------------------------- f32 ---

__device__ void fwd_f32(const float* __restrict__ x_proj,
                        const float* __restrict__ wh,
                        const float* __restrict__ peep, float* hs,
                        float* __restrict__ cs, float* __restrict__ gates,
                        int T, int B, int H, int peepholes, const Plan& p,
                        bool aligned, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout(p, false);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int U = p.units, u4 = 4 * U, rows = p.rows, rgs = rows / 8;
  const int c0 = (int)cluster.block_rank() * U;
  const int b0 = (blockIdx.x / p.cluster) * rows;
  const size_t H4 = 4 * (size_t)H;
  const int lda = p.kpad;
  float* A = reinterpret_cast<float*>(smem + L.a);      // [rows][kpad]
  float* red = reinterpret_cast<float*>(smem + L.red);  // [splits-1][rows][4U]

  for (size_t i = tid; i < L.total / 16; i += nthr)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  WeightRing<float> ring{reinterpret_cast<float*>(smem + L.w), wh, &p, H, c0,
                         p.kpad / p.ktile, aligned,
                         p.slots == p.kpad / p.ktile, 0, 0};
  ring.start(T);

  // this thread: unit u, rows rg*8 .. rg*8+7, depth group s
  const int u = tid % U, rg = (tid / U) % rgs, s = tid / (U * rgs);
  const int unit = c0 + u;
  const bool vu = unit < H, lead = s == 0;
  const int kper = p.ktile / p.splits;
  const float pi = (lead && vu && peepholes) ? peep[unit] : 0.f;
  const float pf = (lead && vu && peepholes) ? peep[H + unit] : 0.f;
  const float po = (lead && vu && peepholes) ? peep[2 * H + unit] : 0.f;
  float c[8];
  float x[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = 0.f;
  auto fetch_x = [&](int t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = b0 + rg * 8 + i;
      const bool ok = lead && vu && t < T && b < B;
      const float* xp = x_proj + ((size_t)t * B + b) * H4 + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[i][g] = ok ? xp[g * H] : 0.f;
    }
  };
  fetch_x(0);

  for (int t = 0; t < T; ++t) {
    if (t > 0) gather_h(A, lda, hs, t - 1, B, H, b0, rows, aligned);

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
    for (int kt = 0; kt < ring.ntk; ++kt) {
      const float* W = ring.acquire(kt);
      // four k a round: one float4 of h per row, 4 x 4 weights
      for (int kk = s * kper; kk < (s + 1) * kper; kk += 4) {
        const float* a = A + (size_t)rg * 8 * lda + kt * p.ktile + kk;
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(a + (size_t)i * lda);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* w = W + (size_t)(kk + j) * u4 + u;
          const float wv[4] = {w[0], w[U], w[2 * U], w[3 * U]};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float h = j == 0 ? av[i].x : j == 1 ? av[i].y
                            : j == 2 ? av[i].z : av[i].w;
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[i][g] = fmaf(h, wv[g], acc[i][g]);
          }
        }
      }
    }
    if (p.splits > 1) {
      if (!lead) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            red[((size_t)(s - 1) * rows + rg * 8 + i) * u4 + g * U + u] =
                acc[i][g];
      }
      __syncthreads();
      if (lead) {
        for (int q = 0; q < p.splits - 1; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int g = 0; g < 4; ++g)
              acc[i][g] += red[((size_t)q * rows + rg * 8 + i) * u4 + g * U + u];
      }
    }

    if (lead) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = b0 + rg * 8 + i;
        float i_pre = x[i][0] + acc[i][0];
        float f_pre = x[i][1] + acc[i][1];
        const float g_pre = x[i][2] + acc[i][2];
        float o_pre = x[i][3] + acc[i][3];
        const float c_prev = c[i];
        if (peepholes) {
          i_pre += c_prev * pi;
          f_pre += c_prev * pf;
        }
        const float ig = sigmoid_f(i_pre);
        const float fg = sigmoid_f(f_pre);
        const float gg = tanhf(g_pre);
        const float cn = fg * c_prev + ig * gg;
        if (peepholes) o_pre += cn * po;
        const float og = sigmoid_f(o_pre);
        const float h = og * tanhf(cn);
        c[i] = cn;
        if (b < B && vu) {
          const size_t out = ((size_t)t * B + b) * H + unit;
          hs[out] = h;
          if (cs != nullptr) cs[out] = cn;
          if (gates != nullptr) {
            float* gt = gates + ((size_t)t * B + b) * H4 + unit;
            gt[0] = ig;
            gt[H] = fg;
            gt[2 * H] = gg;
            gt[3 * H] = og;
          }
        }
      }
    }
    fetch_x(t + 1);
    // h_t of the whole tile is in hs; A and red may be rewritten
    cluster.sync();
  }
}

// f32 CTAs run at most 256 threads (the plan keeps them there), so a
// thread may hold its 8 x 4 accumulators and prefetched x_proj unspilled
template <typename E>
__global__ void __launch_bounds__(sizeof(E) == 2 ? kMaxThreads : 256)
lstm_fwd_kernel(const E* __restrict__ x_proj,   // (T, B, 4H)
                const E* __restrict__ wh,       // (H, 4H)
                const float* __restrict__ peep,  // (4, H): i, f, o, pad
                E* hs,                           // (T, B, H), read back
                E* __restrict__ cs,              // (T, B, H) or null
                E* __restrict__ gates,           // (T, B, 4H) or null
                int T, int B, int H, int peepholes, Plan p, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (sizeof(E) == 2)
    fwd_bf16(x_proj, wh, peep, hs, cs, gates, T, B, H, peepholes, p,
             aligned != 0, smem);
  else
    fwd_f32(x_proj, wh, peep, hs, cs, gates, T, B, H, peepholes, p,
            aligned != 0, smem);
}

// cudaErrorInvalidValue unless the plan is one this source lays out as
// ops/fused_lstm.lstm_plan does (same shared memory, threads and ring)
template <typename E>
int check_plan(const Plan& p) {
  const bool is_bf16 = sizeof(E) == 2;
  const bool ok =
      p.cluster >= 1 && p.cluster <= 16 && p.units > 0 && p.units % 8 == 0 &&
      p.rows > 0 && p.rows % (is_bf16 ? 16 : 8) == 0 && p.rows <= 64 &&
      p.ktile > 0 && p.ktile % 16 == 0 && p.kpad % p.ktile == 0 &&
      p.kpad >= p.cluster * p.units &&
      (p.slots == p.kpad / p.ktile || (p.slots >= 2 && p.slots <= 8)) &&
      p.splits >= 1 && p.ktile % (4 * p.splits) == 0 &&
      p.threads == (is_bf16 ? 32 * kWarpsBf16
                            : p.splits * p.rows / 8 * p.units) &&
      p.threads <= (is_bf16 ? kMaxThreads : 256) &&
      (!is_bf16 || (p.rows / 16) * (p.units / 8) <= kWarpsBf16) &&
      (size_t)p.smem == layout(p, is_bf16).total;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

template <typename E>
cudaLaunchConfig_t cluster_config(const Plan& p, int tiles, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.cluster);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename E>
int set_attributes(const Plan& p) {
  cudaError_t e = cudaFuncSetAttribute(
      lstm_fwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(lstm_fwd_kernel<E>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)e;
}

// Launches lstm_fwd_kernel<E> on `stream` of CUDA device `device` (this
// library links its own CUDA runtime, whose current device is not the
// caller's); returns the first CUDA error (0 = ok).
template <typename E>
int launch_fwd(const E* x_proj, const E* wh, const float* peep, E* hs,
               E* cs, E* gates, int T, int B, int H, int peepholes,
               const Plan& p, int device, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  int err = check_plan<E>(p);
  if (err) return err;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  err = set_attributes<E>(p);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<E>(p, (B + p.rows - 1) / p.rows, stream, &attr);
  // 16-byte copies of wh's rows and of the outputs' unit ranges
  const int aligned = H % (16 / (int)sizeof(E)) == 0 &&
                      (reinterpret_cast<uintptr_t>(wh) |
                       reinterpret_cast<uintptr_t>(hs) |
                       reinterpret_cast<uintptr_t>(cs) |
                       reinterpret_cast<uintptr_t>(gates)) % 16 == 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, lstm_fwd_kernel<E>, x_proj, wh, peep, hs, cs,
                         gates, T, B, H, peepholes, p, aligned);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// how many clusters of the plan the card holds at once; -error on failure
template <typename E>
int max_clusters(const Plan& p, int device) {
  int err = check_plan<E>(p);
  if (err) return -err;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  err = set_attributes<E>(p);
  if (err) return -err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<E>(p, 1, nullptr, &attr);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, lstm_fwd_kernel<E>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

int emt_lstm_fwd_f32(const float* x_proj, const float* wh, const float* peep,
                     float* hs, float* cs, float* gates, int T, int B, int H,
                     int peepholes, int cluster, int rows, int units,
                     int kpad, int ktile, int slots, int splits, int threads,
                     int smem, int device, void* stream) {
  const Plan p{cluster, rows, units, kpad, ktile, slots, splits, threads,
               smem};
  return launch_fwd(x_proj, wh, peep, hs, cs, gates, T, B, H, peepholes, p,
                    device, stream);
}

// x_proj, wh, hs, cs and gates are bf16; peep is f32
int emt_lstm_fwd_bf16(const void* x_proj, const void* wh, const float* peep,
                      void* hs, void* cs, void* gates, int T, int B, int H,
                      int peepholes, int cluster, int rows, int units,
                      int kpad, int ktile, int slots, int splits, int threads,
                      int smem, int device, void* stream) {
  const Plan p{cluster, rows, units, kpad, ktile, slots, splits, threads,
               smem};
  return launch_fwd(static_cast<const bf16*>(x_proj),
                    static_cast<const bf16*>(wh), peep,
                    static_cast<bf16*>(hs), static_cast<bf16*>(cs),
                    static_cast<bf16*>(gates), T, B, H, peepholes, p, device,
                    stream);
}

int emt_lstm_max_clusters_fwd_f32(int cluster, int rows, int units, int kpad,
                                  int ktile, int slots, int splits,
                                  int threads, int smem, int device) {
  return max_clusters<float>(
      Plan{cluster, rows, units, kpad, ktile, slots, splits, threads, smem},
      device);
}

int emt_lstm_max_clusters_fwd_bf16(int cluster, int rows, int units,
                                   int kpad, int ktile, int slots, int splits,
                                   int threads, int smem, int device) {
  return max_clusters<bf16>(
      Plan{cluster, rows, units, kpad, ktile, slots, splits, threads, smem},
      device);
}

const char* emt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
