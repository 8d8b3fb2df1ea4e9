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
// Bound. At the training main-path shape B=64, T=64, H=512, f32: the dh
// carry is 2*(T-1)*B*H*4H = 8.46 GFLOP and dwh the same again, 16.9 GFLOP
// on the FP32 pipe, 0.25 ms at 67 TFLOP/s; the bytes (~101 MB) take ~30
// us: operations bound it, and T-1 dependent steps. In bf16 at bench.py's
// B=2048: the bytes (g_hs, hs, cs 134 MB each and gates 537 MB in, dxp 537
// MB out, wh and dwh 2 MiB each) take 0.44 ms, the 2 x 270 GFLOP of the
// dh carry and dwh 0.55 ms on the tensor cores: operations bound it.
//
// Design (ops/fused_lstm.lstm_plan gives every size): three kernels in
// stream order, no float atomics, every sum in one fixed order (reruns are
// bit-identical).
// 1. recurrence, on thread-block clusters as the forward's: a cluster of
//    C CTAs runs a tile of `rows` batch rows through the reverse time loop;
//    CTA c owns units [c*U, (c+1)*U). Per step it forms its cells' gate
//    gradients from the residuals (loaded into registers one step ahead)
//    and writes them to dxp (bf16: staged in shared memory, 16-byte
//    stores); one cluster barrier; then its units' dh carry, sum_n
//    dgates[b][n] * wh[k][n] over all 4H columns n: the tile's rows of
//    dxp[t] (the dgates rounded to E, as the whole cluster just wrote
//    them) are read back from L2, one peer's columns (a 4U-wide chunk) at
//    a time through a ring of `slots` chunks (bf16: four TMA boxes a
//    chunk, one per gate, into swizzled gate tiles on the slot's
//    mbarrier; f32 and widths TMA cannot take: cp.async), against wh's
//    rows of the CTA's units in the matching column order (resident in
//    shared memory, 136 KiB at H=512 in bf16, or streamed beside the
//    dgates chunks). At H=512 the TMA fill makes bf16 K2 0.83-0.84x the
//    time of the same ring filled by cp.async (PERF.md §6). The stores to
//    dxp are generic-proxy writes and TMA reads them in the async proxy,
//    so each writer fences the two proxies (fence.proxy.async.global)
//    before the cluster barrier. The exchange reads back what the cluster
//    must write to dxp anyway, so no second copy of the dgates is kept in
//    shared memory for the peers; pulling them from the peers' shared
//    memory over DSMEM is the alternative, not measured by a committed
//    script (PERF.md §7). bf16 runs the product on the tensor cores
//    (mma.sync m16n8k16): a warp takes 16 rows x 32 units over a share of each
//    chunk's depth, so an A fragment feeds four mma, and the shares are
//    added through shared memory in a fixed order into the cells' owners;
//    f32 as FMAs (8 rows x 1 unit a thread, the depth split among
//    `splits` groups where the SM would be under-filled, added in a fixed
//    order). The carries stay in registers. dpeep: per-thread sums, then
//    per-CTA in a fixed order into a (tiles, 3, C*U) scratch. No
//    transposed copy of wh is made: its rows are read as they lie.
// 2. dwh = A^T . D over R = (T-1)*B rows, A = hs[0 .. T-2] and D =
//    dxp[1 .. T-1] read in place (h_prev is hs shifted by one step), split
//    into `dwh_split` slices of R so the grid covers the card (at B=2048:
//    64 output tiles of 128 x 128 x 4 slices = 256 CTAs), each slice's
//    f32 sums to a (split, H, 4H) scratch, which a reduction pass
//    adds in slice order and rounds to E. bf16: wgmma m64n128k16 on tiles
//    that TMA (cp.async.bulk.tensor, 128-byte swizzle) loads into a ring
//    of 4 stages tracked by mbarriers; a producer warp issues the loads,
//    two consumer warpgroups own 64 rows of the tile each. Both operands
//    are MN-major (R is the reduction axis), which wgmma takes transposed.
//    A width whose rows are not 16-byte multiples (H % 8 != 0) fills the
//    same ring with plain loads. f32: FP32 FMAs, 8 x 8 outputs a thread,
//    16-row slabs double-buffered with cp.async.
// 3. dpeep: the tiles' partials summed in tile order; row 3 zero.
// The earlier design (8-row CTAs streaming a transposed wh from L2 every
// step, dwh as a 64 x 64-tile SIMT product with no split of R) is what
// this replaces.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kWarpsBf16 = 16;
// dwh tiles: 128 x 128 outputs; bf16 k-blocks of 64 rows in a 4-stage
// ring (32 KiB a stage); f32 slabs of 16 rows
constexpr int kTile = 128;
constexpr int kBlockR = 64;
constexpr int kStages = 4;
constexpr int kStageBytes = 4 * 64 * 128;  // A0, A1, B0, B1: 64 rows x 128 B
constexpr int kDwhThreads = 384;           // 2 consumer warpgroups + producer
constexpr int kSlab = 16;
constexpr int kSimtThreads = 256;

// mirrors ops/fused_lstm.Plan (the backward's fields)
struct Plan {
  int cluster, rows, units, resident, slots, splits, threads, smem;
};

// a bf16 CTA's product warps split each chunk's k16 steps into this many
// groups (16 warps over row blocks x passes of 32 units x groups)
__host__ __device__ inline int bwd_kgroups(int rows, int units) {
  const int g = 16 / ((rows / 16) * ((units + 31) / 32));
  return g < units / 4 ? g : units / 4;
}

// shared-memory byte offsets of one recurrence CTA, as
// ops/fused_lstm._smem counts them
struct Layout {
  size_t w, a, own, red, total;
};

__host__ __device__ inline Layout layout(const Plan& p, bool is_bf16) {
  Layout L;
  const size_t u4 = 4 * (size_t)p.units;
  const size_t chunks = p.resident ? p.cluster : p.slots;
  if (is_bf16) {
    // weight chunks [C or slots][U][4U + 8]; the ring of dgates chunks,
    // 1024-byte aligned (the base itself is aligned in the kernel, with
    // 1024 bytes of room); the own dgates and the depth groups' sums live
    // in the ring's slots
    L.w = 0;
    L.a = (2 * chunks * p.units * (u4 + 8) + 1023) / 1024 * 1024;
    L.own = L.red = L.a;
    L.total = L.a + (size_t)p.slots * 8 * p.rows * p.units + 1024;
    return L;
  }
  size_t off = 0;
  L.w = off;  // weight chunks [C or slots][U][4U + 4]
  off += 4 * chunks * (size_t)p.units * (u4 + 4);
  L.a = off;  // the ring of dgates chunks [slots][rows][4U]
  off += 4 * (size_t)p.slots * p.rows * u4;
  L.own = off;
  L.red = off;  // split partials [splits - 1][rows][U]
  off += 4 * (size_t)(p.splits - 1) * p.rows * p.units;
  L.total = off;
  return L;
}

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
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
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wh's rows of this CTA's units, the columns of peer `peer`'s units, into
// `dst` [U][ld]: row u, column g*U + v is wh[c0 + u][g*H + peer*U + v],
// zero past H
template <typename E>
__device__ void load_wchunk(E* dst, const E* __restrict__ wh, int peer,
                            int U, int H, int c0, bool aligned) {
  const size_t H4 = 4 * (size_t)H;
  const int u4 = 4 * U;
  if constexpr (sizeof(E) == 2) {
    const int ldw = u4 + 8, chunks = u4 / 8;
    for (int i = threadIdx.x; i < U * chunks; i += blockDim.x) {
      const int u = i / chunks, n = (i % chunks) * 8;
      const int g = n / U, col = peer * U + n % U;
      E* d = dst + (size_t)u * ldw + n;
      const E* src = wh + (size_t)(c0 + u) * H4 + (size_t)g * H + col;
      if (c0 + u < H && aligned && col + 8 <= H) {
        cp_async16(d, src);
      } else {
        for (int e = 0; e < 8; ++e)
          d[e] = (c0 + u < H && col + e < H) ? src[e]
                                              : __float2bfloat16(0.f);
      }
    }
  } else {
    // rows of 4U + 4 floats: 16-byte copies, and a warp's float4 reads of
    // one column group (32 units) hit distinct bank groups
    const int ldw = u4 + 4, chunks = u4 / 4;
    for (int i = threadIdx.x; i < U * chunks; i += blockDim.x) {
      const int u = i / chunks, n = (i % chunks) * 4;
      const int g = n / U, col = peer * U + n % U;
      E* d = dst + (size_t)u * ldw + n;
      const E* src = wh + (size_t)(c0 + u) * H4 + (size_t)g * H + col;
      if (c0 + u < H && aligned && col + 4 <= H) {
        cp_async16(d, src);
      } else {
        for (int e = 0; e < 4; ++e)
          d[e] = (c0 + u < H && col + e < H) ? src[e] : 0.f;
      }
    }
  }
}

// The step's chunks, one per peer: peer p's dgates of step t (its units'
// columns of each gate, rounded to E) are dxp[t]'s columns g*H + p*U ..
// g*H + p*U + U-1, which the cluster wrote before the last cluster
// barrier. Chunk q of a step is peer (rank + q) % C's (each CTA adds them
// in its own fixed order, and the peers' rows are read evenly). Its rows of
// the tile go to `dst` [rows][lda] with cp.async from L2, zero past H;
// rows past B are skipped (their cells are masked).
template <typename E>
__device__ void load_dgates(E* dst, int lda, const E* __restrict__ dxp, int t,
                            int peer, int U, int B, int H, int b0, int rows,
                            bool aligned) {
  constexpr int per = 16 / sizeof(E);
  const int cpg = U / per, chunks = 4 * cpg;
  const size_t H4 = 4 * (size_t)H;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, g = (i % chunks) / cpg, u = (i % cpg) * per;
    if (b0 + r >= B) continue;
    const int col = peer * U + u;
    const E* src = dxp + ((size_t)t * B + b0 + r) * H4 + (size_t)g * H + col;
    E* d = dst + (size_t)r * lda + g * U + u;
    if (aligned && col + per <= H) {
      cp_async16(d, src);
    } else {
      for (int e = 0; e < per; ++e) d[e] = col + e < H ? __ldcg(src + e) : zero_e<E>();
    }
  }
}

// The weight chunks and the ring of dgates chunks of the dh carry. wh's
// chunk for a peer is resident (all C loaded once) or streamed with its
// dgates chunk; `slots` chunks are in flight, all within one step.
template <typename E>
struct Chunks {
  E* w;     // weight chunks [C or slots][U][ldw]
  E* a;     // dgates chunks [slots][rows][lda]
  const E* wh;
  const E* dxp;
  int U, H, B, b0, rows, c0, C, rank, slots, ldw, lda;
  bool aligned, resident;

  __device__ int peer(int q) const { return (rank + q) % C; }
  __device__ void start() {
    if (!resident) return;
    for (int q = 0; q < C; ++q)
      load_wchunk(w + (size_t)q * U * ldw, wh, q, U, H, c0, aligned);
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();
  }
  __device__ void issue(int t, int q) {
    if (q < C) {
      load_dgates(a + (size_t)(q % slots) * rows * lda, lda, dxp, t, peer(q),
                  U, B, H, b0, rows, aligned);
      if (!resident)
        load_wchunk(w + (size_t)(q % slots) * U * ldw, wh, peer(q), U, H, c0,
                    aligned);
    }
    cp_async_commit();
  }
  // after the step's barrier: the first slots - 1 chunks in flight
  __device__ void begin(int t) {
    for (int q = 0; q < slots - 1; ++q) issue(t, q);
  }
  // chunk q ready for every thread; the slot it frees refilled
  __device__ void acquire(int t, int q, const E** as, const E** ws) {
    cp_async_wait(slots - 2);
    __syncthreads();
    issue(t, q + slots - 1);
    *as = a + (size_t)(q % slots) * rows * lda;
    *ws = w + (size_t)(resident ? peer(q) : q % slots) * U * ldw;
  }
};

// The bf16 ring: a dgates chunk is 4 gate tiles [rows][U] (rows of U*2
// bytes, 1024-byte aligned slot), each swizzled as TMA's mode for its row
// width (none, 32, 64 or 128 B: byte offset bits 4.. ^= bits 7..), loaded
// by four 2-D TMA boxes per chunk (one per gate) on the slot's mbarrier,
// or, where TMA cannot take the width, by cp.async into the same layout.
__device__ __forceinline__ uint32_t gate_swizzle(int U) {
  return U == 64 ? 0x70u : U == 32 ? 0x30u : U == 16 ? 0x10u : 0u;
}
__device__ __forceinline__ uint32_t swz_off(uint32_t off, uint32_t mask) {
  return off ^ ((off >> 3) & mask);
}

struct GateChunks {
  bf16* w;             // weight chunks [C or slots][U][4U + 8]
  unsigned char* a;    // the ring: slots x 4 gate tiles
  const bf16* wh;
  const bf16* dxp;
  const CUtensorMap* map;  // null: cp.async
  uint64_t* bars;          // [slots] mbarriers of the TMA fills
  int U, H, B, b0, rows, c0, C, rank, slots;
  uint32_t mask, tile_bytes, slot_bytes, phases;
  bool aligned, resident;

  __device__ int peer(int q) const { return (rank + q) % C; }
  __device__ uint32_t bar(int s) const { return smem_addr(&bars[s]); }
  __device__ void start() {
    if (map != nullptr && threadIdx.x == 0) {
      for (int s = 0; s < slots; ++s) mbar_init(bar(s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (resident)
      for (int q = 0; q < C; ++q)
        load_wchunk(w + (size_t)q * U * (4 * U + 8), wh, q, U, H, c0,
                    aligned);
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();
  }
  __device__ void issue(int t, int q) {
    if (q < C) {
      const int s = q % slots, pr = peer(q);
      unsigned char* dst = a + (size_t)s * slot_bytes;
      if (map != nullptr) {
        if (threadIdx.x == 0) {
          // the slot's earlier generic reads and writes come before the
          // async proxy's writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_expect_tx(bar(s), slot_bytes);
          for (int g = 0; g < 4; ++g)
            tma_load_2d(smem_addr(dst + g * tile_bytes), map, bar(s),
                        g * H + pr * U, t * B + b0);
        }
      } else {
        const int cpr = U / 8;  // 16-byte chunks of a gate tile's row
        const size_t H4 = 4 * (size_t)H;
        for (int i = threadIdx.x; i < rows * 4 * cpr; i += blockDim.x) {
          const int r = i / (4 * cpr), g = (i / cpr) % 4, c = i % cpr;
          if (b0 + r >= B) continue;
          const int col = pr * U + c * 8;
          const bf16* src =
              dxp + ((size_t)t * B + b0 + r) * H4 + (size_t)g * H + col;
          bf16* d = reinterpret_cast<bf16*>(
              dst + g * tile_bytes + swz_off((uint32_t)(r * U * 2 + c * 16),
                                             mask));
          if (aligned && col + 8 <= H) {
            cp_async16(d, src);
          } else {
            for (int e = 0; e < 8; ++e)
              d[e] = col + e < H ? __ldcg(src + e) : __float2bfloat16(0.f);
          }
        }
      }
      if (!resident)
        load_wchunk(w + (size_t)s * U * (4 * U + 8), wh, pr, U, H, c0,
                    aligned);
    }
    cp_async_commit();
  }
  __device__ void begin(int t) {
    for (int q = 0; q < slots - 1; ++q) issue(t, q);
  }
  // chunk q ready for every thread (its gate tiles at *as); the slot it
  // frees refilled
  __device__ void acquire(int t, int q, const unsigned char** as,
                          const bf16** ws) {
    const int s = q % slots;
    cp_async_wait(slots - 2);
    if (map != nullptr) {
      mbar_wait(bar(s), (phases >> s) & 1u);
      phases ^= 1u << s;
    }
    __syncthreads();
    issue(t, q + slots - 1);
    *as = a + (size_t)s * slot_bytes;
    *ws = w + (size_t)(resident ? peer(q) : s) * U * (4 * U + 8);
  }
};

// ---------------------------------------------------------------- bf16 ---

__device__ void bwd_bf16(const bf16* __restrict__ g_hs,
                         const bf16* __restrict__ cs,
                         const bf16* __restrict__ gates,
                         const bf16* __restrict__ wh,
                         const float* __restrict__ peep, bf16* dxp,
                         float* __restrict__ dpeep_part, int T, int B, int H,
                         int peepholes, const Plan& p, bool aligned,
                         const CUtensorMap* dmap, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ uint64_t bars[8];
  const Layout L = layout(p, true);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int U = p.units, u4 = 4 * U, ldw = u4 + 8, rows = p.rows;
  const int C = p.cluster, rank = (int)cluster.block_rank(), c0 = rank * U;
  const int tile = blockIdx.x / C, b0 = tile * rows;
  const size_t H4 = 4 * (size_t)H, step = (size_t)B * H;
  const uint32_t slot_bytes = 8u * rows * U;
  // the step's own dgates [rows][4U], staged for dxp in the ring's first
  // slot, and the depth groups' sums [kgroups][rows][U] in the slots after
  // it (the ring is idle while they are used)
  bf16* own = reinterpret_cast<bf16*>(smem + L.a);
  float* sums = reinterpret_cast<float*>(smem + L.a + slot_bytes);

  // (the layout's last 1024 bytes are the room the base was aligned in)
  for (size_t i = tid; i < (L.total - 1024) / 16; i += nthr)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  GateChunks ch{reinterpret_cast<bf16*>(smem + L.w), smem + L.a, wh, dxp,
                dmap, bars, U, H, B, b0, rows, c0, C, rank, p.slots,
                gate_swizzle(U), slot_bytes / 4, slot_bytes, 0u, aligned,
                p.resident != 0};
  ch.start();

  // this warp's 16-row x 8-unit tile; this thread's cells e = 2r + u:
  // row rA + 8r, unit uA + u — the mma accumulator layout
  const int rblocks = rows / 16;
  const bool active = warp < rblocks * (U / 8);
  const int rb = warp % rblocks;
  const int r0 = rb * 16, u0 = (warp / rblocks) * 8;
  const int rA = r0 + (lane >> 2), uA = u0 + 2 * (lane & 3);
  // the product's warps: (row block, pass of 32 units, depth group)
  const int upasses = (U + 31) / 32, kgroups = bwd_kgroups(rows, U);
  const bool pwarp = warp < rblocks * upasses * kgroups;
  const int pr0 = (warp % rblocks) * 16;
  const int up = (warp / rblocks) % upasses, kg = warp / (rblocks * upasses);
  const int pu0 = up * 32, nblk = min(4, U / 8 - up * 4), nk16 = U / 4;
  float dh[4] = {0.f, 0.f, 0.f, 0.f}, dc[4] = {0.f, 0.f, 0.f, 0.f};
  float sp[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  float pi[2], pf[2], po[2];
  for (int u = 0; u < 2; ++u) {
    const int unit = c0 + uA + u;
    const bool ok = active && peepholes && unit < H;
    pi[u] = ok ? peep[unit] : 0.f;
    pf[u] = ok ? peep[H + unit] : 0.f;
    po[u] = ok ? peep[2 * H + unit] : 0.f;
  }
  // residuals of a step, one step ahead: g_hs, c, c_prev, i, f, g, o
  float res[4][7];
  auto fetch_res = [&](int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = b0 + rA + 8 * (e >> 1), unit = c0 + uA + (e & 1);
      const bool ok = active && b < B && unit < H;
      const size_t hr = ((size_t)t * B + b) * H + unit;
      const bf16* gt = gates + ((size_t)t * B + b) * H4 + unit;
      res[e][0] = ok ? ld(g_hs + hr) : 0.f;
      res[e][1] = ok ? ld(cs + hr) : 0.f;
      res[e][2] = ok && t > 0 ? ld(cs + hr - step) : 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) res[e][3 + g] = ok ? ld(gt + g * H) : 0.f;
    }
  };
  fetch_res(T - 1);

  for (int t = T - 1; t >= 0; --t) {
    if (active) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rA + 8 * (e >> 1), b = b0 + row;
        const int ul = uA + (e & 1), unit = c0 + ul;
        float di = 0.f, df = 0.f, dg = 0.f, dout = 0.f;
        if (b < B && unit < H) {
          const float ig = res[e][3], fg = res[e][4], gg = res[e][5],
                      og = res[e][6];
          const float c = res[e][1], c_prev = res[e][2];
          const float tc = tanhf(c);
          const float dhv = res[e][0] + dh[e];
          dout = dhv * tc * og * (1.f - og);
          float dcv = dhv * og * (1.f - tc * tc) + dc[e];
          if (peepholes) dcv += dout * po[e & 1];
          di = dcv * gg * ig * (1.f - ig);
          df = dcv * c_prev * fg * (1.f - fg);
          dg = dcv * ig * (1.f - gg * gg);
          float dc_prev = dcv * fg;
          if (peepholes) {
            dc_prev += di * pi[e & 1] + df * pf[e & 1];
            sp[e & 1][0] += di * c_prev;
            sp[e & 1][1] += df * c_prev;
            sp[e & 1][2] += dout * c;
          }
          dc[e] = dc_prev;
        }
        bf16* o = own + (size_t)row * u4 + ul;
        o[0] = __float2bfloat16(di);
        o[U] = __float2bfloat16(df);
        o[2 * U] = __float2bfloat16(dg);
        o[3 * U] = __float2bfloat16(dout);
      }
    }
    if (t > 0) fetch_res(t - 1);
    __syncthreads();
    // dxp of step t (dgates rounded to E) from the staged rows, 16 bytes a
    // store
    {
      const int cpu = U / 8, row_chunks = 4 * cpu;
      for (int i = tid; i < rows * row_chunks; i += nthr) {
        const int row = i / row_chunks, q = i % row_chunks, b = b0 + row;
        const int g = q / cpu, u = (q % cpu) * 8, unit = c0 + u;
        if (b >= B || unit >= H) continue;
        const bf16* src = own + (size_t)row * u4 + g * U + u;
        bf16* dst = dxp + ((size_t)t * B + b) * H4 + (size_t)g * H + unit;
        if (aligned && unit + 8 <= H)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else
          for (int e = 0; e < 8 && unit + e < H; ++e) dst[e] = src[e];
      }
    }
    // this thread's generic stores to dxp before the peers' TMA reads of
    // them (async proxy)
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    cluster.sync();  // the tile's dxp[t] is complete in memory
    if (t == 0) break;

    // dh carry of step t-1 for this CTA's units: every peer's dgates chunk
    // against wh's rows of these units, the matching columns. Product warp
    // (rb, up, kg) takes 16 rows x the 32 units of pass up over every
    // kgroups-th k16 step of each chunk (an A fragment feeds 4 mma); the
    // groups' sums meet in `sums`, each cell's added in group order.
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    ch.begin(t);
    for (int q = 0; q < C; ++q) {
      const unsigned char* as;
      const bf16* W;
      ch.acquire(t, q, &as, &W);
      if (!pwarp) continue;
      const uint32_t a_base = smem_addr(as), w_base = smem_addr(W);
      const int mi = lane >> 3;
      const int arow = pr0 + (lane & 7) + (mi & 1) * 8;
      for (int j = kg; j < nk16; j += kgroups) {
        // this lane's 8 columns of A: gate tile k / U, swizzled row
        const int k = j * 16 + (mi >> 1) * 8, g = k / U;
        uint32_t a[4];
        ldsm_x4(a, a_base + g * ch.tile_bytes +
                       swz_off((uint32_t)(arow * U + k - g * U) * 2, ch.mask));
#pragma unroll
        for (int bp = 0; bp < 2; ++bp) {
          if (2 * bp < nblk) {
            uint32_t b[4];
            const int urow = pu0 + (2 * bp + (mi >> 1)) * 8 + (lane & 7);
            ldsm_x4(b, w_base + 2u * (uint32_t)(urow * ldw + j * 16 +
                                                (mi & 1) * 8));
            mma_bf16(acc[2 * bp], a, b[0], b[1]);
            if (2 * bp + 1 < nblk) mma_bf16(acc[2 * bp + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the ring's slots are read: the sums may take them
    if (pwarp) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nblk) {
          const int col = pu0 + j * 8 + 2 * (lane & 3);
          float* d = sums + ((size_t)kg * rows + pr0 + (lane >> 2)) * U + col;
          d[0] = acc[j][0];
          d[1] = acc[j][1];
          d[8 * U] = acc[j][2];
          d[8 * U + 1] = acc[j][3];
        }
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* d = sums + (size_t)(rA + 8 * (e >> 1)) * U + uA + (e & 1);
        float s = 0.f;
        for (int g = 0; g < kgroups; ++g) s += d[(size_t)g * rows * U];
        dh[e] = s;
      }
    }
  }

  // dpeep: this CTA's sums, per unit over its rows in a fixed order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L.a);  // [rows/2][3][U]
  if (active)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int q = 0; q < 3; ++q)
        red[((size_t)(rb * 8 + (lane >> 2)) * 3 + q) * U + uA + u] = sp[u][q];
  __syncthreads();
  for (int i = tid; i < 3 * U; i += nthr) {
    const int q = i / U, ul = i % U;
    float s = 0.f;
    for (int slot = 0; slot < rows / 2; ++slot)
      s += red[((size_t)slot * 3 + q) * U + ul];
    dpeep_part[((size_t)tile * 3 + q) * C * U + c0 + ul] = s;
  }
}

// ----------------------------------------------------------------- f32 ---

__device__ void bwd_f32(const float* __restrict__ g_hs,
                        const float* __restrict__ cs,
                        const float* __restrict__ gates,
                        const float* __restrict__ wh,
                        const float* __restrict__ peep,
                        float* dxp,
                        float* __restrict__ dpeep_part, int T, int B, int H,
                        int peepholes, const Plan& p, bool aligned,
                        unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout(p, false);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int U = p.units, u4 = 4 * U, rows = p.rows, rgs = rows / 8;
  const int C = p.cluster, rank = (int)cluster.block_rank(), c0 = rank * U;
  const int tile = blockIdx.x / C, b0 = tile * rows;
  const size_t H4 = 4 * (size_t)H, step = (size_t)B * H;
  float* red = reinterpret_cast<float*>(smem + L.red);  // [splits-1][rows][U]

  for (size_t i = tid; i < L.total / 16; i += nthr)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  Chunks<float> ch{reinterpret_cast<float*>(smem + L.w),
                   reinterpret_cast<float*>(smem + L.a), wh, dxp, U, H, B, b0,
                   rows, c0, C, rank, p.slots, u4 + 4, u4, aligned,
                   p.resident != 0};
  ch.start();

  // this thread: unit u, rows rg*8 .. rg*8+7, depth group s
  const int u = tid % U, rg = (tid / U) % rgs, s = tid / (U * rgs);
  const int unit = c0 + u;
  const bool vu = unit < H, lead = s == 0;
  const float pi = (lead && vu && peepholes) ? peep[unit] : 0.f;
  const float pf = (lead && vu && peepholes) ? peep[H + unit] : 0.f;
  const float po = (lead && vu && peepholes) ? peep[2 * H + unit] : 0.f;
  float dh[8], dc[8], sp[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) dh[i] = dc[i] = 0.f;
  float res[8][7];
  auto fetch_res = [&](int t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = b0 + rg * 8 + i;
      const bool ok = lead && vu && b < B;
      const size_t hr = ((size_t)t * B + b) * H + unit;
      const float* gt = gates + ((size_t)t * B + b) * H4 + unit;
      res[i][0] = ok ? g_hs[hr] : 0.f;
      res[i][1] = ok ? cs[hr] : 0.f;
      res[i][2] = ok && t > 0 ? cs[hr - step] : 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) res[i][3 + g] = ok ? gt[g * H] : 0.f;
    }
  };
  fetch_res(T - 1);

  const int nper = u4 / p.splits;
  for (int t = T - 1; t >= 0; --t) {
    if (lead) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = b0 + rg * 8 + i;
        if (b < B && vu) {
          const float ig = res[i][3], fg = res[i][4], gg = res[i][5],
                      og = res[i][6];
          const float c = res[i][1], c_prev = res[i][2];
          const float tc = tanhf(c);
          const float dhv = res[i][0] + dh[i];
          const float dout = dhv * tc * og * (1.f - og);
          float dcv = dhv * og * (1.f - tc * tc) + dc[i];
          if (peepholes) dcv += dout * po;
          const float di = dcv * gg * ig * (1.f - ig);
          const float df = dcv * c_prev * fg * (1.f - fg);
          const float dg = dcv * ig * (1.f - gg * gg);
          float dc_prev = dcv * fg;
          if (peepholes) {
            dc_prev += di * pi + df * pf;
            sp[0] += di * c_prev;
            sp[1] += df * c_prev;
            sp[2] += dout * c;
          }
          dc[i] = dc_prev;
          float* dx = dxp + ((size_t)t * B + b) * H4 + unit;
          dx[0] = di;
          dx[H] = df;
          dx[2 * H] = dg;
          dx[3 * H] = dout;
        }
      }
    }
    if (t > 0) fetch_res(t - 1);
    cluster.sync();  // the tile's dxp[t] is complete in memory
    if (t == 0) break;

    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    ch.begin(t);
    for (int q = 0; q < C; ++q) {
      const float *as, *W;
      ch.acquire(t, q, &as, &W);
      const float* a = as + (size_t)rg * 8 * u4;
      const float* w = W + (size_t)u * (u4 + 4);
      // four columns a round: one float4 of dgates per row, 4 weights
      for (int n = s * nper; n < (s + 1) * nper; n += 4) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(a + (size_t)i * u4 + n);
        const float4 w4 = *reinterpret_cast<const float4*>(w + n);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i] = fmaf(av[i].x, wv[0], acc[i]);
          acc[i] = fmaf(av[i].y, wv[1], acc[i]);
          acc[i] = fmaf(av[i].z, wv[2], acc[i]);
          acc[i] = fmaf(av[i].w, wv[3], acc[i]);
        }
      }
    }
    if (p.splits > 1) {
      if (!lead)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          red[((size_t)(s - 1) * rows + rg * 8 + i) * U + u] = acc[i];
      __syncthreads();
      if (lead)
        for (int q = 0; q < p.splits - 1; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[i] += red[((size_t)q * rows + rg * 8 + i) * U + u];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dh[i] = acc[i];
  }

  // dpeep: this CTA's sums, per unit over its row groups in a fixed order
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem + L.a);  // [rows/8][3][U]
  if (lead)
    for (int q = 0; q < 3; ++q) part[((size_t)rg * 3 + q) * U + u] = sp[q];
  __syncthreads();
  for (int i = tid; i < 3 * U; i += nthr) {
    const int q = i / U, ul = i % U;
    float sum = 0.f;
    for (int g = 0; g < rgs; ++g) sum += part[((size_t)g * 3 + q) * U + ul];
    dpeep_part[((size_t)tile * 3 + q) * C * U + c0 + ul] = sum;
  }
}

// f32 CTAs run at most 256 threads (the plan keeps them there), so a
// thread may hold its residuals, carries and staged dgates unspilled
template <typename E>
__global__ void __launch_bounds__(sizeof(E) == 2 ? kMaxThreads : 256)
lstm_bwd_kernel(const E* __restrict__ g_hs,     // (T, B, H)
                const E* __restrict__ cs,       // (T, B, H)
                const E* __restrict__ gates,    // (T, B, 4H)
                const E* __restrict__ wh,       // (H, 4H)
                const float* __restrict__ peep,  // (4, H)
                E* dxp,                          // (T, B, 4H), read back
                float* __restrict__ dpeep_part,  // (tiles, 3, C*U)
                int T, int B, int H, int peepholes, Plan p, int aligned,
                const __grid_constant__ CUtensorMap dmap,  // dxp, bf16
                int use_tma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (sizeof(E) == 2) {
    const uint32_t raw = smem_addr(smem_raw);
    unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
    bwd_bf16(g_hs, cs, gates, wh, peep, dxp, dpeep_part, T, B, H, peepholes,
             p, aligned != 0, use_tma ? &dmap : nullptr, smem);
  } else {
    bwd_f32(g_hs, cs, gates, wh, peep, dxp, dpeep_part, T, B, H, peepholes,
            p, aligned != 0, smem_raw);
  }
}

// ------------------------------------------------------------ dwh (bf16) ---

// a wgmma shared-memory descriptor: 128-byte swizzle, leading (MN atom)
// and stride (8-row K group) byte offsets
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// d += A . B, one wgmma m64n128k16 (bf16 in, f32 sums), both operands
// MN-major (transposed) in shared memory, 128-byte swizzled
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// dwh's slice s of output tile (tm, tn), 128 x 128: the k-blocks [kb0,
// kb1) of R, summed on the tensor cores into f32, stored to part[s].
// Warps 0-7 (two warpgroups) consume, warp 8 produces.
__global__ void __launch_bounds__(kDwhThreads, 1)
dwh_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_d,
                 const bf16* __restrict__ hs,     // (R, H): h_prev rows
                 const bf16* __restrict__ drows,  // (R, 4H): dxp[1 ..]
                 float* __restrict__ part,        // (S, H, 4H)
                 int R, int H, int S, int use_tma) {
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  extern __shared__ __align__(16) unsigned char dsm[];
  const uint32_t raw = smem_addr(dsm);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle atoms
  unsigned char* sm = dsm + (base - raw);
  const int H4 = 4 * H;
  const int ntn = (H4 + kTile - 1) / kTile;
  const int k0 = (blockIdx.x / ntn) * kTile, n0 = (blockIdx.x % ntn) * kTile;
  const int s = blockIdx.y;
  const int nkb = (R + kBlockR - 1) / kBlockR;
  const int kb0 = (int)((long long)s * nkb / S);
  const int nk = (int)((long long)(s + 1) * nkb / S) - kb0;
  const int tid = threadIdx.x, wg = tid / 128;
  const uint32_t full = smem_addr(&bars[0]), empty = smem_addr(&bars[kStages]);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, use_tma ? 1 : 32);
      mbar_init(empty + 8 * i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: warp 8 fills the ring, the rest of its group idles
    if (tid >= 256 + 32) return;
    const int lane = tid - 256;
    for (int i = 0; i < nk; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(empty + 8 * st, ((i / kStages) - 1) & 1);
      const uint32_t dst = base + st * kStageBytes;
      const int r0 = (kb0 + i) * kBlockR;
      if (use_tma) {
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, kStageBytes);
          tma_load_2d(dst, &tm_h, full + 8 * st, k0, r0);
          tma_load_2d(dst + 8192, &tm_h, full + 8 * st, k0 + 64, r0);
          tma_load_2d(dst + 16384, &tm_d, full + 8 * st, n0, r0);
          tma_load_2d(dst + 24576, &tm_d, full + 8 * st, n0 + 64, r0);
        }
      } else {
        // the same 64 x 64 boxes, 128-byte swizzled, with plain loads
        for (int box = 0; box < 4; ++box) {
          const bf16* src = box < 2 ? hs : drows;
          const int ncols = box < 2 ? H : H4;
          const int col0 = (box < 2 ? k0 : n0) + (box & 1) * 64;
          unsigned char* d = sm + st * kStageBytes + box * 8192;
          for (int e = lane; e < 64 * 64; e += 32) {
            const int rr = e / 64, cc = e % 64, r = r0 + rr, col = col0 + cc;
            *reinterpret_cast<bf16*>(d + rr * 128 +
                                     (((cc >> 3) ^ (rr & 7)) << 4) +
                                     ((cc & 7) << 1)) =
                (r < R && col < ncols) ? src[(size_t)r * ncols + col]
                                       : __float2bfloat16(0.f);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns the tile's rows [wg*64, wg*64 + 64)
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int st = i % kStages;
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    const uint32_t a = base + st * kStageBytes + wg * 8192;
    const uint32_t b = base + st * kStageBytes + 16384;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16(d, wgmma_desc(a + kk * 2048, 8192, 1024),
                       wgmma_desc(b + kk * 2048, 8192, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    // the previous stage's products are done: hand its slot back
    if (i > 0 && (tid & 127) == 0) mbar_arrive(empty + 8 * ((i - 1) % kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  const int t = tid & 127, lane = t & 31;
  const int row = k0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);
  float* out = part + (size_t)s * H * H4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + j * 8 + 2 * (lane & 3);
    if (col < H4) {
      if (row < H)
        *reinterpret_cast<float2*>(out + (size_t)row * H4 + col) =
            make_float2(d[4 * j], d[4 * j + 1]);
      if (row + 8 < H)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * H4 + col) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// ------------------------------------------------------------- dwh (f32) ---

// dwh's slice s of output tile (tm, tn), 128 x 128, as FP32 FMAs: 16-row
// slabs of hs and dxp double-buffered with cp.async, 8 x 8 outputs a thread
__global__ void __launch_bounds__(kSimtThreads)
dwh_simt_kernel(const float* __restrict__ hs, const float* __restrict__ drows,
                float* __restrict__ part, int R, int H, int S, int aligned) {
  __shared__ __align__(16) float as[2][kSlab][kTile];
  __shared__ __align__(16) float ds[2][kSlab][kTile];
  const int H4 = 4 * H;
  const int ntn = (H4 + kTile - 1) / kTile;
  const int k0 = (blockIdx.x / ntn) * kTile, n0 = (blockIdx.x % ntn) * kTile;
  const int s = blockIdx.y;
  const int nsl = (R + kSlab - 1) / kSlab;
  const int sl0 = (int)((long long)s * nsl / S);
  const int sl1 = (int)((long long)(s + 1) * nsl / S);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  auto load = [&](int sl, int buf) {
    for (int e = tid; e < kSlab * (kTile / 4); e += kSimtThreads) {
      const int rr = e / (kTile / 4), c4 = (e % (kTile / 4)) * 4;
      const int r = sl * kSlab + rr;
      const int k = k0 + c4, n = n0 + c4;
      float* da = &as[buf][rr][c4];
      float* dd = &ds[buf][rr][c4];
      if (r < R && aligned && k + 4 <= H)
        cp_async16(da, hs + (size_t)r * H + k);
      else
        for (int q = 0; q < 4; ++q)
          da[q] = (r < R && k + q < H) ? hs[(size_t)r * H + k + q] : 0.f;
      if (r < R && aligned && n + 4 <= H4)
        cp_async16(dd, drows + (size_t)r * H4 + n);
      else
        for (int q = 0; q < 4; ++q)
          dd[q] = (r < R && n + q < H4) ? drows[(size_t)r * H4 + n + q] : 0.f;
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (sl0 < sl1) {
    load(sl0, 0);
    cp_async_commit();
  }
  for (int sl = sl0; sl < sl1; ++sl) {
    const int buf = (sl - sl0) & 1;
    if (sl + 1 < sl1) {
      load(sl + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kSlab; ++rr) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][rr][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[buf][rr][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ds[buf][rr][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ds[buf][rr][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)s * H * H4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (k < H && n < H4) out[(size_t)k * H4 + n] = acc[i][j];
    }
  }
}

// dwh = the slices' partial sums added in slice order, rounded to E
template <typename E>
__global__ void dwh_reduce_kernel(const float* __restrict__ part,
                                  E* __restrict__ dwh, int S, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += part[(size_t)s * n + i];
  st(dwh + i, sum);
}

// dpeep rows i, f, o: the batch tiles' partials summed in tile order; row
// 3 is zero
__global__ void dpeep_kernel(const float* __restrict__ part,
                             float* __restrict__ dpeep, int tiles, int H,
                             int hp) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= 4 * H) return;
  const int q = n / H, u = n % H;
  float sum = 0.f;
  if (q < 3)
    for (int c = 0; c < tiles; ++c) sum += part[((size_t)c * 3 + q) * hp + u];
  dpeep[n] = sum;
}

// ---------------------------------------------------------------- host ---

template <typename E>
int check_plan(const Plan& p) {
  const bool is_bf16 = sizeof(E) == 2;
  const bool ok =
      p.cluster >= 1 && p.cluster <= 16 && p.units > 0 && p.units % 8 == 0 &&
      p.rows > 0 && p.rows % (is_bf16 ? 16 : 8) == 0 && p.rows <= 64 &&
      p.slots >= 2 && p.slots <= 8 && (p.resident == 0 || p.resident == 1) &&
      p.splits >= 1 && p.units % p.splits == 0 &&
      p.threads == (is_bf16 ? 32 * kWarpsBf16
                            : p.splits * p.rows / 8 * p.units) &&
      p.threads <= (is_bf16 ? kMaxThreads : 256) &&
      (!is_bf16 || ((p.rows / 16) * (p.units / 8) <= kWarpsBf16 &&
                    bwd_kgroups(p.rows, p.units) <= 2 * (p.slots - 1))) &&
      (size_t)p.smem == layout(p, is_bf16).total;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

template <typename E>
int set_attributes(const Plan& p) {
  cudaError_t e = cudaFuncSetAttribute(
      lstm_bwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(
      lstm_bwd_kernel<E>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// loaded (this library does not link libcuda itself)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a (rows, cols) bf16 row-major matrix seen in box_rows x box_cols boxes
// (64 x 64, 128-byte swizzled, for dwh), zero past its edges
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_cols = 64, int box_rows = 64,
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the split product into dwh_part, then its reduction into dwh
template <typename E>
int launch_dwh(const E* hs, const E* dxp, E* dwh, float* dwh_part, int T,
               int B, int H, int S, cudaStream_t s) {
  const int R = (T - 1) * B, H4 = 4 * H;
  const size_t n = (size_t)H * H4;
  if (R == 0) return (int)cudaMemsetAsync(dwh, 0, n * sizeof(E), s);
  const E* drows = dxp + (size_t)B * H4;
  const dim3 grid(((H + kTile - 1) / kTile) * ((H4 + kTile - 1) / kTile), S);
  if constexpr (sizeof(E) == 2) {
    CUtensorMap tm_h, tm_d;
    memset(&tm_h, 0, sizeof(tm_h));
    memset(&tm_d, 0, sizeof(tm_d));
    const int use_tma = H % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(hs) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(drows) % 16 == 0;
    if (use_tma && !(tensor_map(&tm_h, hs, R, H) &&
                     tensor_map(&tm_d, drows, R, H4)))
      return (int)cudaErrorInvalidValue;
    const int smem = kStages * kStageBytes + 1024;
    const cudaError_t e = cudaFuncSetAttribute(
        dwh_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dwh_wgmma_kernel<<<grid, kDwhThreads, smem, s>>>(tm_h, tm_d, hs, drows,
                                                     dwh_part, R, H, S,
                                                     use_tma);
  } else {
    const int aligned = H % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(hs) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(drows) % 16 == 0;
    dwh_simt_kernel<<<grid, kSimtThreads, 0, s>>>(hs, drows, dwh_part, R, H,
                                                  S, aligned);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dwh_reduce_kernel<E><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      dwh_part, dwh, S, n);
  return (int)cudaGetLastError();
}

// Launches the parts of K2 for element type E on `stream` of CUDA device
// `device`; dwh_part (S x H x 4H floats) and dpeep_part (tiles x 3 x
// cluster*units floats) are scratch the caller allocates. Returns the
// first CUDA error (0 = ok).
template <typename E>
int launch_bwd(const E* g_hs, const E* hs, const E* cs, const E* gates,
               const E* wh, const float* peep, E* dxp, E* dwh, float* dpeep,
               float* dwh_part, float* dpeep_part, int T, int B, int H,
               int peepholes, const Plan& p, int S, int parts, int device,
               void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int err = check_plan<E>(p);
  if (err || S < 1) return err ? err : (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (B + p.rows - 1) / p.rows;
  if (parts & 1) {
    err = set_attributes<E>(p);
    if (err) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(p, tiles, stream, &attr);
    // 16-byte copies of wh's rows and of dxp's unit ranges
    const int aligned = H % (16 / (int)sizeof(E)) == 0 &&
                        (reinterpret_cast<uintptr_t>(wh) |
                         reinterpret_cast<uintptr_t>(dxp)) % 16 == 0;
    // bf16: dxp as a (T*B, 4H) matrix in (rows x U) boxes, swizzled for
    // the gate tiles' row width; other widths take cp.async
    CUtensorMap dmap;
    memset(&dmap, 0, sizeof(dmap));
    int use_tma = 0;
    if (sizeof(E) == 2 && aligned &&
        (p.units == 8 || p.units == 16 || p.units == 32 || p.units == 64)) {
      const CUtensorMapSwizzle swz =
          p.units == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
          : p.units == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
          : p.units == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                          : CU_TENSOR_MAP_SWIZZLE_NONE;
      if (!tensor_map(&dmap, dxp, T * B, 4 * H, p.units, p.rows, swz))
        return (int)cudaErrorInvalidValue;
      use_tma = 1;
    }
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, lstm_bwd_kernel<E>, g_hs, cs, gates, wh, peep, dxp, dpeep_part,
        T, B, H, peepholes, p, aligned, dmap, use_tma);
    if (e != cudaSuccess) return (int)e;
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (parts & 2) {
    err = launch_dwh(hs, dxp, dwh, dwh_part, T, B, H, S, s);
    if (err) return err;
  }
  if (parts & 4) {
    dpeep_kernel<<<(4 * H + 255) / 256, 256, 0, s>>>(dpeep_part, dpeep, tiles,
                                                     H, p.cluster * p.units);
    return (int)cudaGetLastError();
  }
  return 0;
}

template <typename E>
int max_clusters(const Plan& p, int device) {
  int err = check_plan<E>(p);
  if (err) return -err;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  err = set_attributes<E>(p);
  if (err) return -err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, 1, nullptr, &attr);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, lstm_bwd_kernel<E>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

int emt_lstm_bwd_f32(const float* g_hs, const float* hs, const float* cs,
                     const float* gates, const float* wh, const float* peep,
                     float* dxp, float* dwh, float* dpeep, float* dwh_part,
                     float* dpeep_part, int T, int B, int H, int peepholes,
                     int cluster, int rows, int units, int resident,
                     int slots, int splits, int threads, int smem,
                     int dwh_split, int parts, int device, void* stream) {
  const Plan p{cluster, rows, units, resident, slots, splits, threads, smem};
  return launch_bwd(g_hs, hs, cs, gates, wh, peep, dxp, dwh, dpeep, dwh_part,
                    dpeep_part, T, B, H, peepholes, p, dwh_split, parts,
                    device, stream);
}

// g_hs, hs, cs, gates, wh, dxp and dwh are bf16; peep, dpeep and the two
// scratch buffers are f32
int emt_lstm_bwd_bf16(const void* g_hs, const void* hs, const void* cs,
                      const void* gates, const void* wh, const float* peep,
                      void* dxp, void* dwh, float* dpeep, float* dwh_part,
                      float* dpeep_part, int T, int B, int H, int peepholes,
                      int cluster, int rows, int units, int resident,
                      int slots, int splits, int threads, int smem,
                      int dwh_split, int parts, int device, void* stream) {
  const Plan p{cluster, rows, units, resident, slots, splits, threads, smem};
  return launch_bwd(
      static_cast<const bf16*>(g_hs), static_cast<const bf16*>(hs),
      static_cast<const bf16*>(cs), static_cast<const bf16*>(gates),
      static_cast<const bf16*>(wh), peep, static_cast<bf16*>(dxp),
      static_cast<bf16*>(dwh), dpeep, dwh_part, dpeep_part, T, B, H,
      peepholes, p, dwh_split, parts, device, stream);
}

int emt_lstm_max_clusters_bwd_f32(int cluster, int rows, int units,
                                  int resident, int slots, int splits,
                                  int threads, int smem, int device) {
  return max_clusters<float>(
      Plan{cluster, rows, units, resident, slots, splits, threads, smem},
      device);
}

int emt_lstm_max_clusters_bwd_bf16(int cluster, int rows, int units,
                                   int resident, int slots, int splits,
                                   int threads, int smem, int device) {
  return max_clusters<bf16>(
      Plan{cluster, rows, units, resident, slots, splits, threads, smem},
      device);
}

const char* emt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
