// Flash attention backward in bf16 on the Hopper tensor cores: dQ, dK and
// dV of the forward's masked softmax attention, for every head width the
// forward serves (multiples of 8 up to 256).
//
// Replaces no TPU kernel: the reference trains through its plain
// attention (src/repro/models/attention.py, attend_full) and has no
// Pallas backward; its gradient here is written by hand because the
// forward is.  f32 takes the split-TF32 kernels of flash_attention_bwd.cu.
// Computes, per (batch, q head h, q row i, key j) with g = h / (H / KV)
// the KV head:
//   P_ij  = exp(scale q_i . k_j - lse_i) where visible, else 0;
//   D_i   = dO_i . O_i;
//   dV_j += P'_ij dO_i       (P' = P rounded to bf16, as the reference's
//                             p . v);
//   dS_ij = P_ij (dO_i . v_j - D_i);
//   dQ_i  = scale sum_j dS'_ij k_j;   dK_j += scale dS'_ij q_i
// with dS' = dS rounded to bf16 as a wgmma operand (FlashAttention-2 and
// -3 round it too).  The sums over the G query heads of a KV head fall
// into dK_g and dV_g.  Visible as the forward: k < kv_len, k <= q if
// causal, k > q - window if window > 0.  Scores, P, dS and every sum are
// f32; outputs bf16, rounded once at the store.  Layout as the forward's:
// q, o, dO, dq (B, Sq, H, hd); k, v, dk, dv (B, Skv, KV, hd); lse (B, H,
// Sq) f32.
//
// Bound on the H100 by operations: five products over the visible pairs
// (the two score products again, dV, dK, dQ), 10 hd flops a pair and
// head, at 989 TFLOP/s in bf16.  The design puts every product on wgmma
// and every tile on TMA (the forward's pattern, flash_attention_tc.cu):
//
// * flash_attention_bwd_tc_delta_kernel, a pre-pass bound by bytes (a
//   read of o and dO): for each packed row (below) the pair (lse log2 e,
//   D), +inf and 0 for the rows past G P or Sq, so that those rows give
//   P = 0 without a test.  The pairs of a tile are 512 contiguous bytes,
//   which one bulk copy brings beside the tile.
// * Packed tiles: a 64-row q tile holds P = 64 / G positions x the G heads
//   of one KV head, loaded by the forward's 5-D map (hd, G, KV, Sq, B).
//   Each K / V tile then meets all G heads at once (no loop over the
//   heads, q and dO read once per key block).  Rows past G P are zeroed
//   once and never stored; rows past Sq come from TMA as zeros.
// * The key side, one block per (b, KV head, 128 keys), two consumer
//   warpgroups of 64 keys and one producer warpgroup.  K and V arrive once
//   by TMA through 4-D maps that end at kv_len (so the keys past it are
//   zeros and no weight meets what lies there), and stay in shared memory
//   with the 128-byte swizzle.  The producer streams the packed q and dO
//   tiles that can see the block's keys (causal and window bounds)
//   through a ring of stages with full / empty mbarriers.  Per tile: S^T
//   = K q^T and dP^T = V dO^T by wgmma_ss_n64 (M = keys, N = packed rows,
//   K-major over hd); P^T and dS^T in f32 registers, the masks built only
//   on edge tiles and applied by selection; dV += P^T dO and dK += dS^T q
//   by wgmma_rs_tn with P^T and dS^T as bf16 register A fragments and dO
//   and q as MN-major B operands (the transpose bit, as V in the
//   forward's P V).  dP^T lands while P^T is computed, dV runs while dS^T
//   is.  dK and dV stay in registers for the whole walk: no atomics.  Key
//   blocks are issued low first (blockIdx.y), the ones that see the most
//   q tiles under causal masking, to even out the tail.  Up to hd 128 one
//   kernel (flash_attention_bwd_tc_dkdv_kernel) accumulates both dK and
//   dV.  Past it a consumer thread would hold dK and dV (2 x hd / 2) and
//   S^T and dP^T (2 x 32) accumulators, 224 at hd 160 and 320 at hd 256,
//   beyond the 240 registers setmaxnreg gives: so two kernels split the
//   work, flash_attention_bwd_tc_dv_kernel (S^T again, P^T, dV: hd / 2 +
//   32 accumulators) and flash_attention_bwd_tc_dk_kernel (S^T, dP^T,
//   dS^T, dK: hd / 2 + 64), eight products in all instead of seven.
// * flash_attention_bwd_tc_dq_kernel: the forward's skeleton, one block
//   per (b, KV head, 2 x 64 packed rows) with K / V through the ring:
//   S = q K^T and dP = dO V^T by wgmma_ss_n64, dS to bf16 A fragments,
//   dQ += dS K with K as an MN-major B operand (hd / 2 + 64
//   accumulators).  Deterministic, no f32 scratch.
// * Widths.  Each instantiation covers HDP columns (Width): the score
//   products run HDP / 16 k-steps and the register-A products N = HDP,
//   so hd 160 multiplies no padding (N = 160 spans two and a half
//   64-column swizzle atoms of the MN-major B).  Five instantiations: 64
//   (hd 8-64), 128 (72-128), 160 (136-160), 192 (168-192), 256
//   (200-256); columns past hd are TMA's zeros.
// * Keeping wgmma asynchronous.  ptxas serializes every wgmma of a kernel
//   (advisories C7515 / C7514 / C7518 under -Xptxas -v; 1.8x slower here)
//   when a wgmma sits on a branch it must treat as divergent, when a
//   non-wgmma instruction writes or reads an accumulator while it may be
//   in flight, or when a run-time bound splits a product's k-steps.  So
//   the warpgroup index comes from a shuffle (uniform), every k-step runs,
//   the first k-step writes its accumulator without reading it, P and dS
//   go to arrays of their own, and each tile is one straight run of
//   commit groups and waits (issuing the next tile's scores early made
//   ptxas lose track of the groups).  The edge tiles' position of a
//   packed row is col / G by a float reciprocal: an integer division cost
//   a fifth of the dK / dV kernel.
// * Registers: the producer warpgroup gives its registers back
//   (setmaxnreg.dec to 24) and the consumers take them (inc to 240); the
//   most accumulators a consumer thread holds is 192 (dK + dV + S^T +
//   dP^T at hd 128; dK + S^T + dP^T and dQ + S + dP at hd 256).  ptxas
//   reports 168 a thread at launch (384 threads, one block per SM) and no
//   spills.
// * Shared memory (KvCfg, QCfg): 64-row boxes of 128 bytes per 64
//   columns.  Up to hd 128 the key side holds K and V of both warpgroups
//   and 4 (hd <= 64, 101,448 bytes) or 3 (166,456) ring stages, the dQ
//   kernel q and dO and as many stages.  Past hd 128 each kernel takes
//   the most stages (up to 3) that fit the H100's 232,448 bytes beside
//   its resident tiles: at hd 136-192 (3 boxes) the dV kernel, resident K
//   only, 3 (199,224), the dK and dQ kernels 2 (198,696 and 197,672); at
//   hd 200-256 (4 boxes) the dV kernel 2 (198,696), the dK and dQ kernels
//   1 (198,168 and 197,656: their copies then wait for the tile before
//   to be released).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "flash_wgmma.cuh"

using namespace flash;

namespace {

constexpr int WGS = 2;                      // consumer warpgroups
constexpr int THREADS = 128 * (WGS + 1);    // + one producer warpgroup
constexpr int ROWS = 64;                    // rows of a packed tile
constexpr int KT = 64;                      // keys of a warpgroup's tile
constexpr int BOX_COLS = 64;                // hd columns per box (128 B)
constexpr int BOX_BYTES = 64 * 128;         // 64 rows of 128 B
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int SMEM_LIMIT = 232448;          // a block's on the H100
constexpr float LOG2E = 1.4426950408889634f;

// The width an instantiation covers, HDP: hd rounded up to 64, 128, 160,
// 192 or 256.  NCH boxes of 64 columns hold it; the score products run
// HDP / 16 k-steps and the register-A products N = HDP columns.
template <int HDP>
struct Width {
  static constexpr int NCH = (HDP + BOX_COLS - 1) / BOX_COLS;
  static constexpr int KSTEPS = HDP / 16;
  static constexpr int NACC = HDP / 2;   // a 64 x HDP accumulator
  static constexpr int STAGE = 2 * NCH * BOX_BYTES;   // two tiles
};

// What a key-side kernel accumulates: dK and dV together (up to hd 128),
// or, past hd 128, dV alone and dK alone in two kernels (the two
// accumulators and the two score tiles would exceed 240 registers).
enum Part { DKDV, DV, DK };

constexpr int smem_bytes(int fixed, int stage, int stages) {
  // 1024 of slack to align the tiles for the 128-byte swizzle; the
  // mbarriers.
  return 1024 + fixed + stages * stage + 8 * (1 + 2 * stages);
}

// The most ring stages (up to 3) that fit the H100 beside `fixed`.
constexpr int stages_that_fit(int fixed, int stage) {
  int s = 3;
  while (s > 1 && smem_bytes(fixed, stage, s) > SMEM_LIMIT) --s;
  return s;
}

// A key-side kernel: resident K (and V unless DV) of both warpgroups; a
// ring of q + dO stages, each with 512 bytes of (lse log2 e, D) pairs.
template <int HDP, int PART>
struct KvCfg {
  using W = Width<HDP>;
  static constexpr int LSD = ROWS * 8;        // 64 (lse log2 e, D) pairs
  static constexpr int FIXED =
      (PART == DV ? 1 : 2) * WGS * W::NCH * BOX_BYTES;
  static constexpr int STAGES =
      W::NCH == 1   ? 4
      : W::NCH == 2 ? 3
                    : stages_that_fit(FIXED, W::STAGE + LSD);
  static constexpr int SMEM = smem_bytes(FIXED, W::STAGE + LSD, STAGES);
};

// The dQ kernel: resident q and dO of both warpgroups, a ring of K + V
// stages.
template <int HDP>
struct QCfg {
  using W = Width<HDP>;
  static constexpr int FIXED = 2 * WGS * W::NCH * BOX_BYTES;
  static constexpr int STAGES = W::NCH <= 2
                                    ? KvCfg<HDP, DKDV>::STAGES
                                    : stages_that_fit(FIXED, W::STAGE);
  static constexpr int SMEM = smem_bytes(FIXED, W::STAGE, STAGES);
};

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))),
      "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Zero rows [used, 64) of `boxes` boxes from `base` (no TMA box writes
// them), then make the zeros visible to the async proxy (wgmma, TMA).
__device__ __forceinline__ void zero_pad_rows(uint8_t* base, int boxes,
                                              int used) {
  if (used >= ROWS) return;
  const int pad = ROWS - used;
  for (int e = threadIdx.x; e < boxes * pad * 8; e += THREADS) {
    const int box = (e >> 3) / pad;
    const int r = used + (e >> 3) % pad;
    *reinterpret_cast<uint4*>(base + box * BOX_BYTES + r * 128 +
                              (e & 7) * 16) = make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x by the SFU, subnormal results flushed to zero (P below 2^-126 is
// 0 to a bf16 product anyway); exp2(-inf) = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four bf16 A fragments (16 of the 64 columns each) of a 64 x 64 f32
// accumulator in the wgmma layout.
__device__ __forceinline__ void pack_frags(const float (&x)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc (64 x 64) = A . B^T over the first 16 KSTEPS columns of the boxes
// from a_addr and b_addr, both K-major.  Every k-step runs, also past hd
// (TMA filled those columns with zeros): a run-time bound between the
// wgmma of one group makes ptxas serialize them (C7515).
template <int KSTEPS>
__device__ __forceinline__ void product_ss(float (&acc)[32], uint32_t a_addr,
                                           uint32_t b_addr) {
  wgmma_ss_n64_zero(acc, desc_sw128(a_addr, 16, 1024),
                    desc_sw128(b_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < KSTEPS; ++kk) {
    const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
    wgmma_ss_n64(acc, desc_sw128(a_addr + off, 16, 1024),
                 desc_sw128(b_addr + off, 16, 1024), 1);
  }
}

// acc (64 x N) += A (registers, 64 x 64) . B (64 rows x the first N
// columns of the boxes from b_addr, MN-major).
template <int N>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_tn<N>(acc, a[kk],
                   desc_sw128(b_addr + kk * 2048, BOX_BYTES, 1024));
}

// Issue acc = A . B^T and acc2 = A2 . B2^T as two commit groups (the
// score products of a tile: S and dP, or S^T and dP^T).  The kernels
// compute P and dS into arrays of their own, never into acc or acc2, for
// the reason wgmma_ss_n64_zero gives.
template <int KSTEPS>
__device__ __forceinline__ void issue_scores(float (&acc)[32],
                                             float (&acc2)[32],
                                             uint32_t a_addr, uint32_t b_addr,
                                             uint32_t a2_addr,
                                             uint32_t b2_addr) {
  wgmma_fence();
  product_ss<KSTEPS>(acc, a_addr, b_addr);
  wgmma_commit();
  product_ss<KSTEPS>(acc2, a2_addr, b2_addr);
  wgmma_commit();
}

// The ring's bookkeeping for the block's tiles t0, t0 + 1, ...: tile t
// sits in stage (t - t0) % STAGES.  A consumer warp waits for a tile to
// land and releases it with one arrival.
template <int STAGES>
struct Ring {
  const uint64_t* bars;   // [full x STAGES][empty x STAGES]
  int t0;
  __device__ __forceinline__ int stage(int t) const {
    return (t - t0) % STAGES;
  }
  __device__ __forceinline__ void wait(int t) const {
    mbar_wait(smem_u32(&bars[stage(t)]), ((t - t0) / STAGES) & 1);
  }
  __device__ __forceinline__ void release(int t) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
      mbar_arrive(smem_u32(&bars[STAGES + stage(t)]));
  }
};

// (lse log2 e, D) of every packed row: row r of tile t of (b, g) is
// position t P + r / G of head g G + r % G.  Eight lanes a row, 16 bytes
// of o and of dO a lane and step.
constexpr int DELTA_THREADS = 256;
constexpr int DELTA_LANES = 8;

__global__ void __launch_bounds__(DELTA_THREADS)
flash_attention_bwd_tc_delta_kernel(const __nv_bfloat16* __restrict__ o,
                                    const __nv_bfloat16* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    float2* __restrict__ lsd, int rows,
                                    int Sq, int H, int KV, int hd,
                                    int ntiles) {
  const int row = blockIdx.x * (DELTA_THREADS / DELTA_LANES) +
                  threadIdx.x / DELTA_LANES;
  const int lane = threadIdx.x % DELTA_LANES;
  if (row >= rows) return;   // whole groups of eight lanes
  const int G = H / KV;
  const int P = ROWS / G;
  const int r = row & (ROWS - 1);
  const int bgt = row / ROWS;                // (b KV + g) ntiles + t
  const int t = bgt % ntiles;
  const int bg = bgt / ntiles;
  const int b = bg / KV;
  const int pos = t * P + r / G;
  const int head = (bg - b * KV) * G + r % G;
  if (r >= G * P || pos >= Sq) {
    if (lane == 0) lsd[row] = make_float2(INFINITY, 0.f);
    return;
  }
  const int64_t at = (((int64_t)b * Sq + pos) * H + head) * hd;
  float sum = 0.f;
  for (int c = 8 * lane; c < hd; c += 8 * DELTA_LANES) {
    float x[8], y[8];
    load8(o + at + c, x);
    load8(dout + at + c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(x[e], y[e], sum);
  }
  // The eight lanes of a row are adjacent and all live.
  const unsigned group = 0xffu << (threadIdx.x & 24);
#pragma unroll
  for (int off = DELTA_LANES / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(group, sum, off);
  if (lane == 0)
    lsd[row] = make_float2(lse[((int64_t)b * H + head) * Sq + pos] * LOG2E,
                           sum);
}

// The key side: dK and / or dV (PART) of the block's 2 x 64 keys.
template <int HDP, int PART>
__device__ __forceinline__ void key_side(const CUtensorMap* qmap,
                                         const CUtensorMap* omap,
                                         const CUtensorMap* kmap,
                                         const CUtensorMap* vmap,
                                         const float2* __restrict__ lsd,
                                         __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv,
                                         int Sq, int Skv, int H, int KV,
                                         int hd, int kv_len, int causal,
                                         int window, int ntiles, float scale,
                                         float scale_log2) {
  using W = Width<HDP>;
  using C = KvCfg<HDP, PART>;
  constexpr int NCH = W::NCH;
  constexpr int STAGES = C::STAGES;
  constexpr bool WANT_DK = PART != DV, WANT_DV = PART != DK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* kvs = smem;                 // K [WGS][NCH] boxes, V [WGS][NCH]
  uint8_t* ring = smem + C::FIXED;     // [STAGES][q NCH boxes, dO NCH]
  float4* lsd_s = reinterpret_cast<float4*>(ring + STAGES * W::STAGE);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + STAGES * (W::STAGE + C::LSD));
  // bars[0]: K and V landed; bars[1 + s]: stage s full; bars[1 + STAGES +
  // s]: stage s empty (one arrival per consumer warp).

  const int G = H / KV;
  const int P = ROWS / G;
  const int rows_used = G * P;
  const int bg = blockIdx.x;
  const int b = bg / KV;
  const int g = bg - b * KV;
  const int k_lo = blockIdx.y * (WGS * KT);
  // The positions [q0, q1) that can see a key of [k_lo, k_hi].
  const int k_hi = min(k_lo + WGS * KT, kv_len) - 1;
  const int q0 = causal ? k_lo : 0;
  int q1 = k_hi < k_lo ? q0 : Sq;
  if (window > 0) q1 = min(q1, k_hi + window);
  const int t0 = q0 / P;
  const int t1 = q1 > q0 ? (q1 + P - 1) / P : t0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // The warpgroup, uniform to the compiler (a shuffle from lane 0): the
  // branches around wgmma depend on it, and a branch ptxas must treat as
  // divergent serializes every wgmma of the kernel (C7518).
  const int group = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), 1);
      mbar_init(smem_u32(&bars[1 + STAGES + s]), WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_pad_rows(ring, STAGES * 2 * NCH, rows_used);
  __syncthreads();

  if (group == 0) {
    // Producer warpgroup: one lane issues every copy.
    regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      const uint32_t kvbar = smem_u32(&bars[0]);
      mbar_expect_tx(kvbar, C::FIXED);
      for (int w = 0; w < WGS; ++w)
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(smem_u32(kvs + (w * NCH + c) * BOX_BYTES), kmap,
                      kvbar, c * BOX_COLS, g, k_lo + w * KT, b);
          if constexpr (WANT_DK)
            tma_load_4d(smem_u32(kvs + ((WGS + w) * NCH + c) * BOX_BYTES),
                        vmap, kvbar, c * BOX_COLS, g, k_lo + w * KT, b);
        }
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(smem_u32(&bars[1 + STAGES + s]), ((i / STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&bars[1 + s]);
        mbar_expect_tx(full, 2 * NCH * rows_used * 128 + C::LSD);
        uint8_t* st = ring + s * W::STAGE;
        for (int c = 0; c < NCH; ++c) {
          tma_load_5d(smem_u32(st + c * BOX_BYTES), qmap, full,
                      c * BOX_COLS, 0, g, t * P, b);
          tma_load_5d(smem_u32(st + (NCH + c) * BOX_BYTES), omap, full,
                      c * BOX_COLS, 0, g, t * P, b);
        }
        bulk_load(smem_u32(lsd_s + s * (ROWS / 2)),
                  lsd + ((int64_t)bg * ntiles + t) * ROWS, C::LSD, full);
      }
    }
    return;
  }
  regs_inc<CONSUMER_REGS>();

  // Consumer warpgroup wg: keys ka + r0 and ka + r0 + 8 of its 64.
  const int wg = group - 1;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int ka = k_lo + wg * KT;
  const int kl = min(ka + KT, kv_len) - 1;   // its last key below kv_len
  const float inv_g = 1.f / G;
  const uint32_t kaddr = smem_u32(kvs + wg * NCH * BOX_BYTES);
  const uint32_t vaddr = smem_u32(kvs + (WGS + wg) * NCH * BOX_BYTES);
  // dK, dV: 64 keys x HDP columns (one register where the part has none).
  float dkacc[WANT_DK ? W::NACC : 1], dvacc[WANT_DV ? W::NACC : 1];
#pragma unroll
  for (int i = 0; i < W::NACC; ++i) {
    if constexpr (WANT_DK) dkacc[i] = 0.f;
    if constexpr (WANT_DV) dvacc[i] = 0.f;
  }
  const Ring<STAGES> ring_at{bars + 1, t0};
  // The q tiles that see one of this warpgroup's keys: a run [a0, a1) of
  // the block's [t0, t1) (causal and window bounds).
  int a0 = t1, a1 = t1;
  for (int t = t0; t < t1; ++t) {
    const int pa = t * P;
    const int pb = min(pa + P, Sq) - 1;
    if (kl >= ka && (!causal || ka <= pb) &&
        (window <= 0 || kl > pa - window)) {
      a0 = min(a0, t);
      a1 = t + 1;
    }
  }
  mbar_wait(smem_u32(&bars[0]), 0);
  for (int t = t0; t < a0; ++t) {
    ring_at.wait(t);
    ring_at.release(t);
  }
  // Each tile of the run: the score products (S^T alone for dV), then dV
  // while dS^T is computed, then dK.  A straight run of commit groups and
  // waits, which ptxas can follow, so that the wgmma stay asynchronous.
  for (int t = a0; t < a1; ++t) {
    const uint32_t qaddr = smem_u32(ring + ring_at.stage(t) * W::STAGE);
    const uint32_t oaddr = qaddr + NCH * BOX_BYTES;
    ring_at.wait(t);
    float st[32], dpt[32];   // S^T, dP^T
    if constexpr (WANT_DK) {
      issue_scores<W::KSTEPS>(st, dpt, kaddr, qaddr, vaddr, oaddr);
      wgmma_wait<1>();   // S^T has landed
    } else {
      wgmma_fence();
      product_ss<W::KSTEPS>(st, kaddr, qaddr);
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(st);

    const int pa = t * P;
    const int pb = min(pa + P, Sq) - 1;
    const bool edge = ka + KT > kv_len || (causal && ka + KT - 1 > pa) ||
                      (window > 0 && ka <= pb - window);
    const float4* ls = lsd_s + ring_at.stage(t) * (ROWS / 2);
    uint32_t hidden = 0;   // bit 4j + e: element masked out
    float pt[32];          // P^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 l2 = ls[4 * j + (lane & 3)];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(st[4 * j + e], scale_log2,
                                -((e & 1) ? l2.z : l2.x)));
        if (edge) {
          // The packed row's position: col / G, exact by the float
          // reciprocal for col < 64 (an integer division would cost more
          // than the tile's products).
          const float col = 8 * j + 2 * (lane & 3) + (e & 1) + 0.5f;
          if (!visible(pa + (int)(col * inv_g), ka + r0 + 8 * (e >> 1),
                       kv_len, causal, window)) {
            p = 0.f;
            hidden |= 1u << (4 * j + e);
          }
        }
        pt[4 * j + e] = p;
      }
    }
    if constexpr (WANT_DV) {
      uint32_t frag[4][4];
      pack_frags(pt, frag);
      fence_regs(dvacc);
      wgmma_fence();
      product_rs<HDP>(dvacc, frag, oaddr);           // dV += P^T dO
      wgmma_commit();
    }
    if constexpr (WANT_DK) {
      wgmma_wait<WANT_DV ? 1 : 0>();                 // dP^T has landed
      fence_regs(dpt);
      float ds[32];          // dS^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 l2 = ls[4 * j + (lane & 3)];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = (e & 1) ? l2.w : l2.y;
          ds[4 * j + e] = (hidden >> (4 * j + e)) & 1
                              ? 0.f
                              : pt[4 * j + e] * (dpt[4 * j + e] - d);
        }
      }
      uint32_t dfrag[4][4];
      pack_frags(ds, dfrag);
      fence_regs(dkacc);
      wgmma_fence();
      product_rs<HDP>(dkacc, dfrag, qaddr);          // dK += dS^T q
      wgmma_commit();
    }
    wgmma_wait<0>();
    if constexpr (WANT_DV) fence_regs(dvacc);
    if constexpr (WANT_DK) fence_regs(dkacc);
    ring_at.release(t);
  }
  for (int t = a1; t < t1; ++t) {
    ring_at.wait(t);
    ring_at.release(t);
  }

  // Every key row below Skv is written: zeros where no query sees it.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = ka + r0 + 8 * h;
    if (key >= Skv) continue;
    const int64_t at = (((int64_t)b * Skv + key) * KV + g) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < hd) {
        if constexpr (WANT_DK)
          *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
              __floats2bfloat162_rn(dkacc[4 * j + 2 * h] * scale,
                                    dkacc[4 * j + 2 * h + 1] * scale);
        if constexpr (WANT_DV)
          *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
              __floats2bfloat162_rn(dvacc[4 * j + 2 * h],
                                    dvacc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// The key-side kernels: one block per (b, KV head, 128 keys).  dK and dV
// together up to hd 128; past it dV and dK apart.
#define KEY_SIDE_PARAMS                                                     \
  const __grid_constant__ CUtensorMap qmap,                                 \
      const __grid_constant__ CUtensorMap omap,                             \
      const __grid_constant__ CUtensorMap kmap,                             \
      const __grid_constant__ CUtensorMap vmap,                             \
      const float2* __restrict__ lsd, __nv_bfloat16* __restrict__ dk,       \
      __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H, int KV,       \
      int hd, int kv_len, int causal, int window, int ntiles, float scale,  \
      float scale_log2
#define KEY_SIDE_ARGS                                                       \
  &qmap, &omap, &kmap, &vmap, lsd, dk, dv, Sq, Skv, H, KV, hd, kv_len,      \
      causal, window, ntiles, scale, scale_log2

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_tc_dkdv_kernel(KEY_SIDE_PARAMS) {
  key_side<HDP, DKDV>(KEY_SIDE_ARGS);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_tc_dv_kernel(KEY_SIDE_PARAMS) {
  key_side<HDP, DV>(KEY_SIDE_ARGS);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_tc_dk_kernel(KEY_SIDE_PARAMS) {
  key_side<HDP, DK>(KEY_SIDE_ARGS);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap omap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const float2* __restrict__ lsd,
                                 __nv_bfloat16* __restrict__ dq, int Sq,
                                 int H, int KV, int hd, int kv_len,
                                 int causal, int window, int ntiles,
                                 float scale, float scale_log2) {
  using W = Width<HDP>;
  using C = QCfg<HDP>;
  constexpr int NCH = W::NCH;
  constexpr int STAGES = C::STAGES;
  constexpr int NACC = W::NACC;      // dQ: 64 rows x HDP columns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;                  // q [WGS][NCH] boxes, dO [WGS][NCH]
  uint8_t* ring = smem + C::FIXED;     // [STAGES][K NCH boxes, V NCH]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * W::STAGE);

  const int G = H / KV;
  const int P = ROWS / G;
  const int rows_used = G * P;
  const int bg = blockIdx.x;
  const int b = bg / KV;
  const int g = bg - b * KV;
  // Under causal masking the last rows see the most keys: issue them
  // first.
  const int qblk = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int p0 = qblk * WGS * P;
  int lo, hi;
  kv_range(p0, min(p0 + WGS * P, Sq) - 1, kv_len, causal, window, &lo,
           &hi);
  const int t0 = lo / KT;
  const int t1 = (hi + KT - 1) / KT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // The warpgroup, uniform to the compiler (a shuffle from lane 0): the
  // branches around wgmma depend on it, and a branch ptxas must treat as
  // divergent serializes every wgmma of the kernel (C7518).
  const int group = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), 1);
      mbar_init(smem_u32(&bars[1 + STAGES + s]), WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_pad_rows(qs, 2 * WGS * NCH, rows_used);
  __syncthreads();

  if (group == 0) {
    regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      const uint32_t qbar = smem_u32(&bars[0]);
      mbar_expect_tx(qbar, 2 * WGS * NCH * rows_used * 128);
      for (int w = 0; w < WGS; ++w)
        for (int c = 0; c < NCH; ++c) {
          tma_load_5d(smem_u32(qs + (w * NCH + c) * BOX_BYTES), &qmap, qbar,
                      c * BOX_COLS, 0, g, p0 + w * P, b);
          tma_load_5d(smem_u32(qs + ((WGS + w) * NCH + c) * BOX_BYTES),
                      &omap, qbar, c * BOX_COLS, 0, g, p0 + w * P, b);
        }
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(smem_u32(&bars[1 + STAGES + s]), ((i / STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&bars[1 + s]);
        mbar_expect_tx(full, W::STAGE);
        uint8_t* st = ring + s * W::STAGE;
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(smem_u32(st + c * BOX_BYTES), &kmap, full,
                      c * BOX_COLS, g, t * KT, b);
          tma_load_4d(smem_u32(st + (NCH + c) * BOX_BYTES), &vmap, full,
                      c * BOX_COLS, g, t * KT, b);
        }
      }
    }
    return;
  }
  regs_inc<CONSUMER_REGS>();

  // Consumer warpgroup wg: rows r0 and r0 + 8 of its packed tile.
  const int wg = group - 1;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int tile = qblk * WGS + wg;
  const int qa = p0 + wg * P;
  const bool any = qa < Sq;
  const int qb = min(qa + P, Sq) - 1;
  int wlo = 0, whi = 0;
  if (any) kv_range(qa, qb, kv_len, causal, window, &wlo, &whi);
  int qpos[2], head[2];
  bool live[2];
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    qpos[h] = qa + r / G;
    head[h] = g * G + r % G;
    live[h] = r < rows_used && qpos[h] < Sq;
    const float2 x = any ? lsd[((int64_t)bg * ntiles + tile) * ROWS + r]
                         : make_float2(INFINITY, 0.f);
    l2[h] = x.x;
    dd[h] = x.y;
  }
  const uint32_t qaddr = smem_u32(qs + wg * NCH * BOX_BYTES);
  const uint32_t oaddr = smem_u32(qs + (WGS + wg) * NCH * BOX_BYTES);
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const Ring<STAGES> ring_at{bars + 1, t0};
  // The K / V tiles this warpgroup's rows see: a run [a0, a1) of the
  // block's [t0, t1).
  int a0 = t1, a1 = t1;
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * KT;
    if (any && wlo < whi && k0 < whi && k0 + KT > wlo) {
      a0 = min(a0, t);
      a1 = t + 1;
    }
  }
  mbar_wait(smem_u32(&bars[0]), 0);
  for (int t = t0; t < a0; ++t) {
    ring_at.wait(t);
    ring_at.release(t);
  }
  // Each tile of the run: the score products, P while dP lands, dS, dQ.
  for (int t = a0; t < a1; ++t) {
    const int k0 = t * KT;
    const uint32_t kaddr = smem_u32(ring + ring_at.stage(t) * W::STAGE);
    const uint32_t vaddr = kaddr + NCH * BOX_BYTES;
    ring_at.wait(t);
    float sacc[32], dpacc[32];   // S, dP
    issue_scores<W::KSTEPS>(sacc, dpacc, qaddr, kaddr, oaddr, vaddr);
    wgmma_wait<1>();   // S has landed
    fence_regs(sacc);

    const bool edge = k0 + KT > kv_len || (causal && k0 + KT - 1 > qa) ||
                      (window > 0 && k0 <= qb - window);
    uint32_t hidden = 0;
    float pq[32];          // P
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2_ftz(fmaf(sacc[4 * j + e], scale_log2, -l2[h]));
        if (edge && !visible(qpos[h], k0 + 8 * j + 2 * (lane & 3) + (e & 1),
                             kv_len, causal, window)) {
          p = 0.f;
          hidden |= 1u << (4 * j + e);
        }
        pq[4 * j + e] = p;
      }
    wgmma_wait<0>();   // dP has landed
    fence_regs(dpacc);
    float ds[32];          // dS
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[4 * j + e] = (hidden >> (4 * j + e)) & 1
                            ? 0.f
                            : pq[4 * j + e] * (dpacc[4 * j + e] - dd[e >> 1]);
    uint32_t dfrag[4][4];
    pack_frags(ds, dfrag);
    fence_regs(acc);
    wgmma_fence();
    product_rs<HDP>(acc, dfrag, kaddr);               // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    ring_at.release(t);
  }
  for (int t = a1; t < t1; ++t) {
    ring_at.wait(t);
    ring_at.release(t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    __nv_bfloat16* row =
        dq + (((int64_t)b * Sq + qpos[h]) * H + head[h]) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale,
                                  acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// Set a key-side or dQ kernel's shared memory and launch it on `grid`.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int smem, cudaStream_t stream,
                  Args... args) {
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float2* lsd, void* dq,
                  void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                  int hd, int kv_len, int causal, int window, float scale,
                  cudaStream_t stream) {
  const int G = H / KV;
  const int P = ROWS / G;
  const int ntiles = (Sq + P - 1) / P;
  CUtensorMap qmap, omap, kmap, vmap;
  const cuuint64_t qdims[5] = {(cuuint64_t)hd, (cuuint64_t)G, (cuuint64_t)KV,
                               (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint32_t qbox[5] = {BOX_COLS, (cuuint32_t)G, 1, (cuuint32_t)P, 1};
  const cuuint64_t kdims[4] = {(cuuint64_t)hd, (cuuint64_t)KV,
                               (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kext[4] = {(cuuint64_t)hd, (cuuint64_t)KV,
                              (cuuint64_t)(kv_len > 0 ? kv_len : 1),
                              (cuuint64_t)B};
  const cuuint32_t kbox[4] = {BOX_COLS, 1, KT, 1};
  int err = encode_map(&qmap, q, 2, 5, qdims, qbox);
  if (err == 0) err = encode_map(&omap, dout, 2, 5, qdims, qbox);
  if (err == 0) err = encode_map(&kmap, k, 2, 4, kdims, kbox, true, kext);
  if (err == 0) err = encode_map(&vmap, v, 2, 4, kdims, kbox, true, kext);
  if (err != 0) return err;

  const int rows = B * KV * ntiles * ROWS;
  constexpr int per_block = DELTA_THREADS / DELTA_LANES;
  flash_attention_bwd_tc_delta_kernel<<<(rows + per_block - 1) / per_block,
                                        DELTA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lsd, rows, Sq, H, KV,
      hd, ntiles);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  const float scale_log2 = scale * LOG2E;
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(dv);
  const dim3 grid_kv(B * KV, (Skv + WGS * KT - 1) / (WGS * KT));
#define KEY_SIDE_LAUNCH(kernel, part)                                     \
  launch_kernel(kernel<HDP>, grid_kv, KvCfg<HDP, part>::SMEM, stream, qmap, \
                omap, kmap, vmap, (const float2*)lsd, dkp, dvp, Sq, Skv, H, \
                KV, hd, kv_len, causal, window, ntiles, scale, scale_log2)
  if constexpr (Width<HDP>::NCH <= 2) {
    err = KEY_SIDE_LAUNCH(flash_attention_bwd_tc_dkdv_kernel, DKDV);
  } else {
    err = KEY_SIDE_LAUNCH(flash_attention_bwd_tc_dv_kernel, DV);
    if (err == 0) err = KEY_SIDE_LAUNCH(flash_attention_bwd_tc_dk_kernel, DK);
  }
#undef KEY_SIDE_LAUNCH
  if (err != 0) return err;
  const dim3 grid_q(B * KV, (Sq + WGS * P - 1) / (WGS * P));
  return launch_kernel(flash_attention_bwd_tc_dq_kernel<HDP>, grid_q,
                       QCfg<HDP>::SMEM, stream, qmap, omap, kmap, vmap,
                       (const float2*)lsd, static_cast<__nv_bfloat16*>(dq),
                       Sq, H, KV, hd, kv_len, causal, window, ntiles, scale,
                       scale_log2);
}

// The largest dynamic shared memory of the kernels of one width.
template <int HDP>
constexpr int smem_of() {
  const int kv = Width<HDP>::NCH <= 2
                     ? KvCfg<HDP, DKDV>::SMEM
                     : (KvCfg<HDP, DV>::SMEM > KvCfg<HDP, DK>::SMEM
                            ? KvCfg<HDP, DV>::SMEM
                            : KvCfg<HDP, DK>::SMEM);
  return kv > QCfg<HDP>::SMEM ? kv : QCfg<HDP>::SMEM;
}

}  // namespace

// dQ, dK, dV in bf16 (hd a multiple of 8 up to 256, H / KV <= 64) of the
// forward with these masks.  `scratch`: (B, KV, ceil(Sq / P), 64, 2) f32,
// P = 64 / (H / KV), for the packed rows' (lse log2 e, D).  Three
// launches on `stream` (four past hd 128); returns the first cudaError,
// -(CUresult) if a tensor map could not be encoded, or 0.
extern "C" int flash_attention_bwd_tc(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* scratch, void* dq, void* dk,
                                      void* dv, int B, int Sq, int Skv,
                                      int H, int KV, int hd, int kv_len,
                                      int causal, int window, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float2* lsd = static_cast<float2*>(scratch);
#define LAUNCH_WIDTH(HDP)                                                   \
  launch_bwd_tc<HDP>(q, k, v, o, dout, l, lsd, dq, dk, dv, B, Sq, Skv, H,   \
                     KV, hd, kv_len, causal, window, scale, s)
  if (hd <= 64) return LAUNCH_WIDTH(64);
  if (hd <= 128) return LAUNCH_WIDTH(128);
  if (hd <= 160) return LAUNCH_WIDTH(160);
  if (hd <= 192) return LAUNCH_WIDTH(192);
  return LAUNCH_WIDTH(256);
#undef LAUNCH_WIDTH
}

// The largest dynamic shared memory of the kernels at this hd, mirrored
// by flash_attention.bwd_tc_smem_bytes in Python; -1 past hd 256.
extern "C" int flash_attention_bwd_tc_smem(int hd) {
  if (hd <= 64) return smem_of<64>();
  if (hd <= 128) return smem_of<128>();
  if (hd <= 160) return smem_of<160>();
  if (hd <= 192) return smem_of<192>();
  return hd <= 256 ? smem_of<256>() : -1;
}
