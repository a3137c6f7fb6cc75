// Flash attention backward in f32 on the Hopper tensor cores, as split
// TF32 products (flash_tf32.cuh): dQ, dK and dV of the f32 forward's
// masked softmax attention (flash_attention.cu).  bf16 goes to the
// wgmma kernels of flash_attention_bwd_tc.cu at every width.
//
// Replaces no TPU kernel: the reference trains through its plain
// attention (src/repro/models/attention.py, attend_full) and has no
// Pallas backward.  The port's forward is a kernel written by hand, so
// its gradient is one too.  Computes, per (batch, q head h, q row i, key
// j) with g = h / (H / KV) the KV head:
//   P_ij  = exp(scale q_i . k_j - lse_i) where visible, else 0 (lse from
//           the forward: the row's log-sum-exp of the scaled scores);
//   D_i   = dO_i . O_i;
//   dV_j += P_ij dO_i;
//   dS_ij = P_ij (dO_i . v_j - D_i);
//   dQ_i  = scale sum_j dS_ij k_j;   dK_j += scale dS_ij q_i.
// The sums over the G query heads of a KV head fall into dK_g and dV_g.
// Visible as the forward: k < kv_len, k <= q if causal, k > q - window
// if window > 0, positions of q and k both from 0 (so Sq != Skv is
// cross-attention).  Inputs, outputs, P, dS, D, the exponentials and
// every sum are f32; the seven products (S^T, dP^T, dV, dK; S, dP, dQ)
// take f32 operands split into two TF32 halves each, three tensor-core
// products a k-step, which keeps the route's 1e-4 limit (one TF32
// product would not).  Layout as the forward's: q, o, dO, dq (B, Sq, H,
// hd); k, v, dk, dv (B, Skv, KV, hd); lse (B, H, Sq).  hd a multiple of
// 8 up to 256.
//
// Bound on the H100 by operations: five products over the visible pairs
// (the two score products again, dV, dK, dQ), 10 hd flops a pair and
// head.  f32-accurate products cost three TF32 products, so the least
// time is at 495 / 3 = 165 TFLOP/s.  What held the CUDA-core kernels
// this replaces (about 0.22 of the old 67 TFLOP/s bound) and what this
// design does about it:
//   - Shared-memory bandwidth: 4 x 4 register patches read a float per
//     two FMAs.  Here a warp's m16n8k8 product reads 8 bytes a lane of
//     each operand for 3 x 1024 multiply-adds.
//   - No overlap of loads with products: tiles were staged by plain loads
//     between barriers.  Here one producer warp streams the tiles by TMA
//     into a ring of stages with full / empty mbarriers, so the next tile
//     lands while this one is multiplied.
//
// * flash_attention_bwd_lsd_kernel, a pre-pass bound by bytes (a read of
//   o and dO): for each (b, h) and position q < SP (Sq rounded up to 64)
//   the pair (lse log2 e, D), (+inf, 0) past Sq (P = 2^(scale log2 e s -
//   lse log2 e), as the forward's softmax in log2 units), so that those
//   rows give P = 0 with no test.  A dK / dV tile's pairs are contiguous, and one bulk
//   copy brings them beside it.
// * flash_attention_bwd_dkdv_kernel: one block per (b, KV head, tile of
//   KEYS keys), 16 keys a consumer warp, K and V resident (TMA, 4-D maps
//   that end at kv_len: the keys past it are zeros and no weight meets
//   what lies there).  A producer warp streams, for each of the G query
//   heads, the q and dO tiles of QT positions that can see the block's
//   keys (causal and window bounds: wholly masked tiles are never
//   loaded), so the group's sum stays inside the block: no atomics, K
//   and V read once.  Per tile: S^T = K q^T and dP^T = V dO^T (keys x
//   positions), P^T and dS^T in registers, selected (not multiplied) by
//   the mask on the tiles that straddle an edge, then dV += P^T dO and
//   dK += dS^T q with P^T and dS^T straight from the score registers.
//   Up to hd 128 eight warps (128 keys, 32 positions a tile) hold dK and
//   dV whole; past it four (64 keys, 16 positions) hold half their
//   columns each, in two blocks (blockIdx.z) that both compute S^T and
//   dP^T in full: 2 x hd / 2 + 2 x QT / 2 accumulators a thread either
//   way.  Key blocks start low first: under causal masking they see the
//   most tiles.
// * flash_attention_bwd_dq_kernel: the f32 prefill's block over packed q
//   tiles (flash_tf32.cuh's Packed: one block per (b, KV head, TILES x 64
//   packed rows of P = 64 / G positions x the G heads), its producer and
//   ring of K / V stages and its rows' masks), with q and dO resident.
//   S = q K^T, dP = dO V^T, dS in registers, dQ += dS K.
// * Both tiled kernels: eight consumer warps take a producer warpgroup
//   whose registers they claim (setmaxnreg); four take a producer warp.
//   Every sum over positions or keys (dV, dK, dQ) runs a tile at a time
//   in fresh mma accumulators added in f32 (the tensor cores truncate as
//   they accumulate), a box of 32 columns at a time (four n-blocks, the
//   split terms in a second chain).  The score products run a box at a
//   time in a loop the compiler does not unroll: fully unrolled, the
//   backward ran slower on the H100 (the tile's code, some thousands of
//   instructions, the likely cause: the instruction cache).
// * Shared memory: every tile in 128-byte swizzled boxes of 32 columns
//   (flash_tf32.cuh; TMA writes them, fragment reads are free of bank
//   conflicts), mirrored by flash_attention.bwd_smem_bytes in Python.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "flash_tf32.cuh"

using namespace flash;
using namespace flash::tf32;

namespace {

// Positions of a (b, h) slab of (lse, D) pairs: Sq rounded up to 64.
__host__ __device__ constexpr int lsd_rows(int Sq) {
  return (Sq + 63) / 64 * 64;
}

// The dK / dV kernel: resident K and V of KEYS keys; a ring of q + dO
// stages of QT positions, each with its QT (lse, D) pairs.
template <int NB>
struct KvCfg {
  static constexpr int WARPS = NB <= 4 ? 8 : 4;      // consumer warps
  static constexpr int KEYS = 16 * WARPS;
  static constexpr int QT = NB <= 4 ? 32 : 16;       // positions a tile
  static constexpr int PARTS = NB <= 4 ? 1 : 2;      // column parts
  static constexpr int NC = 4 * NB / PARTS;          // 8-column n-blocks
  static constexpr int THREADS = block_threads(WARPS);
  static constexpr int KV_BOX = KEYS * ROW_BYTES;
  static constexpr int Q_BOX = QT * ROW_BYTES;
  static constexpr int FIXED = 2 * NB * KV_BOX;
  static constexpr int LSD = 8 * QT;
  static constexpr int STAGE = 2 * NB * Q_BOX + LSD;
  static constexpr int STAGES = stages_that_fit(FIXED, STAGE, 4, SMEM_LIMIT);
  static constexpr int SMEM = smem_bytes(FIXED, STAGE, STAGES);
};

// The dQ kernel: resident q and dO of TILES 64-row packed tiles; a ring
// of K + V stages of KT keys.
template <int NB>
using DqCfg = PackedCfg<NB, NB <= 4 ? 8 : 4, NB <= 6 ? 32 : 16, 2>;

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))),
      "r"(bytes), "r"(bar)
      : "memory");
}

// Eight lanes a row, 8 floats of o and of dO a lane and step.
constexpr int LSD_THREADS = 256;
constexpr int LSD_LANES = 8;

__global__ void __launch_bounds__(LSD_THREADS)
flash_attention_bwd_lsd_kernel(const float* __restrict__ o,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               float2* __restrict__ lsd, int rows, int Sq,
                               int H, int hd, int sp) {
  const int row = blockIdx.x * (LSD_THREADS / LSD_LANES) +
                  threadIdx.x / LSD_LANES;
  const int lane = threadIdx.x % LSD_LANES;
  if (row >= rows) return;   // whole groups of eight lanes
  const int q = row % sp;
  const int bh = row / sp;   // b H + h
  if (q >= Sq) {
    if (lane == 0) lsd[row] = make_float2(INFINITY, 0.f);
    return;
  }
  const int h = bh % H;
  const int b = bh / H;
  const int64_t at = (((int64_t)b * Sq + q) * H + h) * hd;
  float sum = 0.f;
  for (int c = 8 * lane; c < hd; c += 8 * LSD_LANES) {
    float x[8], y[8];
    load8(o + at + c, x);
    load8(dout + at + c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(x[e], y[e], sum);
  }
  // The eight lanes of a row are adjacent and all live.
  const unsigned group = 0xffu << (threadIdx.x & 24);
#pragma unroll
  for (int off = LSD_LANES / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(group, sum, off);
  if (lane == 0)
    lsd[row] = make_float2(lse[(int64_t)bh * Sq + q] * LOG2E, sum);
}

// acc (16 x the part's NBOX boxes of 32 columns) += A (16 x 8 NJ, from
// accumulators) . the part's columns of rows 0 .. 8 NJ - 1 of `tile`, a
// box at a time (eight chains: four n-blocks, split terms apart), each
// box's product over the tile in fresh accumulators added in f32.  Part
// p holds boxes p NBOX .. p NBOX + NBOX - 1; boxes past hd are skipped.
template <int NBOX, int NJ>
__device__ __forceinline__ void box_products(float (&acc)[4 * NBOX][4],
                                             const FragA (&a)[NJ],
                                             const Tile& tile, int part,
                                             int box_bytes, const Lane& ln,
                                             int hd) {
  const Tile tp{tile.base + part * NBOX * box_bytes, box_bytes};
#pragma unroll
  for (int cb = 0; cb < NBOX; ++cb) {
    if (BOX_COLS * (part * NBOX + cb) < hd) {
      float big[4][4], small[4][4];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[c4][e] = small[c4][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          FragB b;
          tp.load_b_mn(b, ln, j, 4 * cb + c4);
          mma3_split(big[c4], small[c4], a[j], b);
        }
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * cb + c4][e] += big[c4][e] + small[c4][e];
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(KvCfg<NB>::THREADS, 1)
flash_attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap omap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const float2* __restrict__ lsd,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int Sq, int Skv,
                                int H, int KV, int hd, int kv_len,
                                int causal, int window, int sp,
                                float scale) {
  using C = KvCfg<NB>;
  constexpr int STAGES = C::STAGES;
  const float scale_log2 = scale * LOG2E;
  constexpr int NJ = C::QT / 8;   // n-blocks of a score tile
  constexpr int NC = C::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* kvs = smem;                  // K NB boxes, V NB boxes
  uint8_t* ring = smem + C::FIXED;      // [STAGES][q NB boxes, dO NB]
  float2* lsd_s =
      reinterpret_cast<float2*>(ring + STAGES * 2 * NB * C::Q_BOX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(lsd_s + STAGES * C::QT);
  // bars[0]: K and V landed; bars[1 + s]: stage s full; bars[1 + STAGES +
  // s]: stage s empty (one arrival per consumer warp).

  const int G = H / KV;
  const int bg = blockIdx.x;
  const int b = bg / KV;
  const int g = bg - b * KV;
  // Key blocks low first: under causal masking they see the most tiles.
  const int k_lo = blockIdx.y * C::KEYS;
  const int part = blockIdx.z;
  // The positions [q0, q1) that can see a key of [k_lo, k_hi].
  const int k_hi = min(k_lo + C::KEYS, kv_len) - 1;
  const int q0 = causal ? k_lo : 0;
  int q1 = k_hi < k_lo ? q0 : Sq;
  if (window > 0) q1 = min(q1, k_hi + window);
  const int tq0 = q0 / C::QT;
  const int nt = q1 > q0 ? (q1 + C::QT - 1) / C::QT - tq0 : 0;
  const int n = G * nt;                 // tiles streamed: heads x tiles
  const int nbox = (hd + BOX_COLS - 1) / BOX_COLS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), 1);
      mbar_init(smem_u32(&bars[1 + STAGES + s]), C::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::WARPS) {
    // Producer: one lane issues every copy.
    if constexpr (C::WARPS == 8) regs_release<PRODUCER_REGS>();
    if (warp == C::WARPS && lane == 0 && n > 0) {
      const uint32_t kvbar = smem_u32(&bars[0]);
      mbar_expect_tx(kvbar, 2 * nbox * C::KV_BOX);
      for (int c = 0; c < nbox; ++c) {
        tma_load_4d(smem_u32(kvs + c * C::KV_BOX), &kmap, kvbar,
                    c * BOX_COLS, g, k_lo, b);
        tma_load_4d(smem_u32(kvs + (NB + c) * C::KV_BOX), &vmap, kvbar,
                    c * BOX_COLS, g, k_lo, b);
      }
      for (int i = 0; i < n; ++i) {
        const int h = g * G + i / nt;
        const int t = tq0 + i % nt;
        const int s = i % STAGES;
        mbar_wait(smem_u32(&bars[1 + STAGES + s]), ((i / STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&bars[1 + s]);
        mbar_expect_tx(full, 2 * nbox * C::Q_BOX + C::LSD);
        uint8_t* st = ring + s * 2 * NB * C::Q_BOX;
        for (int c = 0; c < nbox; ++c) {
          tma_load_4d(smem_u32(st + c * C::Q_BOX), &qmap, full,
                      c * BOX_COLS, h, t * C::QT, b);
          tma_load_4d(smem_u32(st + (NB + c) * C::Q_BOX), &omap, full,
                      c * BOX_COLS, h, t * C::QT, b);
        }
        bulk_load(smem_u32(lsd_s + s * C::QT),
                  lsd + ((int64_t)b * H + h) * sp + t * C::QT, C::LSD, full);
      }
    }
    return;
  }

  if constexpr (C::WARPS == 8) regs_claim<CONSUMER_REGS>();
  // Consumer warp: keys ka + g and ka + g + 8 of the block's.
  const Lane ln(lane);
  const int m0 = 16 * warp;
  const int ka = k_lo + m0;
  const int kl = min(ka + 15, kv_len - 1);   // its last key below kv_len
  const Tile kt{kvs, C::KV_BOX};
  const Tile vt{kvs + NB * C::KV_BOX, C::KV_BOX};
  // This block's part of the columns: n-blocks part NC .. part NC + NC - 1.
  const int c_lo = part * NC;
  float dka[NC][4], dva[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;
  if (n > 0) mbar_wait(smem_u32(&bars[0]), 0);

  for (int i = 0; i < n; ++i) {
    const int t = tq0 + i % nt;
    const int s = i % STAGES;
    mbar_wait(smem_u32(&bars[1 + s]), (i / STAGES) & 1);
    const int pa = t * C::QT;
    const int pb = min(pa + C::QT, Sq) - 1;
    if (kl >= ka && (!causal || ka <= pb) &&
        (window <= 0 || kl > pa - window)) {
      const uint8_t* st = ring + s * 2 * NB * C::Q_BOX;
      const Tile qt{st, C::Q_BOX};
      const Tile ot{st + NB * C::Q_BOX, C::Q_BOX};
      // S^T = K q^T and dP^T = V dO^T over hd (keys x positions).
      float sct[NJ][4], dpt[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sct[j][e] = dpt[j][e] = 0.f;
#pragma unroll 1
      for (int cb = 0; cb < NB; ++cb) {
        if (box_live(cb, hd)) {
#pragma unroll
          for (int ks = 4 * cb; ks < 4 * cb + 4; ++ks) {
            FragA ak, av;
            kt.load_a(ak, ln, ks, m0);
            vt.load_a(av, ln, ks, m0);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              FragB bq, bo;
              qt.load_b(bq, ln, ks, 8 * j);
              mma3(sct[j], ak, bq);
              ot.load_b(bo, ln, ks, 8 * j);
              mma3(dpt[j], av, bo);
            }
          }
        }
      }
      // P^T and dS^T, selected to 0 where a pair is masked; positions
      // past Sq carry lse = +inf, so their P is 0 with no test.
      const bool edge = ka + 16 > kv_len || (causal && ka + 15 > pa) ||
                        (window > 0 && ka <= pb - window);
      const float4* ls = reinterpret_cast<const float4*>(lsd_s + s * C::QT);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 l2 = ls[4 * j + ln.t];   // positions 8j + 2t, + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool vis =
              !edge || visible(pa + 8 * j + 2 * ln.t + (e & 1),
                               ka + ln.g + 8 * (e >> 1), kv_len, causal,
                               window);
          const float p =
              vis ? exp2f(fmaf(sct[j][e], scale_log2,
                               -((e & 1) ? l2.z : l2.x)))
                  : 0.f;
          sct[j][e] = p;
          dpt[j][e] = vis ? p * (dpt[j][e] - ((e & 1) ? l2.w : l2.y)) : 0.f;
        }
      }
      // dV += P^T dO, then dK += dS^T q, over this part's columns a box
      // of 32 at a time (columns past hd are TMA's zeros), its four
      // n-blocks' products over the tile in fresh accumulators.
      FragA fa[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc_to_a(fa[j], sct[j]);
      box_products<NC / 4, NJ>(dva, fa, ot, part, C::Q_BOX, ln, hd);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc_to_a(fa[j], dpt[j]);
      box_products<NC / 4, NJ>(dka, fa, qt, part, C::Q_BOX, ln, hd);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[1 + STAGES + s]));
  }
  // Every key row below Skv is written: zeros where no query sees it.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = ka + ln.g + 8 * h;
    if (key >= Skv) continue;
    const int64_t row = (((int64_t)b * Skv + key) * KV + g) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 8 * (c_lo + c) + 2 * ln.t;
      if (8 * (c_lo + c) < hd) {
        *reinterpret_cast<float2*>(dk + row + col) =
            make_float2(dka[c][2 * h] * scale, dka[c][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dv + row + col) =
            make_float2(dva[c][2 * h], dva[c][2 * h + 1]);
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(DqCfg<NB>::THREADS, 1)
flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap omap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const float2* __restrict__ lsd,
                              float* __restrict__ dq, int Sq, int H, int KV,
                              int hd, int kv_len, int causal, int window,
                              int sp, float scale) {
  using C = DqCfg<NB>;
  const float scale_log2 = scale * LOG2E;
  constexpr int NJ = C::KT / 8;
  constexpr int NC = 4 * NB;
  extern __shared__ uint8_t smem_raw[];
  const Packed<C> blk(smem_raw, Sq, H, KV, hd, kv_len, causal, window);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  blk.init(tid);

  if (warp >= C::WARPS) {
    if constexpr (C::WARPS == 8) regs_release<PRODUCER_REGS>();
    if (warp == C::WARPS && lane == 0) {
      const CUtensorMap* const qmaps[2] = {&qmap, &omap};
      blk.produce(qmaps, &kmap, &vmap);
    }
    return;
  }

  if constexpr (C::WARPS == 8) regs_claim<CONSUMER_REGS>();
  const Lane ln(lane);
  const PackedRows rw(blk, warp, ln, Sq, kv_len, causal, window);
  const int m0 = rw.m0;
  float lse_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 x =
        rw.live[h]
            ? lsd[((int64_t)blk.b * H + rw.head[h]) * sp + rw.qpos[h]]
            : make_float2(INFINITY, 0.f);
    lse_r[h] = x.x;
    d_r[h] = x.y;
  }
  const Tile qt = blk.resident(0, rw.wt);
  const Tile ot = blk.resident(1, rw.wt);
  float dqa[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[c][e] = 0.f;
  blk.wait_resident();

  for (int t = blk.t0, i = 0; t < blk.t1; ++t, ++i) {
    const int k0 = t * C::KT;
    blk.wait_full(i);
    if (rw.sees(k0, C::KT)) {
      const Tile kt = blk.k_tile(i);
      const Tile vt = blk.v_tile(i);
      // S = q K^T and dP = dO V^T over hd, two chains each.
      float sc[NJ][4], dp[NJ][4], scs[NJ][4], dps[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = dp[j][e] = scs[j][e] = dps[j][e] = 0.f;
#pragma unroll 1
      for (int cb = 0; cb < NB; ++cb) {
        if (box_live(cb, hd)) {
#pragma unroll
          for (int ks = 4 * cb; ks < 4 * cb + 4; ++ks) {
            FragA aq, ao;
            qt.load_a(aq, ln, ks, m0);
            ot.load_a(ao, ln, ks, m0);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              FragB bk, bv;
              kt.load_b(bk, ln, ks, 8 * j);
              mma3_split(sc[j], scs[j], aq, bk);
              vt.load_b(bv, ln, ks, 8 * j);
              mma3_split(dp[j], dps[j], ao, bv);
            }
          }
        }
      }
      const bool edge = rw.edge(k0, C::KT, kv_len, causal, window);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const bool vis =
              !edge || visible(rw.qpos[h], k0 + 8 * j + 2 * ln.t + (e & 1),
                               kv_len, causal, window);
          const float p =
              vis ? exp2f(fmaf(sc[j][e] + scs[j][e], scale_log2, -lse_r[h]))
                  : 0.f;
          sc[j][e] = vis ? p * (dp[j][e] + dps[j][e] - d_r[h]) : 0.f;   // dS
        }
      // dQ += dS K, dS straight from the score registers.
      FragA ad[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc_to_a(ad[j], sc[j]);
      box_products<NB, NJ>(dqa, ad, kt, 0, C::KV_BOX, ln, hd);
    }
    blk.release(i, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rw.live[h]) continue;
    float* row =
        dq + (((int64_t)blk.b * Sq + rw.qpos[h]) * H + rw.head[h]) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (8 * c < hd)
        *reinterpret_cast<float2*>(row + 8 * c + 2 * ln.t) = make_float2(
            dqa[c][2 * h] * scale, dqa[c][2 * h + 1] * scale);
  }
}

template <int NB>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float2* lsd, float* dq, float* dk, float* dv, int B, int Sq,
               int Skv, int H, int KV, int hd, int kv_len, int causal,
               int window, float scale, cudaStream_t stream) {
  using KC = KvCfg<NB>;
  using QC = DqCfg<NB>;
  const int sp = lsd_rows(Sq);
  const int rows = B * H * sp;
  const int per = LSD_THREADS / LSD_LANES;
  flash_attention_bwd_lsd_kernel<<<(rows + per - 1) / per, LSD_THREADS, 0,
                                   stream>>>(o, dout, lse, lsd, rows, Sq, H,
                                             hd, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // K and V end at kv_len: the keys past it come back as zeros.  q and dO
  // by head here (the dK / dV kernel), packed by KV head for dQ.
  const cuuint64_t q4[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)Sq,
                            (cuuint64_t)B};
  const cuuint32_t q4_box[4] = {BOX_COLS, 1, KC::QT, 1};
  CUtensorMap kmap, vmap, qmap, omap;
  int rc = encode_keys(&kmap, k, B, Skv, KV, hd, kv_len, KC::KEYS);
  if (rc == 0) rc = encode_keys(&vmap, v, B, Skv, KV, hd, kv_len, KC::KEYS);
  if (rc == 0) rc = encode_map(&qmap, q, 4, 4, q4, q4_box);
  if (rc == 0) rc = encode_map(&omap, dout, 4, 4, q4, q4_box);
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KC::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv(B * KV, (Skv + KC::KEYS - 1) / KC::KEYS, KC::PARTS);
  flash_attention_bwd_dkdv_kernel<NB>
      <<<grid_kv, KC::THREADS, KC::SMEM, stream>>>(
          qmap, omap, kmap, vmap, lsd, dk, dv, Sq, Skv, H, KV, hd, kv_len,
          causal, window, sp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  rc = encode_keys(&kmap, k, B, Skv, KV, hd, kv_len, QC::KT);
  if (rc == 0) rc = encode_keys(&vmap, v, B, Skv, KV, hd, kv_len, QC::KT);
  if (rc == 0) rc = encode_packed(&qmap, q, B, Sq, H, KV, hd);
  if (rc == 0) rc = encode_packed(&omap, dout, B, Sq, H, KV, hd);
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QC::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dq_kernel<NB>
      <<<packed_grid<QC>(B, Sq, H, KV), QC::THREADS, QC::SMEM, stream>>>(
      qmap, omap, kmap, vmap, lsd, dq, Sq, H, KV, hd, kv_len, causal, window,
      sp, scale);
  return (int)cudaGetLastError();
}

template <int NB>
constexpr int bwd_smem() {
  return KvCfg<NB>::SMEM > DqCfg<NB>::SMEM ? KvCfg<NB>::SMEM
                                           : DqCfg<NB>::SMEM;
}

}  // namespace

// dQ, dK, dV in f32 of the forward with these masks.  `delta` is f32
// scratch of B x H x SP x 2 floats (SP = Sq rounded up to 64) for the
// rows' (lse, D) pairs.  H / KV <= 64.  Three launches on `stream`;
// returns the first cudaError, or -(CUresult) if a tensor map could not
// be encoded, or 0.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Skv, int H, int KV,
                                   int hd, int kv_len, int causal, int window,
                                   float scale, void* stream) {
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(o);
  const float* fdo = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  float2* lsd = static_cast<float2*>(delta);
  float* fdq = static_cast<float*>(dq);
  float* fdk = static_cast<float*>(dk);
  float* fdv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (boxes(hd)) {
    case 2:
      return launch_bwd<2>(fq, fk, fv, fo, fdo, fl, lsd, fdq, fdk, fdv, B, Sq,
                           Skv, H, KV, hd, kv_len, causal, window, scale, s);
    case 4:
      return launch_bwd<4>(fq, fk, fv, fo, fdo, fl, lsd, fdq, fdk, fdv, B, Sq,
                           Skv, H, KV, hd, kv_len, causal, window, scale, s);
    case 6:
      return launch_bwd<6>(fq, fk, fv, fo, fdo, fl, lsd, fdq, fdk, fdv, B, Sq,
                           Skv, H, KV, hd, kv_len, causal, window, scale, s);
    default:
      return launch_bwd<8>(fq, fk, fv, fo, fdo, fl, lsd, fdq, fdk, fdv, B, Sq,
                           Skv, H, KV, hd, kv_len, causal, window, scale, s);
  }
}

// The backward's largest dynamic shared memory (of its dK / dV and dQ
// kernels), mirrored by flash_attention.bwd_smem_bytes in Python.
extern "C" int flash_attention_bwd_smem(int hd) {
  switch (boxes(hd)) {
    case 2: return bwd_smem<2>();
    case 4: return bwd_smem<4>();
    case 6: return bwd_smem<6>();
    default: return bwd_smem<8>();
  }
}
