// Flash attention forward (online softmax) for the model zoo's attention:
// the f32 prefill on the tensor cores as split-precision TF32 products
// (flash_tf32.cuh) and the decode (one query row), in f32 or bf16.  The
// bf16 prefill runs on wgmma (flash_attention_tc.cu).
//
// Replaces the TPU kernel flash_attention_kernel (_flash_kernel) of
// src/repro/kernels/flash_attention.py.  Computes, per (batch, q head,
// q row):  s = q k^T scale; visible where k < kv_len, and k <= q if
// causal, and k > q - window if window > 0 (positions of q and k both
// start at 0); online max/sum rescaling with p . v accumulated in f32;
// out = acc / max(l, 1e-30) in the input type.  Masked entries get p =
// 0, so a row with nothing visible gives 0.  For training the prefill
// also writes each row's log-sum-exp m + log(l) of the scaled scores
// (+inf for a row with nothing visible), which the backward
// (flash_attention_bwd.cu) reads; serving passes no lse and writes none.
//
// Layout is the model's: q (B, Sq, H, hd), k and v (B, Skv, KV, hd),
// out (B, Sq, H, hd), contiguous.  q head h reads KV head h / (H / KV):
// grouped-query attention by index, with no repeated copy of K and V.
// hd is a multiple of 8, <= 256.
//
// Bound on the H100: at prefill by operations (4 hd flops per visible
// pair; in f32 three TF32 products each, 495 / 3 = 165 TFLOP/s), at
// decode by bytes (the whole K/V cache is read once).
//
// * flash_attention_f32_kernel (f32 prefill).  The f32 route must agree
//   with the plain version to 1e-5: one TF32 product cannot, split TF32
//   can (each operand as tf32 hi + tf32 lo, three mma.sync m16n8k8 tf32
//   products a k-step; flash_tf32.cuh has the arithmetic and the
//   fragment layouts).  What held the CUDA-core kernel it replaces (0.39
//   of its 67 TFLOP/s bound) and what this design does about it:
//   - Shared-memory bandwidth (4 x 4 register patches, a float read per
//     two FMAs): a warp's m16n8k8 product reads 8 bytes a lane of each
//     operand for 3 x 1024 multiply-adds, from 128-byte swizzled tiles
//     without bank conflicts.
//   - K/V read once per query head: a 64-row q tile packs (position,
//     head) pairs, P = 64 / G positions x the G heads of one KV head (a
//     5-D tensor map (hd, G, KV, Sq, B), as the bf16 prefill), so each
//     K/V tile is loaded once for the whole group.
//   - No overlap of loads with products: one producer warp streams K/V
//     tiles by TMA into a ring of stages with full / empty mbarriers;
//     the maps end at kv_len, so the keys past it come back as zeros and
//     a zero weight never meets what lies there.
//   This block over packed q tiles is flash_tf32.cuh's Packed, which the
//   backward's dQ kernel shares.  Up to hd 128 two 64-row tiles (eight consumer warps, a producer
//   warpgroup whose registers they take) share each 64-key tile; past it
//   one tile and 32 keys.  A warp owns 16 rows: S = q K^T into two
//   accumulator chains, the online softmax in f32 in log2 units, then O
//   = alpha O + P V with P straight from the score registers and each
//   box of 32 columns' product in fresh accumulators (the tensor cores
//   truncate as they accumulate).  One division at the end.  The kv loop
//   runs only over tiles that hold a visible key (causal and window
//   bounds), the mask is built only on tiles that straddle an edge, and
//   blocks of the last positions, which see the most keys, start first.
// * flash_attention_decode_kernel, for Sq == 1, bound by bytes: one block
//   per (b, KV head, kv split) holds up to 4 (else 8) of the G = H / KV
//   query heads that share the KV head, so each K/V tile is read once for
//   all of them.  One producer warp streams K/V tiles of 32 whole rows by
//   TMA (one box each, rows of an odd count of 16 bytes) into a K ring
//   and a V ring (5 and 4 stages in bf16, 3 and 3 in f32) with full /
//   empty mbarriers (a K slot is free after the scores, a V slot after
//   p . v); four consumer warps
//   compute, so the next tiles are in flight while this one is worked on
//   and no thread spends instructions on copies.  bf16 scores run on the
//   tensor cores (mma.sync m16n8k16, q in registers, K by ldmatrix; the
//   softmax step straight from the fragments); f32 scores on the CUDA
//   cores (a lane per key, a warp per quarter of hd).  p stays f32 and
//   p . v runs on the CUDA cores: a thread takes 16 bytes of columns and
//   a group of keys for all rows, its sums kept in registers across tiles
//   and added up once at the end, so each element of V is loaded and
//   converted once.  A block's tiles form a chain of dependent steps, and
//   under load a tile takes several steps' time to arrive, so each block
//   keeps its loads far ahead (the deep rings; 3 blocks fit an SM in bf16
//   at danube's hd).  The kv range of a (b, KV head) is split into as
//   many blocks as the card holds at once, at most 16; they form one
//   thread block cluster, which merges their (m, l, acc) through
//   distributed shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "flash_attention.cuh"
#include "flash_tf32.cuh"

using namespace flash;
using repro::cluster_rank;
using repro::cluster_sync;
using repro::ld_cluster;

namespace {

constexpr int DEC_BK = 32;  // keys per decode tile: one per lane
constexpr int DEC_WARPS = 4;                         // consumer warps
constexpr int DEC_CONSUMERS = 32 * DEC_WARPS;
constexpr int DEC_THREADS = DEC_CONSUMERS + 32;      // + a producer warp

// ---------------------------------------------------------------------------
// f32 prefill / general Sq: split TF32 on the tensor cores
// ---------------------------------------------------------------------------

// Up to hd 128 two 64-row tiles (eight consumer warps) share each K/V
// tile of 64 keys; past it one tile (four warps) and 32 keys, so that q
// and two ring stages fit.
template <int NB>
using F32Cfg = tf32::PackedCfg<NB, NB <= 4 ? 8 : 4, NB <= 4 ? 64 : 32, 1>;

// LSE: write each row's log-sum-exp (training); serving compiles without.
template <int NB, bool LSE>
__global__ void __launch_bounds__(F32Cfg<NB>::THREADS, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           float* __restrict__ o, float* __restrict__ lse,
                           int Sq, int H, int KV, int hd, int kv_len,
                           int causal, int window, float scale_log2) {
  using C = F32Cfg<NB>;
  using namespace tf32;
  constexpr int NJ = C::KT / 8;     // n-blocks of a score tile
  constexpr int NC = 4 * NB;        // n-blocks of 8 output columns
  extern __shared__ uint8_t smem_raw[];
  const Packed<C> blk(smem_raw, Sq, H, KV, hd, kv_len, causal, window);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  blk.init(tid);

  if (warp >= C::WARPS) {
    // Producer: one lane issues every copy.
    if constexpr (C::WARPS == 8) regs_release<PRODUCER_REGS>();
    if (warp == C::WARPS && lane == 0) {
      const CUtensorMap* const qmaps[1] = {&qmap};
      blk.produce(qmaps, &kmap, &vmap);
    }
    return;
  }

  if constexpr (C::WARPS == 8) regs_claim<CONSUMER_REGS>();
  const Lane ln(lane);
  const PackedRows rw(blk, warp, ln, Sq, kv_len, causal, window);
  const int m0 = rw.m0;
  const Tile qt = blk.resident(0, rw.wt);

  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  blk.wait_resident();

  for (int t = blk.t0, i = 0; t < blk.t1; ++t, ++i) {
    const int k0 = t * C::KT;
    blk.wait_full(i);
    if (rw.sees(k0, C::KT)) {
      const Tile kt = blk.k_tile(i);
      const Tile vt = blk.v_tile(i);
      // S = q K^T over hd, 3 x TF32 a k-step, in two chains.
      float sc[NJ][4], scs[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = scs[j][e] = 0.f;
#pragma unroll 1
      for (int cb = 0; cb < NB; ++cb) {
        if (box_live(cb, hd)) {
#pragma unroll
          for (int ks = 4 * cb; ks < 4 * cb + 4; ++ks) {
            FragA a;
            qt.load_a(a, ln, ks, m0);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              FragB kb;
              kt.load_b(kb, ln, ks, 8 * j);
              mma3_split(sc[j], scs[j], a, kb);
            }
          }
        }
      }
      // Online softmax in f32; the mask only on tiles that straddle the
      // causal, window or kv_len edge (keys past kv_len are TMA's zeros).
      const bool edge = rw.edge(k0, C::KT, kv_len, causal, window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = (sc[j][e] + scs[j][e]) * scale_log2;
          if (edge && !visible(rw.qpos[h], k0 + 8 * j + 2 * ln.t + (e & 1),
                               kv_len, causal, window))
            x = NEG_INF;
          sc[j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float alpha[2], m_use[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        // No visible key yet: every x is NEG_INF and must give p = 0.
        m_use[h] = m_new == NEG_INF ? 0.f : m_new;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[j][e] - m_use[e >> 1]);
          sc[j][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
      // O = alpha O + P V, P straight from the score registers; a box of
      // 32 columns at a time (columns past hd are TMA's zeros), its four
      // n-blocks' products over the tile in fresh accumulators, two
      // chains each.
      FragA pa[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc_to_a(pa[j], sc[j]);
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        if (BOX_COLS * cb < hd) {
          float big[4][4], small[4][4];
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
            for (int e = 0; e < 4; ++e) big[c4][e] = small[c4][e] = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int c4 = 0; c4 < 4; ++c4) {
              FragB vb;
              vt.load_b_mn(vb, ln, j, 4 * cb + c4);
              mma3_split(big[c4], small[c4], pa[j], vb);
            }
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[4 * cb + c4][e] = fmaf(acc[4 * cb + c4][e], alpha[e >> 1],
                                         big[c4][e] + small[c4][e]);
        }
      }
    }
    blk.release(i, lane);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rw.live[h]) continue;
    // The row's log-sum-exp of the scaled scores for the backward, from
    // the log2 units of m and l; +inf where no key is visible, so that
    // every p of the row is 0 there.
    if constexpr (LSE) {
      if (ln.t == 0)
        lse[((int64_t)blk.b * H + rw.head[h]) * Sq + rw.qpos[h]] =
            l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : INFINITY;
    }
    float* orow =
        o + (((int64_t)blk.b * Sq + rw.qpos[h]) * H + rw.head[h]) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (8 * c < hd)
        *reinterpret_cast<float2*>(orow + 8 * c + 2 * ln.t) =
            make_float2(acc[c][2 * h] * inv[h], acc[c][2 * h + 1] * inv[h]);
  }
}

// ---------------------------------------------------------------------------
// Decode: Sq == 1, kv split over blocks
// ---------------------------------------------------------------------------

// Ring stages of the decode kernel by element size: bf16 keeps its loads
// far ahead (K, read a phase before V, one tile further); f32 tiles are
// twice the bytes, so fewer fit.
__host__ __device__ constexpr int dec_kstages(int elem) {
  return elem == 2 ? 5 : 3;
}
__host__ __device__ constexpr int dec_vstages(int elem) {
  return elem == 2 ? 4 : 3;
}
constexpr int MAX_SPLITS = 16;     // kv splits of a (b, KV head): a cluster

// Row stride, in elements, of a K/V tile in the decode kernel's ring.
// bf16: an odd count of 16 bytes, so that ldmatrix's 8 row addresses hit
// 8 bank groups: hd itself where it has one (the mma's last k-step then
// reads 8 columns past the row, which the kernel zeroes in registers),
// else hd rounded up to the mma depth of 16 and then to an odd count (TMA
// fills the extra columns with zeros); at most 256, a TMA box's width.
// f32: hd.
__host__ __device__ __forceinline__ int decode_ld(int elem, int hd) {
  if (elem == 4) return hd;
  if ((hd * 2 / 16) & 1) return hd;
  const int r16 = (hd + 15) / 16 * 16;
  const int ld = ((r16 * 2 / 16) | 1) * 8;
  return ld <= 256 ? ld : r16;
}

// p . v threads: `up` per key group (a power of two covering hd's
// 16-byte units), DEC_CONSUMERS / up key groups.
__host__ __device__ __forceinline__ int decode_up(int elem, int hd) {
  const int units = hd * elem / 16;
  int up = 1;
  while (up < units) up *= 2;
  return up;
}

// Blocks an SM must hold: the launch bound of each variant (GR query
// rows, KS mma k-steps kept in registers).
constexpr int decode_min_blocks(int GR, int KS) {
  return GR == 8 ? 2 : (KS == 16 ? 3 : 4);
}

// Shared memory of the decode kernel with GR query rows per block: 128
// bytes of alignment slack (TMA's); the rings of K and V tiles in the
// input type (after the loop, the key groups' partial sums); in f32 q,
// the scores (four warps' partial sums on the CUDA cores, one set from
// the tensor cores), two tiles' p, the running max and sum and two
// tiles' rescales; a full and an empty mbarrier per stage.
size_t decode_smem_bytes(int elem, int GR, int hd) {
  const int stages = dec_kstages(elem) + dec_vstages(elem);
  const size_t ring = (size_t)stages * DEC_BK * decode_ld(elem, hd) * elem;
  const size_t red = sizeof(float) * (size_t)(DEC_CONSUMERS /
                     decode_up(elem, hd)) * GR * hd;
  const int parts = elem == 2 ? 1 : DEC_WARPS;
  return 128 + (ring > red ? ring : red) +
         sizeof(float) * (size_t)(GR * hd + (parts + 2) * GR * DEC_BK +
                                  4 * GR) +
         16 * (size_t)stages;
}

__device__ __forceinline__ void load_unit(const float* p, float* d) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
}
__device__ __forceinline__ void load_unit(const __nv_bfloat16* p, float* d) {
  load8(p, d);
}

// Four 8 x 8 bf16 matrices from shared memory, as mma fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c(16 x 8, f32) += a(16 x 16, bf16) b(16 x 8, bf16); rows 8-15 of a are
// zero (a[0]: rows 0-7, k 0-7; a[1]: rows 0-7, k 8-15).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[2],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(0u), "r"(a[1]), "r"(0u), "r"(b0), "r"(b1));
}

// Barrier of the consumer warps only.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(DEC_CONSUMERS) : "memory");
}

// One block per (b, KV head, chunk of GR of its G query heads, kv
// split); grid (B * KV * chunks, nsplit), the nsplit splits of a chunk
// one cluster.  Warps 0-3 compute, warp 4 loads.  KS: bf16 scores by
// mma with q in registers for up to KS k-steps of 16 (f32: 0, scores on
// the CUDA cores).
template <typename T, int GR, int KS>
__global__ void __launch_bounds__(DEC_THREADS, decode_min_blocks(GR, KS))
flash_attention_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const T* __restrict__ q, T* __restrict__ o,
                              int H, int KV, int hd, int kv_len, int causal,
                              int window, float scale, int tiles_per_split) {
  constexpr int KST = dec_kstages(sizeof(T));
  constexpr int VST = dec_vstages(sizeof(T));
  constexpr int EPU = 16 / sizeof(T);         // elements per 16 bytes
  constexpr int PARTS = KS > 0 ? 1 : DEC_WARPS;   // partial score sets
  extern __shared__ uint8_t smem_raw[];
  // Offset the array itself (not a cast integer) so the compiler keeps
  // shared-memory loads.
  uint8_t* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int G = H / KV;
  const int chunks = (G + GR - 1) / GR;
  const int row_bytes = decode_ld(sizeof(T), hd) * sizeof(T);
  const int tile = DEC_BK * row_bytes;        // bytes of one K or V tile
  const int units = hd / EPU;                 // 16-byte units of a row
  const int up = decode_up(sizeof(T), hd);
  const int up_log2 = __ffs(up) - 1;
  const int kgroups = DEC_CONSUMERS >> up_log2;
  uint8_t* vring = ring + KST * tile;        // K ring, then V ring
  const int ring_bytes = max((KST + VST) * tile, kgroups * GR * hd * 4);
  float* Qs = reinterpret_cast<float*>(ring + ring_bytes);  // GR x hd
  float* Sp = Qs + GR * hd;                   // [PARTS][GR][DEC_BK] scores
  float* Ss = Sp + PARTS * GR * DEC_BK;       // [2][GR][DEC_BK] p
  float* Ms = Ss + 2 * GR * DEC_BK;           // GR running max
  float* Ls = Ms + GR;                        // GR running sum
  float* As = Ls + GR;                        // [2][GR] rescale of a tile
  uint64_t* kfull = reinterpret_cast<uint64_t*>(As + 2 * GR);
  uint64_t* kempty = kfull + KST;
  uint64_t* vfull = kempty + KST;
  uint64_t* vempty = vfull + VST;

  const int bgc = blockIdx.x;                 // (b * KV + g) * chunks + ch
  const int bg = bgc / chunks;
  const int row_lo = (bgc - bg * chunks) * GR;   // first of this chunk's rows
  const int nr = min(GR, G - row_lo);
  const int b = bg / KV;
  const int g = bg - b * KV;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q_row0 = ((int64_t)b * H + g * G + row_lo) * hd;

  int lo, hi;
  kv_range(0, 0, kv_len, causal, window, &lo, &hi);
  const int t_first = lo / DEC_BK + split * tiles_per_split;
  const int n = min((hi + DEC_BK - 1) / DEC_BK, t_first + tiles_per_split) -
                t_first;

  if (tid == 0) {
    for (int st = 0; st < KST; ++st) {
      mbar_init(smem_u32(&kfull[st]), 1);
      mbar_init(smem_u32(&kempty[st]), DEC_WARPS);
    }
    for (int st = 0; st < VST; ++st) {
      mbar_init(smem_u32(&vfull[st]), 1);
      mbar_init(smem_u32(&vempty[st]), DEC_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // mma scores: lane (gq, tq) holds q row gq's k-columns 2 tq, 2 tq + 1
  // and 8 + 2 tq, 9 + 2 tq of each 16, as bf16 pairs, loaded before the
  // K/V stream starts so that they do not queue behind it.
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int ksteps = (hd + 15) / 16;
  uint32_t qa[KS > 0 ? KS : 1][2];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * s + 8 * h + 2 * tq;
      qa[s][h] = warp < DEC_WARPS && gq < nr && col < hd
                     ? *reinterpret_cast<const uint32_t*>(
                           q + q_row0 + (int64_t)gq * hd + col)
                     : 0u;
    }
  __syncthreads();   // the barriers are set up; q's loads are issued

  // Thread 0 starts the first tiles at once (after the barriers are set up
  // and before anything waits on memory), so their latency overlaps the
  // staging of q.
  auto load = [&](const CUtensorMap* map, uint8_t* slots, uint64_t* bars,
                  int stages, int i) {
    const uint32_t bar = smem_u32(&bars[i % stages]);
    mbar_expect_tx(bar, tile);
    tma_load_4d(smem_u32(slots + (i % stages) * tile), map, bar, 0, g,
                (t_first + i) * DEC_BK, b);
  };
  if (tid == 0) {
    for (int i = 0; i < KST && i < n; ++i) load(&kmap, ring, kfull, KST, i);
    for (int i = 0; i < VST && i < n; ++i) load(&vmap, vring, vfull, VST, i);
  }
  // This chunk's query heads are contiguous rows of q; rows past G are 0.
  if (KS == 0)
    stage(Qs, hd, q, q_row0, (int64_t)hd, 0, GR, nr, hd, scale,
          DEC_THREADS);
  for (int r = tid; r < GR; r += DEC_THREADS) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.f;
  }
  __syncthreads();

  if (warp == DEC_WARPS) {
    // Producer: one TMA box of 32 whole rows per K and per V tile into
    // their rings (keys past Skv and columns past hd come back as
    // zeros), a slot refilled as soon as the four consumer warps have
    // released it: K after the scores, V after p . v.  Tile i of a
    // slot's round r waits for the round r - 1 release.
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        if (i >= KST) {
          mbar_wait(smem_u32(&kempty[i % KST]), ((i / KST) & 1) ^ 1);
          load(&kmap, ring, kfull, KST, i);
        }
        if (i >= VST) {
          mbar_wait(smem_u32(&vempty[i % VST]), ((i / VST) & 1) ^ 1);
          load(&vmap, vring, vfull, VST, i);
        }
      }
    }
    __syncwarp();
  } else {
    const int u_pv = tid & (up - 1);          // p . v: this thread's unit
    const int kq = tid >> up_log2;            // ... and key group
    // CUDA-core scores read rows `row_bytes` apart.  An odd count of
    // 16-byte units per row puts 8 lanes' unit u in 8 bank groups already;
    // otherwise each lane starts at unit `lane` (mod units) to that end.
    const int rot = (units & 1) ? 0 : lane;
    float acc[GR][EPU];
#pragma unroll
    for (int r = 0; r < GR; ++r)
#pragma unroll
      for (int e = 0; e < EPU; ++e) acc[r][e] = 0.f;

    for (int i = 0; i < n; ++i) {
      mbar_wait(smem_u32(&kfull[i % KST]), (i / KST) & 1);
      const uint8_t* Kt = ring + (i % KST) * tile;
      const uint8_t* Vt = vring + (i % VST) * tile;
      float* Sb = Ss + (i & 1) * GR * DEC_BK;
      float* Ab = As + (i & 1) * GR;
      const int k0 = (t_first + i) * DEC_BK;

      if constexpr (KS > 0) {
        // Scores on the tensor cores: warp w takes keys 8w .. 8w + 7
        // (n = 8), the query rows padded to 16 (m), hd in k-steps of 16,
        // even and odd k-steps in two chains; f32 sums, scaled after.
        // Lane (gq, tq) ends with row gq's scores of keys 8w + 2 tq and
        // 8w + 2 tq + 1.  Where hd is an odd count of 8 and the row is
        // not padded, the last k-step's ldmatrix reads 8 columns past the
        // row (the next row, or the next slot, whatever is there: stale
        // bytes, or a key past kv_len); those 8 x 8 matrices are set to
        // zero in registers, so an Inf or NaN there cannot reach a score.
        float ce[4] = {0.f, 0.f, 0.f, 0.f};
        float co[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t kaddr =
            smem_u32(Kt) + (warp * 8 + (lane & 7)) * row_bytes +
            16 * (lane >> 3);
#pragma unroll
        for (int s2 = 0; s2 < KS; s2 += 2) {
          if (s2 < ksteps) {
            uint32_t kb[4];
            ldmatrix_x4(kb, kaddr + 32 * s2);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (16 * s2 + 8 * j >= hd) kb[j] = 0u;
            mma_bf16(ce, qa[s2], kb[0], kb[1]);
            if (s2 + 1 < ksteps) mma_bf16(co, qa[s2 + 1], kb[2], kb[3]);
          }
        }
        __syncwarp();   // the warp's reads of K are done: free the slot
        if (lane == 0) mbar_arrive(smem_u32(&kempty[i % KST]));
        // The softmax step from the fragments: the row max from each
        // warp's 8 keys (2 shuffles) and the four warps' partials, p for
        // the lane's own 2 keys, the row sum the same way.
        const int key = 8 * warp + 2 * tq;
        const bool vis0 = visible(0, k0 + key, kv_len, causal, window);
        const bool vis1 = visible(0, k0 + key + 1, kv_len, causal, window);
        const float s0 = (ce[0] + co[0]) * scale;
        const float s1 = (ce[1] + co[1]) * scale;
        float* pmax = Sp;                 // [warp][8]
        float* psum = Sp + 8 * DEC_WARPS;  // [warp][8]
        float* mnew = Sp + 16 * DEC_WARPS;  // [8]
        float mx = fmaxf(vis0 ? s0 : NEG_INF, vis1 ? s1 : NEG_INF);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (tq == 0) pmax[warp * 8 + gq] = mx;
        consumers_sync();
        const float m_old = Ms[gq < GR ? gq : 0];
        float m_new = m_old;
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w)
          m_new = fmaxf(m_new, pmax[w * 8 + gq]);
        const float p0 = vis0 ? expf(s0 - m_new) : 0.f;
        const float p1 = vis1 ? expf(s1 - m_new) : 0.f;
        float sum = p0 + p1;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (gq < GR) {
          Sb[gq * DEC_BK + key] = p0;
          Sb[gq * DEC_BK + key + 1] = p1;
          if (tq == 0) psum[warp * 8 + gq] = sum;
          if (warp == 0 && tq == 0) {
            Ab[gq] = expf(m_old - m_new);
            mnew[gq] = m_new;
          }
        }
        // p, the rescales and the partial sums of tile i are ready; the
        // running max and sum move on (read again only after the next
        // tile's first barrier).
        consumers_sync();
        if (tid < GR) {
          float l = 0.f;
#pragma unroll
          for (int w = 0; w < DEC_WARPS; ++w) l += psum[w * 8 + tid];
          Ls[tid] = Ab[tid] * Ls[tid] + l;
          Ms[tid] = mnew[tid];
        }
      } else {
        // Scores on the CUDA cores: lane = key, warp w sums the 16-byte
        // units w, w + 4, ... of hd (rotated by `rot`), each K unit loaded
        // once for all GR rows of q (scaled in the staging).
        float sc[GR];
#pragma unroll
        for (int r = 0; r < GR; ++r) sc[r] = 0.f;
        int uu = warp + rot;
        while (uu >= units) uu -= units;
        const uint8_t* krow = Kt + lane * row_bytes;
        for (int u = warp; u < units; u += DEC_WARPS) {
          float kv[EPU];
          load_unit(reinterpret_cast<const T*>(krow + uu * 16), kv);
#pragma unroll
          for (int r = 0; r < GR; ++r) {
            const float* qr = Qs + r * hd + uu * EPU;
#pragma unroll
            for (int e = 0; e < EPU; e += 4) {
              const float4 a = *reinterpret_cast<const float4*>(qr + e);
              sc[r] = fmaf(a.x, kv[e], sc[r]);
              sc[r] = fmaf(a.y, kv[e + 1], sc[r]);
              sc[r] = fmaf(a.z, kv[e + 2], sc[r]);
              sc[r] = fmaf(a.w, kv[e + 3], sc[r]);
            }
          }
          uu += DEC_WARPS;
          while (uu >= units) uu -= units;
        }
        __syncwarp();   // the warp's reads of K are done: free the slot
        if (lane == 0) mbar_arrive(smem_u32(&kempty[i % KST]));
#pragma unroll
        for (int r = 0; r < GR; ++r)
          Sp[(warp * GR + r) * DEC_BK + lane] = sc[r];
        consumers_sync();

        // Softmax step: warp w takes rows w, w + 4, ..., lane = key.
        const bool vis = visible(0, k0 + lane, kv_len, causal, window);
        for (int r = warp; r < GR; r += DEC_WARPS) {
          float sv = 0.f;
#pragma unroll
          for (int w = 0; w < PARTS; ++w)
            sv += Sp[(w * GR + r) * DEC_BK + lane];
          float mx = vis ? sv : NEG_INF;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_old = Ms[r];
          const float m_new = fmaxf(m_old, mx);
          const float p = vis ? expf(sv - m_new) : 0.f;
          Sb[r * DEC_BK + lane] = p;
          float sum = p;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          __syncwarp();
          if (lane == 0) {
            const float alpha = expf(m_old - m_new);
            Ab[r] = alpha;
            Ls[r] = alpha * Ls[r] + sum;
            Ms[r] = m_new;
          }
        }
        // p of tile i is ready.  p and the rescales alternate between two
        // buffers and the scores were read above, so tile i + 1 can start
        // while this p . v runs.
        consumers_sync();
      }

      // p . v on the CUDA cores in f32: this thread's unit of columns
      // over keys kq, kq + kgroups, ... below kv_len (keys past it carry
      // p = 0 and are skipped).
      mbar_wait(smem_u32(&vfull[i % VST]), (i / VST) & 1);
      if (u_pv < units) {
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          const float alpha = Ab[r];
#pragma unroll
          for (int e = 0; e < EPU; ++e) acc[r][e] *= alpha;
        }
        const int rows = min(DEC_BK, kv_len - k0);
        for (int kk = kq; kk < rows; kk += kgroups) {
          float vv[EPU];
          load_unit(
              reinterpret_cast<const T*>(Vt + kk * row_bytes + u_pv * 16),
              vv);
#pragma unroll
          for (int r = 0; r < GR; ++r) {
            const float p = Sb[r * DEC_BK + kk];
#pragma unroll
            for (int e = 0; e < EPU; ++e)
              acc[r][e] = fmaf(p, vv[e], acc[r][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&vempty[i % VST]));  // V slot free
    }
    consumers_sync();   // the ring is free: it takes the key groups' sums
    float* red = reinterpret_cast<float*>(ring);   // [kgroups][GR][hd]
    if (u_pv < units) {
#pragma unroll
      for (int r = 0; r < GR; ++r)
#pragma unroll
        for (int e = 0; e < EPU; e += 4)
          *reinterpret_cast<float4*>(red + (kq * GR + r) * hd + u_pv * EPU +
                                     e) =
              make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2],
                          acc[r][e + 3]);
    }
    consumers_sync();
    // This split's acc replaces q; Ms and Ls hold its max and sum.
    for (int idx = tid; idx < nr * hd; idx += DEC_CONSUMERS) {
      const int r = idx / hd;
      const int c = idx - r * hd;
      float sum = 0.f;
      for (int w = 0; w < kgroups; ++w) sum += red[(w * GR + r) * hd + c];
      Qs[idx] = sum;
    }
  }

  // Every split's (m, l, acc) is in its block's shared memory.  The
  // cluster's blocks share out the outputs, each reading all the splits
  // through distributed shared memory in one round trip.
  cluster_sync();
  for (int idx = (int)cluster_rank() * DEC_THREADS + tid; idx < nr * hd;
       idx += nsplit * DEC_THREADS) {
    const int r = idx / hd;
    float m[MAX_SPLITS], l[MAX_SPLITS], a[MAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < nsplit) {   // all loads in flight at once
        m[sp] = ld_cluster(Ms + r, sp);
        l[sp] = ld_cluster(Ls + r, sp);
        a[sp] = ld_cluster(Qs + idx, sp);
      }
    float mx = NEG_INF;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < nsplit) mx = fmaxf(mx, m[sp]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < nsplit) {
        const float w = expf(m[sp] - mx);
        den += w * l[sp];
        num += w * a[sp];
      }
    store1(o + q_row0 + idx, num / fmaxf(den, 1e-30f));
  }
  cluster_sync();   // no block leaves while another reads its memory
}

template <int NB>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int H, int KV, int hd,
               int kv_len, int causal, int window, float scale,
               cudaStream_t stream) {
  using C = F32Cfg<NB>;
  CUtensorMap qmap, kmap, vmap;
  int err = tf32::encode_packed(&qmap, q, B, Sq, H, KV, hd);
  if (err == 0)
    err = tf32::encode_keys(&kmap, k, B, Skv, KV, hd, kv_len, C::KT);
  if (err == 0)
    err = tf32::encode_keys(&vmap, v, B, Skv, KV, hd, kv_len, C::KT);
  if (err != 0) return err;
  auto kernel = lse != nullptr ? flash_attention_f32_kernel<NB, true>
                               : flash_attention_f32_kernel<NB, false>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  kernel<<<tf32::packed_grid<C>(B, Sq, H, KV), C::THREADS, C::SMEM,
           stream>>>(
      qmap, kmap, vmap, static_cast<float*>(o), lse, Sq, H, KV, hd, kv_len,
      causal, window, scale * tf32::LOG2E);
  return (int)cudaGetLastError();
}

int f32_by_width(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Skv, int H, int KV, int hd,
                 int kv_len, int causal, int window, float scale,
                 cudaStream_t s) {
  switch (tf32::boxes(hd)) {
    case 2:
      return launch_f32<2>(q, k, v, o, lse, B, Sq, Skv, H, KV, hd, kv_len,
                           causal, window, scale, s);
    case 4:
      return launch_f32<4>(q, k, v, o, lse, B, Sq, Skv, H, KV, hd, kv_len,
                           causal, window, scale, s);
    case 6:
      return launch_f32<6>(q, k, v, o, lse, B, Sq, Skv, H, KV, hd, kv_len,
                           causal, window, scale, s);
    default:
      return launch_f32<8>(q, k, v, o, lse, B, Sq, Skv, H, KV, hd, kv_len,
                           causal, window, scale, s);
  }
}

// What launch_decode does: launch, or ask the occupancy calculator.
enum class Query { LAUNCH, CLUSTERS, BLOCKS };

template <typename T, int GR, int KS>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  int B, int Skv, int H, int KV, int hd, int kv_len,
                  int causal, int window, float scale, int nsplit,
                  int tiles_per_split, cudaStream_t stream, Query query,
                  int* out) {
  const int G = H / KV;
  const int elem = sizeof(T);
  auto kernel = flash_attention_decode_kernel<T, GR, KS>;
  const size_t smem = decode_smem_bytes(elem, GR, hd);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && nsplit > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * ((G + GR - 1) / GR), nsplit);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (query == Query::CLUSTERS)   // how many such clusters fit at once
    return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  if (query == Query::BLOCKS)     // how many blocks an SM holds at once
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, DEC_THREADS, smem);
  CUtensorMap kmap, vmap;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KV,
                              (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint32_t box[4] = {(cuuint32_t)decode_ld(elem, hd), 1, DEC_BK, 1};
  int rc = encode_map(&kmap, k, elem, 4, dims, box, false);
  if (rc == 0) rc = encode_map(&vmap, v, elem, 4, dims, box, false);
  if (rc != 0) return rc;
  err = cudaLaunchKernelEx(&cfg, kernel, kmap, vmap,
                           static_cast<const T*>(q), static_cast<T*>(o), H,
                           KV, hd, kv_len, causal, window, scale,
                           tiles_per_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int decode_variant(const void* q, const void* k, const void* v, void* o,
                   int B, int Skv, int H, int KV, int hd, int kv_len,
                   int causal, int window, float scale, int nsplit, int per,
                   cudaStream_t s, Query query, int* out) {
  const bool four = H / KV <= 4;
  if constexpr (sizeof(T) == 4) {
    return four ? launch_decode<T, 4, 0>(q, k, v, o, B, Skv, H, KV, hd,
                                         kv_len, causal, window, scale,
                                         nsplit, per, s, query, out)
                : launch_decode<T, 8, 0>(q, k, v, o, B, Skv, H, KV, hd,
                                         kv_len, causal, window, scale,
                                         nsplit, per, s, query, out);
  } else if ((hd + 15) / 16 <= 8) {
    return four ? launch_decode<T, 4, 8>(q, k, v, o, B, Skv, H, KV, hd,
                                         kv_len, causal, window, scale,
                                         nsplit, per, s, query, out)
                : launch_decode<T, 8, 8>(q, k, v, o, B, Skv, H, KV, hd,
                                         kv_len, causal, window, scale,
                                         nsplit, per, s, query, out);
  } else {
    return four ? launch_decode<T, 4, 16>(q, k, v, o, B, Skv, H, KV, hd,
                                          kv_len, causal, window, scale,
                                          nsplit, per, s, query, out)
                : launch_decode<T, 8, 16>(q, k, v, o, B, Skv, H, KV, hd,
                                          kv_len, causal, window, scale,
                                          nsplit, per, s, query, out);
  }
}

}  // namespace

// f32 prefill (any Sq).  H / KV <= 64, hd a multiple of 8 up to 256.
// lse: null, or (B, H, Sq) f32 for each row's log-sum-exp (training).
// Returns cudaGetLastError() after the launch, or -(CUresult) if a tensor
// map could not be encoded.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Sq, int Skv, int H, int KV,
                                       int hd, int kv_len, int causal,
                                       int window, float scale,
                                       void* stream) {
  return f32_by_width(q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, H,
                      KV, hd, kv_len, causal, window, scale,
                      static_cast<cudaStream_t>(stream));
}

// The f32 prefill's dynamic shared memory at this hd (mirrored by
// flash_attention.f32_smem_bytes in Python).
extern "C" int flash_attention_fwd_f32_smem(int hd) {
  switch (tf32::boxes(hd)) {
    case 2: return F32Cfg<2>::SMEM;
    case 4: return F32Cfg<4>::SMEM;
    case 6: return F32Cfg<6>::SMEM;
    default: return F32Cfg<8>::SMEM;
  }
}

// Sq == 1.  Returns cudaGetLastError() after the launch, or -(CUresult)
// if a tensor map could not be encoded.  A block takes up to 4 query
// heads of a KV head (8 where H / KV > 4; more heads take more blocks).
// Each of the nsplit (<= 16) blocks of a (b, KV head, chunk of heads)
// takes tiles_per_split tiles of 32 keys; they form a cluster that merges
// their results.  dtype: 0 = f32, 1 = bf16.
extern "C" int flash_attention_decode(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Skv, int H, int KV, int hd,
                                      int kv_len, int causal, int window,
                                      float scale, int nsplit,
                                      int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return decode_variant<float>(q, k, v, o, B, Skv, H, KV, hd, kv_len,
                                 causal, window, scale, nsplit,
                                 tiles_per_split, s, Query::LAUNCH, nullptr);
  return decode_variant<__nv_bfloat16>(q, k, v, o, B, Skv, H, KV, hd, kv_len,
                                       causal, window, scale, nsplit,
                                       tiles_per_split, s, Query::LAUNCH,
                                       nullptr);
}

namespace {

int decode_query(int dtype, int G, int hd, int nsplit, Query query) {
  int n = 0;
  const int err =
      dtype == 0
          ? decode_variant<float>(nullptr, nullptr, nullptr, nullptr, 1, 1,
                                  G, 1, hd, 1, 0, 0, 1.f, nsplit, 1, nullptr,
                                  query, &n)
          : decode_variant<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr,
                                          1, 1, G, 1, hd, 1, 0, 0, 1.f,
                                          nsplit, 1, nullptr, query, &n);
  return err == 0 ? n : -err;
}

}  // namespace

// How many clusters of nsplit decode blocks (dtype, H / KV = G, hd) the
// card holds at once, or -(cudaError) (cudaOccupancyMaxActiveClusters).
extern "C" int flash_attention_decode_clusters(int dtype, int G, int hd,
                                               int nsplit) {
  return decode_query(dtype, G, hd, nsplit, Query::CLUSTERS);
}

// How many decode blocks (dtype, G, hd) an SM holds at once, or
// -(cudaError) (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int flash_attention_decode_blocks(int dtype, int G, int hd) {
  return decode_query(dtype, G, hd, 1, Query::BLOCKS);
}

// The decode kernel's dynamic shared memory.
extern "C" int flash_attention_decode_smem(int dtype, int G, int hd) {
  const int gr = G <= 4 ? 4 : 8;
  return (int)decode_smem_bytes(dtype == 0 ? 4 : 2, gr, hd);
}
