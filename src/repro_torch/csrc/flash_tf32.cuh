// Split-precision TF32 ("3xTF32") products on the tensor cores for the
// f32 flash kernels (flash_attention.cu: the f32 prefill;
// flash_attention_bwd.cu: the f32 backward).
//
// * The arithmetic.  Each f32 operand x is split into hi = tf32(x) and
//   lo = tf32(x - hi), both rounded to nearest (cvt.rna: the tensor cores
//   would truncate the low 13 bits of an f32 operand themselves, and no
//   PyTorch flag reaches a hand-written kernel), and a . b is taken as
//   hi_a hi_b + hi_a lo_b + lo_a hi_b by three mma.sync.m16n8k8 tf32
//   products summed in f32 (mma3; mma3_split keeps the two small terms
//   in a second accumulator chain).  The dropped lo_a lo_b and the
//   rounding of lo leave about 2^-21 of |a| |b| a product, near f32's own
//   2^-24 and far inside the f32 routes' limits (tests/
//   test_torch_flash_tf32x3.py emulates it; one product, hi_a hi_b
//   alone, misses them).
// * Tiles.  Every f32 tile in shared memory is written by TMA with the
//   128-byte swizzle: boxes of 32 columns (128 bytes) x the tile's rows,
//   each box 1024-byte aligned, where the 16-byte unit u of row r lies at
//   unit u ^ (r % 8).  Fragments are read from it element by element and
//   split in registers: no transposed copy, no second copy of a tile.
// * Fragment reads without bank conflicts.  A product whose reduction
//   runs along a tile's rows (Q K^T, K Q^T and their dO / V forms:
//   "K-major" operands, A and B alike) reads 8-byte pairs: the k-step's 8
//   columns are permuted (its logical column t and t + 4 are a pair of
//   neighbours, and its pairs lie in units s and s + 4 of the box), so a
//   half-warp's 16 pairs fill the 32 banks once.  A product whose
//   reduction runs down a tile's columns (P V, P^T dO, dS^T q, dS K:
//   "MN-major" B operands) reads 4-byte elements of rows 8j + 2t and
//   8j + 2t + 1, which the swizzle puts in 32 distinct banks.
// * Sums in f32.  The tensor cores truncate as they accumulate, so a sum
//   over thousands of keys or positions (O, dV, dK, dQ) never runs in an
//   mma accumulator: each tile's product goes into a fresh one, which is
//   added to the f32 sum in registers (a tile of 64 keys: 24 truncating
//   steps).  Chained over a 4,500-key window instead, the prefill's error
//   exceeded its 1e-5 limit.
// * Accumulator to A operand without shuffles.  An m16n8 accumulator
//   holds columns 2t and 2t + 1 of rows g and g + 8 (g = lane / 4, t =
//   lane % 4); the tf32 A fragment wants columns t and t + 4.  The
//   reduction's order is free, so the product that takes P (or dS) as
//   its A operand reads its k-step's logical column t from accumulator
//   column 2t and t + 4 from 2t + 1, and its B operand's rows 2t and
//   2t + 1 to match: no shuffle and no pass through shared memory.

#pragma once

#include <stdint.h>

#include "flash_attention.cuh"

namespace flash {
namespace tf32 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BOX_COLS = 32;     // f32 columns of a swizzled box (128 B)
constexpr int ROW_BYTES = 128;   // a box row

__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// An A fragment (16 x 8) and a B fragment (8 x 8), split.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int i, float x) { split(x, hi[i], lo[i]); }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(int i, float x) { split(x, hi[i], lo[i]); }
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in f32 from three tf32 products, the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.lo, b.hi[0], b.hi[1]);
  mma(c, a.hi, b.lo[0], b.lo[1]);
  mma(c, a.hi, b.hi[0], b.hi[1]);
}

// The same products in two chains: big += hi_a hi_b, small += hi_a lo_b
// + lo_a hi_b (added to big at the end), so that twice as many
// independent products are in flight.
__device__ __forceinline__ void mma3_split(float (&big)[4],
                                           float (&small)[4], const FragA& a,
                                           const FragB& b) {
  mma(small, a.lo, b.hi[0], b.hi[1]);
  mma(small, a.hi, b.lo[0], b.lo[1]);
  mma(big, a.hi, b.hi[0], b.hi[1]);
}

// Byte offsets of a lane's reads within a box row, by the lane's (g, t).
struct Lane {
  int g, t;
  // K-major pair of k-step s4 (0-3 within a box) in a row r with r % 8
  // == g: columns 4 s4 + 16 (t / 2) + 2 (t % 2) and the next.
  uint32_t kpair[4];
  // MN-major element of column 8 c4 + g (c4 = 0-3 within a box) in a row
  // r with r % 8 == 2t + e, e = 0, 1.
  uint32_t mn[4][2];
  __device__ __forceinline__ explicit Lane(int lane) {
    g = lane >> 2;
    t = lane & 3;
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4)
      kpair[s4] = (((s4 ^ (g & 3)) | ((((t >> 1) ^ (g >> 2)) & 1) << 2))
                   << 4) | ((t & 1) << 3);
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mn[c4][e] = ((((c4 ^ t) << 1) | ((g >> 2) ^ e)) << 4) |
                    ((g & 3) << 2);
  }
};

// A swizzled tile: `rows` rows of boxes `box_bytes` apart.
struct Tile {
  const uint8_t* base;
  int box_bytes;
  __device__ __forceinline__ float2 pair(const Lane& ln, int ks,
                                         int row) const {
    return *reinterpret_cast<const float2*>(
        base + (ks >> 2) * box_bytes + row * ROW_BYTES + ln.kpair[ks & 3]);
  }
  // The K-major A fragment of k-step ks over rows m0 + g and m0 + g + 8.
  __device__ __forceinline__ void load_a(FragA& a, const Lane& ln, int ks,
                                         int m0) const {
    const float2 x = pair(ln, ks, m0 + ln.g);
    const float2 y = pair(ln, ks, m0 + ln.g + 8);
    a.set(0, x.x);
    a.set(2, x.y);
    a.set(1, y.x);
    a.set(3, y.y);
  }
  // The K-major B fragment of k-step ks over rows (n index) n0 + g.
  __device__ __forceinline__ void load_b(FragB& b, const Lane& ln, int ks,
                                         int n0) const {
    const float2 x = pair(ln, ks, n0 + ln.g);
    b.set(0, x.x);
    b.set(1, x.y);
  }
  // The MN-major B fragment of the k-step over rows 8j .. 8j + 7 and the
  // n-block of columns 8c .. 8c + 7: rows 8j + 2t and 8j + 2t + 1 (the
  // accumulator's column order, see the header).
  __device__ __forceinline__ void load_b_mn(FragB& b, const Lane& ln, int j,
                                            int c) const {
    const uint8_t* p = base + (c >> 2) * box_bytes +
                       (8 * j + 2 * ln.t) * ROW_BYTES;
    b.set(0, *reinterpret_cast<const float*>(p + ln.mn[c & 3][0]));
    b.set(1, *reinterpret_cast<const float*>(p + ROW_BYTES +
                                             ln.mn[c & 3][1]));
  }
};

// The A fragment of a product that takes an m16n8 accumulator (P, P^T,
// dS or dS^T; its n-block j) as its k-step j.
__device__ __forceinline__ void acc_to_a(FragA& a, const float (&c)[4]) {
  a.set(0, c[0]);
  a.set(1, c[2]);
  a.set(2, c[1]);
  a.set(3, c[3]);
}

// Does box cb hold any column below hd?  Past hd TMA wrote zeros, so a
// box wholly past it is skipped; the test is by box, not by k-step, so
// that a box's four k-steps form one branch-free run whose loads the
// compiler can issue ahead of the products.
__device__ __forceinline__ bool box_live(int cb, int hd) {
  return BOX_COLS * cb < hd;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The most ring stages (up to `most`) that fit `limit` bytes beside
// `fixed`, with 1024 bytes of alignment slack and a full and an empty
// mbarrier per stage (and one more).
__host__ __device__ constexpr int smem_bytes(int fixed, int stage,
                                             int stages) {
  return 1024 + fixed + stages * stage + 8 * (1 + 2 * stages);
}
__host__ __device__ constexpr int stages_that_fit(int fixed, int stage,
                                                  int most, int limit) {
  int s = most;
  while (s > 1 && smem_bytes(fixed, stage, s) > limit) --s;
  return s;
}

constexpr int SMEM_LIMIT = 232448;   // a block's on the H100

// Blocks of eight consumer warps take a producer warpgroup (one warp of
// it issues the copies) and move its registers to the consumers: nine
// warps would cap every thread at 168 registers (a sub-partition's 16,384
// over its three warps).  Blocks of four take one producer warp (255).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
__host__ __device__ constexpr int block_threads(int warps) {
  return 32 * warps + (warps == 8 ? 128 : 32);
}
// Registers a thread of this warpgroup may hold from here on (sm_90a).
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Blocks over packed q tiles: the f32 prefill (flash_attention.cu) and the
// backward's dQ kernel (flash_attention_bwd.cu).  One block per (b, KV
// head, TILES x 64 packed rows): a 64-row tile holds P = 64 / G positions
// x the G heads of the KV head, loaded by a 5-D map (hd, G, KV, Sq, B), so
// each K / V tile that one producer lane streams by TMA through a ring of
// stages meets the whole group.  Blocks of the last positions, which see
// the most keys under causal masking, start first.
// ---------------------------------------------------------------------------

constexpr int PACKED_ROWS = 64;   // a q tile: four consumer warps of 16 rows

// The instantiation that covers hd: NB boxes of 32 columns, 2, 4, 6 or 8.
__host__ __device__ constexpr int boxes(int hd) {
  return ((hd + BOX_COLS - 1) / BOX_COLS + 1) / 2 * 2;
}

// SETS q-like tensors (q; or q and dO) resident in TILES = WARPS / 4 tiles
// each, and a ring of K + V stages of KT keys: the most stages, up to 4,
// that fit the H100 beside them.
template <int NB_, int WARPS_, int KT_, int SETS_>
struct PackedCfg {
  static constexpr int NB = NB_;
  static constexpr int WARPS = WARPS_;                // consumer warps
  static constexpr int TILES = WARPS / 4;             // 64-row q tiles
  static constexpr int KT = KT_;                      // keys of a K/V tile
  static constexpr int SETS = SETS_;
  static constexpr int THREADS = block_threads(WARPS);
  static constexpr int Q_BOX = PACKED_ROWS * ROW_BYTES;
  static constexpr int KV_BOX = KT * ROW_BYTES;
  static constexpr int FIXED = SETS * TILES * NB * Q_BOX;
  static constexpr int STAGE = 2 * NB * KV_BOX;       // K and V
  static constexpr int STAGES = stages_that_fit(FIXED, STAGE, 4, SMEM_LIMIT);
  static constexpr int SMEM = smem_bytes(FIXED, STAGE, STAGES);
};

// A packed block's shared memory and what it covers: the K / V tiles
// [t0, t1) that its positions p0 .. see.
template <class C>
struct Packed {
  uint8_t* res;     // [SETS][TILES][NB] boxes
  uint8_t* ring;    // [STAGES][K NB boxes, V NB boxes]
  uint64_t* bars;   // [0]: resident tiles landed; [1 + s]: stage s full;
                    // [1 + STAGES + s]: stage s empty (one arrival per
                    // consumer warp)
  int G, P, rows_used, b, g, p0, t0, t1, nbox;

  __device__ __forceinline__ Packed(uint8_t* smem_raw, int Sq, int H,
                                    int KV, int hd, int kv_len, int causal,
                                    int window) {
    res = align1024(smem_raw);
    ring = res + C::FIXED;
    bars = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);
    G = H / KV;
    P = PACKED_ROWS / G;
    rows_used = G * P;
    b = blockIdx.x / KV;
    g = blockIdx.x - b * KV;
    p0 = (gridDim.y - 1 - blockIdx.y) * C::TILES * P;
    int lo, hi;
    kv_range(p0, min(p0 + C::TILES * P, Sq) - 1, kv_len, causal, window,
             &lo, &hi);
    t0 = lo / C::KT;
    t1 = (hi + C::KT - 1) / C::KT;
    nbox = (hd + BOX_COLS - 1) / BOX_COLS;
  }

  // The barriers, and zeros in the rows no resident box writes; the
  // whole block then syncs.
  __device__ __forceinline__ void init(int tid) const {
    if (tid == 0) {
      mbar_init(smem_u32(&bars[0]), 1);
      for (int s = 0; s < C::STAGES; ++s) {
        mbar_init(smem_u32(&bars[1 + s]), 1);
        mbar_init(smem_u32(&bars[1 + C::STAGES + s]), C::WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (rows_used < PACKED_ROWS) {
      const int pad = PACKED_ROWS - rows_used;
      for (int e = tid; e < C::SETS * C::TILES * nbox * pad * 8;
           e += C::THREADS) {
        const int box = (e >> 3) / pad;   // [SETS][TILES][nbox]
        const int r = rows_used + (e >> 3) % pad;
        *reinterpret_cast<uint4*>(
            res + ((box / nbox) * C::NB + box % nbox) * C::Q_BOX +
            r * ROW_BYTES + (e & 7) * 16) = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
  }

  // The producer lane: the resident tiles of each of `qmaps`, then every
  // K / V tile through the ring.
  __device__ __forceinline__ void produce(
      const CUtensorMap* const (&qmaps)[C::SETS], const CUtensorMap* kmap,
      const CUtensorMap* vmap) const {
    const uint32_t qbar = smem_u32(&bars[0]);
    mbar_expect_tx(qbar, C::SETS * C::TILES * nbox * rows_used * ROW_BYTES);
    for (int w = 0; w < C::TILES; ++w)
      for (int c = 0; c < nbox; ++c)
        for (int set = 0; set < C::SETS; ++set)
          tma_load_5d(smem_u32(res + ((set * C::TILES + w) * C::NB + c) *
                                         C::Q_BOX),
                      qmaps[set], qbar, c * BOX_COLS, 0, g, p0 + w * P, b);
    for (int t = t0, i = 0; t < t1; ++t, ++i) {
      mbar_wait(empty(i), ((i / C::STAGES) & 1) ^ 1);
      const uint32_t bar = full(i);
      mbar_expect_tx(bar, 2 * nbox * C::KV_BOX);
      uint8_t* st = stage(i);
      for (int c = 0; c < nbox; ++c) {
        tma_load_4d(smem_u32(st + c * C::KV_BOX), kmap, bar, c * BOX_COLS,
                    g, t * C::KT, b);
        tma_load_4d(smem_u32(st + (C::NB + c) * C::KV_BOX), vmap, bar,
                    c * BOX_COLS, g, t * C::KT, b);
      }
    }
  }

  __device__ __forceinline__ uint8_t* stage(int i) const {
    return ring + (i % C::STAGES) * C::STAGE;
  }
  __device__ __forceinline__ uint32_t full(int i) const {
    return smem_u32(&bars[1 + i % C::STAGES]);
  }
  __device__ __forceinline__ uint32_t empty(int i) const {
    return smem_u32(&bars[1 + C::STAGES + i % C::STAGES]);
  }
  // Consumer side: the resident tiles, the i-th K / V stage, and handing
  // it back (one arrival a warp).
  __device__ __forceinline__ void wait_resident() const {
    mbar_wait(smem_u32(&bars[0]), 0);
  }
  __device__ __forceinline__ void wait_full(int i) const {
    mbar_wait(full(i), (i / C::STAGES) & 1);
  }
  __device__ __forceinline__ void release(int i, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i));
  }
  __device__ __forceinline__ Tile resident(int set, int wt) const {
    return Tile{res + (set * C::TILES + wt) * C::NB * C::Q_BOX, C::Q_BOX};
  }
  __device__ __forceinline__ Tile k_tile(int i) const {
    return Tile{stage(i), C::KV_BOX};
  }
  __device__ __forceinline__ Tile v_tile(int i) const {
    return Tile{stage(i) + C::NB * C::KV_BOX, C::KV_BOX};
  }
};

// The rows of a consumer warp: packed rows m0 + g and m0 + g + 8 (m0 = 16
// (warp % 4)) of tile wt = warp / 4, their positions and heads, and the
// keys [wlo, whi) its positions qa .. qb see.
struct PackedRows {
  int wt, m0, qa, qb, wlo, whi;
  bool any;
  int qpos[2], head[2];
  bool live[2];

  template <class C>
  __device__ __forceinline__ PackedRows(const Packed<C>& blk, int warp,
                                        const Lane& ln, int Sq, int kv_len,
                                        int causal, int window) {
    wt = warp >> 2;
    m0 = 16 * (warp & 3);
    qa = blk.p0 + wt * blk.P;
    any = qa < Sq;
    qb = min(qa + blk.P, Sq) - 1;
    wlo = whi = 0;
    if (any) kv_range(qa, qb, kv_len, causal, window, &wlo, &whi);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + ln.g + 8 * h;
      qpos[h] = qa + r / blk.G;
      head[h] = blk.g * blk.G + r % blk.G;
      live[h] = r < blk.rows_used && qpos[h] < Sq;
    }
  }

  // Does the key tile [k0, k0 + kt) hold a key that a row sees?
  __device__ __forceinline__ bool sees(int k0, int kt) const {
    return any && wlo < whi && k0 < whi && k0 + kt > wlo;
  }
  // Does it straddle the causal, window or kv_len edge, so that the mask
  // must be built (keys past kv_len are TMA's zeros)?
  __device__ __forceinline__ bool edge(int k0, int kt, int kv_len,
                                       int causal, int window) const {
    return k0 + kt > kv_len || (causal && k0 + kt - 1 > qa) ||
           (window > 0 && k0 <= qb - window);
  }
};

// Host side: a packed q-like map, (B, Sq, H, hd) in boxes of 32 columns x
// G heads x P positions, and a K or V map, (B, Skv, KV, hd) in boxes of 32
// columns x kt keys, ending at kv_len (the keys past it come back as
// zeros).  Each returns 0 or -(CUresult).
inline int encode_packed(CUtensorMap* map, const void* t, int B, int Sq,
                         int H, int KV, int hd) {
  const int G = H / KV;
  const cuuint64_t dims[5] = {(cuuint64_t)hd, (cuuint64_t)G, (cuuint64_t)KV,
                              (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint32_t box[5] = {BOX_COLS, (cuuint32_t)G, 1,
                             (cuuint32_t)(PACKED_ROWS / G), 1};
  return encode_map(map, t, 4, 5, dims, box);
}
inline int encode_keys(CUtensorMap* map, const void* t, int B, int Skv,
                       int KV, int hd, int kv_len, int kt) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KV,
                              (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t ext[4] = {(cuuint64_t)hd, (cuuint64_t)KV,
                             (cuuint64_t)(kv_len > 0 ? kv_len : 1),
                             (cuuint64_t)B};
  const cuuint32_t box[4] = {BOX_COLS, 1, (cuuint32_t)kt, 1};
  return encode_map(map, t, 4, 4, dims, box, true, ext);
}
// The grid of a packed kernel: (B x KV, position blocks).
template <class C>
dim3 packed_grid(int B, int Sq, int H, int KV) {
  const int rows = C::TILES * (PACKED_ROWS / (H / KV));   // positions
  return dim3(B * KV, (Sq + rows - 1) / rows);
}

}  // namespace tf32
}  // namespace flash
