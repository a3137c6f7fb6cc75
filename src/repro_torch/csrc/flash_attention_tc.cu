// Flash attention prefill in bf16 on the Hopper tensor cores.
//
// Replaces, for bf16 inputs with more than one query row, the TPU kernel
// flash_attention_kernel (_flash_kernel) of
// src/repro/kernels/flash_attention.py; f32 takes the split-TF32 kernel of
// flash_attention.cu.  Computes, per (batch, q head, q row): s = q k^T,
// accumulated in f32 on bf16 inputs; x = s * scale (in the f32
// accumulator, log2 units); visible where k < kv_len, k <= q if causal
// and k > q - window if window > 0; online max / sum in f32 with the sum
// taken over the f32 p; p rounded to bf16 for the p . v product (as the
// reference's model path casts its probabilities to v's type), f32
// accumulation; out = acc / max(l, 1e-30), rounded to nearest once at the
// bf16 store.  A row with nothing visible gives 0.  For training it also
// writes each row's log-sum-exp of the scaled scores (+inf for a row with
// nothing visible), which the backward reads; serving passes no lse.
// Layout as the model's: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), q
// head h reads KV head h / (H / KV).
//
// Bound on the H100: by operations (4 hd flops per visible (q, k) pair
// and head, 989 TFLOP/s in bf16); danube's prefill (B = 4, S = 5000, 32
// heads of 120, window 4096) has a 0.75 ms bound.  The design:
//
// * Products by wgmma: S = Q K^T with both operands in shared memory
//   (K-major, 128-byte swizzle), O += P V with P converted to bf16 in
//   registers as the A operand and V in shared memory as an MN-major B
//   operand (the transpose bit; V is not transposed in memory).  hd is
//   covered by 64-column boxes; the k-steps of S stop at hd rounded up to
//   16 and the zero columns past hd (TMA's out-of-bounds fill) cost
//   nothing else; P V runs at N = 64 x boxes.
// * K/V by TMA: 4-D tensor maps (hd, KV, Skv, B), boxes of 64 columns x
//   64 keys, into a ring of stages with full / empty mbarriers.  One
//   producer warp keeps the ring filled; two consumer warpgroups compute.
//   The K/V maps end at kv_len, so the keys and values past it (the
//   ragged tail past Skv too) come back as zeros, and a zero weight p
//   never meets what lies there (0 x NaN would be NaN); the kernel
//   masks their scores as well.
// * K/V shared by the query group: a warpgroup's 64-row M tile packs
//   (q position, head) pairs, P = 64 / G positions x the G heads of one
//   KV head, which are adjacent rows of q in memory (a 5-D tensor map
//   (hd, G, KV, Sq, B) loads them as one box).  So each K/V tile is
//   loaded once for the 2 x 64 rows of a block whatever G is, no head
//   needs a warpgroup of its own (G = 5 at hd = 160 would need 5 x 128
//   threads with 80 accumulator registers each), and G = 1, 4, 5 use
//   64, 64 and 60 of the 64 rows.  Rows past G x P are zeroed once and
//   never stored.
// * Tile skip as the f32 kernel: a block walks only the kv tiles
//   that its positions can see (causal and window bounds), and builds
//   the mask only on tiles that straddle the causal, window or kv_len
//   edge.
//
// Later work: setmaxnreg, a persistent grid, the two warpgroups'
// softmax and products ping-ponged, fp8.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "flash_wgmma.cuh"

using namespace flash;

namespace {

constexpr int TC_WG = 2;                    // consumer warpgroups
constexpr int TC_THREADS = 128 * TC_WG + 32;  // + one producer warp
constexpr int ROWS = 64;                    // rows of a warpgroup's tile
constexpr int KT = 64;                      // keys per K/V tile
constexpr int BOX_COLS = 64;                // hd columns per box (128 B)
constexpr int BOX_BYTES = 64 * 128;         // 64 rows of 128 B
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// NCH: boxes of 64 columns that cover hd.
template <int NCH>
struct TcCfg {
  static constexpr int STAGES = NCH <= 2 ? 4 : (NCH == 3 ? 3 : 2);
  static constexpr int Q_BYTES = TC_WG * NCH * BOX_BYTES;
  static constexpr int STAGE_BYTES = 2 * NCH * BOX_BYTES;   // K and V
  // 1024 of slack to align the ring for the 128-byte swizzle; barriers.
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
};

// LSE: write each row's log-sum-exp (training); serving compiles without.
template <int NCH, bool LSE>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int H, int KV,
                          int hd, int kv_len, int causal, int window,
                          float scale_log2) {
  using C = TcCfg<NCH>;
  constexpr int STAGES = C::STAGES;
  constexpr int NACC = 32 * NCH;      // O: 64 x (64 NCH) over 128 threads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                  // [TC_WG][NCH] boxes
  uint8_t* ring = smem + C::Q_BYTES;   // [STAGES][K boxes, V boxes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  // bars[0]: Q landed; bars[1 + s]: stage s full; bars[1 + STAGES + s]:
  // stage s empty (one arrival per consumer warp).

  const int G = H / KV;
  const int P = ROWS / G;              // q positions per warpgroup tile
  const int rows_used = G * P;
  const int bg = blockIdx.y;
  const int b = bg / KV;
  const int g = bg - b * KV;
  const int p0 = blockIdx.x * TC_WG * P;
  int lo, hi;
  kv_range(p0, min(p0 + TC_WG * P, Sq) - 1, kv_len, causal, window, &lo,
           &hi);
  const int t0 = lo / KT;
  const int t1 = (hi + KT - 1) / KT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), 1);
      mbar_init(smem_u32(&bars[1 + STAGES + s]), TC_WG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (rows_used < ROWS) {   // the rows no Q box writes
    const int pad = ROWS - rows_used;
    for (int e = tid; e < TC_WG * NCH * pad * 8; e += TC_THREADS) {
      const int box = (e >> 3) / pad;
      const int r = rows_used + (e >> 3) % pad;
      *reinterpret_cast<uint4*>(qs + box * BOX_BYTES + r * 128 +
                                (e & 7) * 16) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == TC_WG * 4) {
    // Producer: one lane issues every copy.
    if (lane == 0) {
      const uint32_t qbar = smem_u32(&bars[0]);
      mbar_expect_tx(qbar, TC_WG * NCH * rows_used * 128);
      for (int w = 0; w < TC_WG; ++w)
        for (int c = 0; c < NCH; ++c)
          tma_load_5d(smem_u32(qs + (w * NCH + c) * BOX_BYTES), &qmap, qbar,
                      c * BOX_COLS, 0, g, p0 + w * P, b);
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(smem_u32(&bars[1 + STAGES + s]), ((i / STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&bars[1 + s]);
        mbar_expect_tx(full, C::STAGE_BYTES);
        uint8_t* st = ring + s * C::STAGE_BYTES;
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

  // Consumer warpgroup wg: rows r0 and r0 + 8 of its 64-row tile.
  const int wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int qa = p0 + wg * P;
  const bool any = qa < Sq;
  const int qb = min(qa + P, Sq) - 1;
  int wlo = 0, whi = 0;
  if (any) kv_range(qa, qb, kv_len, causal, window, &wlo, &whi);
  int qpos[2], head[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    qpos[h] = qa + r / G;
    head[h] = g * G + r % G;
    live[h] = r < rows_used && qpos[h] < Sq;
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  const uint32_t qaddr = smem_u32(qs + wg * NCH * BOX_BYTES);
  const int ksteps = (hd + 15) / 16;
  mbar_wait(smem_u32(&bars[0]), 0);

  for (int t = t0, i = 0; t < t1; ++t, ++i) {
    const int s = i % STAGES;
    const int k0 = t * KT;
    mbar_wait(smem_u32(&bars[1 + s]), (i / STAGES) & 1);
    if (any && wlo < whi && k0 < whi && k0 + KT > wlo) {
      const uint32_t kaddr = smem_u32(ring + s * C::STAGE_BYTES);
      const uint32_t vaddr = kaddr + NCH * BOX_BYTES;
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NCH; ++kk) {
        if (kk < ksteps) {
          const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
          wgmma_ss_n64(sacc, desc_sw128(qaddr + off, 16, 1024),
                       desc_sw128(kaddr + off, 16, 1024), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      const bool edge = k0 + KT > kv_len || (causal && k0 + KT - 1 > qa) ||
                        (window > 0 && k0 <= qb - window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = sacc[4 * j + e] * scale_log2;
          if (edge && !visible(qpos[h], k0 + 8 * j + 2 * (lane & 3) + (e & 1),
                               kv_len, causal, window))
            x = NEG_INF;
          sacc[4 * j + e] = x;
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
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sacc[4 * j + e] - m_use[e >> 1]);
          sacc[4 * j + e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
      // P as four bf16 A fragments of 16 keys each.
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
#pragma unroll
      for (int c = 0; c < NACC; ++c) acc[c] *= alpha[(c >> 1) & 1];
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tn<64 * NCH>(acc, pa[kk],
                              desc_sw128(vaddr + kk * 2048, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bars[1 + STAGES + s]));
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
    if (!live[h]) continue;
    // The row's log-sum-exp of the scaled scores, from the log2 units of
    // m and l; +inf where no key is visible (every p of the row 0).
    if constexpr (LSE) {
      if ((lane & 3) == 0)
        lse[((int64_t)b * H + head[h]) * Sq + qpos[h]] =
            l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : INFINITY;
    }
    __nv_bfloat16* orow =
        o + (((int64_t)b * Sq + qpos[h]) * H + head[h]) * hd;
#pragma unroll
    for (int j = 0; j < 8 * NCH; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv[h],
                                  acc[4 * j + 2 * h + 1] * inv[h]);
    }
  }
}

template <int NCH>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Sq, int Skv, int H, int KV, int hd,
              int kv_len, int causal, int window, float scale,
              cudaStream_t stream) {
  const int G = H / KV;
  const int P = ROWS / G;
  CUtensorMap qmap, kmap, vmap;
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
  if (err == 0) err = encode_map(&kmap, k, 2, 4, kdims, kbox, true, kext);
  if (err == 0) err = encode_map(&vmap, v, 2, 4, kdims, kbox, true, kext);
  if (err != 0) return err;
  const int smem = TcCfg<NCH>::SMEM;
  auto kernel = lse != nullptr ? flash_attention_tc_kernel<NCH, true>
                               : flash_attention_tc_kernel<NCH, false>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid((Sq + TC_WG * P - 1) / (TC_WG * P), B * KV);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, Sq, H, KV, hd,
      kv_len, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16, Sq > 1.  H / KV <= 64, hd a multiple of 8 up to 256.  lse: null,
// or (B, H, Sq) f32 for each row's log-sum-exp (training).  Returns
// cudaGetLastError() after the launch, or -(CUresult) if a tensor map
// could not be encoded.
extern "C" int flash_attention_fwd_tc(const void* q, const void* k,
                                      const void* v, void* o, void* lse_ptr,
                                      int B, int Sq, int Skv, int H, int KV,
                                      int hd, int kv_len, int causal,
                                      int window, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
  switch ((hd + BOX_COLS - 1) / BOX_COLS) {
    case 1:
      return launch_tc<1>(q, k, v, o, lse, B, Sq, Skv, H, KV, hd, kv_len,
                          causal, window, scale, s);
    case 2:
      return launch_tc<2>(q, k, v, o, lse, B, Sq, Skv, H, KV, hd, kv_len,
                          causal, window, scale, s);
    case 3:
      return launch_tc<3>(q, k, v, o, lse, B, Sq, Skv, H, KV, hd, kv_len,
                          causal, window, scale, s);
    default:
      return launch_tc<4>(q, k, v, o, lse, B, Sq, Skv, H, KV, hd, kv_len,
                          causal, window, scale, s);
  }
}

// The dynamic shared memory the kernel asks for at this hd (mirrored by
// flash_attention.tc_smem_bytes in Python).
extern "C" int flash_attention_tc_smem(int hd) {
  switch ((hd + BOX_COLS - 1) / BOX_COLS) {
    case 1: return TcCfg<1>::SMEM;
    case 2: return TcCfg<2>::SMEM;
    case 3: return TcCfg<3>::SMEM;
    default: return TcCfg<4>::SMEM;
  }
}
