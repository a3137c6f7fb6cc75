// Flash attention forward (online softmax) for the model zoo's attention.
//
// Replaces the TPU kernel flash_attention_kernel (_flash_kernel) of
// src/repro/kernels/flash_attention.py.  Computes, per (batch, q head,
// q row):  s = (q * scale) k^T in f32; visible where k < kv_len, and
// k <= q if causal, and k > q - window if window > 0 (positions of q and
// k both start at 0); online max/sum rescaling with p . v accumulated in
// f32; out = acc / max(l, 1e-30) in the input type.  Masked entries get
// p = 0, so a row with nothing visible gives 0.
//
// Layout is the model's: q (B, Sq, H, hd), k and v (B, Skv, KV, hd),
// out (B, Sq, H, hd), contiguous.  q head h reads KV head h / (H / KV):
// grouped-query attention by index, with no repeated copy of K and V.
// Types: f32 or bf16 in, f32 arithmetic.  hd is a multiple of 8, <= 256.
//
// Bound on the H100: at prefill by operations (4 hd flops per visible
// pair), at decode by bytes (the whole K/V cache is read once).  This is
// the simple design, on the CUDA cores in f32 (the f32 path must agree
// with the plain version to 1e-5, which TF32 tensor cores cannot):
//
// * flash_attention_fwd_kernel: one block per (b, h, 64-row q tile), 256
//   threads.  The q tile and each 64-row K/V tile are staged in shared
//   memory as f32, rows padded to hd + 4 floats so that the 16-byte
//   reads of 8 neighbouring threads hit distinct banks.  Each thread
//   owns a 4 x 4 patch of the score tile (rows ty + 16i, keys tx + 16j)
//   and 4 rows x up to 16 columns of the output accumulator, in
//   registers; row max and sum reduce over the 16 lanes of a half-warp.
//   The kv loop runs only over tiles that hold a visible key: causal and
//   window bounds clip it, so wholly masked tiles are never loaded.
// * flash_attention_decode_kernel + flash_attention_combine_kernel, for
//   Sq == 1: one block per (b, KV head, kv split).  The block holds the
//   G = H / KV query heads that share the KV head, so each K/V tile is
//   read once for all of them and no 64-row tile is wasted on one query;
//   the kv range is split over enough blocks to fill the card, and the
//   combine kernel merges the splits' (m, l, acc).
//
// Later work (ROADMAP queue 2): wgmma tensor cores, TMA staging, a
// GQA-shared tile at prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;      // q rows per prefill block
constexpr int BK = 64;      // keys per K/V tile
constexpr int FWD_THREADS = 256;
constexpr int DEC_THREADS = 128;
constexpr int DEC_MAX_ITEMS = 8;  // float4 accumulators per decode thread

__device__ __forceinline__ void load8(const float* p, float* d) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* d) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage `rows` rows of one head into shared memory as f32 (row stride
// ld), multiplied by `mul`; rows at or past `limit` become zeros.
// Row r of the tile is element ((b * S + pos0 + r) * NH + head) * hd.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t base, int64_t row_stride,
                                      int pos0, int rows, int limit, int hd,
                                      float mul, int nthreads) {
  const int chunks = hd / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += nthreads) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    float vals[8];
    if (pos0 + r < limit) {
      load8(src + base + (int64_t)(pos0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
    out[0] = make_float4(vals[0] * mul, vals[1] * mul, vals[2] * mul,
                         vals[3] * mul);
    out[1] = make_float4(vals[4] * mul, vals[5] * mul, vals[6] * mul,
                         vals[7] * mul);
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int kv_len,
                                        int causal, int window) {
  bool v = kpos < kv_len;
  if (causal) v = v && kpos <= qpos;
  if (window > 0) v = v && kpos > qpos - window;
  return v;
}

// The kv range [lo, hi) that can hold a visible key for q rows
// [q_lo, q_hi].
__device__ __forceinline__ void kv_range(int q_lo, int q_hi, int kv_len,
                                         int causal, int window, int* lo,
                                         int* hi) {
  int h = kv_len;
  if (causal) h = min(h, q_hi + 1);
  int l = 0;
  if (window > 0) l = max(0, q_lo - window + 1);
  *lo = l;
  *hi = max(h, l);
}

// ---------------------------------------------------------------------------
// Prefill / general Sq
// ---------------------------------------------------------------------------

// NJ4: groups of 4 output columns per thread (hd <= 64 * NJ4).
template <typename T, int NJ4>
__global__ void __launch_bounds__(FWD_THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int Sq, int Skv, int H, int KV, int hd,
                           int kv_len, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = hd + 4;
  const int ldp = BK + 4;
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ps = Vs + BK * ld;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / KV);
  const int q_lo = blockIdx.x * BQ;
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;   // rows ty + 16 i
  const int tx = tid & 15;   // keys tx + 16 j; columns 4 tx + 64 jj + e

  const int64_t q_base = ((int64_t)b * Sq * H + h) * hd;
  const int64_t kv_base = ((int64_t)b * Skv * KV + g) * hd;
  stage(Qs, ld, q, q_base, (int64_t)H * hd, q_lo, BQ, Sq, hd, scale,
        FWD_THREADS);

  float m[4], l[4];
  float acc[4][NJ4 * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ4 * 4; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  kv_range(q_lo, q_hi, kv_len, causal, window, &lo, &hi);
  const int t0 = lo / BK;
  const int t1 = (hi + BK - 1) / BK;
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's readers are done
    stage(Ks, ld, k, kv_base, (int64_t)KV * hd, k0, BK, kv_len, hd, 1.f,
          FWD_THREADS);
    stage(Vs, ld, v, kv_base, (int64_t)KV * hd, k0, BK, kv_len, hd, 1.f,
          FWD_THREADS);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty + 16 * i;
      bool vis[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(qpos, k0 + tx + 16 * j, kv_len, causal, window);
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NJ4 * 4; ++c) acc[i][c] *= alpha[i];
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * ldp + kk);
#pragma unroll
      for (int jj = 0; jj < NJ4; ++jj) {
        const int c = 4 * tx + 64 * jj;
        if (c < hd) {
          float4 va[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            va[e] = *reinterpret_cast<const float4*>(Vs + (kk + e) * ld + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][4 * jj + 0] = fmaf(pe[e], va[e].x, acc[i][4 * jj + 0]);
              acc[i][4 * jj + 1] = fmaf(pe[e], va[e].y, acc[i][4 * jj + 1]);
              acc[i][4 * jj + 2] = fmaf(pe[e], va[e].z, acc[i][4 * jj + 2]);
              acc[i][4 * jj + 3] = fmaf(pe[e], va[e].w, acc[i][4 * jj + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_lo + ty + 16 * i;
    if (qpos >= Sq) continue;   // tail rows of the last tile
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + q_base + (int64_t)qpos * H * hd;
#pragma unroll
    for (int jj = 0; jj < NJ4; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c < hd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store1(orow + c + e, acc[i][4 * jj + e] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Decode: Sq == 1, kv split over blocks
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
flash_attention_decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              float* __restrict__ part_m,
                              float* __restrict__ part_l,
                              float* __restrict__ part_acc, int Skv, int H,
                              int KV, int hd, int kv_len, int causal,
                              int window, float scale, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = H / KV;
  const int ld = hd + 4;
  float* Qs = smem;                 // G x ld
  float* Ks = Qs + G * ld;          // BK x ld
  float* Vs = Ks + BK * ld;         // BK x ld
  float* Ss = Vs + BK * ld;         // G x BK scores, then p
  float* Ms = Ss + G * BK;          // G running max
  float* Ls = Ms + G;               // G running sum
  float* As = Ls + G;               // G rescale of this tile

  const int bg = blockIdx.x;        // b * KV + g
  const int b = bg / KV;
  const int g = bg - b * KV;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hd4 = hd / 4;

  // The G query heads g*G .. g*G+G-1 of batch b are contiguous rows.
  stage(Qs, ld, q, ((int64_t)b * H + g * G) * hd, (int64_t)hd, 0, G, G, hd,
        scale, DEC_THREADS);
  for (int gg = tid; gg < G; gg += DEC_THREADS) {
    Ms[gg] = NEG_INF;
    Ls[gg] = 0.f;
  }
  float4 acc[DEC_MAX_ITEMS];
#pragma unroll
  for (int r = 0; r < DEC_MAX_ITEMS; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  int lo, hi;
  kv_range(0, 0, kv_len, causal, window, &lo, &hi);
  const int t_first = lo / BK + split * tiles_per_split;
  const int t_end = min((hi + BK - 1) / BK, t_first + tiles_per_split);
  const int64_t kv_base = ((int64_t)b * Skv * KV + g) * hd;
  for (int t = t_first; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    stage(Ks, ld, k, kv_base, (int64_t)KV * hd, k0, BK, kv_len, hd, 1.f,
          DEC_THREADS);
    stage(Vs, ld, v, kv_base, (int64_t)KV * hd, k0, BK, kv_len, hd, 1.f,
          DEC_THREADS);
    __syncthreads();
    for (int idx = tid; idx < G * BK; idx += DEC_THREADS) {
      const int gg = idx / BK;
      const int kk = idx - gg * BK;
      const float* qr = Qs + gg * ld;
      const float* kr = Ks + kk * ld;
      float s = 0.f;
      for (int d = 0; d < hd; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + d);
        const float4 c = *reinterpret_cast<const float4*>(kr + d);
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      Ss[idx] = s;
    }
    __syncthreads();
    for (int gg = warp; gg < G; gg += DEC_THREADS / 32) {
      float sv[2];
      bool vis[2];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kk = lane + 32 * u;
        sv[u] = Ss[gg * BK + kk];
        vis[u] = visible(0, k0 + kk, kv_len, causal, window);
        if (vis[u]) mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[gg];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = vis[u] ? expf(sv[u] - m_new) : 0.f;
        Ss[gg * BK + lane + 32 * u] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[gg] = alpha;
        Ls[gg] = alpha * Ls[gg] + sum;
        Ms[gg] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < DEC_MAX_ITEMS; ++r) {
      const int idx = tid + DEC_THREADS * r;
      if (idx < G * hd4) {
        const int gg = idx / hd4;
        const int c = (idx - gg * hd4) * 4;
        const float alpha = As[gg];
        float4 a = acc[r];
        a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
        const float* pr = Ss + gg * BK;
        for (int kk = 0; kk < BK; ++kk) {
          const float p = pr[kk];
          const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * ld + c);
          a.x = fmaf(p, vv.x, a.x);
          a.y = fmaf(p, vv.y, a.y);
          a.z = fmaf(p, vv.z, a.z);
          a.w = fmaf(p, vv.w, a.w);
        }
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  const int64_t row0 = ((int64_t)bg * nsplit + split) * G;
  for (int gg = tid; gg < G; gg += DEC_THREADS) {
    part_m[row0 + gg] = Ms[gg];
    part_l[row0 + gg] = Ls[gg];
  }
#pragma unroll
  for (int r = 0; r < DEC_MAX_ITEMS; ++r) {
    const int idx = tid + DEC_THREADS * r;
    if (idx < G * hd4) {
      const int gg = idx / hd4;
      const int c = (idx - gg * hd4) * 4;
      *reinterpret_cast<float4*>(part_acc + (row0 + gg) * hd + c) = acc[r];
    }
  }
}

// One block per (b, q head): merge the splits' (m, l, acc).
template <typename T>
__global__ void flash_attention_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ o, int H, int KV,
    int hd, int nsplit) {
  const int G = H / KV;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / G;
  const int gg = h - g * G;
  const int bg = b * KV + g;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part_m[((int64_t)bg * nsplit + s) * G + gg]);
  float denom = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const int64_t row = ((int64_t)bg * nsplit + s) * G + gg;
    denom += expf(part_m[row] - mx) * part_l[row];
  }
  const float inv = 1.f / fmaxf(denom, 1e-30f);
  for (int c = threadIdx.x; c < hd; c += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const int64_t row = ((int64_t)bg * nsplit + s) * G + gg;
      num += expf(part_m[row] - mx) * part_acc[row * hd + c];
    }
    store1(o + (int64_t)bh * hd + c, num * inv);
  }
}

size_t fwd_smem_bytes(int hd) {
  return sizeof(float) * (size_t)(BQ * (hd + 4) * 1 + 2 * BK * (hd + 4) +
                                  BQ * (BK + 4));
}

size_t decode_smem_bytes(int G, int hd) {
  return sizeof(float) * (size_t)(G * (hd + 4) + 2 * BK * (hd + 4) +
                                  G * BK + 3 * G);
}

template <typename T, int NJ4>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KV, int hd, int kv_len, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T, NJ4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_fwd_kernel<T, NJ4><<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, hd,
      kv_len, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_by_width(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Skv, int H, int KV, int hd, int kv_len,
                 int causal, int window, float scale, cudaStream_t stream) {
  if (hd <= 64)
    return launch_fwd<T, 1>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len, causal,
                            window, scale, stream);
  if (hd <= 128)
    return launch_fwd<T, 2>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len, causal,
                            window, scale, stream);
  if (hd <= 192)
    return launch_fwd<T, 3>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len, causal,
                            window, scale, stream);
  return launch_fwd<T, 4>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len, causal,
                          window, scale, stream);
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  float* part_m, float* part_l, float* part_acc, int B,
                  int Skv, int H, int KV, int hd, int kv_len, int causal,
                  int window, float scale, int nsplit, int tiles_per_split,
                  cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = decode_smem_bytes(G, hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_decode_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * KV, nsplit);
  flash_attention_decode_kernel<T><<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_m, part_l, part_acc, Skv, H, KV, hd,
      kv_len, causal, window, scale, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_combine_kernel<T><<<B * H, 128, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), H, KV, hd, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Sq, int Skv, int H, int KV, int hd,
                                   int kv_len, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_by_width<float>(q, k, v, o, B, Sq, Skv, H, KV, hd, kv_len,
                               causal, window, scale, s);
  return fwd_by_width<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, hd,
                                     kv_len, causal, window, scale, s);
}

// Sq == 1.  part_m, part_l: (B * KV * nsplit * G) f32 scratch; part_acc:
// that times hd.  Each of the nsplit blocks of a (b, KV head) takes
// tiles_per_split tiles of 64 keys.
extern "C" int flash_attention_decode(const void* q, const void* k,
                                      const void* v, void* o, void* part_m,
                                      void* part_l, void* part_acc,
                                      int dtype, int B, int Skv, int H,
                                      int KV, int hd, int kv_len, int causal,
                                      int window, float scale, int nsplit,
                                      int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return launch_decode<float>(q, k, v, o, pm, pl, pa, B, Skv, H, KV, hd,
                                kv_len, causal, window, scale, nsplit,
                                tiles_per_split, s);
  return launch_decode<__nv_bfloat16>(q, k, v, o, pm, pl, pa, B, Skv, H, KV,
                                      hd, kv_len, causal, window, scale,
                                      nsplit, tiles_per_split, s);
}
