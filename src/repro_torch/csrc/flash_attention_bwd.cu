// Flash attention backward on the CUDA cores in f32: dQ, dK and dV of the
// f32 forward's masked softmax attention (flash_attention.cu).  bf16 goes
// to the tensor-core kernels of flash_attention_bwd_tc.cu at every width.
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
// cross-attention).  Everything is f32.  Layout as the forward's: q, o,
// dO, dq (B, Sq, H, hd); k, v, dk, dv (B, Skv, KV, hd); lse and D (B, H,
// Sq).  hd a multiple of 8 up to 256.
//
// Bound on the H100 by operations: five products over the visible pairs
// (the two score products recomputed, dV, dK and dQ), 10 hd flops a pair
// and head, at 67 TFLOP/s outside the tensor cores (the 1e-4 limit of
// the f32 route rules out TF32).  The design (FlashAttention-2's):
//
// * flash_attention_bwd_delta_kernel: D, one warp a row.
// * flash_attention_bwd_dkdv_kernel: one block per (b, KV head, tile of
//   R keys), which loops over the G query heads of its group and, for
//   each, over the 64-row q tiles that can see its keys (causal and
//   window bounds; wholly masked tiles are never loaded).  Its K and V
//   tiles stay in shared memory, and dK and dV in registers for the
//   whole loop, so the group's sum stays inside the block: no atomics,
//   no repeated K / V.
// * flash_attention_bwd_dq_kernel: one block per (b, q head, tile of R
//   rows), which loops over the 64-key tiles its rows can see, dQ in
//   registers.
//
// Tiles as the f32 prefill's: rows staged as f32 in shared memory, padded
// to hd + 4 floats; 256 threads, each with an RI x 4 patch of the (R,
// 64) score tile (rows ty + 16 i, columns tx + 16 j) and RI rows x up to
// 16 columns of each accumulator (columns 4 tx + 64 jj + e).  R = 64 up
// to hd 128 and 32 past it, so that two R-row and two 64-row tiles fit
// the 227 KB of shared memory at hd 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

using namespace flash;

namespace {

constexpr int BWD_THREADS = 256;
constexpr int LT = 64;   // rows of the tile a block loops over

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// S = A B1^T and dP = C B2^T over hd for an (16 RI, 64) tile: A / C rows
// ty + 16 i of the R-row tiles, B1 / B2 rows tx + 16 j of the 64-row
// tiles (row stride ld).
template <int RI>
__device__ __forceinline__ void two_products(const float* A, const float* B1,
                                             const float* C, const float* B2,
                                             int ld, int hd, int ty, int tx,
                                             float (&s)[RI][4],
                                             float (&dp)[RI][4]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < hd; d += 4) {
    float4 a[RI], c[RI], b1[4], b2[4];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + d);
      c[i] = *reinterpret_cast<const float4*>(C + (ty + 16 * i) * ld + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b1[j] = *reinterpret_cast<const float4*>(B1 + (tx + 16 * j) * ld + d);
      b2[j] = *reinterpret_cast<const float4*>(B2 + (tx + 16 * j) * ld + d);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = dot4(a[i], b1[j], s[i][j]);
        dp[i][j] = dot4(c[i], b2[j], dp[i][j]);
      }
  }
}

// acc[i][4 jj + e] += sum_r W[ty + 16 i][r] X[r][4 tx + 64 jj + e] over
// the 64 rows r of X (W's row stride ldw, X's ld).
template <int RI, int NJ4>
__device__ __forceinline__ void accumulate(float (&acc)[RI][NJ4 * 4],
                                           const float* W, int ldw,
                                           const float* X, int ld, int hd,
                                           int ty, int tx) {
  for (int r = 0; r < LT; r += 4) {
    float4 w[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      w[i] = *reinterpret_cast<const float4*>(W + (ty + 16 * i) * ldw + r);
#pragma unroll
    for (int jj = 0; jj < NJ4; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c < hd) {
        float4 x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = *reinterpret_cast<const float4*>(X + (r + e) * ld + c);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float we[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][4 * jj + 0] = fmaf(we[e], x[e].x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(we[e], x[e].y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(we[e], x[e].z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(we[e], x[e].w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }
}

// Rows ty + 16 i (i < RI) of acc, times `mul`, into row pos0 + ty + 16 i
// (below `limit`) of a (.., S, NH, hd) tensor at `base`.
template <typename T, int RI, int NJ4>
__device__ __forceinline__ void store_rows(T* dst, int64_t base,
                                           int64_t row_stride, int pos0,
                                           int limit, int hd, float mul,
                                           const float (&acc)[RI][NJ4 * 4],
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int pos = pos0 + ty + 16 * i;
    if (pos >= limit) continue;
    T* row = dst + base + (int64_t)pos * row_stride;
#pragma unroll
    for (int jj = 0; jj < NJ4; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c < hd) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store1(row + c + e, acc[i][4 * jj + e] * mul);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_attention_bwd_delta_kernel(const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 float* __restrict__ delta, int rows, int Sq,
                                 int H, int hd) {
  const int row = blockIdx.x * (BWD_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  // row = (b Sq + q) H + h in the (B, Sq, H, hd) layout.
  const T* a = o + (int64_t)row * hd;
  const T* b = dout + (int64_t)row * hd;
  float sum = 0.f;
  for (int c = 8 * lane; c < hd; c += 256) {
    float x[8], y[8];
    load8(a + c, x);
    load8(b + c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(x[e], y[e], sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = row % H;
    const int bq = row / H;
    const int q = bq % Sq;
    const int b = bq / Sq;
    delta[((int64_t)b * H + h) * Sq + q] = sum;
  }
}

// R = 16 RI keys a block; NJ4 groups of 4 columns a thread (hd <= 64 NJ4).
template <typename T, int RI, int NJ4>
__global__ void __launch_bounds__(BWD_THREADS)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv,
                                int Sq, int Skv, int H, int KV, int hd,
                                int kv_len, int causal, int window,
                                float scale) {
  constexpr int R = 16 * RI;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = hd + 4;
  const int ldp = LT + 4;
  float* Ks = smem;                 // R x ld
  float* Vs = Ks + R * ld;          // R x ld
  float* Qs = Vs + R * ld;          // LT x ld, q * scale
  float* Os = Qs + LT * ld;         // LT x ld, dO
  float* Ps = Os + LT * ld;         // R x ldp: P (rounded as for p . v)
  float* Ss = Ps + R * ldp;         // R x ldp: dS
  float* Ls = Ss + R * ldp;         // LT: lse
  float* Ds = Ls + LT;              // LT: D

  const int bg = blockIdx.y;
  const int b = bg / KV;
  const int g = bg - b * KV;
  const int G = H / KV;
  const int k_lo = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int64_t kv_base = ((int64_t)b * Skv * KV + g) * hd;
  const int64_t kv_stride = (int64_t)KV * hd;

  float acc_k[RI][NJ4 * 4], acc_v[RI][NJ4 * 4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NJ4 * 4; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // The q rows [q0, q1) that can see a key of [k_lo, k_hi].
  const int k_hi = min(k_lo + R, kv_len) - 1;
  int q0 = causal ? k_lo : 0;
  int q1 = k_hi < k_lo ? q0 : Sq;
  if (window > 0) q1 = min(q1, k_hi + window);
  const int t0 = q0 / LT;
  const int t1 = q1 > q0 ? (q1 + LT - 1) / LT : t0;

  if (t1 > t0) {
    stage(Ks, ld, k, kv_base, kv_stride, k_lo, R, kv_len, hd, 1.f,
          BWD_THREADS);
    stage(Vs, ld, v, kv_base, kv_stride, k_lo, R, kv_len, hd, 1.f,
          BWD_THREADS);
  }
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const int64_t q_base = ((int64_t)b * Sq * H + h) * hd;
    const int64_t q_stride = (int64_t)H * hd;
    const float* lse_row = lse + ((int64_t)b * H + h) * Sq;
    const float* d_row = delta + ((int64_t)b * H + h) * Sq;
    for (int t = t0; t < t1; ++t) {
      const int q_lo = t * LT;
      __syncthreads();   // the previous tile's readers are done
      stage(Qs, ld, q, q_base, q_stride, q_lo, LT, Sq, hd, scale,
            BWD_THREADS);
      stage(Os, ld, dout, q_base, q_stride, q_lo, LT, Sq, hd, 1.f,
            BWD_THREADS);
      for (int r = tid; r < LT; r += BWD_THREADS) {
        const bool in = q_lo + r < Sq;
        Ls[r] = in ? lse_row[q_lo + r] : 0.f;
        Ds[r] = in ? d_row[q_lo + r] : 0.f;
      }
      __syncthreads();

      float s[RI][4], dp[RI][4];
      two_products<RI>(Ks, Qs, Vs, Os, ld, hd, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int kpos = k_lo + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int qpos = q_lo + c;
          const bool vis = qpos < Sq &&
                           visible(qpos, kpos, kv_len, causal, window);
          const float p = vis ? expf(s[i][j] - Ls[c]) : 0.f;
          Ps[(ty + 16 * i) * ldp + c] = p;
          Ss[(ty + 16 * i) * ldp + c] = vis ? p * (dp[i][j] - Ds[c]) : 0.f;
        }
      }
      __syncthreads();
      accumulate<RI, NJ4>(acc_v, Ps, ldp, Os, ld, hd, ty, tx);
      accumulate<RI, NJ4>(acc_k, Ss, ldp, Qs, ld, hd, ty, tx);
    }
  }
  // Every key row is written: zeros where no query sees it.
  store_rows<T, RI, NJ4>(dk, kv_base, kv_stride, k_lo, Skv, hd, 1.f, acc_k,
                         ty, tx);
  store_rows<T, RI, NJ4>(dv, kv_base, kv_stride, k_lo, Skv, hd, 1.f, acc_v,
                         ty, tx);
}

// R = 16 RI q rows a block.
template <typename T, int RI, int NJ4>
__global__ void __launch_bounds__(BWD_THREADS)
flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dq, int Sq, int Skv, int H,
                              int KV, int hd, int kv_len, int causal,
                              int window, float scale) {
  constexpr int R = 16 * RI;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = hd + 4;
  const int ldp = LT + 4;
  float* Qs = smem;                 // R x ld, q * scale
  float* Os = Qs + R * ld;          // R x ld, dO
  float* Ks = Os + R * ld;          // LT x ld
  float* Vs = Ks + LT * ld;         // LT x ld
  float* Ss = Vs + LT * ld;         // R x ldp: dS

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / KV);
  const int q_lo = blockIdx.x * R;
  const int q_hi = min(q_lo + R, Sq) - 1;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int64_t q_base = ((int64_t)b * Sq * H + h) * hd;
  const int64_t q_stride = (int64_t)H * hd;
  const int64_t kv_base = ((int64_t)b * Skv * KV + g) * hd;
  const int64_t kv_stride = (int64_t)KV * hd;

  stage(Qs, ld, q, q_base, q_stride, q_lo, R, Sq, hd, scale, BWD_THREADS);
  stage(Os, ld, dout, q_base, q_stride, q_lo, R, Sq, hd, 1.f, BWD_THREADS);
  float lse_r[RI], d_r[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q_lo + ty + 16 * i;
    const int64_t at = ((int64_t)b * H + h) * Sq + qpos;
    lse_r[i] = qpos < Sq ? lse[at] : 0.f;
    d_r[i] = qpos < Sq ? delta[at] : 0.f;
  }

  float acc[RI][NJ4 * 4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NJ4 * 4; ++c) acc[i][c] = 0.f;

  int lo, hi;
  kv_range(q_lo, q_hi, kv_len, causal, window, &lo, &hi);
  const int t0 = lo / LT;
  const int t1 = (hi + LT - 1) / LT;
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * LT;
    __syncthreads();   // the previous tile's readers are done
    stage(Ks, ld, k, kv_base, kv_stride, k0, LT, kv_len, hd, 1.f,
          BWD_THREADS);
    stage(Vs, ld, v, kv_base, kv_stride, k0, LT, kv_len, hd, 1.f,
          BWD_THREADS);
    __syncthreads();

    float s[RI][4], dp[RI][4];
    two_products<RI>(Qs, Ks, Os, Vs, ld, hd, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q_lo + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool vis = qpos < Sq &&
                         visible(qpos, k0 + c, kv_len, causal, window);
        const float p = vis ? expf(s[i][j] - lse_r[i]) : 0.f;
        Ss[(ty + 16 * i) * ldp + c] = vis ? p * (dp[i][j] - d_r[i]) : 0.f;
      }
    }
    __syncthreads();
    accumulate<RI, NJ4>(acc, Ss, ldp, Ks, ld, hd, ty, tx);
  }
  store_rows<T, RI, NJ4>(dq, q_base, q_stride, q_lo, Sq, hd, scale, acc, ty,
                         tx);
}

// Rows of the tile a block owns: 64 up to hd 128, 32 past it.
__host__ __device__ constexpr int bwd_rows(int hd) {
  return hd <= 128 ? 64 : 32;
}

// Dynamic shared memory of the dK / dV kernel (the larger of the two):
// two R-row and two 64-row tiles of hd + 4 floats, the P and dS tiles,
// lse and D.
size_t bwd_smem_bytes(int hd) {
  const int r = bwd_rows(hd);
  return sizeof(float) *
         ((size_t)(2 * r + 2 * LT) * (hd + 4) + 2 * r * (LT + 4) + 2 * LT);
}

size_t dq_smem_bytes(int hd) {
  const int r = bwd_rows(hd);
  return sizeof(float) * ((size_t)(2 * r + 2 * LT) * (hd + 4) + r * (LT + 4));
}

template <typename T, int RI, int NJ4>
int launch_bwd(const T* q, const T* k, const T* v, const T* o,
               const T* dout, const float* lse, float* delta, T* dq, T* dk,
               T* dv, int B, int Sq, int Skv, int H, int KV, int hd,
               int kv_len, int causal, int window, float scale,
               cudaStream_t stream) {
  const int rows = B * Sq * H;
  const int warps = BWD_THREADS / 32;
  flash_attention_bwd_delta_kernel<T>
      <<<(rows + warps - 1) / warps, BWD_THREADS, 0, stream>>>(
          o, dout, delta, rows, Sq, H, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int R = 16 * RI;
  const size_t smem_kv = bwd_smem_bytes(hd);
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, RI, NJ4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((Skv + R - 1) / R, B * KV);
  flash_attention_bwd_dkdv_kernel<T, RI, NJ4>
      <<<grid_kv, BWD_THREADS, smem_kv, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, Sq, Skv, H, KV, hd, kv_len,
          causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = dq_smem_bytes(hd);
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, RI, NJ4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((Sq + R - 1) / R, B * H);
  flash_attention_bwd_dq_kernel<T, RI, NJ4>
      <<<grid_q, BWD_THREADS, smem_q, stream>>>(
          q, k, v, dout, lse, delta, dq, Sq, Skv, H, KV, hd, kv_len, causal,
          window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_by_width(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* delta, void* dq,
                 void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                 int hd, int kv_len, int causal, int window, float scale,
                 cudaStream_t s) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(o);
  const T* tdo = static_cast<const T*>(dout);
  const float* fl = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(delta);
  T* tdq = static_cast<T*>(dq);
  T* tdk = static_cast<T*>(dk);
  T* tdv = static_cast<T*>(dv);
  if (hd <= 64)
    return launch_bwd<T, 4, 1>(tq, tk, tv, to, tdo, fl, fd, tdq, tdk, tdv, B,
                               Sq, Skv, H, KV, hd, kv_len, causal, window,
                               scale, s);
  if (hd <= 128)
    return launch_bwd<T, 4, 2>(tq, tk, tv, to, tdo, fl, fd, tdq, tdk, tdv, B,
                               Sq, Skv, H, KV, hd, kv_len, causal, window,
                               scale, s);
  if (hd <= 192)
    return launch_bwd<T, 2, 3>(tq, tk, tv, to, tdo, fl, fd, tdq, tdk, tdv, B,
                               Sq, Skv, H, KV, hd, kv_len, causal, window,
                               scale, s);
  return launch_bwd<T, 2, 4>(tq, tk, tv, to, tdo, fl, fd, tdq, tdk, tdv, B,
                             Sq, Skv, H, KV, hd, kv_len, causal, window,
                             scale, s);
}

}  // namespace

// dQ, dK, dV in f32 (and D into `delta`, (B, H, Sq) f32 scratch) of the
// forward with these masks.  Three launches on `stream`; returns the
// first cudaError, or 0.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Skv, int H, int KV,
                                   int hd, int kv_len, int causal, int window,
                                   float scale, void* stream) {
  return bwd_by_width<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                             Skv, H, KV, hd, kv_len, causal, window, scale,
                             static_cast<cudaStream_t>(stream));
}

// The backward's largest dynamic shared memory (its dK / dV kernel's),
// mirrored by flash_attention.bwd_smem_bytes in Python.
extern "C" int flash_attention_bwd_smem(int hd) {
  return (int)bwd_smem_bytes(hd);
}
