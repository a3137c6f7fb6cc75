// FedAvg weighted aggregation: out[p] = sum_k w[k] * u[k, p], f32, its
// success-masked form out[p] = sum_k (w[k] * m[k]) * u[k, p], and its
// staleness-weighted form out[p] = sum_k ((w[k] * m[k]) * s[k]) * u[k, p].
//
// Replaces the TPU kernel fedavg_agg_kernel (src/repro/kernels/
// fedavg_agg.py, _fedavg_kernel), which tiled P into VMEM blocks and
// reduced a (K, BLOCK_P) tile on the VPU.
//
// Bound on the H100: bytes.  K*P*4 bytes of updates are read once and
// P*4 written, against 2*K*P flops — about 0.5 flop/byte, far below the
// card's ridge point, so the kernel can at best stream the (K, P) matrix
// at HBM rate (K=100, P=21,840: 8.7 MB, ~2.6 us at 3.35 TB/s).  At that
// size the matrix is gone in about one memory latency, so what counts is
// how many bytes are in flight at once: ~3.35 TB/s x ~0.8 us, some
// 2.7 MB over the card, about 20 KB per SM.
//
// Design: split-K streaming.  A block splits the K rows over kGroups = 16
// row groups (row k to group k % 16) of 16 threads; each thread owns VEC
// neighbouring columns and reads them with one VEC-wide load (float4,
// float2 or float, the widest that P and the matrix's address allow: the
// wrapper's route), so a block owns 16 * VEC columns and a group reads
// 64 * VEC contiguous bytes of a row.  Each thread issues kUnroll = 8
// rows' loads before it waits on any (256 threads x 8 x 16 bytes = 32 KB
// in flight a block at float4), and the first batch is issued before the
// weights are staged, so the staging's round trip hides under it.  The
// grid is ceil(P / (16 * VEC)) blocks: 342 at the CNN's P = 21,840 with
// float4, over two per SM.  Each thread sums its rows in ascending k with
// fmaf; the 16 partial sums of a column then meet in shared memory and
// one thread adds them in group order.  The order does not depend on VEC,
// so every route gives the same bits, and no atomics: the same inputs
// give the same bits on every launch.
//
// A scenario axis: S independent (K, P) problems stacked as (S, K, P)
// with (S, K) row operands and an (S, P) output run in one launch, the
// scenario on blockIdx.y.  Each block offsets its pointers to its
// scenario and then runs the single problem's reduction unchanged, so
// scenario s of a batched launch gives bit for bit what a launch on its
// rows alone gives.  A VEC-wide load stays aligned in every scenario:
// scenario s starts s * K * P floats past the first, a multiple of VEC
// whenever P is.
//
// The three entry points differ only in how they stage the K weights in
// shared memory (w, w * m, (w * m) * s, each product rounded by
// __fmul_rn in the reference's left-to-right order) and then run the same
// reduction, so an all-ones mask (w * 1.0 == w exactly) gives the
// unmasked result bit for bit and an all-ones s the masked one: the
// identity the event driver's synchronous limit leans on.  Nothing
// renormalises.  The (K,) rows are noise beside the (K, P) matrix: the
// same byte bound for all three.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 16;                    // row groups of a block
constexpr int kLanes = kThreads / kGroups;     // threads on one row
constexpr int kUnroll = 8;
constexpr int kMaxSharedK = 4096;

template <int VEC>
__device__ __forceinline__ void load_vec(float (&x)[VEC],
                                         const float* __restrict__ p) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

// Rows k0, k0 + kGroups, ... of this thread's columns.
template <int VEC>
__device__ __forceinline__ void load_batch(float (&x)[kUnroll][VEC],
                                           const float* __restrict__ col,
                                           int k0, int K, long long P,
                                           bool live) {
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int k = k0 + i * kGroups;
    if (live && k < K) {
      load_vec<VEC>(x[i], col + (long long)k * P);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) x[i][v] = 0.0f;
    }
  }
}

// The reduction all three kernels share.  `stage(k)` gives weight k as
// the entry point folds it; it runs once per k, into shared memory.
template <int VEC, typename Stage>
__device__ __forceinline__ void split_k_sum(const float* __restrict__ updates,
                                            float* __restrict__ out, int K,
                                            long long P, Stage stage) {
  constexpr int kCols = kLanes * VEC;
  __shared__ float w[kMaxSharedK];
  __shared__ float part[kGroups][kCols];
  const int g = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const long long col = (long long)blockIdx.x * kCols + l * VEC;
  const bool live = col < P;           // P % VEC == 0: all VEC or none
  const float* src = updates + col;

  float x[kUnroll][VEC];
  load_batch<VEC>(x, src, g, K, P, live);
  for (int k = threadIdx.x; k < K; k += kThreads) w[k] = stage(k);
  __syncthreads();

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  for (int k0 = g;;) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int k = k0 + i * kGroups;
      if (k < K) {
        const float wk = w[k];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wk, x[i][v], acc[v]);
      }
    }
    k0 += kUnroll * kGroups;
    if (k0 >= K) break;
    load_batch<VEC>(x, src, k0, K, P, live);
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) part[g][l * VEC + v] = acc[v];
  __syncthreads();
  if (threadIdx.x < kCols) {
    const long long c = (long long)blockIdx.x * kCols + threadIdx.x;
    if (c < P) {
      float s = part[0][threadIdx.x];
#pragma unroll
      for (int r = 1; r < kGroups; ++r) s += part[r][threadIdx.x];
      out[c] = s;
    }
  }
}

// Scenario blockIdx.y's (K, P) matrix, (K,) rows and (P,) output.
__device__ __forceinline__ long long scenario() { return blockIdx.y; }

template <int VEC>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_kernel(const float* __restrict__ updates,
                  const float* __restrict__ weights, float* __restrict__ out,
                  int K, long long P) {
  const long long s = scenario();
  const float* w = weights + s * K;
  split_k_sum<VEC>(updates + s * K * P, out + s * P, K, P,
                   [=](int k) { return w[k]; });
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_masked_kernel(const float* __restrict__ updates,
                         const float* __restrict__ weights,
                         const float* __restrict__ mask,
                         float* __restrict__ out, int K, long long P) {
  const long long s = scenario();
  const float* w = weights + s * K;
  const float* m = mask + s * K;
  split_k_sum<VEC>(updates + s * K * P, out + s * P, K, P, [=](int k) {
    return __fmul_rn(w[k], m[k]);
  });
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_stale_kernel(const float* __restrict__ updates,
                        const float* __restrict__ weights,
                        const float* __restrict__ mask,
                        const float* __restrict__ stale,
                        float* __restrict__ out, int K, long long P) {
  const long long s = scenario();
  const float* w = weights + s * K;
  const float* m = mask + s * K;
  const float* st = stale + s * K;
  split_k_sum<VEC>(updates + s * K * P, out + s * P, K, P, [=](int k) {
    return __fmul_rn(__fmul_rn(w[k], m[k]), st[k]);
  });
}

// The launch shared by the entry points: `vec` is the wrapper's route
// (1, 2 or 4 floats a load); refused unless P and both row pointers
// allow it (every scenario's then does too).
bool valid(const float* updates, const float* out, int S, int K,
           long long P, int vec) {
  if (S < 1 || S > 65535 || K < 1 || K > kMaxSharedK || P < 1) return false;
  if (vec != 1 && vec != 2 && vec != 4) return false;
  const uintptr_t align = (uintptr_t)vec * sizeof(float);
  return P % vec == 0 && (uintptr_t)updates % align == 0 &&
         (uintptr_t)out % align == 0;
}

template <int VEC>
dim3 grid(int S, long long P) {
  constexpr int kCols = kLanes * VEC;
  return dim3((unsigned)((P + kCols - 1) / kCols), (unsigned)S);
}

template <template <int> class Launch, typename... Args>
int dispatch(int vec, Args... args) {
  switch (vec) {
    case 4: Launch<4>::run(args...); break;
    case 2: Launch<2>::run(args...); break;
    default: Launch<1>::run(args...); break;
  }
  return (int)cudaGetLastError();
}

template <int VEC>
struct Plain {
  static void run(const float* u, const float* w, float* out, int S, int K,
                  long long P, cudaStream_t s) {
    fedavg_agg_kernel<VEC><<<grid<VEC>(S, P), kThreads, 0, s>>>(u, w, out,
                                                                K, P);
  }
};

template <int VEC>
struct Masked {
  static void run(const float* u, const float* w, const float* m,
                  float* out, int S, int K, long long P, cudaStream_t s) {
    fedavg_agg_masked_kernel<VEC><<<grid<VEC>(S, P), kThreads, 0, s>>>(
        u, w, m, out, K, P);
  }
};

template <int VEC>
struct Stale {
  static void run(const float* u, const float* w, const float* m,
                  const float* st, float* out, int S, int K, long long P,
                  cudaStream_t s) {
    fedavg_agg_stale_kernel<VEC><<<grid<VEC>(S, P), kThreads, 0, s>>>(
        u, w, m, st, out, K, P);
  }
};

}  // namespace

// Every entry takes S scenarios: (S, K, P) updates, (S, K) rows and an
// (S, P) output, all contiguous (S = 1 for one problem).
extern "C" int fedavg_agg_f32(const float* updates, const float* weights,
                              float* out, int S, int K, long long P, int vec,
                              cudaStream_t stream) {
  if (!valid(updates, out, S, K, P, vec)) return (int)cudaErrorInvalidValue;
  return dispatch<Plain>(vec, updates, weights, out, S, K, P, stream);
}

extern "C" int fedavg_agg_masked_f32(const float* updates,
                                     const float* weights, const float* mask,
                                     float* out, int S, int K, long long P,
                                     int vec, cudaStream_t stream) {
  if (!valid(updates, out, S, K, P, vec)) return (int)cudaErrorInvalidValue;
  return dispatch<Masked>(vec, updates, weights, mask, out, S, K, P,
                          stream);
}

extern "C" int fedavg_agg_stale_f32(const float* updates,
                                    const float* weights, const float* mask,
                                    const float* stale, float* out, int S,
                                    int K, long long P, int vec,
                                    cudaStream_t stream) {
  if (!valid(updates, out, S, K, P, vec)) return (int)cudaErrorInvalidValue;
  return dispatch<Stale>(vec, updates, weights, mask, stale, out, S, K, P,
                         stream);
}
