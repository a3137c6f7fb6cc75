// Label histogram -> [Gini-Simpson, Shannon (log2), count] per client.
//
// Replaces the TPU kernel diversity_kernel (src/repro/kernels/
// diversity.py, _diversity_kernel), which held one client's label row in
// VMEM and built the (C,) histogram with an iota-compare reduction.
//
// Bound on the H100: bytes, and in practice launch latency.  K*N*(4 + 4)
// bytes are read once and K*12 written (K = 100, N = 900: 720 KB, 0.2 us
// at 3.35 TB/s); the work per byte is a compare and an add.
//
// Design: one block of kThreads = 128 threads a client.  A 900-label row
// is 225 16-byte vectors of labels and 225 of mask, so 128 threads read
// the whole row in one round of loads: each thread issues all of its
// loads (kUnroll = 2 vectors of each, 4 loads in flight, on the vector
// route) before it uses any.  Splitting a row over more blocks would add
// a merge across blocks and remove no round trip; 100 blocks on 132 SMs
// each wait for one round of loads.  Loads are int4 / float4 where N is a
// multiple of 4 and both rows start 16-byte aligned (then every row
// does), else 8 scalar loads in flight a thread: the wrapper's route.
//
// No atomics.  The paper's shards are label-sorted, 12 a device, so a
// row holds a few classes and most lanes of a warp hold the same label:
// adds into one shared histogram would all hit one or two addresses.
// Instead each thread counts its own labels class by class in registers
// (the TPU kernel's iota-compare over the handful of labels it holds)
// and keeps its counts in a private column of shared memory, class c of
// thread t at c * kThreads + t: consecutive lanes on consecutive banks
// whatever the labels.  Then warp w adds the 128 columns of classes w,
// w + 4, ... in a fixed order (4 classes' butterflies in flight), and one
// warp reduces the histogram to the two measures with the reference's
// 0 * log 0 := 0 guard.  The order of every sum is fixed, so a launch's
// bits depend on the inputs alone; a {0, 1} mask gives exact integer
// counts.  Labels outside [0, C) equal no class and count nowhere, like
// the reference's one_hot.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 64;
constexpr int kMergeChains = 4;  // classes a warp sums at once

template <int VEC>
__device__ __forceinline__ void load_row(int (&lab)[VEC], float (&m)[VEC],
                                         const int* __restrict__ labels,
                                         const float* __restrict__ mask,
                                         long long at) {
  if constexpr (VEC == 4) {
    const int4 l = __ldg(reinterpret_cast<const int4*>(labels + at));
    const float4 w = __ldg(reinterpret_cast<const float4*>(mask + at));
    lab[0] = l.x;
    lab[1] = l.y;
    lab[2] = l.z;
    lab[3] = l.w;
    m[0] = w.x;
    m[1] = w.y;
    m[2] = w.z;
    m[3] = w.w;
  } else {
    lab[0] = __ldg(labels + at);
    m[0] = __ldg(mask + at);
  }
}

// VEC labels a load, UNROLL loads of each operand in flight a thread.
template <int VEC, int UNROLL>
__global__ void __launch_bounds__(kThreads)
diversity_kernel(const int* __restrict__ labels,
                 const float* __restrict__ mask, float* __restrict__ out,
                 int N, int C) {
  extern __shared__ float columns[];  // C x kThreads
  __shared__ float hist[kMaxClasses];
  const int tid = threadIdx.x;
  float* col = columns + tid;
  for (int c = 0; c < C; ++c) col[c * kThreads] = 0.0f;
  const long long row = (long long)blockIdx.x * N;
  const int units = N / VEC;
  for (int first = tid; first < units; first += kThreads * UNROLL) {
    int lab[UNROLL][VEC];
    float m[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = first + u * kThreads;
      if (i < units) {
        load_row<VEC>(lab[u], m[u], labels, mask, row + (long long)i * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          lab[u][e] = -1;
          m[u][e] = 0.0f;
        }
      }
    }
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc += lab[u][e] == c ? m[u][e] : 0.0f;
      col[c * kThreads] += acc;
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c0 = warp; c0 < C; c0 += kWarps * kMergeChains) {
    float s[kMergeChains];
#pragma unroll
    for (int u = 0; u < kMergeChains; ++u) {
      const int c = c0 + u * kWarps;
      s[u] = 0.0f;
      if (c < C) {
#pragma unroll
        for (int j = 0; j < kWarps; ++j)
          s[u] += columns[c * kThreads + j * 32 + lane];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kMergeChains; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kMergeChains; ++u)
        if (c0 + u * kWarps < C) hist[c0 + u * kWarps] = s[u];
    }
  }
  __syncthreads();
  if (warp != 0) return;
  // One warp: each lane holds up to two classes (C <= 64).
  const float h0 = lane < C ? hist[lane] : 0.0f;
  const float h1 = lane + 32 < C ? hist[lane + 32] : 0.0f;
  const float total = repro::warp_reduce<repro::SumOp>(h0 + h1);
  const float denom = fmaxf(total, 1.0f);
  const float p0 = h0 / denom;
  const float p1 = h1 / denom;
  const float l0 = p0 > 0.0f ? log2f(fmaxf(p0, 1e-30f)) : 0.0f;
  const float l1 = p1 > 0.0f ? log2f(fmaxf(p1, 1e-30f)) : 0.0f;
  float sq = p0 * p0 + p1 * p1;
  float ent = p0 * l0 + p1 * l1;
  repro::warp_reduce_pair<repro::SumOp, repro::SumOp>(sq, ent);
  if (lane == 0) {
    out[blockIdx.x * 3 + 0] = 1.0f - sq;
    out[blockIdx.x * 3 + 1] = -ent;
    out[blockIdx.x * 3 + 2] = total;
  }
}

}  // namespace

// Labels a load for rows of N labels at `labels` and `mask`: 4 where N
// is a multiple of 4 and both start 16-byte aligned, else 1.  Mirrored
// by kernels/diversity.py::route, read back by the card test.
extern "C" int diversity_route(const void* labels, const void* mask, int N) {
  const bool aligned = reinterpret_cast<uintptr_t>(labels) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  return N % 4 == 0 && aligned ? 4 : 1;
}

extern "C" int diversity_stats(const int* labels, const float* mask,
                               float* out, int K, int N, int C,
                               cudaStream_t stream) {
  if (K < 1 || N < 1 || C < 1 || C > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * C * kThreads;
  if (diversity_route(labels, mask, N) == 4)
    diversity_kernel<4, 2><<<K, kThreads, smem, stream>>>(labels, mask, out,
                                                          N, C);
  else
    diversity_kernel<1, 8><<<K, kThreads, smem, stream>>>(labels, mask, out,
                                                          N, C);
  return (int)cudaGetLastError();
}
