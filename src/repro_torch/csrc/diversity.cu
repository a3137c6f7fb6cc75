// Label histogram -> [Gini-Simpson, Shannon (log2), count] per client.
//
// Replaces the TPU kernel diversity_kernel (src/repro/kernels/
// diversity.py, _diversity_kernel), which held one client's label row in
// VMEM and built the (C,) histogram with an iota-compare reduction.
// Here one block owns one client: its threads stride over the N labels
// and add the mask value into a shared-memory histogram of C <= 64
// classes, then one warp reduces the histogram to the two measures with
// the reference's 0 * log 0 := 0 guard.  The mask is {0, 1}, so every
// count is an exact integer and the atomic adds give the same histogram
// in any order.  Labels outside [0, C) count nowhere, like the
// reference's one_hot.
//
// Bound on the H100: bytes.  K*N*(4 + 4) bytes are read once and K*12
// written; the work per byte is a compare and an add.
#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 64;

__global__ void diversity_kernel(const int* __restrict__ labels,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out, int N, int C) {
  __shared__ float hist[kMaxClasses];
  for (int c = threadIdx.x; c < C; c += blockDim.x) hist[c] = 0.0f;
  __syncthreads();
  const long long row = (long long)blockIdx.x * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int lab = labels[row + i];
    const float m = mask[row + i];
    if (lab >= 0 && lab < C && m != 0.0f) atomicAdd(&hist[lab], m);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  // One warp: each lane holds up to two classes (C <= 64).
  const int lane = threadIdx.x;
  const float h0 = lane < C ? hist[lane] : 0.0f;
  const float h1 = lane + 32 < C ? hist[lane + 32] : 0.0f;
  const float total = repro::warp_reduce<repro::SumOp>(h0 + h1);
  const float denom = fmaxf(total, 1.0f);
  const float p0 = h0 / denom;
  const float p1 = h1 / denom;
  const float sq = repro::warp_reduce<repro::SumOp>(p0 * p0 + p1 * p1);
  const float l0 = p0 > 0.0f ? log2f(fmaxf(p0, 1e-30f)) : 0.0f;
  const float l1 = p1 > 0.0f ? log2f(fmaxf(p1, 1e-30f)) : 0.0f;
  const float ent = repro::warp_reduce<repro::SumOp>(p0 * l0 + p1 * l1);
  if (lane == 0) {
    out[blockIdx.x * 3 + 0] = 1.0f - sq;
    out[blockIdx.x * 3 + 1] = -ent;
    out[blockIdx.x * 3 + 2] = total;
  }
}

}  // namespace

extern "C" int diversity_stats(const int* labels, const float* mask,
                               float* out, int K, int N, int C,
                               cudaStream_t stream) {
  if (K < 1 || N < 1 || C < 1 || C > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  diversity_kernel<<<K, kThreads, 0, stream>>>(labels, mask, out, N, C);
  return (int)cudaGetLastError();
}
