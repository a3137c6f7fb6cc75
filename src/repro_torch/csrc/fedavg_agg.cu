// FedAvg weighted aggregation: out[p] = sum_k w[k] * u[k, p], f32, its
// success-masked form out[p] = sum_k (w[k] * m[k]) * u[k, p], and its
// staleness-weighted form out[p] = sum_k ((w[k] * m[k]) * s[k]) * u[k, p].
//
// Replaces the TPU kernel fedavg_agg_kernel (src/repro/kernels/
// fedavg_agg.py, _fedavg_kernel), which tiled P into VMEM blocks and
// reduced a (K, BLOCK_P) tile on the VPU.  Here one thread owns one
// coordinate p and walks the K client rows in order, accumulating in
// f32; neighbouring threads read neighbouring addresses of each row, so
// every load is coalesced.  The ragged tail is masked (p < P), not
// padded.  The K weights sit in shared memory.
//
// Bound on the H100: bytes.  K*P*4 bytes of updates are read once and
// P*4 written, against 2*K*P flops — about 0.5 flop/byte, far below the
// card's ridge point, so the kernel can at best stream the (K, P) matrix
// at HBM rate (K=100, P=21,840: 8.7 MB, ~2.6 us at 3.35 TB/s).
//
// The masked kernel replaces fedavg_agg_masked_kernel (the fault
// subsystem's aggregate over the uploads that landed).  It folds the mask
// into the weights as they are staged in shared memory and then runs the
// very same column loop, so an all-ones mask (w * 1.0 == w exactly) gives
// the unmasked kernel's result bit for bit.  Nothing renormalises.
//
// The stale kernel replaces fedavg_agg_stale_kernel (the event-driven
// driver's buffered flush, which discounts each arrived update by its
// model-version staleness s = (1 + tau)^-gamma).  It stages
// (w * m) * s, rounded after each product in the reference's
// left-to-right order, and runs the same column loop: an all-ones s
// (x * 1.0 == x exactly) gives the masked kernel's result bit for bit,
// the identity the event driver's synchronous limit leans on.  The
// three (K,) rows are noise beside the (K, P) matrix: the same byte
// bound as its siblings.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedK = 4096;

// The column loop both kernels share: `w` holds the staged weights.
__device__ __forceinline__ void weighted_column_sum(
    const float* __restrict__ updates, const float* w,
    float* __restrict__ out, int K, long long P) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float* col = updates + p;
  float acc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) acc += w[k] * __ldg(col + (long long)k * P);
  out[p] = acc;
}

__global__ void fedavg_agg_kernel(const float* __restrict__ updates,
                                  const float* __restrict__ weights,
                                  float* __restrict__ out, int K,
                                  long long P) {
  __shared__ float w[kMaxSharedK];
  for (int k = threadIdx.x; k < K; k += blockDim.x) w[k] = weights[k];
  __syncthreads();
  weighted_column_sum(updates, w, out, K, P);
}

__global__ void fedavg_agg_masked_kernel(const float* __restrict__ updates,
                                         const float* __restrict__ weights,
                                         const float* __restrict__ mask,
                                         float* __restrict__ out, int K,
                                         long long P) {
  __shared__ float w[kMaxSharedK];
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    w[k] = __fmul_rn(weights[k], mask[k]);
  __syncthreads();
  weighted_column_sum(updates, w, out, K, P);
}

__global__ void fedavg_agg_stale_kernel(const float* __restrict__ updates,
                                        const float* __restrict__ weights,
                                        const float* __restrict__ mask,
                                        const float* __restrict__ stale,
                                        float* __restrict__ out, int K,
                                        long long P) {
  __shared__ float w[kMaxSharedK];
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    w[k] = __fmul_rn(__fmul_rn(weights[k], mask[k]), stale[k]);
  __syncthreads();
  weighted_column_sum(updates, w, out, K, P);
}

}  // namespace

extern "C" int fedavg_agg_f32(const float* updates, const float* weights,
                              float* out, int K, long long P,
                              cudaStream_t stream) {
  if (K < 1 || K > kMaxSharedK || P < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (P + kThreads - 1) / kThreads;
  fedavg_agg_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      updates, weights, out, K, P);
  return (int)cudaGetLastError();
}

extern "C" int fedavg_agg_masked_f32(const float* updates,
                                     const float* weights, const float* mask,
                                     float* out, int K, long long P,
                                     cudaStream_t stream) {
  if (K < 1 || K > kMaxSharedK || P < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (P + kThreads - 1) / kThreads;
  fedavg_agg_masked_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      updates, weights, mask, out, K, P);
  return (int)cudaGetLastError();
}

extern "C" int fedavg_agg_stale_f32(const float* updates,
                                    const float* weights, const float* mask,
                                    const float* stale, float* out, int K,
                                    long long P, cudaStream_t stream) {
  if (K < 1 || K > kMaxSharedK || P < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (P + kThreads - 1) / kThreads;
  fedavg_agg_stale_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      updates, weights, mask, stale, out, K, P);
  return (int)cudaGetLastError();
}
