// Streaming-data refresh: counts, diversity stats and staleness per device.
//
// Replaces the TPU kernel stream_update_kernel (src/repro/kernels/
// stream_update.py, _stream_update_kernel), which held one scenario's
// (K, C) count and delta blocks in VMEM and reduced over the class axis
// on the VPU.  Here one block owns one scenario and one thread owns one
// device row: the C <= 64 classes of the row sit in a register array, so
// the cap rescale, the size, Gini-Simpson and Shannon all fall out of one
// read of the row.  The arithmetic keeps the reference's order:
//   h = max(h0 + d, 0); size_cap > 0: h *= total > cap ? cap / max(total, 1) : 1
//   p = h / max(size, 1); gini = 1 - sum p*p
//   shannon = -sum p * (p > 0 ? log2(max(p, 1e-30)) : 0)
//   stale' = (sel > 0 ? 0 : decay * stale) + arrivals
// Products go through __fmul_rn so the compiler does not fuse them into
// the following add: the plain version rounds each product.
//
// Bound on the H100: bytes, and in practice launch latency.  S*K*C*4*3 +
// S*K*4*6 bytes move (K = 100, C = 10: 14 KB), a few flops per byte.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxClasses = 64;
constexpr int kMaxThreads = 1024;

__global__ void stream_update_kernel(const float* __restrict__ hists,
                                     const float* __restrict__ deltas,
                                     const float* __restrict__ arrivals,
                                     const float* __restrict__ staleness,
                                     const float* __restrict__ selected,
                                     float* __restrict__ h_out,
                                     float* __restrict__ stats_out,
                                     float* __restrict__ stale_out, int K,
                                     int C, float decay, float size_cap) {
  const long long scen = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const long long row = scen * K + k;
    const float* h0 = hists + row * C;
    const float* d = deltas + row * C;
    float h[kMaxClasses];
    float total = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < C) {
        h[c] = fmaxf(h0[c] + d[c], 0.0f);
        total += h[c];
      }
    }
    if (size_cap > 0.0f) {
      const float scale =
          total > size_cap ? size_cap / fmaxf(total, 1.0f) : 1.0f;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c)
        if (c < C) h[c] = __fmul_rn(h[c], scale);
    }
    float size = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < C) {
        h_out[row * C + c] = h[c];
        size += h[c];
      }
    }
    const float denom = fmaxf(size, 1.0f);
    float sq = 0.0f;
    float ent = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < C) {
        const float p = h[c] / denom;
        const float logp = p > 0.0f ? log2f(fmaxf(p, 1e-30f)) : 0.0f;
        sq += __fmul_rn(p, p);
        ent += __fmul_rn(p, logp);
      }
    }
    stats_out[row * 3 + 0] = 1.0f - sq;
    stats_out[row * 3 + 1] = -ent;
    stats_out[row * 3 + 2] = size;
    const float kept =
        selected[row] > 0.0f ? 0.0f : __fmul_rn(decay, staleness[row]);
    stale_out[row] = kept + arrivals[row];
  }
}

}  // namespace

extern "C" int stream_update_f32(const float* hists, const float* deltas,
                                 const float* arrivals,
                                 const float* staleness,
                                 const float* selected, float* h_out,
                                 float* stats_out, float* stale_out, int S,
                                 int K, int C, float decay, float size_cap,
                                 cudaStream_t stream) {
  if (S < 1 || K < 1 || C < 1 || C > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  int threads = ((K + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  stream_update_kernel<<<S, threads, 0, stream>>>(
      hists, deltas, arrivals, staleness, selected, h_out, stats_out,
      stale_out, K, C, decay, size_cap);
  return (int)cudaGetLastError();
}
