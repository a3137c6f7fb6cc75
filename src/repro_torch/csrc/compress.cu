// Fused uplink compression with error feedback, one device row per block.
//
// Replaces the TPU kernel compress_update_kernel (src/repro/kernels/
// compress.py, _compress_update_kernel), which held a whole scenario's
// (K, P) update and residual blocks in VMEM and says that a launch at a
// real P needs a P-blocked variant.  This is that variant: one block owns
// one (scenario, device) row and walks it in strides of the block, with
// the row max and the top-k threshold carried in registers across the
// strides and combined by block reductions (block_reduce.cuh).
//
//   v = u + r
//   quant: m = max |v|; levels = max(2^b - 1, 1)
//          scaled = |v| / max(m, 1e-12) * levels; fl = floor(scaled)
//          q = fl + (noise < scaled - fl); c = sign(v) * q / levels * m
//   topk:  thresh_iters trips of lo/hi bisection on count(|v| >= mid) > keep
//          c = |v| >= hi ? v : 0
//   r' = sel > 0 ? v - c : r
//
// The order of operations is the reference's, and the products go
// through __fmul_rn: the compiler would otherwise fuse `scaled - fl` or
// `v - c` into an FMA and round differently from the plain version, which
// flips stochastic roundings.  Built without fast math, so `/` is IEEE.
//
// Bound on the H100: bytes.  quant reads u, r, noise and writes c, r'
// (20 bytes a coordinate) plus a first pass over u, r for the row max;
// topk stages v in the c output and re-reads it on each bisection trip,
// so it moves 16 bytes a coordinate at the bound and about
// (8 + 4 * thresh_iters + 12) here, mostly from L2.
#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kQuant = 0;
constexpr int kTopk = 1;

__global__ void compress_update_kernel(
    const float* __restrict__ updates, const float* __restrict__ residual,
    const float* __restrict__ widths, const float* __restrict__ selected,
    const float* __restrict__ noise, float* __restrict__ c_out,
    float* __restrict__ r_out, long long P, int mode, int keep,
    int thresh_iters) {
  __shared__ float scratch[33];
  const long long row = blockIdx.x;
  const float* u = updates + row * P;
  const float* r = residual + row * P;
  float* c = c_out + row * P;
  float* rn = r_out + row * P;
  const bool take = selected[row] > 0.0f;

  // Pass 1: the row max of |v|; topk keeps v in the c output.
  float m = -INFINITY;
  for (long long p = threadIdx.x; p < P; p += blockDim.x) {
    const float v = u[p] + r[p];
    if (mode == kTopk) c[p] = v;
    m = fmaxf(m, fabsf(v));
  }
  m = repro::block_reduce<repro::MaxOp>(m, scratch);

  if (mode == kQuant) {
    const float* nz = noise + row * P;
    const float levels = fmaxf(exp2f(widths[row]) - 1.0f, 1.0f);
    const float m_floor = fmaxf(m, 1e-12f);
    for (long long p = threadIdx.x; p < P; p += blockDim.x) {
      const float rp = r[p];
      const float v = u[p] + rp;
      const float scaled = __fmul_rn(fabsf(v) / m_floor, levels);
      const float fl = floorf(scaled);
      const float q = fl + (nz[p] < scaled - fl ? 1.0f : 0.0f);
      const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
      const float cp = __fmul_rn(__fmul_rn(sgn, q) / levels, m);
      c[p] = cp;
      rn[p] = take ? v - cp : rp;
    }
    return;
  }

  // topk: each thread re-reads the coordinates it staged itself.
  float lo = 0.0f;
  float hi = m;
  for (int it = 0; it < thresh_iters; ++it) {
    const float mid = __fmul_rn(0.5f, lo + hi);
    float cnt = 0.0f;
    for (long long p = threadIdx.x; p < P; p += blockDim.x)
      cnt += fabsf(c[p]) >= mid ? 1.0f : 0.0f;
    cnt = repro::block_reduce<repro::SumOp>(cnt, scratch);
    if (cnt > (float)keep) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  for (long long p = threadIdx.x; p < P; p += blockDim.x) {
    const float v = c[p];
    const float cp = fabsf(v) >= hi ? v : 0.0f;
    c[p] = cp;
    rn[p] = take ? v - cp : r[p];
  }
}

}  // namespace

extern "C" int compress_update_f32(const float* updates,
                                   const float* residual,
                                   const float* widths,
                                   const float* selected, const float* noise,
                                   float* c_out, float* r_out, int rows,
                                   long long P, int mode, int keep,
                                   int thresh_iters, cudaStream_t stream) {
  if (rows < 1 || P < 1 || (mode != kQuant && mode != kTopk) ||
      thresh_iters < 0)
    return (int)cudaErrorInvalidValue;
  compress_update_kernel<<<rows, kThreads, 0, stream>>>(
      updates, residual, widths, selected, noise, c_out, r_out, P, mode,
      keep, thresh_iters);
  return (int)cudaGetLastError();
}
