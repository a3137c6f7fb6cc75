// Streaming-data refresh: counts, diversity stats and staleness per device.
//
// Replaces the TPU kernel stream_update_kernel (src/repro/kernels/
// stream_update.py, _stream_update_kernel), which held one scenario's
// (K, C) count and delta blocks in VMEM and reduced over the class axis
// on the VPU.  The arithmetic keeps the reference's, element by element:
//   h = max(h0 + d, 0); size_cap > 0: h *= total > cap ? cap / max(total, 1) : 1
//   p = h / max(size, 1); gini = 1 - sum p*p
//   shannon = -sum p * (p > 0 ? log2(max(p, 1e-30)) : 0)
//   stale' = (sel > 0 ? 0 : decay * stale) + arrivals
// Products go through __fmul_rn so the compiler does not fuse them into
// the following add: the plain version rounds each product.  Only the
// order of the C-term sums differs from the plain version's.
//
// Bound on the H100: bytes, and in practice launch latency.  S*K*C*4*3 +
// S*K*4*6 bytes move (K = 100, C = 10: 14 KB), a few flops per byte; an
// empty launch takes longer than moving them.  So the design keeps the
// chain of dependent steps after the launch short:
// - The S*K device rows are one flat set, kRows(G) rows a 128-thread
//   block (8 at C = 10), so S = 1 spreads over 13 SMs and S = 16 over
//   200 blocks, not one block a scenario.
// - A row gets a group of G lanes (G = 8, 16 or 32 by C; a lane holds
//   V = 2 classes for 32 < C <= 64), a compile-time width: no thread
//   loops over classes under a runtime guard.
// - Rows are contiguous, so the 32 / G rows of a warp are one contiguous
//   span of floats: lane c of a group reads and writes class c of its
//   row, and each load or store instruction of the warp touches that
//   span and nothing else, every 32-byte sector of it in full.  Staging
//   the span through shared memory, consecutive threads on consecutive
//   floats, moves the same sectors and adds two barriers; a development
//   build of it read about 0.3 us slower a launch.
// - The row's sums (total, size, sum p^2 and sum p log2 p) are
//   __shfl_xor_sync butterflies of log2(G) stages inside the group, the
//   last two in flight together; every lane of a group ends with the same
//   bits, so the group agrees on the cap's scale and the denominator.
// - Staleness is one thread a device, coalesced; lanes 0-2 of a group
//   store its row's three stats, so the warp's stats store is one
//   contiguous span too.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxClasses = 64;

// Sum over the aligned group of G lanes; every lane of the group gets the
// same bits (a + b == b + a in IEEE arithmetic).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int G>
__device__ __forceinline__ void group_sum_pair(float& a, float& b) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ra = __shfl_xor_sync(0xffffffffu, a, off);
    const float rb = __shfl_xor_sync(0xffffffffu, b, off);
    a += ra;
    b += rb;
  }
}

// G lanes a row, V classes a lane (class c = lane + v * G).
template <int G, int V>
__global__ void __launch_bounds__(kThreads) stream_update_kernel(
    const float* __restrict__ hists, const float* __restrict__ deltas,
    const float* __restrict__ arrivals, const float* __restrict__ staleness,
    const float* __restrict__ selected, float* __restrict__ h_out,
    float* __restrict__ stats_out, float* __restrict__ stale_out, int rows,
    int C, float decay, float size_cap) {
  constexpr int kRows = kThreads / G;
  const int row0 = blockIdx.x * kRows;
  if (threadIdx.x < kRows && row0 + threadIdx.x < rows) {
    const int r = row0 + threadIdx.x;
    const float kept =
        selected[r] > 0.0f ? 0.0f : __fmul_rn(decay, staleness[r]);
    stale_out[r] = kept + arrivals[r];
  }
  const int lane = threadIdx.x % G;
  const int r = row0 + threadIdx.x / G;
  const bool live = r < rows;
  const long long base = (long long)r * C;
  float h[V];
  float total = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = lane + v * G;
    h[v] = live && c < C ? fmaxf(hists[base + c] + deltas[base + c], 0.0f)
                         : 0.0f;
    total += h[v];
  }
  total = group_sum<G>(total);
  float size = total;
  if (size_cap > 0.0f) {
    const float scale =
        total > size_cap ? size_cap / fmaxf(total, 1.0f) : 1.0f;
    size = 0.0f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      h[v] = __fmul_rn(h[v], scale);
      size += h[v];
    }
    size = group_sum<G>(size);
  }
  const float denom = fmaxf(size, 1.0f);
  float sq = 0.0f;
  float ent = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = lane + v * G;
    if (live && c < C) h_out[base + c] = h[v];
    const float p = h[v] / denom;
    const float logp = p > 0.0f ? log2f(fmaxf(p, 1e-30f)) : 0.0f;
    sq += __fmul_rn(p, p);
    ent += __fmul_rn(p, logp);
  }
  group_sum_pair<G>(sq, ent);
  if (live && lane < 3)
    stats_out[(long long)r * 3 + lane] =
        lane == 0 ? 1.0f - sq : lane == 1 ? -ent : size;
}

// Lanes a row and classes a lane for C classes: the narrowest group of 8,
// 16 or 32 lanes that holds C, two classes a lane past 32.  Mirrored by
// kernels/stream_update.py::route.
int group_lanes(int C) { return C <= 8 ? 8 : C <= 16 ? 16 : 32; }
int lane_classes(int C) { return C <= 32 ? 1 : 2; }

template <int G, int V>
cudaError_t launch(const float* hists, const float* deltas,
                   const float* arrivals, const float* staleness,
                   const float* selected, float* h_out, float* stats_out,
                   float* stale_out, int rows, int C, float decay,
                   float size_cap, cudaStream_t stream) {
  constexpr int kRows = kThreads / G;
  stream_update_kernel<G, V><<<(rows + kRows - 1) / kRows, kThreads, 0,
                               stream>>>(hists, deltas, arrivals, staleness,
                                         selected, h_out, stats_out,
                                         stale_out, rows, C, decay,
                                         size_cap);
  return cudaGetLastError();
}

}  // namespace

// The group's lanes a row times the classes a lane, for C classes (0 if
// the kernel does not take C): what kernels/stream_update.py::route
// predicts, read back by the card test.
extern "C" int stream_update_route(int C) {
  if (C < 1 || C > kMaxClasses) return 0;
  return group_lanes(C) * lane_classes(C);
}

extern "C" int stream_update_f32(const float* hists, const float* deltas,
                                 const float* arrivals,
                                 const float* staleness,
                                 const float* selected, float* h_out,
                                 float* stats_out, float* stale_out, int S,
                                 int K, int C, float decay, float size_cap,
                                 cudaStream_t stream) {
  if (S < 1 || K < 1 || C < 1 || C > kMaxClasses ||
      (long long)S * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rows = S * K;
  switch (stream_update_route(C)) {
    case 8:
      return (int)launch<8, 1>(hists, deltas, arrivals, staleness, selected,
                               h_out, stats_out, stale_out, rows, C, decay,
                               size_cap, stream);
    case 16:
      return (int)launch<16, 1>(hists, deltas, arrivals, staleness,
                                selected, h_out, stats_out, stale_out, rows,
                                C, decay, size_cap, stream);
    case 32:
      return (int)launch<32, 1>(hists, deltas, arrivals, staleness,
                                selected, h_out, stats_out, stale_out, rows,
                                C, decay, size_cap, stream);
    default:
      return (int)launch<32, 2>(hists, deltas, arrivals, staleness,
                                selected, h_out, stats_out, stale_out, rows,
                                C, decay, size_cap, stream);
  }
}
