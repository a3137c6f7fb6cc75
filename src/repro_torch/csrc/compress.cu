// Fused uplink compression with error feedback, rows held on chip.
//
// Replaces the TPU kernel compress_update_kernel (src/repro/kernels/
// compress.py, _compress_update_kernel), which held a whole scenario's
// (K, P) update and residual blocks in VMEM and says that a launch at a
// real P needs a P-blocked variant.
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
// (20 bytes a coordinate); topk moves 16 (no noise).
//
// The on-chip route (rows up to kMaxCluster * kMaxChunk floats) reads
// each row from HBM once.  A row is split over a thread block cluster of
// nb = 1, 2, 4 or 8 blocks (the wrapper picks nb from P and the mode; a
// block's chunk is at most kMaxChunk floats, 96 KB, so two blocks share an
// SM); each block keeps its chunk of v = u + r in shared memory from the
// first read to the final write of c and r'.  An unselected row's r' = r
// is written during that first read, so r is never read twice.  Device
// memory moves in the widest loads and stores (float4, float2, float)
// the block's addresses allow, 16 floats of each input in flight a
// thread.  The row max and each bisection pass's counts are combined over
// the cluster with one barrier a round: each warp reduces with redux.sync
// and adds its totals into this block's slots by shared-memory atomics
// (integer counts, and the max of |v| as its bit pattern: both exact in
// any order); after the barrier each warp reads the slots of every block
// of the cluster, one (value, block) pair a lane, through distributed
// shared memory.  Slots rotate over three buffers, so a slot is zeroed
// two rounds before it is used again and no second barrier is needed.
//
// topk first takes full_trips trips over the whole chunk, one a pass.
// Each warp then packs the magnitudes still inside the bracket [lo, hi)
// into a pool of its own (a few percent of the chunk; a warp whose pool
// overflows keeps counting its whole share) and each thread counts those
// at or above hi, which every later midpoint counts.  The remaining trips
// run D a pass over the pools: the 2^D - 1 midpoints the next D trips can
// visit, each computed as its trip would compute it (__fmul_rn(0.5f,
// lo + hi) down the tree of brackets), counted in one sweep.  Counts fall
// as the midpoint rises, so the trips' lo after D steps is the largest
// midpoint whose count exceeds keep (or lo) and hi the least of the
// others (or hi): the trip-by-trip bracket, bit for bit.  Each count is an
// integer below 2^24, so the kept set is the plain version's exactly.
//
// Longer rows take the streaming route (the earlier design): one
// 1024-thread block a row walks it in strides, v staged in the c output
// and re-read on each of the thresh_iters trips.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "block_reduce.cuh"
#include "cluster.cuh"

extern "C" int compress_update_smem(long long P, int nb, int mode);

namespace {

constexpr int kQuant = 0;
constexpr int kTopk = 1;
constexpr int kStreamThreads = 1024;
constexpr int kThreads = 512;
constexpr int kMaxChunk = 24576;       // floats of a row a block holds
constexpr int kMaxCluster = 8;
constexpr int kMaxDepth = 4;
constexpr int kUnroll = 8;

// The arithmetic of one quantized coordinate, shared by both routes.
__device__ __forceinline__ float quantize(float v, float nz, float m,
                                          float m_floor, float levels) {
  const float scaled = __fmul_rn(fabsf(v) / m_floor, levels);
  const float fl = floorf(scaled);
  const float q = fl + (nz < scaled - fl ? 1.0f : 0.0f);
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(__fmul_rn(sgn, q) / levels, m);
}

__device__ __forceinline__ float quant_levels(float width) {
  return fmaxf(exp2f(width) - 1.0f, 1.0f);
}

// ---------------------------------------------------------------------
// Streaming route: one block a row, the row read from device memory on
// every pass.
// ---------------------------------------------------------------------
__global__ void compress_stream_kernel(
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
    const float levels = quant_levels(widths[row]);
    const float m_floor = fmaxf(m, 1e-12f);
    for (long long p = threadIdx.x; p < P; p += blockDim.x) {
      const float rp = r[p];
      const float v = u[p] + rp;
      const float cp = quantize(v, nz[p], m, m_floor, levels);
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

// ---------------------------------------------------------------------
// On-chip route.
// ---------------------------------------------------------------------

// The rounds of the cluster-wide combine.  In a round, each warp folds
// its values into this block's slots[round % 3] by shared-memory atomics
// (lane j adds value j); finish() is the round's one barrier.  Then each
// warp reads the n slots of every block of the cluster at once, one
// (value, block) pair a lane, through distributed shared memory, and
// folds each value's nb blocks by a butterfly over its nb lanes.  It then
// zeroes the slot two rounds ahead, whose last readers (round - 1) have
// all passed this barrier, and whose next writers come after the next.
struct Rounds {
  uint32_t (*slots)[16];
  int nb;
  int round;

  // Lane j < n adds vals[j] (the same in every lane) to slot j.
  template <bool MAX, int N>
  __device__ __forceinline__ void add(const uint32_t (&vals)[N], int n) {
    const int lane = threadIdx.x & 31;
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (lane == j) mine = vals[j];
    uint32_t* s = slots[round % 3];
    if (lane < n) {
      if (MAX) {
        atomicMax(s + lane, mine);
      } else {
        atomicAdd(s + lane, mine);
      }
    }
  }

  template <bool MAX, int N>
  __device__ __forceinline__ void finish(uint32_t (&tot)[N], int n) {
    if (nb > 1) {
      repro::cluster_sync();
    } else {
      __syncthreads();
    }
    const uint32_t* s = slots[round % 3];
    const int lane = threadIdx.x & 31;
    const int pairs = n * nb;        // nb is a power of two <= 8
#pragma unroll
    for (int base = 0; base < N * kMaxCluster; base += 32) {
      if (base < pairs) {
        const int idx = base + lane;
        uint32_t x = 0;
        if (idx < pairs) {
          const int j = idx / nb;
          x = nb > 1 ? repro::ld_cluster(s + j, idx % nb) : s[j];
        }
        for (int off = 1; off < nb; off <<= 1) {
          const uint32_t y = __shfl_xor_sync(0xffffffffu, x, off);
          x = MAX ? max(x, y) : x + y;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int src = j * nb - base;
          if (j < n && src >= 0 && src < 32)
            tot[j] = __shfl_sync(0xffffffffu, x, src);
        }
      }
    }
    if (threadIdx.x < 16) slots[(round + 2) % 3][threadIdx.x] = 0;
    ++round;
  }
};

// Each thread's counts of |v| >= mids[j] (j < n) over its float4s of the
// chunk, q = tid, tid + kThreads, ...: NaN padding counts nowhere.
template <int N>
__device__ __forceinline__ void count_share(const float4* xs, int len4,
                                            const float (&mids)[N], int n,
                                            uint32_t (&cnt)[N]) {
  for (int q = threadIdx.x; q < len4; q += kThreads) {
    const float4 x = xs[q];
    const float a0 = fabsf(x.x), a1 = fabsf(x.y), a2 = fabsf(x.z),
                a3 = fabsf(x.w);
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n)
        cnt[j] += (uint32_t)(a0 >= mids[j]) + (uint32_t)(a1 >= mids[j]) +
                  (uint32_t)(a2 >= mids[j]) + (uint32_t)(a3 >= mids[j]);
  }
}

// The same over a warp's pool of `nw` kept magnitudes, a lane taking
// pool[lane], pool[lane + 32], ...
template <int N>
__device__ __forceinline__ void count_pool(const float* pool, int nw,
                                           const float (&mids)[N], int n,
                                           uint32_t (&cnt)[N]) {
  for (int i = threadIdx.x & 31; i < nw; i += 32) {
    const float a = pool[i];
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n) cnt[j] += (uint32_t)(a >= mids[j]);
  }
}

// One pass of d <= D bisection trips.  The 2^d - 1 midpoints the trips
// can visit, in heap order (node j's children: 2j + 1 where the count
// exceeds keep and lo = mid, 2j + 2 where hi = mid), each computed as its
// trip computes it; `count(mids, n, cnt)` adds this thread's counts; the
// cluster's totals then give the trips' bracket: the largest midpoint
// whose count exceeds keep (or lo), the least of the others (or hi).
template <int D, typename Count>
__device__ __forceinline__ void bisect_pass(float& lo, float& hi, int d,
                                            int keep, Rounds& rounds,
                                            Count count) {
  constexpr int N = (1 << D) - 1;
  const int n = (1 << d) - 1;
  float mids[N], blo[N], bhi[N];
  blo[0] = lo;
  bhi[0] = hi;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mids[j] = __fmul_rn(0.5f, blo[j] + bhi[j]);
    if (2 * j + 2 < N) {
      blo[2 * j + 1] = mids[j];
      bhi[2 * j + 1] = bhi[j];
      blo[2 * j + 2] = blo[j];
      bhi[2 * j + 2] = mids[j];
    }
  }
  uint32_t cnt[N];
#pragma unroll
  for (int j = 0; j < N; ++j) cnt[j] = 0;
  count(mids, n, cnt);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) cnt[j] = __reduce_add_sync(0xffffffffu, cnt[j]);
  rounds.add<false>(cnt, n);
  uint32_t tot[N];
  rounds.finish<false>(tot, n);
  float nlo = lo, nhi = hi;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) {
      if (tot[j] > (uint32_t)keep) {
        nlo = fmaxf(nlo, mids[j]);
      } else {
        nhi = fminf(nhi, mids[j]);
      }
    }
  lo = nlo;
  hi = nhi;
}

// VEC floats to or from p, aligned to VEC floats.
template <int VEC>
__device__ __forceinline__ void ldv(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void stv(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// One block's share of a row: its len coordinates in device memory and v
// in shared memory.  A walk over it takes VEC floats a step (thread tid
// the vectors tid, tid + kThreads, ...), then the last len % VEC floats
// one a thread.
struct Chunk {
  const float* u;
  const float* r;
  const float* nz;
  float* c;
  float* rn;
  float* vs;
  int len;
  bool take;
};

// The one read of u and r: v into shared memory and an unselected row's
// r' = r; returns this thread's max of |v|.  16 floats of each input in
// flight a thread.
template <int VEC>
__device__ __forceinline__ float read_chunk(const Chunk& k) {
  constexpr int U = 16 / VEC;
  const int nv = k.len / VEC;
  float m = 0.0f;
  for (int base = threadIdx.x; base < nv; base += U * kThreads) {
    float uu[U][VEC], rr[U][VEC];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int iv = base + i * kThreads;
      if (iv < nv) {
        ldv<VEC>(k.u + iv * VEC, uu[i]);
        ldv<VEC>(k.r + iv * VEC, rr[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int iv = base + i * kThreads;
      if (iv < nv) {
        float v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[e] = uu[i][e] + rr[i][e];
          m = fmaxf(m, fabsf(v[e]));
        }
        stv<VEC>(k.vs + iv * VEC, v);
        if (!k.take) stv<VEC>(k.rn + iv * VEC, rr[i]);
      }
    }
  }
  const int p = nv * VEC + threadIdx.x;
  if (p < k.len) {
    const float rp = k.r[p];
    const float v = k.u[p] + rp;
    k.vs[p] = v;
    m = fmaxf(m, fabsf(v));
    if (!k.take) k.rn[p] = rp;
  }
  return m;
}

// quant's pass: the noise in, c and a selected row's r' out.
template <int VEC>
__device__ __forceinline__ void quant_chunk(const Chunk& k, float m,
                                            float m_floor, float levels) {
  constexpr int U = 16 / VEC;
  const int nv = k.len / VEC;
  for (int base = threadIdx.x; base < nv; base += U * kThreads) {
    float z[U][VEC];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int iv = base + i * kThreads;
      if (iv < nv) ldv<VEC>(k.nz + iv * VEC, z[i]);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int iv = base + i * kThreads;
      if (iv < nv) {
        float v[VEC], cp[VEC], rp[VEC];
        ldv<VEC>(k.vs + iv * VEC, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          cp[e] = quantize(v[e], z[i][e], m, m_floor, levels);
          rp[e] = v[e] - cp[e];
        }
        stv<VEC>(k.c + iv * VEC, cp);
        if (k.take) stv<VEC>(k.rn + iv * VEC, rp);
      }
    }
  }
  const int p = nv * VEC + threadIdx.x;
  if (p < k.len) {
    const float v = k.vs[p];
    const float cp = quantize(v, k.nz[p], m, m_floor, levels);
    k.c[p] = cp;
    if (k.take) k.rn[p] = v - cp;
  }
}

// topk's write: c = |v| >= hi ? v : 0 and a selected row's r' = v - c.
template <int VEC>
__device__ __forceinline__ void topk_chunk(const Chunk& k, float hi) {
  const int nv = k.len / VEC;
  for (int iv = threadIdx.x; iv < nv; iv += kThreads) {
    float v[VEC], cp[VEC], rp[VEC];
    ldv<VEC>(k.vs + iv * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      cp[e] = fabsf(v[e]) >= hi ? v[e] : 0.0f;
      rp[e] = v[e] - cp[e];
    }
    stv<VEC>(k.c + iv * VEC, cp);
    if (k.take) stv<VEC>(k.rn + iv * VEC, rp);
  }
  const int p = nv * VEC + threadIdx.x;
  if (p < k.len) {
    const float v = k.vs[p];
    const float cp = fabsf(v) >= hi ? v : 0.0f;
    k.c[p] = cp;
    if (k.take) k.rn[p] = v - cp;
  }
}

// Calls f(std::integral_constant<int, VEC>()) with the widest VEC (4, 2
// or 1 floats) that every address OR-ed into `addrs` is aligned to.
template <typename F>
__device__ __forceinline__ auto by_width(uintptr_t addrs, F f) {
  if (addrs % 16 == 0) return f(std::integral_constant<int, 4>());
  if (addrs % 8 == 0) return f(std::integral_constant<int, 2>());
  return f(std::integral_constant<int, 1>());
}

template <int MODE, int D>
__global__ void __launch_bounds__(kThreads, 2)
compress_onchip_kernel(const float* __restrict__ updates,
                       const float* __restrict__ residual,
                       const float* __restrict__ widths,
                       const float* __restrict__ selected,
                       const float* __restrict__ noise,
                       float* __restrict__ c_out, float* __restrict__ r_out,
                       long long P, int nb, int chunk, int keep,
                       int thresh_iters, int full_trips, int cap) {
  extern __shared__ float4 vs4[];
  __shared__ uint32_t slots[3][16];
  const int tid = threadIdx.x;
  const uint32_t rank = nb > 1 ? repro::cluster_rank() : 0;
  const long long row = blockIdx.x / nb;
  const long long first = (long long)rank * chunk;
  const long long off = row * P + first;
  const Chunk k{updates + off,
                residual + off,
                MODE == kQuant ? noise + off : nullptr,
                c_out + off,
                r_out + off,
                reinterpret_cast<float*>(vs4),
                (int)max(0LL, min((long long)chunk, P - first)),
                selected[row] > 0.0f};
  // chunk is a multiple of 4 floats, so a block's addresses are aligned as
  // its row's.
  const uintptr_t addrs = (uintptr_t)k.u | (uintptr_t)k.r | (uintptr_t)k.c |
                          (uintptr_t)k.rn | (uintptr_t)k.nz;
  if (tid < 48) slots[tid / 16][tid % 16] = 0;
  __syncthreads();

  float m = by_width(addrs, [&](auto vec) {
    return read_chunk<decltype(vec)::value>(k);
  });
  // Pad to whole float4s with NaN, which no midpoint counts.
  const int len4 = (k.len + 3) / 4;
  if (tid < 4 * len4 - k.len) k.vs[k.len + tid] = __int_as_float(0x7fc00000);

  // Round 0: the row max.  |v| >= 0, so its bits order as unsigned ints.
  Rounds rounds{slots, nb, 0};
  {
    const uint32_t w[1] = {__reduce_max_sync(0xffffffffu, __float_as_uint(m))};
    rounds.add<true>(w, 1);
    uint32_t tot[1];
    rounds.finish<true>(tot, 1);
    m = __uint_as_float(tot[0]);
  }

  if constexpr (MODE == kQuant) {
    const float levels = quant_levels(widths[row]);
    const float m_floor = fmaxf(m, 1e-12f);
    by_width(addrs, [&](auto vec) {
      quant_chunk<decltype(vec)::value>(k, m, m_floor, levels);
      return 0;
    });
  } else {
    // The first full_trips trips count the whole chunk, one a pass.
    float lo = 0.0f;
    float hi = m;
    int left = thresh_iters;
    const auto share = [&](const auto& mids, int n, auto& cnt) {
      count_share(vs4, len4, mids, n, cnt);
    };
    for (int t = 0; t < full_trips && left > 0; ++t, --left)
      bisect_pass<1>(lo, hi, 1, keep, rounds, share);
    if (left > 0) {
      // Compaction: each warp packs the |v| of its share that lie in
      // [lo, hi) into its own pool (ballots give each lane its place; no
      // barrier, as no other warp reads the pool), and each thread counts
      // those at or above hi, which every later midpoint (lo <= mid <= hi)
      // counts; those below lo none does.  A warp whose pool would hold
      // more than 32 * cap keeps counting its whole share.
      const int warp = tid >> 5;
      const int lane = tid & 31;
      const int capw = 32 * cap;
      float* pool = k.vs + chunk + warp * capw;
      uint32_t above = 0;
      int nw = 0;
      for (int q0 = warp * 32; q0 < len4; q0 += kThreads) {
        const int q = q0 + lane;
        float4 x = make_float4(NAN, NAN, NAN, NAN);
        if (q < len4) x = vs4[q];
        const float a[4] = {fabsf(x.x), fabsf(x.y), fabsf(x.z), fabsf(x.w)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          above += (uint32_t)(a[e] >= hi);
          const bool in = a[e] >= lo && a[e] < hi;
          const uint32_t ball = __ballot_sync(0xffffffffu, in);
          const int pos = nw + __popc(ball & ((1u << lane) - 1u));
          if (in && pos < capw) pool[pos] = a[e];
          nw += __popc(ball);
        }
      }
      const bool whole = nw > capw;
      const auto kept = [&](const auto& mids, int n, auto& cnt) {
        if (whole) {
          count_share(vs4, len4, mids, n, cnt);
          return;
        }
        count_pool(pool, nw, mids, n, cnt);
#pragma unroll
        for (int j = 0; j < (int)(sizeof(cnt) / sizeof(cnt[0])); ++j)
          cnt[j] += above;
      };
      // The rest, D trips a pass over the kept values.
      while (left > 0) {
        const int d = min(D, left);
        left -= d;
        bisect_pass<D>(lo, hi, d, keep, rounds, kept);
      }
    }
    by_width(addrs, [&](auto vec) {
      topk_chunk<decltype(vec)::value>(k, hi);
      return 0;
    });
  }
  // No block leaves while another may still read its slots.
  if (nb > 1) repro::cluster_sync();
}

// A block's share of a row of P floats over nb blocks, rounded up to
// whole float4s.
long long onchip_chunk(long long P, int nb) {
  return 4 * (((P + nb - 1) / nb + 3) / 4);
}

// Pool slots a thread of a topk block adds to its warp's pool: an eighth
// of the coordinates of its share of the chunk.
int kept_slots(int chunk) {
  const int per_thread = ((chunk + 3) / 4 + kThreads - 1) / kThreads;
  return (4 * per_thread + 7) / 8;
}

template <int MODE, int D>
int launch_onchip(const float* updates, const float* residual,
                  const float* widths, const float* selected,
                  const float* noise, float* c_out, float* r_out, int rows,
                  long long P, int nb, int keep, int thresh_iters,
                  int full_trips, cudaStream_t stream) {
  const int chunk = onchip_chunk(P, nb);
  const size_t smem = (size_t)compress_update_smem(P, nb, MODE);
  auto kernel = compress_onchip_kernel<MODE, D>;
  // The shared-memory opt-in, once per device for this instantiation (it
  // costs the host microseconds a call).
  static std::atomic<uint64_t> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && !((opted.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kMaxChunk + kThreads * kept_slots(kMaxChunk)) *
            (int)sizeof(float));
    if (err == cudaSuccess) opted.fetch_or(uint64_t{1} << dev);
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * (unsigned)nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nb > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, updates, residual, widths, selected,
                           noise, c_out, r_out, P, nb, chunk, keep,
                           thresh_iters, full_trips, kept_slots(chunk));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// route 0: on chip, nb blocks a row in a cluster, topk counting the whole
// chunk for its first full_trips trips, then bisecting `depth` trips a
// pass over the kept values; route 1: streaming (one block a row).
extern "C" int compress_update_f32(const float* updates,
                                   const float* residual,
                                   const float* widths,
                                   const float* selected, const float* noise,
                                   float* c_out, float* r_out, int rows,
                                   long long P, int mode, int keep,
                                   int thresh_iters, int route, int nb,
                                   int depth, int full_trips,
                                   cudaStream_t stream) {
  if (rows < 1 || P < 1 || (mode != kQuant && mode != kTopk) ||
      thresh_iters < 0)
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    compress_stream_kernel<<<rows, kStreamThreads, 0, stream>>>(
        updates, residual, widths, selected, noise, c_out, r_out, P, mode,
        keep, thresh_iters);
    return (int)cudaGetLastError();
  }
  if (route != 0 || (nb != 1 && nb != 2 && nb != 4 && nb != kMaxCluster) ||
      compress_update_smem(P, nb, mode) == 0 || depth < 1 ||
      depth > kMaxDepth || full_trips < 0)
    return (int)cudaErrorInvalidValue;
  const auto args = [&](auto launch) {
    return launch(updates, residual, widths, selected, noise, c_out, r_out,
                  rows, P, nb, keep, thresh_iters, full_trips, stream);
  };
  if (mode == kQuant) return args(launch_onchip<kQuant, 1>);
  switch (depth) {
    case 1: return args(launch_onchip<kTopk, 1>);
    case 2: return args(launch_onchip<kTopk, 2>);
    case 3: return args(launch_onchip<kTopk, 3>);
    default: return args(launch_onchip<kTopk, 4>);
  }
}

// The dynamic shared memory of an on-chip block for rows of P floats over
// nb blocks (the chunk, and for topk its kept-value slots), or 0 where the
// route refuses them: the wrapper's mirror.
extern "C" int compress_update_smem(long long P, int nb, int mode) {
  if (P < 1 || nb < 1 || nb > kMaxCluster) return 0;
  const long long chunk = onchip_chunk(P, nb);
  if (chunk > kMaxChunk) return 0;
  long long floats = chunk;
  if (mode == kTopk) floats += (long long)kThreads * kept_slots((int)chunk);
  return (int)(floats * (long long)sizeof(float));
}
