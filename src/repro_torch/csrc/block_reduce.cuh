// Block-wide reductions shared by the port's kernels.
//
// Every thread of the block calls the reduction with its own value and
// gets the block's result back.  Warp shuffles reduce inside each warp;
// lane 0 of each warp parks its partial in shared memory; warp 0 folds
// the partials.  `scratch` must hold at least 33 elements.  The trailing
// __syncthreads lets the next reduction reuse `scratch` at once.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro {

struct SumOp {
  __device__ static float identity() { return 0.0f; }
  __device__ static float apply(float a, float b) { return a + b; }
};
struct MaxOp {
  __device__ static float identity() { return -INFINITY; }
  __device__ static float apply(float a, float b) { return fmaxf(a, b); }
};
struct MinOp {
  __device__ static float identity() { return INFINITY; }
  __device__ static float apply(float a, float b) { return fminf(a, b); }
};

template <typename Op>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = Op::apply(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Two independent warp reductions in one butterfly, both in flight: each
// lane ends with the same two results (the tree of warp_reduce).
template <typename OpA, typename OpB>
__device__ __forceinline__ void warp_reduce_pair(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ra = __shfl_xor_sync(0xffffffffu, a, off);
    const float rb = __shfl_xor_sync(0xffffffffu, b, off);
    a = OpA::apply(a, ra);
    b = OpB::apply(b, rb);
  }
}

// One reduction over the block; `scratch` holds at least 33 floats.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_reduce<Op>(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? scratch[lane] : Op::identity();
    t = warp_reduce<Op>(t);
    if (lane == 0) scratch[32] = t;
  }
  __syncthreads();
  const float r = scratch[32];
  __syncthreads();
  return r;
}

// Two independent reductions in one pass (one per PGD starting point).
template <typename Op>
__device__ __forceinline__ float2 block_reduce2(float2 v, float2* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v.x = warp_reduce<Op>(v.x);
  v.y = warp_reduce<Op>(v.y);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float2 t = lane < nwarps ? scratch[lane]
                             : make_float2(Op::identity(), Op::identity());
    t.x = warp_reduce<Op>(t.x);
    t.y = warp_reduce<Op>(t.y);
    if (lane == 0) scratch[32] = t;
  }
  __syncthreads();
  float2 r = scratch[32];
  __syncthreads();
  return r;
}

}  // namespace repro
