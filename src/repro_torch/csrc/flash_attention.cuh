// Helpers shared by the flash attention kernels (flash_attention.cu: the
// f32 prefill in split TF32 and the decode; flash_attention_tc.cu:
// the bf16 prefill on the tensor cores; flash_attention_bwd.cu and
// flash_attention_bwd_tc.cu: the backward): masks, staging into shared
// memory, mbarriers, TMA loads and tensor maps.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int kv_len,
                                        int causal, int window) {
  bool v = kpos < kv_len;
  if (causal) v = v && kpos <= qpos;
  if (window > 0) v = v && kpos > qpos - window;
  return v;
}

// The kv range [lo, hi) that can hold a visible key for q rows
// [q_lo, q_hi].
__device__ __forceinline__ void kv_range(int q_lo, int q_hi, int kv_len,
                                         int causal, int window, int* lo,
                                         int* hi) {
  int h = kv_len;
  if (causal) h = min(h, q_hi + 1);
  int l = 0;
  if (window > 0) l = max(0, q_lo - window + 1);
  *lo = l;
  *hi = max(h, l);
}

// Eight elements as f32, and one stored in the input type (rounded to
// nearest in bf16).
__device__ __forceinline__ void load8(const float* p, float* d) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* d) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage `rows` rows of one head into shared memory as f32 (row stride
// ld), multiplied by `mul`; rows at or past `limit` become zeros.
// Row r of the tile is element ((b * S + pos0 + r) * NH + head) * hd.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t base, int64_t row_stride,
                                      int pos0, int rows, int limit, int hd,
                                      float mul, int nthreads) {
  const int chunks = hd / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += nthreads) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    float vals[8];
    if (pos0 + r < limit) {
      load8(src + base + (int64_t)(pos0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
    out[0] = make_float4(vals[0] * mul, vals[1] * mul, vals[2] * mul,
                         vals[3] * mul);
    out[1] = make_float4(vals[4] * mul, vals[5] * mul, vals[6] * mul,
                         vals[7] * mul);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers: arrivals plus the bytes of asynchronous copies.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A 4-D TMA box into shared memory, counted on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A 5-D TMA box into shared memory (the tensor-core kernels' packed q
// tiles: hd, G, KV, Sq, B), counted on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// cuTensorMapEncodeTiled is a driver-API function: fetch it through the
// runtime so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of `rank` dims (innermost first, dense strides) over
// elements of `elem` bytes (2: bf16, 4: f32), boxes `box`, with the
// 128-byte swizzle or none, zeros out of bounds.  `extent`, if given,
// bounds each dim below its size in `dims` (which alone sets the
// strides): reads past it come back as zeros.  Returns 0 or -(CUresult).
inline int encode_map(CUtensorMap* map, const void* base, int elem, int rank,
                      const cuuint64_t* dims, const cuuint32_t* box,
                      bool swizzle = true,
                      const cuuint64_t* extent = nullptr) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  cuuint64_t strides[4];
  cuuint64_t stride = elem;
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapDataType type = elem == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUresult res = fn(map, type, rank, const_cast<void*>(base),
                    extent != nullptr ? extent : dims, strides,
                    box, ones,
                    CU_TENSOR_MAP_INTERLEAVE_NONE,
                    swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -(int)res;
}

}  // namespace flash
