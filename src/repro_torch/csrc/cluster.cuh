// Thread block clusters, shared by the port's kernels (flash_attention.cu:
// the decode's kv splits; compress.cu: a row split over several blocks):
// this block's rank in its cluster, a barrier of every thread of the
// cluster, and loads from the same shared variable of block `rank`
// (distributed shared memory).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of shared variable `p` in the shared memory of block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return addr;
}

__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(cluster_addr(p, rank))
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_cluster(const uint32_t* p,
                                               uint32_t rank) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(cluster_addr(p, rank))
               : "memory");
  return v;
}

}  // namespace repro
