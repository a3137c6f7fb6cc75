// Fill the shared memory of every SM with one 32-bit word.
//
// Shared memory is not cleared between kernels: a kernel that reads a
// byte it has not written reads whatever an earlier kernel left there.
// A check fills it with a NaN pattern first, so that such a read shows
// up as a NaN in the result instead of passing on leftover finite bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FILL_THREADS = 1024;

__global__ void __launch_bounds__(FILL_THREADS)
shared_fill_kernel(uint32_t word, int words) {
  extern __shared__ uint32_t buf[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  for (int i = threadIdx.x; i < words; i += FILL_THREADS)
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(base + 4 * i), "r"(word)
                 : "memory");
}

}  // namespace

// Launches blocks_per_sm x (SM count) blocks that each take all the shared
// memory a block may have, so every SM runs several.  Returns
// cudaGetLastError() after the launch.
extern "C" int shared_fill(int word, int blocks_per_sm, void* stream) {
  int dev = 0, sms = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(shared_fill_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  shared_fill_kernel<<<sms * blocks_per_sm, FILL_THREADS, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t>(word), bytes / 4);
  return (int)cudaGetLastError();
}
