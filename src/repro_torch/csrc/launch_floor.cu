// An empty kernel: the launch-latency floor of the card.
//
// No TPU kernel is replaced.  `chip_smoke.py` times it by CUDA-graph
// replay, by host loop and by the profiler's device time a launch, and
// sets every small kernel's time beside it: a kernel that moves a few
// kilobytes cannot finish in less time than an empty launch takes.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// One block of one warp.  Returns cudaGetLastError() after the launch.
extern "C" int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
