// An empty kernel behind the same plain C interface as the renderer's
// kernels. Its device time is the floor under any kernel of a few
// microseconds: what one launch costs the card when no work is done.
// It is a measuring aid and lies on no path of the renderer.
#include <cuda_runtime.h>

__global__ void launch_floor_kernel() {}

extern "C" int rodygs_launch_floor(int blocks, int threads,
                                   cudaStream_t stream) {
  launch_floor_kernel<<<blocks, threads, 0, stream>>>();
  return (int)cudaGetLastError();
}
