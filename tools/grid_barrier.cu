// The decode kernel's grid barrier alone (decode_layer.cuh::grid_sync),
// for tools/grid_barrier.py: `iters` barriers in a row on a cooperative
// grid of 256-thread blocks.

#include "decode_layer.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 1) barrier_loop(unsigned* bar, int iters) {
  unsigned target = 0;
  if (threadIdx.x == 0) target = ld_acquire(bar + 1);
  for (int i = 0; i < iters; ++i) grid_sync(bar, target);
  if (blockIdx.x == 0 && threadIdx.x == 0) bar[1] = target;
}

}  // namespace

extern "C" int qtts_barrier_loop(void* bar, int grid, int iters, void* stream) {
  unsigned* b = static_cast<unsigned*>(bar);
  void* args[] = {&b, &iters};
  return (int)cudaLaunchCooperativeKernel((const void*)barrier_loop, dim3(grid),
                                          dim3(kThreads), args, 0,
                                          reinterpret_cast<cudaStream_t>(stream));
}
