// Launch and per-block overhead probes K5, K6 and K7, for Hopper (sm_90a).
//
// Replace, in order:
// - K5 scripts/exp_pallas_overhead.py::make_grid_fn (kernel copy_kernel):
//   x + 1 over int32 [n_steps * rows, 128], one (rows, 128) block per grid
//   step.  Here one CUDA block per tile, one thread per element.
// - K6 scripts/exp_pallas_overhead.py::main's g (kernel loop_kernel): the
//   same x + 1 as ONE grid step that loops over the (8, 128) tiles.  Here
//   one block that loops over the tiles.
// - K7 scripts/exp_device_roundup.py section 1 (kernel empty_kernel): an
//   identity copy of a float32 [128, 128] tile whose index map sends every
//   grid step to block (0, 0).  Here `steps` blocks that each copy the same
//   tile to the one output.  Those writes race, but every block writes the
//   same value to each element, so the result is the tile whichever block
//   writes last: the race is benign.
// Plain versions: x + 1 and x.clone(), in
// libdeflate_tpu_torch/experiments/exp_launch_overhead.py and
// exp_device_roundup.py.
//
// What bounds them on this card: bytes, a few kilobytes to 2 MiB read and
// written once (under a microsecond at 3.35 TB/s); in practice the fixed
// cost of a launch and of scheduling blocks, which is what they measure.
// Design: the simplest kernels that do the work, so that their time is
// the overhead: a thread per element of a tile, no tiling tricks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

__global__ void add_one_grid_kernel(const int* __restrict__ x,
                                    int* __restrict__ o, int tile) {
  const size_t base = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    o[base + i] = x[base + i] + 1;
}

__global__ void add_one_loop_kernel(const int* __restrict__ x,
                                    int* __restrict__ o, int ntiles,
                                    int tile) {
  for (int k = 0; k < ntiles; ++k) {
    const size_t base = (size_t)k * tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
      o[base + i] = x[base + i] + 1;
  }
}

__global__ void copy_same_tile_kernel(const float* __restrict__ x,
                                      float* __restrict__ o, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = x[i];
}

int threads_for(int tile) { return tile < 1024 ? tile : 1024; }

}  // namespace

// K5: x, o int32 [n_steps * rows][128]; one block per (rows, 128) tile.
extern "C" int grid_add_one_launch(const int* x, int* o, int n_steps,
                                   int rows, void* stream) {
  const int tile = rows * kLanes;
  if (n_steps > 0)
    add_one_grid_kernel<<<n_steps, threads_for(tile), 0,
                          (cudaStream_t)stream>>>(x, o, tile);
  return (int)cudaGetLastError();
}

// K6: x, o int32 [ntiles * rows][128]; one block loops over the tiles.
extern "C" int loop_add_one_launch(const int* x, int* o, int ntiles,
                                   int rows, void* stream) {
  const int tile = rows * kLanes;
  add_one_loop_kernel<<<1, threads_for(tile), 0, (cudaStream_t)stream>>>(
      x, o, ntiles, tile);
  return (int)cudaGetLastError();
}

// K7: x, o float32 [n]; `steps` blocks each copy all of x to o.
extern "C" int grid_copy_launch(const float* x, float* o, int n, int steps,
                                void* stream) {
  if (steps > 0)
    copy_same_tile_kernel<<<steps, threads_for(n), 0,
                            (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}
