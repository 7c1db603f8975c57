// Launch and per-block overhead probes K5, K6 and K7, for Hopper (sm_90a).
//
// Replace, in order:
// - K5 scripts/exp_pallas_overhead.py::make_grid_fn (kernel copy_kernel):
//   x + 1 over int32 [n_steps * rows, 128], one (rows, 128) block per grid
//   step.  Here one CUDA block per tile, one thread per element.
// - K6 scripts/exp_pallas_overhead.py::main's g (kernel loop_kernel): the
//   same x + 1 as ONE grid step that loops over the (8, 128) tiles.  One
//   grid step is the whole TensorCore, so here it is one persistent wave:
//   a block per SM, each looping over tiles blockIdx.x, + gridDim.x, ...
// - K7 scripts/exp_device_roundup.py section 1 (kernel empty_kernel): an
//   identity copy of a float32 [128, 128] tile whose index map sends every
//   grid step to block (0, 0), so Pallas moves the tile across HBM once
//   each way whatever the step count.  Here `steps` blocks that split the
//   tile between them: each element read once and written once.
// Plain versions: x + 1 and x.clone(), in
// libdeflate_tpu_torch/experiments/exp_launch_overhead.py and
// exp_device_roundup.py.
//
// What bounds them on this card: bytes, a few kilobytes to 2 MiB read and
// written once (under a microsecond at 3.35 TB/s); in practice the fixed
// cost of a launch and of scheduling blocks, which is what they measure.
// Design: K5 is the simplest kernel that does the work, so that its time
// is the overhead: a block a tile (a grid step), a thread per 16 bytes of
// it (the first design took a thread per element, 4-byte loads; the two
// are timed in turns by chip_smoke.py, which builds the earlier one at
// run time).  K6 must not be
// latency-bound on one SM (a single block waits for one DRAM round trip
// per 4 KB tile): its threads move 16 bytes each (an int4 of a tile), and
// each block issues the loads of up to kLoopAhead of its tiles before it
// stores any, so a wave over 256 tiles has all its loads in flight at
// once.  The grid is the SM count (capped at the tile count), read once.
// K7's `steps` blocks take contiguous shares of the tile's 16-byte
// pieces, a piece a thread per pass and up to kLoopAhead passes' loads
// before their stores.  The pieces are aligned on x: up to 3 floats
// before the first and after the last go through block 0 as scalars, and
// where o is aligned differently from x each piece is stored as 4 floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kLoopThreads = 256;  // int4s in a (8, 128) int32 tile
constexpr int kLoopAhead = 4;      // tiles (K6) or pieces (K7) loaded
                                   // before their stores

__device__ __forceinline__ int4 add_one4(int4 v) {
  // wrapping int32 x + 1, in unsigned arithmetic (signed overflow is UB)
  return make_int4((int)((unsigned)v.x + 1u), (int)((unsigned)v.y + 1u),
                   (int)((unsigned)v.z + 1u), (int)((unsigned)v.w + 1u));
}

// K5: one block a (rows, 128) tile of `tile4` int4s, one int4 a thread.
__global__ void add_one_grid_kernel(const int4* __restrict__ x,
                                    int4* __restrict__ o, int tile4) {
  const size_t i = (size_t)blockIdx.x * tile4 + threadIdx.x;
  o[i] = add_one4(x[i]);
}

// Tiles of kLoopThreads int4s, one a thread; block b loops over tiles b,
// b + gridDim.x, ..., kLoopAhead of them per pass, all loads of a pass
// before its stores.
__global__ void __launch_bounds__(kLoopThreads)
add_one_loop_kernel(const int4* __restrict__ x, int4* __restrict__ o,
                    int ntiles) {
  const int i = threadIdx.x;
  const int stride = gridDim.x;
  for (int t = blockIdx.x; t < ntiles; t += kLoopAhead * stride) {
    int4 v[kLoopAhead];
#pragma unroll
    for (int k = 0; k < kLoopAhead; ++k)
      if (t + k * stride < ntiles)
        v[k] = x[(size_t)(t + k * stride) * kLoopThreads + i];
#pragma unroll
    for (int k = 0; k < kLoopAhead; ++k)
      if (t + k * stride < ntiles)
        o[(size_t)(t + k * stride) * kLoopThreads + i] = add_one4(v[k]);
  }
}

// x, o float [n]: floats [0, head) and [head + 4 * pieces, n) by block 0,
// the float4 pieces of x + head by all, per_block to a block
__global__ void __launch_bounds__(1024)
grid_copy_kernel(const float* __restrict__ x, float* __restrict__ o, int n,
                 int head, int pieces, int per_block, bool vec_store) {
  const int i = threadIdx.x;
  const int tail = n - head - 4 * pieces;
  const bool ends = blockIdx.x == 0;
  float hv = 0.f, tv = 0.f;
  if (ends && i < head) hv = x[i];
  if (ends && i < tail) tv = x[n - tail + i];
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  const int p0 = (int)min((long long)blockIdx.x * per_block, (long long)pieces);
  const int p1 = min(p0 + per_block, pieces);
  const int stride = blockDim.x;
  for (int p = p0 + i; p < p1; p += kLoopAhead * stride) {
    float4 v[kLoopAhead];
#pragma unroll
    for (int k = 0; k < kLoopAhead; ++k)
      if (p + k * stride < p1) v[k] = xv[p + k * stride];
#pragma unroll
    for (int k = 0; k < kLoopAhead; ++k) {
      const int q = p + k * stride;
      if (q >= p1) continue;
      if (vec_store) {
        reinterpret_cast<float4*>(o + head)[q] = v[k];
      } else {
        float* d = o + head + 4 * q;
        d[0] = v[k].x;
        d[1] = v[k].y;
        d[2] = v[k].z;
        d[3] = v[k].w;
      }
    }
  }
  if (ends && i < head) o[i] = hv;
  if (ends && i < tail) o[n - tail + i] = tv;
}

}  // namespace

// K5: x, o int32 [n_steps * rows][128], 16-byte aligned, 1 <= rows <= 8;
// one block per (rows, 128) tile, rows * 32 threads.
extern "C" int grid_add_one_launch(const int* x, int* o, int n_steps,
                                   int rows, void* stream) {
  const int tile4 = rows * kLanes / 4;
  if (n_steps > 0)
    add_one_grid_kernel<<<n_steps, tile4, 0, (cudaStream_t)stream>>>(
        (const int4*)x, (int4*)o, tile4);
  return (int)cudaGetLastError();
}

// K6: x, o int32 [ntiles * 8][128], 16-byte aligned; a persistent wave
// of min(SMs, ntiles) blocks loops over the (8, 128) tiles.
extern "C" int loop_add_one_launch(const int* x, int* o, int ntiles,
                                   void* stream) {
  static int sms = 0;  // the device's SM count, read on the first call
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = ntiles < sms ? ntiles : sms;
  if (blocks > 0)
    add_one_loop_kernel<<<blocks, kLoopThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)x, (int4*)o, ntiles);
  return (int)cudaGetLastError();
}

// K7: x, o float32 [n], 4-byte aligned, 1 <= n; `steps` blocks copy x
// to o, each element once.
extern "C" int grid_copy_launch(const float* x, float* o, int n, int steps,
                                void* stream) {
  if (steps <= 0 || n <= 0) return (int)cudaGetLastError();
  const int mis = (int)((uintptr_t)x & 15);
  const int head = min((16 - mis) % 16 / 4, n);
  const int pieces = (n - head) / 4;
  const int per_block = (int)(((long long)pieces + steps - 1) / steps);
  const int threads = min(max((per_block + 31) / 32 * 32, 32), 1024);
  const bool vec_store = ((uintptr_t)(o + head) & 15) == 0;
  grid_copy_kernel<<<steps, threads, 0, (cudaStream_t)stream>>>(
      x, o, n, head, pieces, per_block, vec_store);
  return (int)cudaGetLastError();
}
