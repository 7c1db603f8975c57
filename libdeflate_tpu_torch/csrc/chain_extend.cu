// The candidate stage's chain extension, for Hopper (sm_90a): C3 and C4.
//
// Replace XLA code, not Pallas kernels:
// - C3, chain_relax: libdeflate_tpu/compress/tpu_pipeline.py::
//   _chain_extend_multi (lines 690-736), the multi-stride max-relaxation of
//   K = 2, 3 or 5 candidates on every DP tier.  Plain version:
//   chain_extend_multi in libdeflate_tpu_torch/compress/pipeline.py (a
//   Python loop of elementwise int64 ops, ~15 a (stride, k, j) triple:
//   1503 device ops a call at K = 3, ~3790 at K = 5).
// - C4, chain_double: _chain_extend (lines 631-651) and _chain_extend2
//   (654-687), the stride-8 doubling of the greedy tiers' sorted matchfind
//   and of the rescue pass.  Plain versions: chain_extend and
//   chain_extend2 in the same file.
//
// What they compute, per row of [rows, n] int64 arrays, ahead(x, s)[i]
// being x[i + s] and 0 past the row's end:
// - C3: candidates (r_k, d_k, f_k), k < K.  For each stride s of the list
//   (strides1 then strides2), from the previous step's values only:
//     can = r_k >= s; for j = 0 .. K-1 in order:
//       cand = can && ahead(d_j, s) == d_k ? s + ahead(r_j, s) : 0
//       if cand > r_new_k (strictly): r_new_k = cand, f_new_k = ahead(f_j, s)
//   then len_k = min(r_k + (r_k >= 4 ? f_k : 0), 258).  d_k pass through.
// - C4, one candidate: at s = 8, 16, 32, 64, 128, 256 (every power of
//   two from 8 below 258), take = r == s &&
//   ahead(d, s) == d: r += take ? ahead(r, s) : 0, f = take ?
//   ahead(f, s) : f; len as above.  Two candidates (A, B): tA1 = rA == s
//   && ahead(dA, s) == dA, tA2 = rA == s && !tA1 && ahead(dB, s) == dA,
//   tB1 and tB2 likewise for B, every one from the old values; the longer
//   final length wins, ties to A: (len, dist).
//
// What bounds them on this card.  Bytes: every input read once and every
// length written once, K * 32 bytes a position for C3 (0.080 / 0.120 /
// 0.200 ms at K = 2 / 3 / 5 on 4 x 1 MiB at 3.35 TB/s); operations: ~6
// integer operations per (stride, k, j) a position, over 132 x 64 INT32
// lanes x 1.98 GHz (0.048 ms for lean's K = 2 over one round of 8
// strides, 0.217 and 0.602 ms for K = 3 and 5 over two).  C4 is bytes:
// 32 (one candidate) or 64 bytes a position.
//
// Design: one launch covers the whole extension.  A block owns a tile of
// `tile` positions of one row and loads it with a halo of H = the sum of
// the strides (510 for two default rounds, 255 for one, 504 for C4),
// zero past the row's end, into shared memory as int32 (r, d, f of each
// candidate: the JAX package's own int32).  Position p of the tile is
// exact after step q while p + (the strides still to come) < tile + H:
// the region updated shrinks by s each step, and after the last step the
// tile's first `tile` positions are exact.  A step updates its region in
// chunks of a block's width in ascending order: a chunk reads positions
// at or past its own first one, which no earlier chunk writes, so one
// barrier between a chunk's reads (into registers) and its writes keeps
// every read on the previous step's values, and one barrier ends the
// step.  Positions past the row's end hold (0, 0, 0) and stay so (r = 0
// never passes `r >= s` for s >= 1, nor `r == s`).  The final lengths
// are computed in 64 bits.  Domain: values within +-2^30 (the JAX
// package's int32 with room for r + s), strides >= 1, up to 16 of them
// summing to at most 1024.  The shared-memory limit is raised at the
// first launch of each instantiation on each device.

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTile = 1024;      // the wrappers' tile
constexpr int kMaxStrides = 16;
constexpr int kMaxHalo = 1024;      // the sum of the strides
constexpr int kMaxK = 5;
constexpr int kMaxLen = 258;        // DEFLATE's longest match
constexpr int kDoubleSteps = 6;     // C4's strides 8 << q: 8 .. 256
constexpr int kDoubleHalo = 8 + 16 + 32 + 64 + 128 + 256;

struct Strides {
  int n;
  int s[kMaxStrides];
};

struct Arrays {
  const long long* m[kMaxK];
  const long long* d[kMaxK];
  const long long* f[kMaxK];
  long long* out[kMaxK];   // C3: K lengths; C4: the length, then the dist
};

constexpr int smem_bytes(int K, int tile, int halo) {
  return 3 * K * (tile + halo) * (int)sizeof(int);
}

// One step at tile position p (p + s inside the tile): the new (r, f) of
// every candidate from the old values at p and p + s.
template <int K, bool kDouble>
__device__ __forceinline__ void step_at(const int* sr, const int* sd,
                                        const int* sf, int W, int p, int s,
                                        int (&nr)[K], int (&nf)[K]) {
  int rs[K], ds[K], fs[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    rs[j] = sr[j * W + p + s];
    ds[j] = sd[j * W + p + s];
    fs[j] = sf[j * W + p + s];
  }
  if constexpr (!kDouble) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = sr[k * W + p];
      const int dk = sd[k * W + p];
      const bool can = r >= s;
      int rn = r, fn = sf[k * W + p];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int cand = (can && ds[j] == dk) ? s + rs[j] : 0;
        if (cand > rn) {
          rn = cand;
          fn = fs[j];
        }
      }
      nr[k] = rn;
      nf[k] = fn;
    }
  } else if constexpr (K == 1) {
    const int r = sr[p];
    const bool take = r == s && ds[0] == sd[p];
    nr[0] = take ? r + rs[0] : r;
    nf[0] = take ? fs[0] : sf[p];
  } else {
    const int rA = sr[p], rB = sr[W + p];
    const int dA = sd[p], dB = sd[W + p];
    const bool tA1 = rA == s && ds[0] == dA;
    const bool tA2 = rA == s && !tA1 && ds[1] == dA;
    const bool tB1 = rB == s && ds[0] == dB;
    const bool tB2 = rB == s && !tB1 && ds[1] == dB;
    nr[0] = rA + (tA1 ? rs[0] : tA2 ? rs[1] : 0);
    nf[0] = tA1 ? fs[0] : tA2 ? fs[1] : sf[p];
    nr[1] = rB + (tB1 ? rs[0] : tB2 ? rs[1] : 0);
    nf[1] = tB1 ? fs[0] : tB2 ? fs[1] : sf[W + p];
  }
}

__device__ __forceinline__ long long final_len(int r, int f) {
  const long long v = (long long)r + (r >= 4 ? (long long)f : 0ll);
  return v < kMaxLen ? v : kMaxLen;
}

// One block's tile, grid (tiles of a row, rows); K candidates; C3 (the
// strides `st`) or C4 (kDouble: the strides 8 .. 256, K = 1 or 2)
template <int K, bool kDouble>
__device__ __forceinline__ void chain_tile(const Arrays& a, const Strides& st,
                                           int n, int tile, int halo) {
  extern __shared__ int smem[];
  const int W = tile + halo;
  int* sr = smem;
  int* sd = sr + K * W;
  int* sf = sd + K * W;
  const long long base = (long long)blockIdx.y * n;
  const int t0 = blockIdx.x * tile;
  for (int p = threadIdx.x; p < W; p += kThreads) {
    const long long i = (long long)t0 + p;
    const bool in = i < n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sr[k * W + p] = in ? (int)a.m[k][base + i] : 0;
      sd[k * W + p] = in ? (int)a.d[k][base + i] : 0;
      sf[k * W + p] = in ? (int)a.f[k][base + i] : 0;
    }
  }
  __syncthreads();
  const int nsteps = kDouble ? kDoubleSteps : st.n;
  int valid = W;
  for (int q = 0; q < nsteps; ++q) {
    const int s = kDouble ? 8 << q : st.s[q];
    valid -= s;
    for (int c = 0; c < valid; c += kThreads) {
      const int p = c + threadIdx.x;
      int nr[K], nf[K];
      if (p < valid) step_at<K, kDouble>(sr, sd, sf, W, p, s, nr, nf);
      __syncthreads();
      if (p < valid) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          sr[k * W + p] = nr[k];
          sf[k * W + p] = nf[k];
        }
      }
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < tile; p += kThreads) {
    const long long i = (long long)t0 + p;
    if (i >= n) break;
    if constexpr (!kDouble || K == 1) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        a.out[k][base + i] = final_len(sr[k * W + p], sf[k * W + p]);
    } else {
      const long long lenA = final_len(sr[p], sf[p]);
      const long long lenB = final_len(sr[W + p], sf[W + p]);
      const bool useB = lenB > lenA;
      a.out[0][base + i] = useB ? lenB : lenA;
      a.out[1][base + i] = useB ? a.d[1][base + i] : a.d[0][base + i];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
chain_relax_kernel(Arrays a, Strides st, int n, int tile, int halo) {
  chain_tile<K, false>(a, st, n, tile, halo);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
chain_double_kernel(Arrays a, Strides st, int n, int tile, int halo) {
  chain_tile<K, true>(a, st, n, tile, halo);
}

// The launch of one instantiation: the shared-memory limit raised to its
// largest size at the first launch on each device (a bit per device; one
// past the 64th raises it at every launch).
template <int K, bool kDouble>
int launch(const Arrays& a, const Strides& st, int rows, int n, int tile,
           int halo, cudaStream_t stream) {
  static std::atomic<unsigned long long> raised{0};
  auto* kernel = kDouble ? chain_double_kernel<K> : chain_relax_kernel<K>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(K, kMaxTile, kDouble ? kDoubleHalo : kMaxHalo));
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit);
  }
  const dim3 grid((n + tile - 1) / tile, rows);
  kernel<<<grid, kThreads, smem_bytes(K, tile, halo), stream>>>(a, st, n,
                                                                tile, halo);
  return (int)cudaGetLastError();
}

void fill(Arrays& a, void* const* ins, void* const* outs, int K) {
  for (int k = 0; k < K; ++k) {
    a.m[k] = (const long long*)ins[3 * k];
    a.d[k] = (const long long*)ins[3 * k + 1];
    a.f[k] = (const long long*)ins[3 * k + 2];
    a.out[k] = (long long*)outs[k];
  }
}

}  // namespace

// C3.  ins: 3K pointers (mlen, dist, fine of each candidate), outs: K
// length pointers, all contiguous int64 [rows, n]; strides: nstrides
// values >= 1 (strides1 then strides2), summing to at most 1024; tile
// 1 .. 1024 positions a block (the wrapper's is 1024).  Returns the CUDA
// error of the launch (0 on success); cudaErrorInvalidValue for a K other
// than 2, 3 or 5 or arguments out of range, without launching.
extern "C" int chain_relax_launch(void* const* ins, void* const* outs, int K,
                                  int rows, int n, const int* strides,
                                  int nstrides, int tile, void* stream) {
  if (!(K == 2 || K == 3 || K == 5) || nstrides < 0 ||
      nstrides > kMaxStrides || tile < 1 || tile > kMaxTile || n < 0 ||
      rows < 0 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{};
  st.n = nstrides;
  int halo = 0;
  for (int q = 0; q < nstrides; ++q) {
    if (strides[q] < 1) return (int)cudaErrorInvalidValue;
    st.s[q] = strides[q];
    halo += strides[q];
    if (halo > kMaxHalo) return (int)cudaErrorInvalidValue;
  }
  if (rows == 0 || n == 0) return 0;
  Arrays a{};
  fill(a, ins, outs, K);
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 2) return launch<2, false>(a, st, rows, n, tile, halo, s);
  if (K == 3) return launch<3, false>(a, st, rows, n, tile, halo, s);
  return launch<5, false>(a, st, rows, n, tile, halo, s);
}

// C4.  ins: 3K pointers as above, K = 1 (chain_extend: outs the length)
// or 2 (chain_extend2: outs the length and the chosen dist), all
// contiguous int64 [rows, n]; tile 1 .. 1024.
extern "C" int chain_double_launch(void* const* ins, void* const* outs,
                                   int K, int rows, int n, int tile,
                                   void* stream) {
  if (!(K == 1 || K == 2) || tile < 1 || tile > kMaxTile || n < 0 ||
      rows < 0 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  Arrays a{};
  fill(a, ins, outs, K);
  const Strides st{};
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 1) return launch<1, true>(a, st, rows, n, tile, kDoubleHalo, s);
  return launch<2, true>(a, st, rows, n, tile, kDoubleHalo, s);
}
