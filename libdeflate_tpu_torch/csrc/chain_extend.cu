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
// 0.200 ms at K = 2 / 3 / 5 on 4 x 1 MiB at 3.35 TB/s); operations:
// 4K^2 + 3K integer operations per stride a position (the step below: K
// adds s + ahead(r_j, s), K compares r_k >= s, for each k j = 0's compare,
// select, compare and two selects and each later j's two compares and
// two selects, a compare that ands in a predicate counting one), over 132
// x 64 INT32 lanes x 1.98 GHz (0.044 ms for lean's K = 2 over one round
// of 8 strides, 0.180 and 0.461 ms for K = 3 and 5 over two).  C4 is
// bytes: 32 (one candidate) or 64 bytes a position.
//
// Design (the first design loaded each tile with a halo of the strides'
// sum, stepped the halo too, and met a barrier a 512-position chunk a
// step): a persistent grid walks each row's tiles from its end down, so
// that no tile reloads or recomputes a halo.
// - Grid.  min(tiles, SMs x the blocks an SM holds, at most 3 an SM: each
//   block pays one prologue) blocks; block b owns
//   a contiguous run of the flat (row, tile) indices (balanced to within
//   one tile) and walks it downwards.  No grid dimension counts rows, so
//   any number of rows launches.
// - Carried levels.  Step q at position p reads the values after step
//   q - 1 at p and p + s_q only.  So a tile [a, a + T) needs, at step q,
//   the level q - 1 of [a + T, a + T + s_q): the first s_q positions of
//   the tile above it, which the same block stepped just before.  While
//   it steps a tile, the block saves each level's first s_q positions
//   (r, f of every candidate) into a carry of sum(s) positions in shared
//   memory, and before step q of the next tile down it copies them above
//   that tile.  The d above a tile are the original ones (d never
//   change).  The row's last tile takes zeros above it (past the row's
//   end), which stay zero (r = 0 never passes r >= s nor r == s).  The
//   first tile of a block's run, if not its row's last, takes its carry
//   from a prologue: the original sum(s) positions above it, stepped
//   through a region shrinking by s each step (the first design's halo,
//   once a block instead of once a tile).
// - Registers.  A thread holds its tile positions p = tid + e x threads:
//   their r, d, f of every candidate live in registers across the steps,
//   so a step reads only the 3K values at p + s from shared memory,
//   computes every new (r, f) into the same registers, meets a barrier,
//   writes them, and meets one more before the next step's reads (none
//   written after the last step: the lengths go from registers to global
//   memory).  256 threads at K <= 3 (C3 at K = 2 capped at the registers
//   of 3 blocks an SM), 512 at K = 5.
// - Loads.  Two buffers alternate: while a tile is stepped, cp.async
//   brings the next tile down's low words (the int32 the JAX package
//   carries) into the other buffer, zero-filled past the row's end; the
//   d above a tile are copied from the buffer of the tile above.  A
//   run's prologue positions are copied first.
// - Operations.  s + ahead(r_j, s) once a j.  j = 0 as the plain loop
//   has it (a cand of 0 where it cannot match: a negative r_k takes it);
//   past j = 0 r >= 0, so a later j is two compares and two selects:
//   better = can & (ahead(d_j) == d_k) & (s + ahead(r_j) > r_new).  A
//   warp none of whose positions can change at a step (no r >= s in C3,
//   no r == s in C4 at two candidates) skips it, but for a negative C3
//   length.
// - Kept only what paid in turns (PERF.md): one barrier a step by an r, f
//   ping-pong buffer cost a block an SM and lost; DPX max-with-predicate
//   lost; a tile of 2048 or 512 lost; 512 threads at K <= 3 and 256 at K =
//   5 lost; loads without cp.async at K > 2 lost; explicit ld.shared at
//   register + immediate addresses lost.  CHAIN_CLOCK builds the clock64()
//   phase probe (experiments/chain_variants.py).
// The final lengths are computed in 64 bits; C4's dist out is the int32
// d sign-extended.  Domain: values within +-2^30 (the JAX package's
// int32 with room for r + s), strides >= 1, up to 16 of them summing to
// at most 1024, tile 1 .. 1024, and a block's shared memory, (6 K W + 2
// K H) x 4 bytes with H the strides' sum and W = max(tile + the largest
// stride, H), with the strides' copy at most 227 KiB (at K = 5 and tile
// 1024 one stride of at most 684); a launch outside it returns
// cudaErrorInvalidValue.  The shared-memory limit is raised once a
// device to that size (an atomic bit a device); the SM count is kept per
// device.

#include <atomic>

#include <cuda_runtime.h>

// CHAIN_CLOCK (a measurement build only): thread 0 of every block adds its
// clock64() cycles in the prologue, the loads (from a tile's start to its
// own values read), the steps and the stores to chain_cycles, which
// chain_clock_take reads and clears.
#ifdef CHAIN_CLOCK
__device__ unsigned long long chain_cycles[5];   // four phases, blocks
#define CHAIN_TICK(var) const long long var = clock64()
#else
#define CHAIN_TICK(var)
#endif

namespace {

constexpr int kMaxTile = 1024;     // the wrappers' tile at most
constexpr int kMaxStrides = 16;
constexpr int kMaxHalo = 1024;      // the sum of the strides
constexpr int kMaxK = 5;
constexpr int kMaxLen = 258;        // DEFLATE's longest match
constexpr int kMaxDevices = 64;
constexpr int kStaticSmem = kMaxStrides * (int)sizeof(int);  // sts
// a block's dynamic shared memory at most: the card's 227 KiB a block
// less the strides' copy
constexpr int kMaxSmem = 227 * 1024 - kStaticSmem;

// A block's threads (256 at K <= 3, 512 at K = 5), the tile positions a
// thread holds, the prologue positions a thread holds, and the blocks an
// SM must hold at K candidates, C3 or C4 (kDouble): 3 for C3 at K = 2
template <int K, bool kDouble>
struct Shape {
  static constexpr int threads = K <= 3 ? 256 : 512;
  static constexpr int own = kMaxTile / threads;
  static constexpr int own_halo = (kMaxHalo + threads - 1) / threads;
  static constexpr int min_blocks = K == 2 && !kDouble ? 3 : 1;
  // the warp skip, but for C4's one candidate (where it lost)
  static constexpr bool skip = !(kDouble && K == 1);
  static_assert(kMaxTile % threads == 0, "a tile is whole rounds of threads");
};

constexpr int kMaxBlocksPerSm = 3;   // each block pays one prologue

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

struct Geometry {
  long long tiles;   // rows x tiles a row
  int n;             // positions a row
  int tile;          // positions a tile
  int per_row;       // tiles a row
  int halo;          // the sum of the strides
  int smax;          // the largest stride
  int width;         // a buffer's positions: max(tile + smax, halo)
};

// One buffer in shared memory: r, d, f of candidate k at k * width
struct Buf {
  int* r;
  int* d;
  int* f;
};

__device__ __forceinline__ Buf buffer(int* base, int K, int W) {
  return {base, base + K * W, base + 2 * K * W};
}

// The two tile buffers (r, d, f) and the carry
constexpr long long smem_bytes(int K, int width, int halo) {
  return (2ll * 3 * K * width + 2ll * K * halo) * (long long)sizeof(int);
}

__device__ __forceinline__ void cp_async4(int* dst, const long long* src,
                                          bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Every group of copies but the last one committed in
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Positions [a0, a0 + count) of the row at `base` into b[0, count) by
// cp.async, the low word of each value, zero past the row's end; NT
// threads.
template <int K, int NT>
__device__ __forceinline__ void load_run(const Arrays& a, Buf b, int W,
                                         long long base, int a0, int count,
                                         int n) {
#pragma unroll 4
  for (int p = threadIdx.x; p < count; p += NT) {
    const int i = a0 + p;
    const bool in = i < n;
    const long long g = base + (in ? i : 0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cp_async4(b.r + k * W + p, a.m[k] + g, in);
      cp_async4(b.d + k * W + p, a.d[k] + g, in);
      cp_async4(b.f + k * W + p, a.f[k] + g, in);
    }
  }
}

// The old values s ahead of a thread's first position at one step:
// r, d, f of candidate j at r[j], d[j], f[j]; a position e rounds of
// threads later reads them at the offset e x threads.
template <int K>
struct Ahead {
  const int* r[K];
  const int* d[K];
  const int* f[K];
};

template <int K>
__device__ __forceinline__ Ahead<K> ahead(Buf b, int W, int x) {
  Ahead<K> h;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    h.r[j] = b.r + j * W + x;
    h.d[j] = b.d + j * W + x;
    h.f[j] = b.f + j * W + x;
  }
  return h;
}

// One step at a position held in registers, `in` whether it lies in the
// region: (r, d, f) its old values, which become the new (r, f), from
// the old values at the offset `off` of h.  Every lane of the warp calls
// it.  With the skip, a warp none of whose positions can change (no r >=
// s in C3, no r == s in C4) reads only f_0 there, which a negative C3
// length takes.
template <int K, bool kDouble>
__device__ __forceinline__ void step(int (&r)[K], const int (&d)[K],
                                     int (&f)[K], const Ahead<K>& h,
                                     int off, int s, bool in) {
  if constexpr (Shape<K, kDouble>::skip) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < K; ++k) any |= kDouble ? r[k] == s : r[k] >= s;
    if (!__any_sync(0xffffffffu, in & any)) {
      if constexpr (!kDouble) {
        if (in) {
          const int fs0 = h.f[0][off];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            f[k] = r[k] < 0 ? fs0 : f[k];
            r[k] = r[k] < 0 ? 0 : r[k];
          }
        }
      }
      return;
    }
  }
  if (!in) return;
  int rs[K], ds[K], fs[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    rs[j] = h.r[j][off];
    ds[j] = h.d[j][off];
    fs[j] = h.f[j][off];
  }
  if constexpr (!kDouble) {
#pragma unroll
    for (int j = 0; j < K; ++j) rs[j] += s;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool can = r[k] >= s;
      // j = 0 as the plain loop has it (its cand of 0 takes a negative
      // r); past it r >= 0, so a j that cannot match needs no cand
      const int c0 = can & (ds[0] == d[k]) ? rs[0] : 0;
      bool better = c0 > r[k];
      int rn = better ? c0 : r[k];
      int fn = better ? fs[0] : f[k];
#pragma unroll
      for (int j = 1; j < K; ++j) {
        better = can & (ds[j] == d[k]) & (rs[j] > rn);
        rn = better ? rs[j] : rn;
        fn = better ? fs[j] : fn;
      }
      r[k] = rn;
      f[k] = fn;
    }
  } else if constexpr (K == 1) {
    const bool take = (r[0] == s) & (ds[0] == d[0]);
    r[0] = take ? r[0] + rs[0] : r[0];
    f[0] = take ? fs[0] : f[0];
  } else {
    const bool tA1 = (r[0] == s) & (ds[0] == d[0]);
    const bool tA2 = (r[0] == s) & !tA1 & (ds[1] == d[0]);
    const bool tB1 = (r[1] == s) & (ds[0] == d[1]);
    const bool tB2 = (r[1] == s) & !tB1 & (ds[1] == d[1]);
    r[0] += tA1 ? rs[0] : tA2 ? rs[1] : 0;
    f[0] = tA1 ? fs[0] : tA2 ? fs[1] : f[0];
    r[1] += tB1 ? rs[0] : tB2 ? rs[1] : 0;
    f[1] = tB1 ? fs[0] : tB2 ? fs[1] : f[1];
  }
}

__device__ __forceinline__ long long final_len(int r, int f) {
  const long long v = (long long)r + (r >= 4 ? (long long)f : 0ll);
  return v < kMaxLen ? v : kMaxLen;
}

// The level of b[0, s) (r, f) into the carry at `off`; carry rows r of k
// at k * H, f of k at (K + k) * H.
template <int K, int NT>
__device__ __forceinline__ void save_carry(int* carry, int H, int off,
                                           Buf b, int W, int s) {
  for (int i = threadIdx.x; i < s; i += NT) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      carry[k * H + off + i] = b.r[k * W + i];
      carry[(K + k) * H + off + i] = b.f[k * W + i];
    }
  }
}

// b[T, T + s) (r, f) from the carry at `off`, or zeros above a row's end.
template <int K, int NT>
__device__ __forceinline__ void fill_above(const int* carry, int H, int off,
                                           Buf b, int W, int T, int s,
                                           bool top) {
  for (int i = threadIdx.x; i < s; i += NT) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      b.r[k * W + T + i] = top ? 0 : carry[k * H + off + i];
      b.f[k * W + T + i] = top ? 0 : carry[(K + k) * H + off + i];
    }
  }
}

// The prologue of a run that does not start at its row's last tile: b
// holds the original H positions above its first tile (in shared memory
// for every thread); they are stepped through a region shrinking by s
// each step, every level's first s positions saved into the carry.
template <int K, bool kDouble>
__device__ __forceinline__ void prologue(const int* sts, int nsteps, Buf b,
                                         int W, int* carry, int H) {
  using Sh = Shape<K, kDouble>;
  constexpr int NT = Sh::threads, E = Sh::own_halo;
  int valid = H, off = 0;
  for (int q = 0; q < nsteps; ++q) {
    const int s = sts[q];
    save_carry<K, NT>(carry, H, off, b, W, s);
    valid -= s;
    const Ahead<K> h = ahead<K>(b, W, threadIdx.x + s);
    int r[E][K], d[E][K], f[E][K];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = threadIdx.x + e * NT;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        r[e][k] = p < valid ? b.r[k * W + p] : 0;
        d[e][k] = p < valid ? b.d[k * W + p] : 0;
        f[e][k] = p < valid ? b.f[k * W + p] : 0;
      }
      step<K, kDouble>(r[e], d[e], f[e], h, e * NT, s, p < valid);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = threadIdx.x + e * NT;
      if (p < valid) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          b.r[k * W + p] = r[e][k];
          b.f[k * W + p] = f[e][k];
        }
      }
    }
    __syncthreads();
    off += s;
  }
}

// One block's run of tiles, walked from the highest flat index down; K
// candidates; C3 (the strides `st`) or C4 (kDouble: 8 .. 256, K = 1, 2).
template <int K, bool kDouble>
__device__ __forceinline__ void chain_walk(const Arrays& a, const Strides& st,
                                           const Geometry& g) {
  using Sh = Shape<K, kDouble>;
  constexpr int NT = Sh::threads, E = Sh::own;
  extern __shared__ int smem[];
  __shared__ int sts[kMaxStrides];
  const int T = g.tile, W = g.width, H = g.halo, n = g.n;
  const int nsteps = st.n;
  if (threadIdx.x < nsteps) sts[threadIdx.x] = st.s[threadIdx.x];
  const int tile_ints = 3 * K * W;
  int* carry = smem + 2 * tile_ints;
  const long long per = g.tiles / gridDim.x, extra = g.tiles % gridDim.x;
  const long long blk = blockIdx.x;
  const long long g0 = blk * per + (blk < extra ? blk : extra);
  const long long g1 = g0 + per + (blk < extra ? 1 : 0);
  __syncthreads();
  if (g0 >= g1) return;
  int cur = 0;
#ifdef CHAIN_CLOCK
  long long cyc[4] = {0, 0, 0, 0};
#endif
  {
    CHAIN_TICK(c0);
    const long long t = g1 - 1;
    const long long base = t / g.per_row * (long long)n;
    const int a0 = (int)(t % g.per_row) * T;
    const bool top = a0 / T == g.per_row - 1;
    // the prologue's positions, then the first tile's
    const Buf P = buffer(smem + tile_ints, K, W);
    if (!top) {
      load_run<K, NT>(a, P, W, base, a0 + T, H, n);
      cp_async_commit();
    }
    load_run<K, NT>(a, buffer(smem, K, W), W, base, a0, T, n);
    cp_async_commit();
    if (!top) {
      cp_async_wait_prior();
      __syncthreads();
      prologue<K, kDouble>(sts, nsteps, P, W, carry, H);
    }
#ifdef CHAIN_CLOCK
    cyc[0] += clock64() - c0;
#endif
  }
  for (long long t = g1 - 1; t >= g0; --t) {
    CHAIN_TICK(c1);
    const long long base = t / g.per_row * (long long)n;
    const int col = (int)(t % g.per_row);
    const int a0 = col * T;
    const bool top = col == g.per_row - 1;
    const Buf X = buffer(smem + cur * tile_ints, K, W);
    const Buf Y = buffer(smem + (cur ^ 1) * tile_ints, K, W);
    cp_async_wait_all();
    __syncthreads();   // X in; every read of the tile above done
    for (int i = threadIdx.x; i < g.smax; i += NT) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        X.d[k * W + T + i] = top ? 0 : Y.d[k * W + i];
    }
    if (nsteps > 0) fill_above<K, NT>(carry, H, 0, X, W, T, sts[0], top);
    __syncthreads();
    if (t > g0) {
      const long long u = t - 1;
      load_run<K, NT>(a, Y, W, u / g.per_row * (long long)n,
                      (int)(u % g.per_row) * T, T, n);
      cp_async_commit();
    }
    int r[E][K], d[E][K], f[E][K];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = threadIdx.x + e * NT;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        r[e][k] = p < T ? X.r[k * W + p] : 0;
        d[e][k] = p < T ? X.d[k * W + p] : 0;
        f[e][k] = p < T ? X.f[k * W + p] : 0;
      }
    }
    CHAIN_TICK(c2);
    // level q lies in X
    int off = 0;
    for (int q = 0; q < nsteps; ++q) {
      const int s = sts[q];
      if (q > 0) {
        fill_above<K, NT>(carry, H, off, X, W, T, s, top);
        __syncthreads();
      }
      save_carry<K, NT>(carry, H, off, X, W, s);
      const Ahead<K> h = ahead<K>(X, W, threadIdx.x + s);
#pragma unroll
      for (int e = 0; e < E; ++e)
        step<K, kDouble>(r[e], d[e], f[e], h, e * NT, s,
                         threadIdx.x + e * NT < T);
      if (q + 1 < nsteps) {
        __syncthreads();
        int* wr = X.r + threadIdx.x;
        int* wf = X.f + threadIdx.x;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (threadIdx.x + e * NT < T) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              wr[k * W + e * NT] = r[e][k];
              wf[k * W + e * NT] = f[e][k];
            }
          }
        }
      }
      off += s;
    }
    CHAIN_TICK(c3);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = threadIdx.x + e * NT;
      if (p < T && a0 + p < n) {
        const long long i = base + a0 + p;
        if constexpr (!kDouble || K == 1) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            a.out[k][i] = final_len(r[e][k], f[e][k]);
        } else {
          const long long lenA = final_len(r[e][0], f[e][0]);
          const long long lenB = final_len(r[e][1], f[e][1]);
          const bool useB = lenB > lenA;
          a.out[0][i] = useB ? lenB : lenA;
          a.out[1][i] = useB ? d[e][1] : d[e][0];
        }
      }
    }
#ifdef CHAIN_CLOCK
    cyc[1] += c2 - c1;
    cyc[2] += c3 - c2;
    cyc[3] += clock64() - c3;
#endif
    cur ^= 1;
  }
#ifdef CHAIN_CLOCK
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i)
      atomicAdd(&chain_cycles[i], (unsigned long long)cyc[i]);
    atomicAdd(&chain_cycles[4], 1ull);
  }
#endif
}

template <int K>
__global__ void __launch_bounds__(Shape<K, false>::threads,
                                  Shape<K, false>::min_blocks)
chain_relax_kernel(Arrays a, Strides st, Geometry g) {
  chain_walk<K, false>(a, st, g);
}

template <int K>
__global__ void __launch_bounds__(Shape<K, true>::threads,
                                  Shape<K, true>::min_blocks)
chain_double_kernel(Arrays a, Strides st, Geometry g) {
  chain_walk<K, true>(a, st, g);
}

// The launch of one instantiation, after the domain's checks: the
// shared-memory limit raised once a device (devices past the 64th at
// every launch) to kMaxSmem, or to the device's opt-in maximum less the
// strides' copy if that is less; the SM count kept per device.
template <int K, bool kDouble>
int launch(const Arrays& a, const Strides& st, int rows, int n, int tile,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> raised{0};
  static std::atomic<int> sms[kMaxDevices];
  auto* kernel = kDouble ? chain_double_kernel<K> : chain_relax_kernel<K>;
  Geometry g{};
  g.n = n;
  g.tile = tile;
  g.per_row = (n + tile - 1) / tile;
  g.tiles = (long long)rows * g.per_row;
  for (int q = 0; q < st.n; ++q) {
    g.halo += st.s[q];
    g.smax = st.s[q] > g.smax ? st.s[q] : g.smax;
  }
  g.width = tile + g.smax > g.halo ? tile + g.smax : g.halo;
  const long long smem = smem_bytes(K, g.width, g.halo);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const bool kept = dev < kMaxDevices;
  const unsigned long long bit = kept ? 1ull << dev : 0;
  if (!kept || !(raised.load() & bit)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - kStaticSmem < kMaxSmem
                                   ? optin - kStaticSmem : kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit);
  }
  int nsm = kept ? sms[dev].load() : 0;
  if (nsm == 0) {
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (kept) sms[dev].store(nsm);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, Shape<K, kDouble>::threads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  per_sm = per_sm < 1 ? 1 : per_sm > kMaxBlocksPerSm ? kMaxBlocksPerSm
                                                      : per_sm;
  const long long blocks = g.tiles < (long long)nsm * per_sm
                               ? g.tiles : (long long)nsm * per_sm;
  kernel<<<(unsigned)blocks, Shape<K, kDouble>::threads, (size_t)smem,
           stream>>>(a, st, g);
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
// 1 .. 1024 positions a block's tile (the wrapper's is 1024); a block's
// shared memory at most kMaxSmem (see the header).  Returns the CUDA
// error of the launch (0 on success); cudaErrorInvalidValue for a K
// other than 2, 3 or 5 or arguments out of range, without launching.
extern "C" int chain_relax_launch(void* const* ins, void* const* outs, int K,
                                  int rows, int n, const int* strides,
                                  int nstrides, int tile, void* stream) {
  if (!(K == 2 || K == 3 || K == 5) || nstrides < 0 ||
      nstrides > kMaxStrides || tile < 1 || tile > kMaxTile || n < 0 ||
      rows < 0)
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
  Arrays a{};
  fill(a, ins, outs, K);
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 2) return launch<2, false>(a, st, rows, n, tile, s);
  if (K == 3) return launch<3, false>(a, st, rows, n, tile, s);
  return launch<5, false>(a, st, rows, n, tile, s);
}

// C4.  ins: 3K pointers as above, K = 1 (chain_extend: outs the length)
// or 2 (chain_extend2: outs the length and the chosen dist), all
// contiguous int64 [rows, n]; tile 1 .. 1024.
extern "C" int chain_double_launch(void* const* ins, void* const* outs,
                                   int K, int rows, int n, int tile,
                                   void* stream) {
  if (!(K == 1 || K == 2) || tile < 1 || tile > kMaxTile || n < 0 ||
      rows < 0)
    return (int)cudaErrorInvalidValue;
  Arrays a{};
  fill(a, ins, outs, K);
  Strides st{};
  st.n = 6;
  for (int q = 0; q < st.n; ++q) st.s[q] = 8 << q;
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 1) return launch<1, true>(a, st, rows, n, tile, s);
  return launch<2, true>(a, st, rows, n, tile, s);
}

#ifdef CHAIN_CLOCK
// The probe's cycles since the last take, out int64 [5]: the prologue,
// loads, steps and stores summed over blocks, then the blocks; cleared.
extern "C" int chain_clock_take(long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, chain_cycles, sizeof(chain_cycles));
  static const unsigned long long zeros[5] = {0, 0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(chain_cycles, zeros, sizeof(zeros));
  return (int)err;
}
#endif
