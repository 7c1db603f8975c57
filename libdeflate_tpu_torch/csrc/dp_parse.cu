// Backwards min-cost DP over independent S-position segments, for Hopper
// (sm_90a).
//
// Replaces libdeflate_tpu/compress/pallas_kernels.py::dp_parse_pallas
// (kernel body _dp_kernel).  Plain version: dp_parse_plain in
// libdeflate_tpu_torch/compress/kernels.py.
//
// What it computes, per lane (one S-position segment of one chunk), for
// t = S-1 down to 0, with D[S] = 0:
//   D[t] = min( lit[t] + D[t+1],
//               min over the ladder's rungs f with t+f <= S of
//                   cheapest offset cost among A/B/C with len >= f
//                   (and d3 at f = 3) + lc[f] + D[t+f],
//               the tail edge of length S-t when it lies in 3..258 )
// and the winning edge's span and dist.  Only a strictly lower cost
// replaces the best so far, in the order literal, rungs ascending, tail,
// and among A, B, C, d3 in that order.  The fields are read as the
// reference reads them: the twelve inputs are wrapped to int32, packed
// into its five overlapping words (pallas_kernels.py:225-238) and
// unpacked (:128-139), so a field past its bits spills into the next; the
// output keeps the reference's (span << 16 | dist) word split at bit 16,
// so a dist of 65536 or more spills into span.
//
// The ladder is a template argument: LEN_LADDER_DENSE2 (80 rungs, the
// lean, optfast and deep tiers), LEN_LADDER_DENSE (46 rungs, options of
// the experiments) or LEN_LADDER (28 rungs, the optimal tiers), each rung
// table a constexpr function.
//
// What bounds it on this card: bytes, then the serial recurrence.  The
// work the function needs is 2 adds and 1 min per feasible rung, 317 M
// rungs for the main path's 4 x 1 MiB batch at S = 1024 on the dense
// ladder (0.057 ms at 132 SMs x 64 INT32 lanes x 1.98 GHz), 111 M on the
// sparse one.  Reading the caller's twelve int64
// inputs once and writing span and dist as int64 once is 470 MB, 0.140 ms
// at 3.35 TB/s.  Within a lane each step needs the step before, 1024
// times; only the literal edge reads D[t+1], every rung reads D[t+3] or
// later.
//
// Design:
// - G = kGroup = 8 threads of one warp run each lane, so a warp holds
//   4 lanes and the main path's 4096 lanes fill ~8 warps an SM, in
//   blocks of kWarps = 4 warps (experiments/dp_variants.py times G = 4
//   and 16, and 2 and 8 warps a block, beside it).  Thread g
//   takes rungs g, g+G, g+2G, ... with each rung's length and its
//   (lc[f] << 9 | order << 2) in registers (a lane's chunk is fixed).
//   The sparse ladder's 28 rungs give threads 0-3 four rungs and
//   threads 4-7 three and a padding slot (the 46-rung ladder: threads
//   0-5 six, 6-7 five and a padding slot), selected away at its min (a
//   compile-time no-op on the 80-rung ladder), so that no rung's order
//   moves and the rung work a lane stays the ladder's.
// - A candidate is one integer key, cost << 9 | order << 2 | which:
//   order 0 is the literal, 1..R the rungs in ladder order, R + 1 the
//   tail (R = 80, 46 or 28); which is 0-2
//   for A/B/C and 3 for d3.  The first minimum of the reference is the
//   minimum key, so each rung costs one add of three terms and one min,
//   and the group reduces its keys with __shfl_xor_sync.
// - Key range.  After the caps the literal cost is at most 255, and the
//   literal edge is always feasible, so D[t] <= 255 * (S - t) and the
//   winner's key is at most (255 * S) << 9 < 2^30 for S <= 8192.  An
//   infeasible edge adds 2^31 (a cost-window slot past the segment end)
//   or 2^30 (no candidate reaches f), so it never wins, and no sum passes
//   2^32: for S <= kKey32MaxS the key is 32 bits.  A longer segment (the
//   port's small odd-sized chunks, S = n_pad) takes 64-bit keys with
//   2^63 and 2^62.
// - The cheapest offset cost as a function of f is a step function with
//   its steps at the three lengths: each position's record holds the
//   lengths sorted (clamped to 2..259) and the three step values, built
//   once when the position is staged, so a rung costs three compares and
//   selects.
// - The cost window D[t..t+258] lives in shared memory as a 512-slot
//   ring a lane, D << 9 so that it adds to a key as it is; slots 0-257
//   are mirrored at 512-769, so a rung reads slot (t & 511) + f without
//   a wrap.  Slots past the segment end hold 2^31.  One thread of the
//   group writes D[t]; a __syncwarp() a step orders it before the reads
//   two steps later.  No __syncthreads() in the loop: warps are
//   independent.
// - The step is pipelined: at step t the group forms the rung and tail
//   minimum of position t-1 (it reads D[t+2] and later) beside step t's
//   min(literal, rung minimum of t), so the chain carried from step to
//   step is the literal's add and one min.
// - One launch on the caller's tensors.  Each warp stages its lanes'
//   positions in tiles of 2G positions a lane: the twelve int64 inputs
//   are loaded (coalesced, one tile ahead, into registers), packed and
//   unpacked as the reference does, and stored as 32-byte records in a
//   two-tile ring in shared memory; the winners' orders go to shared
//   memory too, and a tile's span and dist are written as int64, 16
//   consecutive positions a half-warp, once the tile is done.
// - Threads of a ragged last warp run every step (a shuffle needs every
//   thread its mask names); their loads and stores are masked.
// What still bounds it: the rung work (three compares and selects, an
// add of three terms and a min a rung) issued on the SM's INT32 lanes:
// on an H100 the same kernel with one rung a thread takes ~0.64 of its
// time, and without its input loads ~0.95 (experiments/dp_variants.py).
// The lc costs are taken as non-negative (they are bit counts).

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLen = 258;
constexpr int kLcEntries = 259;
constexpr int kWin = 512;          // ring slots a lane (>= 259, power of 2)
constexpr int kMirror = 258;       // slots 0..257 mirrored at 512..769
constexpr int kShift = 9;          // key = cost << 9 | order << 2 | which
constexpr int kInputs = 12;
constexpr int kGroup = 8;          // threads a lane
constexpr int kWarps = 4;          // warps a block
constexpr int kPos = 2;            // positions a thread stages a tile
constexpr int kKey32MaxS = 8192;   // longest segment for 32-bit keys

// The three length ladders (tpu_optimal.py:75-87), one instantiation
// each.  LEN_LADDER_DENSE2: every length 3..66, then 74..130 step 8, 146..258
// step 16.
struct Dense2 {
  static constexpr int kRungs = 80;
  __host__ __device__ static constexpr int rung(int i) {
    return i < 64 ? i + 3 : (i < 72 ? 66 + 8 * (i - 63) : 130 + 16 * (i - 71));
  }
};
static_assert(Dense2::rung(63) == 66 && Dense2::rung(64) == 74 &&
                  Dense2::rung(71) == 130 && Dense2::rung(72) == 146 &&
                  Dense2::rung(Dense2::kRungs - 1) == 258,
              "denser ladder");

// LEN_LADDER_DENSE: every length 3..34, then 38..50 step 4, 58 and 66,
// 82..130 step 16, 162..258 step 32.  46 rungs: with G = 8, threads 0-5
// take six and threads 6-7 five and a padding slot.
struct Dense {
  static constexpr int kRungs = 46;
  __host__ __device__ static constexpr int rung(int i) {
    return i < 32   ? i + 3
           : i < 36 ? 34 + 4 * (i - 31)
           : i < 38 ? 50 + 8 * (i - 35)
           : i < 42 ? 66 + 16 * (i - 37)
                    : 130 + 32 * (i - 41);
  }
};
static_assert(Dense::rung(31) == 34 && Dense::rung(32) == 38 &&
                  Dense::rung(35) == 50 && Dense::rung(36) == 58 &&
                  Dense::rung(37) == 66 && Dense::rung(38) == 82 &&
                  Dense::rung(41) == 130 && Dense::rung(42) == 162 &&
                  Dense::rung(Dense::kRungs - 1) == 258,
              "dense ladder");

// LEN_LADDER: 3..10, then four tops of each extra-bit band b = 0..4,
// 2 + 8 * 2^b + 2^(b+1) * (k + 1) for k = 0..3 (12..18, 22..34, 42..66,
// 82..130, 162..258).
struct Sparse {
  static constexpr int kRungs = 28;
  __host__ __device__ static constexpr int rung(int i) {
    return i < 8 ? i + 3
                 : 2 + (8 << ((i - 8) >> 2)) +
                       (2 << ((i - 8) >> 2)) * (((i - 8) & 3) + 1);
  }
};
static_assert(Sparse::rung(7) == 10 && Sparse::rung(8) == 12 &&
                  Sparse::rung(12) == 22 && Sparse::rung(16) == 42 &&
                  Sparse::rung(19) == 66 && Sparse::rung(20) == 82 &&
                  Sparse::rung(24) == 162 &&
                  Sparse::rung(Sparse::kRungs - 1) == 258,
              "sparse ladder");

template <int G, typename L>
struct Shape {
  static_assert(G == 4 || G == 8 || G == 16, "group size");
  static constexpr int kLanes = 32 / G;          // lanes a warp
  // rungs a thread; where G does not divide the ladder, the last rung
  // slot of some threads is padding that takes no part in the minimum
  static constexpr int kPer = (L::kRungs + G - 1) / G;
  static constexpr int kTile = kPos * 32 / kLanes;  // positions a tile
  static constexpr int kRecs = 2 * kTile;        // record ring, positions
  static constexpr int kStride = 800 + G;        // ring row: >= 770 slots,
                                                 // lanes G banks apart
};

struct Inputs {
  const long long* a[kInputs];
};

// One position's fields: lengths sorted (9 bits each), the offset-cost
// step values (keys cost << 9 | which), then clit | c3 << 8 | d3 << 18
// and the three distances.
struct Rec {
  uint4 steps;
  uint4 rest;
};

template <int G, typename L, typename Key>
struct WarpSmem {
  using Sh = Shape<G, L>;
  Rec rec[Sh::kRecs][Sh::kLanes];
  Key ring[Sh::kLanes][Sh::kStride];
  Key tail[Sh::kLanes][kLcEntries + 1];
  unsigned short won[Sh::kLanes][Sh::kRecs];
};

__device__ __forceinline__ Rec make_rec(const long long (&v)[kInputs]) {
  const int cl = (int)v[0], lA = (int)v[1], dA = (int)v[2], cA = (int)v[3],
            lB = (int)v[4], dB = (int)v[5], cB = (int)v[6], lC = (int)v[7],
            dC = (int)v[8], cC = (int)v[9], d3 = (int)v[10], c3 = (int)v[11];
  // the reference's five words (pallas_kernels.py:225-238) ...
  const unsigned wl = ((unsigned)min(cC, 0x3FF) << 22) |
                      ((unsigned)min(cl, 0xFF) << 14) | (unsigned)d3;
  const unsigned wa = ((unsigned)lA << 18) | (unsigned)dA;
  const unsigned wb = ((unsigned)lB << 18) | (unsigned)dB;
  const unsigned wd = ((unsigned)lC << 18) | (unsigned)dC;
  const unsigned wc = ((unsigned)min(cA, 0x3FF) << 20) |
                      ((unsigned)min(cB, 0x3FF) << 10) |
                      (unsigned)min(c3, 0x3FF);
  // ... and its fields as _dp_kernel reads them (:128-139)
  int len[3] = {(int)wa >> 18, (int)wb >> 18, (int)wd >> 18};
  unsigned key[3] = {((wc >> 20) & 0x3FF) << kShift,
                     (((wc >> 10) & 0x3FF) << kShift) | 1,
                     ((wl >> 22) & 0x3FF) << kShift | 2};
#pragma unroll
  for (int i = 0; i < 3; ++i) len[i] = min(max(len[i], 2), kMaxLen + 1);
  // sort by length; the payload keys go along
#define DP_SWAP(i, j)                                          \
  if (len[j] < len[i]) {                                       \
    const int l = len[i]; len[i] = len[j]; len[j] = l;         \
    const unsigned k = key[i]; key[i] = key[j]; key[j] = k;    \
  }
  DP_SWAP(0, 1) DP_SWAP(1, 2) DP_SWAP(0, 1)
#undef DP_SWAP
  // for f <= len[0] all three reach f, then the two longest, then one
  const unsigned v3 = key[2], v2 = min(key[1], v3), v1 = min(key[0], v2);
  Rec r;
  r.steps = make_uint4(len[0] | len[1] << 9 | len[2] << 18, v1, v2, v3);
  r.rest = make_uint4(((wl >> 14) & 0xFF) | (wc & 0x3FF) << 8 |
                          (wl & 0x3FFF) << 18,
                      wa & 0x3FFFF, wb & 0x3FFFF, wd & 0x3FFFF);
  return r;
}

// the cheapest offset cost (as a key) of the matches that reach f
template <typename Key>
__device__ __forceinline__ Key step_cost(const uint4& s, int f) {
  constexpr Key kNone = Key(1) << (8 * sizeof(Key) - 2);
  Key cd = f <= (int)(s.x >> 18) ? (Key)s.w : kNone;
  cd = f <= (int)((s.x >> 9) & 511) ? (Key)s.z : cd;
  return f <= (int)(s.x & 511) ? (Key)s.y : cd;
}

template <int G, typename L, typename Key>
__global__ void __launch_bounds__(32 * kWarps)
dp_parse_kernel(Inputs in, const void* __restrict__ lc, int lc_is64,
                int lc_rows, long long* __restrict__ span,
                long long* __restrict__ dist, int S, int lanes, int lpc) {
  using Sh = Shape<G, L>;
  constexpr int kRungs = L::kRungs, kTailOrder = kRungs + 1;
  constexpr Key kPastEnd = Key(1) << (8 * sizeof(Key) - 1);
  constexpr int kTile = Sh::kTile, kRecMask = Sh::kRecs - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  WarpSmem<G, L, Key>& sm =
      reinterpret_cast<WarpSmem<G, L, Key>*>(smem_raw)[warp];
  const int li = tid / G, g = tid % G;
  const int lane0 = (blockIdx.x * kWarps + warp) * Sh::kLanes;
  const int lane = lane0 + li;
  const size_t row =
      (size_t)(lc_rows == 1 || lane >= lanes ? 0 : lane / lpc) * kLcEntries;
  auto lc_key = [&](int f) -> Key {  // lc capped at 2^20, as a key
    const int v = lc_is64 ? (int)((const long long*)lc)[row + f]
                          : ((const int*)lc)[row + f];
    return (Key)(unsigned)min(v, 1 << 20) << kShift;
  };

  // this thread's rungs: g, g+G, ... (a padding slot past the ladder
  // reads its last rung's window slot and is never taken)
  int fk[Sh::kPer];
  Key pre[Sh::kPer];
#pragma unroll
  for (int k = 0; k < Sh::kPer; ++k) {
    const int i = g + G * k;
    fk[k] = L::rung(min(i, kRungs - 1));
    pre[k] = lc_key(fk[k]) | (Key)((i + 1) << 2);
  }
  for (int f = g; f <= kMaxLen; f += G)
    sm.tail[li][f] = f >= 3 ? lc_key(f) | (Key)(kTailOrder << 2) : Key(0);
  // D[S] = 0; the slots of positions past S hold kPastEnd
  for (int s = g; s < kWin; s += G) {
    const Key v = s == (S & (kWin - 1)) ? Key(0) : kPastEnd;
    sm.ring[li][s] = v;
    if (s < kMirror) sm.ring[li][s + kWin] = v;
  }

  // staging: element e = tid + 32 r is position (e % kTile) of a tile of
  // lane lane0 + e / kTile
  long long raw[kPos][kInputs];
  auto load_tile = [&](int j) {
#pragma unroll
    for (int r = 0; r < kPos; ++r) {
      const int e = tid + 32 * r, l = lane0 + e / kTile;
      const int pos = j * kTile + e % kTile;
      const bool ok = l < lanes && pos < S;
      const size_t at = ok ? (size_t)l * S + pos : 0;
#pragma unroll
      for (int a = 0; a < kInputs; ++a)
        raw[r][a] = ok ? __ldg(in.a[a] + at) : 0;
    }
  };
  auto store_tile = [&](int j) {
#pragma unroll
    for (int r = 0; r < kPos; ++r) {
      const int e = tid + 32 * r;
      sm.rec[(j * kTile + e % kTile) & kRecMask][e / kTile] = make_rec(raw[r]);
    }
  };
  auto write_tile = [&](int j) {
#pragma unroll
    for (int r = 0; r < kPos; ++r) {
      const int e = tid + 32 * r, l = lane0 + e / kTile;
      const int pos = j * kTile + e % kTile;
      if (l >= lanes || pos >= S) continue;
      const int slot = pos & kRecMask;
      const unsigned w = sm.won[e / kTile][slot];
      const uint4 rest = sm.rec[slot][e / kTile].rest;
      const int order = w >> 2, which = w & 3;
      unsigned sp, ds;
      if (order == 0) {
        sp = 1;
        ds = 0;
      } else {
        sp = order <= kRungs ? L::rung(order - 1) : S - pos;
        ds = which == 0 ? rest.y
                        : which == 1 ? rest.z
                                     : which == 2 ? rest.w : rest.x >> 18;
      }
      const size_t at = (size_t)l * S + pos;
      span[at] = sp | ds >> 16;  // the reference's word split at bit 16
      dist[at] = ds & 0xFFFF;
    }
  };

  // the minimum key over position p's rungs and tail edge, in every
  // thread of the group
  auto rung_min = [&](int p) -> Key {
    const Rec& rp = sm.rec[p & kRecMask][li];
    const uint4 s = rp.steps;
    const unsigned lit3 = rp.rest.x;
    const Key* D = &sm.ring[li][p & (kWin - 1)];
    const Key e0 = pre[0] + D[fk[0]];
    Key m = e0 + step_cost<Key>(s, fk[0]);
#pragma unroll
    for (int k = 1; k < Sh::kPer; ++k) {
      const Key e = pre[k] + D[fk[k]] + step_cost<Key>(s, fk[k]);
      m = kRungs % G == 0 || g + G * k < kRungs ? min(m, e) : m;
    }
    // d3 at f = 3 (thread 0's first rung), after A/B/C in a tie
    const Key k3 = g == 0 && (lit3 >> 18) != 0
                       ? (Key)((((lit3 >> 8) & 0x3FF) << kShift) | 3)
                       : Key(1) << (8 * sizeof(Key) - 2);
    m = min(m, e0 + k3);
    const int ft = S - p;
    if (ft >= 3 && ft <= kMaxLen)
      m = min(m, sm.tail[li][ft] + step_cost<Key>(s, ft));
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      m = min(m, (Key)__shfl_xor_sync(0xffffffffu, m, o));
    return m;
  };

  const int jtop = (S - 1) / kTile;
  load_tile(jtop);
  store_tile(jtop);
  if (jtop > 0) load_tile(jtop - 1);
  __syncwarp();
  Key dnext = 0;             // D[t+1] << 9
  Key rcur = rung_min(S - 1);
  for (int j = jtop; j >= 0; --j) {
    if (j < jtop) write_tile(j + 1);
    __syncwarp();
    if (j > 0) {
      store_tile(j - 1);
      if (j > 1) load_tile(j - 2);
    }
    __syncwarp();
    for (int t = min(S - 1, j * kTile + kTile - 1); t >= j * kTile; --t) {
      const Key rnext = t > 0 ? rung_min(t - 1) : Key(0);
      const Key lit = (Key)(sm.rec[t & kRecMask][li].rest.x & 0xFF) << kShift;
      const Key key = min(lit + dnext, rcur);
      dnext = key & ~(Key)((1 << kShift) - 1);
      if (g == 0) {
        const int s = t & (kWin - 1);
        sm.ring[li][s] = dnext;
        if (s < kMirror) sm.ring[li][s + kWin] = dnext;
        sm.won[li][t & kRecMask] = (unsigned short)(key & ((1 << kShift) - 1));
      }
      rcur = rnext;
      __syncwarp();
    }
  }
  write_tile(0);
}

template <int G, typename L, typename Key>
int launch(const Inputs& in, const void* lc, int lc_is64, int lc_rows,
           long long* span, long long* dist, int S, int lanes, int lpc,
           cudaStream_t stream) {
  // the shared-memory limit, raised at the first launch on each device (a
  // bit per device; one past the 64th raises it at every launch)
  static std::atomic<unsigned long long> raised{0};
  const int smem = (int)(kWarps * sizeof(WarpSmem<G, L, Key>));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(dp_parse_kernel<G, L, Key>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit);
  }
  const int per_block = kWarps * Shape<G, L>::kLanes;
  dp_parse_kernel<G, L, Key><<<(lanes + per_block - 1) / per_block,
                            32 * kWarps, smem, stream>>>(
      in, lc, lc_is64, lc_rows, span, dist, S, lanes, lpc);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs: the twelve [B, n_pad] int64 arrays of dp_parse, contiguous
// (lane l's positions are l*S .. l*S + S-1), lc the [lc_rows][259] match
// costs (int32, or int64 if lc_is64; lc_rows 1 or B) with lc >= 0; span
// and dist int64 [B, n_pad], every element written; nrungs the ladder,
// 80 for LEN_LADDER_DENSE2, 46 for LEN_LADDER_DENSE or 28 for
// LEN_LADDER.  Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for another ladder).
extern "C" int dp_parse_launch(
    const long long* cost_lit, const long long* lenA, const long long* dA,
    const long long* cdA, const long long* lenB, const long long* dB,
    const long long* cdB, const long long* lenC, const long long* dC,
    const long long* cdC, const long long* d3, const long long* cd3,
    const void* lc, int lc_is64, int lc_rows, long long* span,
    long long* dist, int S, int lanes, int lpc, int nrungs, void* stream) {
  const Inputs in = {{cost_lit, lenA, dA, cdA, lenB, dB, cdB, lenC, dC, cdC,
                      d3, cd3}};
  if (nrungs != Dense2::kRungs && nrungs != Dense::kRungs &&
      nrungs != Sparse::kRungs)
    return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool k32 = S <= kKey32MaxS;
  if (nrungs == Dense2::kRungs)
    return k32 ? launch<kGroup, Dense2, unsigned>(in, lc, lc_is64, lc_rows,
                                                  span, dist, S, lanes, lpc,
                                                  st)
               : launch<kGroup, Dense2, unsigned long long>(
                     in, lc, lc_is64, lc_rows, span, dist, S, lanes, lpc,
                     st);
  if (nrungs == Dense::kRungs)
    return k32 ? launch<kGroup, Dense, unsigned>(in, lc, lc_is64, lc_rows,
                                                 span, dist, S, lanes, lpc,
                                                 st)
               : launch<kGroup, Dense, unsigned long long>(
                     in, lc, lc_is64, lc_rows, span, dist, S, lanes, lpc,
                     st);
  return k32 ? launch<kGroup, Sparse, unsigned>(in, lc, lc_is64, lc_rows,
                                                span, dist, S, lanes, lpc, st)
             : launch<kGroup, Sparse, unsigned long long>(
                   in, lc, lc_is64, lc_rows, span, dist, S, lanes, lpc, st);
}
