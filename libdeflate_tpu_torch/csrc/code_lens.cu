// Kraft-exact code-length build, one histogram row a warp, for Hopper
// (sm_90a).
//
// Replaces XLA loop code, not a Pallas kernel:
// libdeflate_tpu/compress/tpu_dynamic.py::_build_code_lens (its lax.scans:
// the spend, the 48 fix steps and the refinement's passes of level
// steps), vmapped over rows by _build_code_lens_pair.  Plain version:
// build_code_lens in libdeflate_tpu_torch/compress/dynamic.py (Python
// loops of torch ops over symbols and levels).
//
// What it computes, per row of hist [R, nsym] (nsym <= 512), with
// kraft = 2^max_len and used = hist > 0:
//   - the seed: share = uint32(f32(hist) * (f32(kraft) / f32(total))),
//     two correctly rounded f32 operations (__fdiv_rn, __fmul_rn: no
//     compiler flag changes them), total = max(sum(hist), 1); e = bsr of
//     max(share, 1), bumped by one when the uint32 difference
//     share - 2^e exceeds 2^max(e-1, 0) (share 0 wraps and always
//     bumps); k_des = 2^clip(e, 0, max_len-1) for a used symbol;
//   - the spend, in frequency-descending order (hist descending, then
//     index ascending: the order of the unique keys hist*512 + nsym - i),
//     reserving one unit for every later used symbol:
//     k = 2^bsr(min(k_des, max(budget - later, 1)));
//   - up to 48 fix steps while r = kraft - sum(k) > 0: double the largest
//     k <= r below kraft/2, else halve the smallest k > r of at least 2
//     (index 0 when there is none); first index on ties;
//   - lens = max_len - bsr(k), 0 where k = 0;
//   - refine_passes passes of level steps l = 2..max_len: shorten the
//     most frequent symbol of length l and lengthen the least frequent of
//     length l-1 when the first is more frequent (first index on ties);
//   - ok = (r == 0) and at least two used symbols.
//
// What bounds it on this card: the dependent chain of steps, not bytes
// or operations.  A row reads 286 int64 counts and writes 286 int64
// lengths (4.6 KB; the lean path's 8 rows 37 KB, 0.011 us at 3.35 TB/s);
// the spend is one step a used symbol, each needing the budget of the
// one before, then up to 48 fix steps and refine_passes * (max_len - 1)
// level steps, each a reduction over the row.
//
// Design: one warp a row, four rows a block (one warp on each of the SM's
// four schedulers), no __syncthreads().
// - The counts are loaded all at once (16 a lane), then the used symbols
//   are compacted (ballots) and sorted in the warp's registers: a bitonic
//   sort of the keys hist << 10 | 1023 - i, descending, over N = max(32,
//   next power of two >= n_used) slots, J = N / 32 consecutive sorted
//   positions a lane (p = lane * J + j; the kernel is instantiated for
//   J = 1, 2, 4, 8, 16), in 32 bits when every count of the row is below
//   2^21 (a 1 MiB chunk's are), else in 64 (the wrapper takes counts up
//   to 2^30).  64-bit keys alone take the lean path's 8-row launch from
//   0.0058 to 0.0092 ms on an H100 (experiments/scan_variants.py), so
//   both widths stay.  A distance row of 30 symbols sorts one key a
//   lane.  Everything after works on sorted
//   positions; the lengths go back to their symbols through shared
//   memory at the end.
// - The spend over sorted positions: s_p = budget_p - later_p obeys
//   s_{p+1} = s_p + 1 - k_p, and k_p = k_des_p exactly while s_p >=
//   k_des_p.  A warp scan gives s_p under that assumption for every p at
//   once; the first p where it fails (a min reduction) takes k_p =
//   2^bsr(s_p), and every later s rises by k_des_p - k_p.  s never grows
//   and each such clamp at least halves it, so a row has at most about
//   max_len + 2 clamps; once s <= 1 every later k is 1, which the formula
//   k = 2^bsr(min(k_des, max(s, 1))) with the scanned s already gives.
//   So the spend is a scan and a few reductions, not n_used dependent
//   steps.
// - A fix step reduces 32-bit keys k << 9 | index (k <= 2^14, index <=
//   511) by redux.sync (__reduce_max_sync, __reduce_min_sync).
// - A refinement pass finds, for every length present at once, its most
//   frequent symbol A (first index on ties: the smallest p) and its least
//   frequent B (first index on ties: the largest p2, the position in
//   (hist descending, index descending) order, computed once from the
//   h-groups of the sorted row), with one ballot each: the first (last)
//   lane holding the length, then that lane's first (last) j of it from a
//   small table in shared memory; the lengths are kept in both orders.
//   Then the level steps run as a chain of scalars: step l moves A_l
//   (length l to l-1) and B_l (l-1 to l) when hist[A_l] > hist[B_l],
//   where A_l is the pass's A at l (no earlier step touched length l) and
//   B_l is the pass's B at l-1, or B_{l-1} when step l-1 moved and B_{l-1}
//   is less frequent (step l-1 took A_{l-1}, the length's most frequent,
//   out of l-1 and put B_{l-1} in; when A_{l-1} was also the length's least
//   frequent, B_{l-1} is less frequent still).  Lane l applies level l's
//   move with shared atomics (a B may rise through several levels).  The
//   count of symbols at each length never changes (a move swaps one
//   symbol each way), so the lengths present are one ballot for the whole
//   refinement, and steps with no symbol at l or l-1 (which change
//   nothing) are skipped.
// - The fixed-point exits: a fix step whose delta is 0 leaves (k, r) as
//   they were, so every later step is the same no-op; once r <= 0 nothing
//   changes either; a refinement pass that moves nothing is a fixed point.
// - Every k is a power of two, so r > 0 is a multiple of the smallest k
//   and some k <= r can double unless every k is kraft/2 (one used symbol
//   at most): halving then finds no candidate and halves k[0] (0 when
//   symbol 0 is unused).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSym = 512;
constexpr int kRowsPerBlock = 4;
constexpr int kFixSteps = 48;
constexpr int kMaxLenCap = 15;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNone = 0xFFFFFFFFu;

__device__ __forceinline__ int bsr(unsigned x) { return 31 - __clz(x); }

struct RowSmem {
  long long key[kMaxSym];        // compacted sort keys; then the lengths
                                 // by p and by p2 (refinement)
  int hs[kMaxSym];               // hist by sorted position p
  int hs2[kMaxSym];              // hist by p2
  short p_of_p2[kMaxSym];
  short p2_of_p[kMaxSym];
  unsigned char tab_a[32][16];   // a lane's first j of each length (p)
  unsigned char tab_b[32][16];   // a lane's last j of each length (p2)
  unsigned char lens[kMaxSym];   // lengths by symbol
};

// k_des of a count (used or not: the caller masks).
__device__ __forceinline__ int seed_kdes(long long h, float scale,
                                         int max_len) {
  const unsigned share = __float2uint_rz(__fmul_rn(__ll2float_rn(h), scale));
  int e = bsr(share > 1u ? share : 1u);
  const unsigned half = 1u << (e > 0 ? e - 1 : 0);
  e += (share - (1u << e)) > half ? 1 : 0;
  const int ec = e < 0 ? 0 : (e > max_len - 1 ? max_len - 1 : e);
  return 1 << ec;
}

// A bitonic sort, descending, of the warp's 32 J keys: key p = lane * J +
// j in v[j] of its lane.  The merges of fewer than J keys run in each
// lane's registers (unrolled: every direction is known when compiling).
// In a larger merge every key of a lane goes one way, so a lane that sorts
// ascending complements its keys for the merge and every exchange keeps
// the larger key at the lower position; strides of J and more exchange
// with lane ^ (stride / J), smaller ones swap registers.  The merge
// loops stay rolled: the code stays small.
template <int J, typename K>
__device__ __forceinline__ void bitonic_desc(K (&v)[J], int lane) {
  constexpr int N = 32 * J;
#pragma unroll
  for (int size = 2; size < J; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j & stride) continue;
        const K a = v[j], b = v[j | stride];
        const bool desc = (j & size) == 0;
        v[j] = desc ? (a > b ? a : b) : (a < b ? a : b);
        v[j | stride] = desc ? (a < b ? a : b) : (a > b ? a : b);
      }
    }
  }
#pragma unroll 1
  for (int size = J > 1 ? J : 2; size <= N; size <<= 1) {
    const K flip = (lane & (size / J)) ? ~K(0) : K(0);
#pragma unroll
    for (int j = 0; j < J; ++j) v[j] ^= flip;
#pragma unroll 1
    for (int stride = size >> 1; stride >= J; stride >>= 1) {
      const int lx = stride / J;
      const bool lower = (lane & lx) == 0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const K o = __shfl_xor_sync(kFull, v[j], lx);
        v[j] = lower ? (v[j] > o ? v[j] : o) : (v[j] < o ? v[j] : o);
      }
    }
#pragma unroll
    for (int stride = J / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j & stride) continue;
        const K a = v[j], b = v[j | stride];
        v[j] = a > b ? a : b;
        v[j | stride] = a < b ? a : b;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) v[j] ^= flip;
  }
}

// The row after compaction: the sort, the spend, the fix and the
// refinement over J sorted positions a lane; writes the lengths by
// symbol into sm.lens and returns r.
template <int J>
__device__ __forceinline__ int row_body(RowSmem& sm, int n_used, bool narrow,
                                        float scale, int refine_passes,
                                        int max_len) {
  constexpr int N = 32 * J;
  const int lane = threadIdx.x & 31;
  const int kraft = 1 << max_len;
  const int p0 = lane * J;           // this lane's first sorted position

  // the descending sort; 32-bit keys when every count is below 2^21.
  // A slot past n_used holds key 0: symbol 1023, k_des 1 (no part in the
  // spend's sums), then k 0 and length 0.
  int sym[J], kd[J];
  {
    long long v[J];
    if (narrow) {
      unsigned v32[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        v32[j] = p0 + j < n_used ? (unsigned)sm.key[p0 + j] : 0u;
      bitonic_desc<J>(v32, lane);
#pragma unroll
      for (int j = 0; j < J; ++j) v[j] = v32[j];
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j)
        v[j] = p0 + j < n_used ? sm.key[p0 + j] : 0;
      bitonic_desc<J>(v, lane);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int h = (int)(v[j] >> 10);
      sym[j] = 1023 - (int)(v[j] & 1023);
      kd[j] = p0 + j < n_used ? seed_kdes(h, scale, max_len) : 1;
      sm.hs[p0 + j] = h;
    }
  }

  // the spend: s under "no clamp", then the clamps in order
  int k[J];
  int r;
  {
    int su[J];
    int acc = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      su[j] = acc;
      acc += 1 - kd[j];
    }
    int incl = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    const int s0 = kraft - (n_used - 1);
    const int before = s0 + incl - acc;
#pragma unroll
    for (int j = 0; j < J; ++j) su[j] += before;
    if (s0 > 1) {
      // s >= 1 throughout: a slot past n_used (k_des 1) never fails
      int f = -1;
      for (;;) {
        unsigned cand = kNone;
        int cs = 0, ckd = 0;
#pragma unroll
        for (int j = J - 1; j >= 0; --j)
          if (p0 + j > f && su[j] < kd[j]) {
            cand = (unsigned)(p0 + j);
            cs = su[j];
            ckd = kd[j];
          }
        const unsigned fm = __reduce_min_sync(kFull, cand);
        if (fm == kNone) break;
        const int owner = (int)fm / J;
        const int sf = __shfl_sync(kFull, cs, owner);
        const int kdf = __shfl_sync(kFull, ckd, owner);
        const int kf = 1 << bsr((unsigned)sf);   // 1 <= sf < kdf
        f = (int)fm;
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (p0 + j > f) su[j] += kdf - kf;
        if (sf + 1 - kf <= 1) break;   // s <= 1 from here: every k is 1
      }
    }
    unsigned ksum = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int allow = su[j] > 1 ? su[j] : 1;
      k[j] = p0 + j < n_used
                 ? 1 << bsr((unsigned)(kd[j] < allow ? kd[j] : allow))
                 : 0;
      ksum += (unsigned)k[j];
    }
    r = kraft - (int)__reduce_add_sync(kFull, ksum);
  }

  // the fix steps: keys k << 9 | index (k <= 2^14, index <= 511); k = 0
  // past n_used is never a candidate
  for (int step = 0; step < kFixSteps && r > 0; ++step) {
    const unsigned lim = (unsigned)(r < (kraft >> 1) - 1 ? r
                                                         : (kraft >> 1) - 1);
    unsigned dkey = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const unsigned key = (unsigned)k[j] << 9 | (511 - sym[j]);
      if ((unsigned)(k[j] - 1) < lim && key > dkey) dkey = key;
    }
    dkey = __reduce_max_sync(kFull, dkey);
    int idx, delta;
    if (dkey != 0) {                  // double the largest k <= r
      idx = 511 - (int)(dkey & 511);
      delta = (int)(dkey >> 9);
    } else {                          // halve the smallest k > r
      unsigned hkey = kNone;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const unsigned key = (unsigned)k[j] << 9 | sym[j];
        if (k[j] > r && k[j] >= 2 && key < hkey) hkey = key;
      }
      hkey = __reduce_min_sync(kFull, hkey);
      int kidx;
      if (hkey != kNone) {
        idx = (int)(hkey & 511);
        kidx = (int)(hkey >> 9);
      } else {                        // the empty set: index 0
        unsigned k0 = 0;
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (sym[j] == 0) k0 = (unsigned)k[j];
        idx = 0;
        kidx = (int)__reduce_max_sync(kFull, k0);
      }
      delta = -(kidx >> 1);
    }
    if (delta == 0) break;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (sym[j] == idx) k[j] += delta;
    r -= delta;
  }

  int lens[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    lens[j] = k[j] > 0 ? max_len - bsr((unsigned)k[j]) : 0;

  // the refinement
  if (refine_passes > 0) {
    // p2: the position in (hist descending, index descending) order, the
    // reverse of the (hist, index) ascending order of the level steps'
    // second key: p2 = first + last of p's h-group - p
    int* lens_a = reinterpret_cast<int*>(sm.key);   // lengths by p
    int* lens_b = lens_a + kMaxSym;                  // lengths by p2
    __syncwarp();                     // hs written, the key slots free
    int g0[J], g1[J];
    int run = -1;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int p = p0 + j;
      if (p == 0 || sm.hs[p - 1] != sm.hs[p]) run = p;
      g0[j] = run;
      lens_a[p] = lens_b[p] = 0;
    }
    int x = run;                    // inclusive max-scan of group starts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o && y > x) x = y;
    }
    int carry = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) carry = -1;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (g0[j] < 0) g0[j] = carry;
    run = N;
#pragma unroll
    for (int j = J - 1; j >= 0; --j) {
      const int p = p0 + j;
      if (p == n_used - 1 || (p < n_used - 1 && sm.hs[p + 1] != sm.hs[p]))
        run = p;
      g1[j] = run;
    }
    x = run;                        // suffix min-scan of group ends
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(kFull, x, o);
      if (lane + o < 32 && y < x) x = y;
    }
    carry = __shfl_down_sync(kFull, x, 1);
    if (lane == 31) carry = N;
    unsigned present = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int p = p0 + j;
      if (g1[j] == N) g1[j] = carry;
      if (p < n_used) {
        const int p2 = g0[j] + g1[j] - p;
        sm.hs2[p2] = sm.hs[p];
        sm.p_of_p2[p2] = (short)p;
        sm.p2_of_p[p] = (short)p2;
        lens_a[p] = lens[j];
        lens_b[p2] = lens[j];
        present |= 1u << lens[j];
      }
    }
    present = __reduce_or_sync(kFull, present);
    // every slot of the tables written once, so that a length no lane
    // holds reads a defined (unused) slot
    reinterpret_cast<unsigned long long*>(sm.tab_a[lane])[0] = 0;
    reinterpret_cast<unsigned long long*>(sm.tab_a[lane])[1] = 0;
    reinterpret_cast<unsigned long long*>(sm.tab_b[lane])[0] = 0;
    reinterpret_cast<unsigned long long*>(sm.tab_b[lane])[1] = 0;
    __syncwarp();

    for (int pass = 0; pass < refine_passes; ++pass) {
      // per lane: the lengths it holds, the first j of each in p order,
      // the last j of each in p2 order (a slot past n_used has length 0,
      // which no step reads)
      unsigned ma = 0, mb = 0;
#pragma unroll
      for (int j = J - 1; j >= 0; --j) {
        sm.tab_a[lane][lens[j]] = (unsigned char)j;
        ma |= 1u << lens[j];
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int lb = lens_b[p0 + j];
        sm.tab_b[lane][lb] = (unsigned char)j;
        mb |= 1u << lb;
      }
      __syncwarp();
      // every length: A, its most frequent symbol (the smallest p), and
      // B, its least frequent (the largest p2), by ballots (a length not
      // present reads lane 0's slots, written but used by no step; no
      // branch, so the fifteen lengths' ballots and loads overlap)
      unsigned amin[kMaxLenCap + 1], bmax[kMaxLenCap + 1];
      int ha[kMaxLenCap + 1], hb[kMaxLenCap + 1];
#pragma unroll
      for (int l = 1; l <= kMaxLenCap; ++l) {
        const unsigned ba = __ballot_sync(kFull, ma >> l & 1);
        const unsigned bb = __ballot_sync(kFull, mb >> l & 1);
        const int la = ba ? __ffs(ba) - 1 : 0;
        const int lb = bb ? 31 - __clz(bb) : 0;
        amin[l] = la * J + sm.tab_a[la][l];
        bmax[l] = lb * J + sm.tab_b[lb][l];
        ha[l] = sm.hs[amin[l]];
        hb[l] = sm.hs2[bmax[l]];
      }
      // the level steps as a chain of scalars (every lane the same)
      unsigned moved = 0, bsel[kMaxLenCap + 1];
      unsigned bprev = 0;
      int hprev = 0;
      bool mprev = false;
#pragma unroll
      for (int l = 2; l <= kMaxLenCap; ++l) {
        bsel[l] = 0;
        bool mv = false;
        if ((present >> l & 1) && (present >> (l - 1) & 1)) {
          unsigned b = bmax[l - 1];
          int hbl = hb[l - 1];
          if (mprev && bprev > b) {
            b = bprev;
            hbl = hprev;
          }
          mv = ha[l] > hbl;
          bsel[l] = b;
          bprev = b;
          hprev = hbl;
        }
        mprev = mv;
        moved |= (unsigned)mv << l;
      }
      if (!moved) break;
      // lane l applies level l's move: A down, B up (B may rise through
      // several levels, hence the atomics)
      unsigned my_a = 0, my_b = 0;
#pragma unroll
      for (int l = 2; l <= kMaxLenCap; ++l)
        if (lane == l) {
          my_a = amin[l];
          my_b = bsel[l];
        }
      if (moved >> lane & 1) {
        atomicSub(&lens_a[my_a], 1);
        atomicSub(&lens_b[sm.p2_of_p[my_a]], 1);
        atomicAdd(&lens_b[my_b], 1);
        atomicAdd(&lens_a[sm.p_of_p2[my_b]], 1);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < J; ++j) lens[j] = lens_a[p0 + j];
    }
  }

#pragma unroll
  for (int j = 0; j < J; ++j)
    if (lens[j]) sm.lens[sym[j]] = (unsigned char)lens[j];
  return r;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
code_lens_kernel(const long long* __restrict__ hist_in,
                 long long* __restrict__ lens_out,
                 unsigned char* __restrict__ ok_out, int rows, int nsym,
                 int refine_passes, int max_len) {
  __shared__ RowSmem smem[kRowsPerBlock];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;
  RowSmem& sm = smem[warp];
  const long long* hrow = hist_in + row * nsym;

  // the counts, their total, the used count, the compaction
  long long tot = 0;
  int n_used = 0;
  unsigned hmax = 0;
  const unsigned below = (1u << lane) - 1;
  long long hv[kMaxSym / 32];
#pragma unroll
  for (int j = 0; j < kMaxSym / 32; ++j) {   // every load issued first
    const int i = lane + 32 * j;
    hv[j] = i < nsym ? hrow[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kMaxSym / 32; ++j) {
    const int i = lane + 32 * j;
    if (32 * j >= nsym) break;
    const long long h = hv[j];
    tot += h;
    hmax = (unsigned)h > hmax ? (unsigned)h : hmax;
    const unsigned m = __ballot_sync(kFull, h > 0);
    if (h > 0)
      sm.key[n_used + __popc(m & below)] = h << 10 | (1023 - i);
    n_used += __popc(m);
    if (i < nsym) sm.lens[i] = 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(kFull, tot, o);
  __syncwarp();
  const bool narrow = __reduce_max_sync(kFull, hmax) < (1u << 21);
  const long long total = tot > 1 ? tot : 1;
  const float scale = __fdiv_rn((float)(1 << max_len), __ll2float_rn(total));

  int r;
  if (n_used <= 32)
    r = row_body<1>(sm, n_used, narrow, scale, refine_passes, max_len);
  else if (n_used <= 64)
    r = row_body<2>(sm, n_used, narrow, scale, refine_passes, max_len);
  else if (n_used <= 128)
    r = row_body<4>(sm, n_used, narrow, scale, refine_passes, max_len);
  else if (n_used <= 256)
    r = row_body<8>(sm, n_used, narrow, scale, refine_passes, max_len);
  else
    r = row_body<16>(sm, n_used, narrow, scale, refine_passes, max_len);
  __syncwarp();

  long long* lrow = lens_out + row * nsym;
  for (int i = lane; i < nsym; i += 32) lrow[i] = sm.lens[i];
  if (lane == 0) ok_out[row] = r == 0 && n_used >= 2;
}

}  // namespace

// Inputs: hist int64 [rows, nsym], contiguous, counts in [0, 2^30) with
// row sums below 2^53 (1 <= nsym <= 512); lens int64
// [rows, nsym] and ok bool [rows], every element written; refine_passes
// >= 0 and 2 <= max_len <= 15.  Returns the CUDA error of the launch (0
// on success; cudaErrorInvalidValue for arguments out of range).
extern "C" int code_lens_launch(const long long* hist, long long* lens,
                                unsigned char* ok, int rows, int nsym,
                                int refine_passes, int max_len,
                                void* stream) {
  if (rows <= 0) return 0;
  if (nsym < 1 || nsym > kMaxSym || refine_passes < 0 || max_len < 2 ||
      max_len > kMaxLenCap)
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  code_lens_kernel<<<blocks, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      hist, lens, ok, rows, nsym, refine_passes, max_len);
  return (int)cudaGetLastError();
}
