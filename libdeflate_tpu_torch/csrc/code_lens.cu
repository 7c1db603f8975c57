// Kraft-exact code-length build, one histogram row a block, for Hopper
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
//   - the spend, in frequency-descending order (keys hist*512 + nsym - i,
//     unique), reserving one unit for every later used symbol:
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
// Design: one block a row, one thread a symbol (nsym rounded up to
// warps).
// - The descending order is a rank count: thread i counts the keys above
//   its own (nsym reads of shared memory), and writes k_des to slot rank.
//   Used symbols have keys of at least 512 and unused ones at most nsym,
//   so the used symbols are ranks 0 .. n_used-1 and the count of later
//   used symbols at rank j is n_used - 1 - j.
// - The spend runs on one thread over shared memory, one step a used
//   symbol.
// - A fix or level step is one block reduction of 64-bit keys (value << 10
//   | index, or 1023 - index for a maximum, so that the first index wins
//   a tie): warp shuffles, one slot a warp in shared memory, one
//   __syncthreads(), then every thread reduces the warps' slots; the
//   slots alternate between two buffers, so the next reduction needs no
//   second barrier.
// - Every k is a power of two, so r > 0 is a multiple of the smallest k
//   and some k <= r can double unless every k is kraft/2 (one used
//   symbol at most): halving then finds no candidate and halves k[0],
//   which thread 0 broadcasts through the reduction.
// - A fix step whose delta is 0 leaves (k, r) as they were, so every
//   later step is the same no-op and the loop stops; once r <= 0 nothing
//   changes either.  A refinement pass that changes nothing is a fixed
//   point, so the passes stop there.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSym = 512;
constexpr int kMaxWarps = kMaxSym / 32;
constexpr int kFixSteps = 48;
constexpr long long kNone = 0x7FFFFFFFFFFFFFFFll;

__device__ __forceinline__ int bsr(unsigned x) { return 31 - __clz(x); }

struct Slots {
  long long a[2][kMaxWarps];   // maxima
  long long b[2][kMaxWarps];   // minima
  long long c[2];              // a value thread 0 broadcasts
};

// Block-wide (max of a, min of b) over every thread; c from thread 0.
// One __syncthreads(): buffer `buf` alternates between calls.
__device__ __forceinline__ void reduce(Slots& s, int& buf, long long& a,
                                       long long& b, long long& c,
                                       int warps) {
  for (int o = 16; o > 0; o >>= 1) {
    a = max(a, __shfl_xor_sync(0xFFFFFFFFu, a, o));
    b = min(b, __shfl_xor_sync(0xFFFFFFFFu, b, o));
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s.a[buf][w] = a;
    s.b[buf][w] = b;
  }
  if (threadIdx.x == 0) s.c[buf] = c;
  __syncthreads();
  a = s.a[buf][0];
  b = s.b[buf][0];
  for (int i = 1; i < warps; ++i) {
    a = max(a, s.a[buf][i]);
    b = min(b, s.b[buf][i]);
  }
  c = s.c[buf];
  buf ^= 1;
}

// Block-wide sums of a and b, through the same slots as reduce().
__device__ __forceinline__ void sum2(Slots& s, int& buf, long long& a,
                                     long long& b, int warps) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xFFFFFFFFu, a, o);
    b += __shfl_xor_sync(0xFFFFFFFFu, b, o);
  }
  if ((threadIdx.x & 31) == 0) {
    s.a[buf][threadIdx.x >> 5] = a;
    s.b[buf][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = 0;
  b = 0;
  for (int i = 0; i < warps; ++i) {
    a += s.a[buf][i];
    b += s.b[buf][i];
  }
  buf ^= 1;
}

__global__ void code_lens_kernel(const long long* __restrict__ hist_in,
                                 long long* __restrict__ lens_out,
                                 unsigned char* __restrict__ ok_out, int nsym,
                                 int refine_passes, int max_len) {
  __shared__ long long hist[kMaxSym];
  __shared__ int ksort[kMaxSym];
  __shared__ Slots slots;
  const int i = threadIdx.x;
  const int warps = blockDim.x >> 5;
  const bool mine = i < nsym;
  const long long row = blockIdx.x;
  const long long h = mine ? hist_in[row * nsym + i] : 0;
  const bool used = h > 0;
  hist[i] = h;
  const int kraft = 1 << max_len;
  int buf = 0;

  // total and the used count
  long long tot = h, nused = used ? 1 : 0;
  sum2(slots, buf, tot, nused, warps);   // its barrier also publishes hist
  const int n_used = (int)nused;
  const long long total = tot > 1 ? tot : 1;

  // the seed
  const float scale = __fdiv_rn((float)kraft, __ll2float_rn(total));
  const unsigned share = __float2uint_rz(__fmul_rn(__ll2float_rn(h), scale));
  int e = bsr(share > 1u ? share : 1u);
  const unsigned half = 1u << (e > 0 ? e - 1 : 0);
  e += (share - (1u << e)) > half ? 1 : 0;
  const int ec = e < 0 ? 0 : (e > max_len - 1 ? max_len - 1 : e);
  const int k_des = used ? 1 << ec : 0;

  // the descending order as a rank count over unique keys
  int rank = 0;
  if (mine) {
    const long long key = h * 512 + (nsym - i);
    for (int j = 0; j < nsym; ++j) rank += hist[j] * 512 + (nsym - j) > key;
    ksort[rank] = k_des;
  }
  __syncthreads();

  // the spend: one step a used symbol, ranks 0 .. n_used-1
  if (i == 0) {
    int budget = kraft;
    for (int j = 0; j < n_used; ++j) {
      const int later = n_used - 1 - j;
      const int allow = budget - later > 1 ? budget - later : 1;
      const int kd = ksort[j];
      const int kj = 1 << bsr((unsigned)(kd < allow ? kd : allow));
      budget -= kj;
      ksort[j] = kj;
    }
  }
  __syncthreads();
  int k = used ? ksort[rank] : 0;

  // r = kraft - sum(k)
  long long ksum = k, zero = 0;
  sum2(slots, buf, ksum, zero, warps);
  long long r = kraft - ksum;

  // the fix steps
  for (int step = 0; step < kFixSteps && r > 0; ++step) {
    const bool can_dbl = used && k <= r && k < (kraft >> 1);
    const bool can_hlv = used && k > r && k >= 2;
    long long dkey = can_dbl ? ((long long)k << 10) | (1023 - i) : -1;
    long long hkey = !mine ? kNone
                           : ((long long)(can_hlv ? k : 1 << 30) << 10) | i;
    long long k0 = k;
    reduce(slots, buf, dkey, hkey, k0, warps);
    const bool any_dbl = dkey >= 0;
    const int idx = any_dbl ? 1023 - (int)(dkey & 1023) : (int)(hkey & 1023);
    const long long hv = hkey >> 10;
    const long long kidx =
        any_dbl ? dkey >> 10 : (hv == (1 << 30) ? k0 : hv);
    const long long delta = any_dbl ? kidx : -(kidx >> 1);
    if (delta == 0) break;
    if (i == idx) k += (int)delta;
    r -= delta;
  }

  int lens = k > 0 ? max_len - bsr((unsigned)k) : 0;

  // the refinement
  for (int pass = 0; pass < refine_passes; ++pass) {
    bool changed = false;
    for (int l = 2; l <= max_len; ++l) {
      long long akey = used && lens == l ? (h << 10) | (1023 - i) : -1;
      long long bkey = used && lens == l - 1 ? (h << 10) | i : kNone;
      long long unused = 0;
      reduce(slots, buf, akey, bkey, unused, warps);
      if (akey >= 0 && bkey != kNone && (akey >> 10) > (bkey >> 10)) {
        if (i == 1023 - (int)(akey & 1023)) --lens;
        if (i == (int)(bkey & 1023)) ++lens;
        changed = true;
      }
    }
    if (!changed) break;
  }

  if (mine) lens_out[row * nsym + i] = lens;
  if (i == 0) ok_out[row] = r == 0 && n_used >= 2;
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
      max_len > 15)
    return (int)cudaErrorInvalidValue;
  const int threads = (nsym + 31) / 32 * 32;
  code_lens_kernel<<<rows, threads, 0, (cudaStream_t)stream>>>(
      hist, lens, ok, nsym, refine_passes, max_len);
  return (int)cudaGetLastError();
}
