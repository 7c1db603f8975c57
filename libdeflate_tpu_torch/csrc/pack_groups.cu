// Bit placement of pre-merged group buffers, for Hopper (sm_90a).
//
// Replaces libdeflate_tpu/compress/pallas_kernels.py::pack_groups_pallas
// (kernel body _pack_kernel).  Plain version: group_place in
// libdeflate_tpu_torch/compress/pipeline.py.
//
// What it computes: for every chunk b and 128-position group g, OR the
// group's capw+1 pre-shifted words sbuf[b, g, :] into out[b, gw[b, g] + j].
// The groups' bits are disjoint and gw never decreases within a chunk,
// so the result does not depend on the order of the ORs.  Words whose
// target lies at or past nwords carry only zero bits and are skipped.
// Inputs and output are the caller's int64 tensors: the low 32 bits of
// each sbuf word are its bits, and each output word is written in
// [0, 2^32), zeros included, so the wrapper needs no other device op.
//
// What bounds it on this card: bytes.  It must read sbuf and gw once and
// write the output once (21.8 MB for a 4 x 1 MiB batch: 6.5 us at
// 3.35 TB/s).
//
// Design (pack_groups_launch): a gather in one launch, every output word
// written once, no atomics in device memory and no memset.  A chunk's
// words split into the span [head, tail) that some group's window
// [gw, gw + capw + 1) reaches and the rest, which zero blocks fill
// (kZeroWords each).  The span is cut at the start word of every
// kGroups-th group: tile block k owns the words from group k*kGroups's
// start word to the next tile's, so its own groups' (group, word) pairs
// number kGroups * (capw + 1) however many groups share a word: in the
// corpus's runs class ~20 groups of a few bits start on one word and
// ~1000 windows cover it, and they are spread over many tiles rather
// than walked word by word.  The last tile stops after the last group's
// start word; the up to capw words after it, which every group of the
// last ~capw words reaches, go to kTail tail blocks, else one block would
// OR ~25 000 pairs there on runs-class chunks.  Inside a chunk the same
// holds for the first wide tile after a run of dense groups: it also ORs
// the rows of every group that starts in the capw words before it, alone
// (chip_smoke.py times such chunks).  Lending those words to the dense
// tiles before it bounds that work but measured slower on every other
// input, so it is not done.
//
// A tile loads, in one round, its groups' start words and the kLook
// before them; the first group whose window reaches its words is found
// among those by one warp ballot (by a 32-way warp search over gw, which
// never decreases, if it lies further back).  The covering groups' word
// ranges go to shared memory.  Where the tile's words are at least a row
// wide (capw + 1), consecutive threads load consecutive words of the
// covering groups' rows, kAhead loads each before any lookup; where the
// window is narrower (dense groups), each group gets as many slots as
// the window has words.  Each nonzero word ORs into a shared-memory copy
// of the tile's words (shared atomics), which is stored once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 64;       // groups whose start words bound a tile
constexpr int kWindow = 3072;     // words a tile accumulates at once
constexpr int kBatch = 1024;      // covering groups staged at once
constexpr int kZeroWords = 4096;  // words a zero block fills
constexpr int kTail = 8;          // blocks past a chunk's last start word
constexpr int kLook = 32;         // groups before a tile loaded up front
constexpr int kAhead = 4;         // slots a thread loads before its ORs
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWindow >= kGroups * 46, "a main-path tile fits one window");
static_assert(kLook == 32 && kLook + kGroups <= kThreads,
              "warp 0 holds the looked-back groups, a thread each");

// First index i in [lo, hi) with a[i] >= key, or hi if there is none; a
// is non-decreasing.  Called by all 32 lanes of one warp; each round
// probes 32 points and keeps the one segment that holds the answer.
__device__ int warp_lower_bound(const long long* __restrict__ a, int lo,
                                int hi, long long key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;  // last index of segment lane
    const unsigned ge = __ballot_sync(kFull, p >= hi || a[p] >= key);
    if (ge == 0) return hi;
    const int f = __ffs(ge) - 1;
    const int last = lo + (f + 1) * step - 1;
    lo += f * step;
    hi = last < hi ? last : hi;
  }
  const int p = lo + lane;
  const unsigned ge = __ballot_sync(kFull, p >= hi || a[p] >= key);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

// A staged group's pairs in the window [wa, we): (start - wa, first word
// ja, word count, unused); a count of 0 means none, and then the other
// fields are not read (a start word far outside the window does not fit
// an int).
__device__ __forceinline__ int4 group_meta(long long s, long long wa,
                                           long long we, int capw1) {
  const long long ja = max(wa - s, 0LL);
  const long long count = min(we - s, (long long)capw1) - ja;
  if (count <= 0) return make_int4(0, 0, 0, 0);
  return make_int4((int)(s - wa), (int)ja, (int)count, 0);
}

// OR into acc the pairs of the nb staged groups gb.. (meta in s_meta)
// that land in a window of n words.  Called by the whole block.
__device__ __forceinline__ void or_batch(const long long* __restrict__ src,
                                         int capw1, int gb, int nb, int n,
                                         const int4* s_meta, unsigned* acc) {
  const long long* rows = src + (size_t)gb * capw1;
  if (n >= capw1) {
    // whole rows: slot s is word s of the batch's rows, so the loads of
    // kAhead slots go out before any shared-memory lookup
    const int slots = nb * capw1;
    const int di = kThreads / capw1, dk = kThreads % capw1;
    int i = threadIdx.x / capw1, j = threadIdx.x % capw1;
    for (int s0 = threadIdx.x; s0 < slots; s0 += kAhead * kThreads) {
      unsigned v[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q)
        v[q] = s0 + q * kThreads < slots
                   ? (unsigned)rows[s0 + q * kThreads] : 0u;
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        if (v[q] != 0u) {
          const int4 mt = s_meta[i];
          if (j >= mt.y && j < mt.y + mt.z) atomicOr(&acc[mt.x + j], v[q]);
        }
        i += di;
        j += dk;
        if (j >= capw1) {
          j -= capw1;
          ++i;
        }
      }
    }
    return;
  }
  // a narrow window (many groups a word): n slots a group, slot (i, k)
  // the pair (gb + i, ja_i + k) if k < count_i
  const int slots = nb * n;
  const int di = kThreads / n, dk = kThreads % n;
  int i = threadIdx.x / n, k = threadIdx.x % n;
  for (int s0 = threadIdx.x; s0 < slots; s0 += kAhead * kThreads) {
    unsigned v[kAhead];
    int t[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      v[q] = 0u;
      t[q] = 0;
      if (s0 + q * kThreads < slots) {
        const int4 mt = s_meta[i];
        if (k < mt.z) {
          t[q] = mt.x + mt.y + k;
          v[q] = (unsigned)rows[(size_t)i * capw1 + mt.y + k];
        }
      }
      i += di;
      k += dk;
      if (k >= n) {
        k -= n;
        ++i;
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (v[q] != 0u) atomicOr(&acc[t[q]], v[q]);
  }
}

// Grid: B chunks x (tiles tile blocks, kTail tail blocks, zblocks zero
// blocks).
__global__ void __launch_bounds__(kThreads)
pack_gather_kernel(const long long* __restrict__ sbuf,
                   const long long* __restrict__ gw,
                   long long* __restrict__ out, int m, int capw1, int nwords,
                   int tiles, int zblocks) {
  __shared__ unsigned acc[kWindow];
  __shared__ int4 s_meta[kBatch];
  __shared__ int s_lo;

  const int per_chunk = tiles + kTail + zblocks;
  const int b = blockIdx.x / per_chunk;
  const int r = blockIdx.x - b * per_chunk;
  const long long* g = gw + (size_t)b * m;
  const long long* src = sbuf + (size_t)b * m * capw1;
  long long* dst = out + (size_t)b * nwords;
  const long long nw = nwords;
  // [head, tail): the words some group's window reaches.  Tiles own
  // [head, cut), tail blocks [cut, tail); cut is the word after the last
  // group's start word.
  long long head = nw, cut = nw, tail = nw;
  if (m > 0) {
    head = max(min(g[0], nw), 0LL);
    tail = max(min(g[m - 1] + capw1, nw), head);
    cut = min(max(g[m - 1] + 1, head), tail);
  }

  if (r >= tiles + kTail) {  // a zero block: its slice's words outside
    const long long w0 = (long long)(r - tiles - kTail) * kZeroWords;
    const long long w1 = min(w0 + kZeroWords, nw);
    for (long long w = w0 + threadIdx.x; w < w1; w += kThreads)
      if (w < head || w >= tail) dst[w] = 0;
    return;
  }

  // a tile's groups [g0, g1); every group lies before a tail block's
  // words.  Thread t loads the start word of group from + t now: the 32
  // before g0 (the first group that reaches the block's words is most
  // often among them) and the block's own.
  const int g0 = r < tiles ? r * kGroups : m;
  const int g1 = r < tiles ? min(g0 + kGroups, m) : m;
  const int from = max(g0 - kLook, 0);
  const long long mine =
      from + (int)threadIdx.x < g1 ? g[from + threadIdx.x] : 0;
  long long a, e;
  if (r < tiles) {
    a = r == 0 ? head : min(max(g[g0], head), cut);
    e = g1 == m ? cut : min(max(g[g1], a), cut);
  } else {
    const int piece = (capw1 + kTail - 2) / kTail;  // covers capw1 - 1
    a = min(cut + (long long)(r - tiles) * piece, tail);
    e = min(a + piece, tail);
  }

  for (long long wa = a; wa < e; wa += kWindow) {
    const long long we = min(wa + kWindow, e);
    const int n = (int)(we - wa);
    for (int i = threadIdx.x; i < n; i += kThreads) acc[i] = 0u;
    // lo, the first group with gw > wa - capw1; the groups that reach
    // [wa, we) are among [lo, g1), since groups from g1 on start at or
    // past e.  In the first window lo <= g0.
    const bool first = wa == a;
    if (threadIdx.x < 32) {
      const long long key = wa - capw1 + 1;
      int lo;
      if (first) {
        const unsigned ge = __ballot_sync(
            kFull, from + (int)threadIdx.x >= g0 || mine >= key);
        lo = ge ? from + __ffs(ge) - 1 : g0;
        if (lo == from && from > 0) lo = warp_lower_bound(g, 0, from, key);
      } else {
        lo = warp_lower_bound(g, 0, g1, key);
      }
      if (threadIdx.x == 0) s_lo = lo;
    }
    __syncthreads();
    const int lo = s_lo;
    // the first window's groups from `from` on are in registers already
    const int held = first ? max(lo, from) : g1;
    for (int gb = lo; gb < held; gb += kBatch) {
      const int nb = min(kBatch, held - gb);
      for (int i = threadIdx.x; i < nb; i += kThreads)
        s_meta[i] = group_meta(g[gb + i], wa, we, capw1);
      __syncthreads();
      or_batch(src, capw1, gb, nb, n, s_meta, acc);
      __syncthreads();
    }
    if (held < g1) {
      const int i = from + (int)threadIdx.x - held;
      if (i >= 0 && i < g1 - held)
        s_meta[i] = group_meta(mine, wa, we, capw1);
      __syncthreads();
      or_batch(src, capw1, held, g1 - held, n, s_meta, acc);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < n; i += kThreads)
      dst[wa + i] = (long long)acc[i];
    __syncthreads();
  }
}

}  // namespace

// sbuf int64 [B][m][capw1], gw int64 [B][m] (non-decreasing per chunk,
// >= 0), out int64 [B][nwords], every word written.  Returns the CUDA
// error of the launch.
extern "C" int pack_groups_launch(const long long* sbuf, const long long* gw,
                                  long long* out, int B, int m, int capw1,
                                  int nwords, void* stream) {
  const int tiles = (m + kGroups - 1) / kGroups;
  const int zblocks = (nwords + kZeroWords - 1) / kZeroWords;
  const long long blocks = (long long)B * (tiles + kTail + zblocks);
  if (blocks > 0)
    pack_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(sbuf, gw, out, m, capw1,
                                                 nwords, tiles, zblocks);
  return (int)cudaGetLastError();
}

