// The sorted matchfind's probes after the sort, for Hopper (sm_90a): C5.
//
// Replaces XLA code, not a Pallas kernel: the work of
// libdeflate_tpu/compress/tpu_pipeline.py::_sorted_matchfind (line 192)
// after its sort, in the two forms levels 0-7 run:
// - "best" (no return_pair / return_triple, no wide_ext): the static tier
//   (depth 2, 64 KiB segments), dyn1 (depth 6, 128 KiB) and the rescue
//   pass (depth 2, 8-byte payloads);
// - "lean" (return_triple over w, w4[, w8, w12]): the lean DP tiers and
//   the mesh's levels 5-7 (depth 6, 128 KiB).
// Plain versions: pipeline.sorted_best and pipeline.sorted_matchfind_lean
// in libdeflate_tpu_torch/compress/pipeline.py, ~40 int64 elementwise ops
// a probe over [segments, seg] (the rolls of the hash, the order and
// every payload word, the word LCP, the packing), the best-two pick, four
// payload gathers and the scatter back: ~300 library ops a call, each
// reading and writing the whole batch.
//
// What it computes, per segment of ``seg`` sorted keys k = h << pos_bits |
// lp (the segment's sort by hash, then position): for every sorted slot j
// and d = 1 .. depth, the probe of the slot d before it,
//   same = j >= d && hash(j - d) == hash(j) && hash(j) != junk,
//   dist = lp(j) - lp(j - d), ok = same && dist <= 32768,
// the word-granular LCP of the two positions' payloads (W little-endian
// 32-bit words from the bytes at the position, zero past the row's end):
//   eq4 = ok && word 0 equal, mlen = 4 x the leading equal words (gated by
//   eq4), fine = the trailing zero bytes of the first unequal word's XOR
//   (0 when every word is equal),
// packed as mlen << 18 | fine << 16 | (32769 - (eq4 ? dist : 0)).  "best"
// writes the unpacked maximum over d; "lean" writes A, the maximum, B, the
// maximum over the probes whose low 16 bits differ from A's (zero when
// none), each unpacked, and C, probe 1 with its length capped to 12 in
// steps of 4 and fine 0 (the JAX path's packing loss).  Every output goes
// to the slot's own position, lp, in position order, as int64: 3 arrays
// (mlen, dist, fine) for best, 9 for lean (A, B, C).
//
// What bounds it on this card: bytes.  Each position's 8-byte key and
// its byte are read once (the payloads are the segment's bytes, which
// stay in L2) and 24 (best) or 72 (lean) bytes written: 33 or 81 bytes a
// position, 0.66 / 1.62 ms at 64 x 1 MiB and 3.35 TB/s (the packed
// scratch below adds 8 or 16 more, in L2 mostly); operations are ~25 a
// probe.  The plain version moves ~1 GB an op.
//
// Design:
// - A block of 256 threads takes one tile of 256 sorted slots of one
//   segment, plus a halo of the ``depth`` slots before it.  Each thread
//   reads its slot's key, splits it into the hash and the local position
//   (the sort's order is the key's low bits), and reads its payload from
//   the bytes once: W + 1 aligned 32-bit loads funnel-shifted to the
//   position's byte offset.  The tile's hashes, positions and payload
//   words go to shared memory; each neighbour's come from there.
// - The probes run in registers: a probe whose hash differs costs two
//   shared loads and a compare; the LCP is 32-bit XORs, and the remainder
//   __ffs of the first unequal word.  "best" keeps a running maximum;
//   "lean" takes the maximum in a first pass over d and the runner-up in
//   a second (the probes recomputed from shared memory), as
//   pipeline._best_two computes it, for any keys.
// - Stores.  The outputs are in position order and the slots in hash
//   order, so a slot's stores scatter over its segment.  Nine scattered
//   int64 stores a slot (lean) took 17.3 ms at 64 x 1 MiB on the H100,
//   three (best) 4.7: each scattered array ~1.5 ms.  So a slot writes one
//   packed word at its position (best: A's 23 bits in 32; lean: A | B <<
//   23 | C << 46 in 64), and the segment's last block to finish (a
//   count of finished tiles a segment, after a __threadfence(): the
//   threadFenceReduction pattern) unpacks the segment's words into the
//   outputs with coalesced stores while they are still in L2.
// - Blocks run a segment's tiles in order (one flat grid, segment major),
//   so a segment's words (at most 1 MiB) meet in the 50 MB L2.
// Domain: width 8 or 16 bytes, depth 1 .. 32, 1 <= seg, rows x seg the
// [B, n] batch flattened with n a multiple of seg and of 4, 0 <= shift <
// n (the bytes' offset: the rescue pass reads its row half a segment
// on), pos_bits <= 30; a launch outside it returns cudaErrorInvalidValue.

#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;        // sorted slots a block, a thread each
constexpr int kMaxDepth = 32;
constexpr int kWindow = 32768;
constexpr int kInvD = kWindow + 1;
constexpr int kStride = kTile + kMaxDepth;   // shared slots a tile

struct Outs {
  long long* p[9];
};

// The packed probe of the slot ``i`` of shared memory against this
// thread's own slot: mlen << 18 | fine << 16 | (32769 - dist), dist 0
// unless eq4.
template <int W>
__device__ __forceinline__ int probe_pack(const int* s_hash, const int* s_pos,
                                          const unsigned* s_pay, int i,
                                          bool gate, int h, int lp,
                                          const unsigned* pay) {
  if (!gate || s_hash[i] != h) return kInvD;
  const int dist = lp - s_pos[i];
  if (dist > kWindow) return kInvD;
  if ((pay[0] ^ s_pay[i]) != 0) return kInvD;
  int mlen = 4;
  unsigned x = 0;
#pragma unroll
  for (int k = 1; k < W; ++k) {
    const unsigned xk = pay[k] ^ s_pay[k * kStride + i];
    if (x == 0) {
      if (xk == 0)
        mlen += 4;
      else
        x = xk;
    }
  }
  const int fine = x != 0 ? (__ffs(x) - 1) >> 3 : 0;
  return (mlen << 18) | (fine << 16) | (kInvD - dist);
}

// A probe's (mlen, fine, dist) as 23 bits, mlen << 18 | fine << 16 |
// dist, from its packed form (pipeline._unpack_inv, then _pay).
__device__ __forceinline__ unsigned long long pay_of(int p) {
  return (unsigned long long)((p & ~0xFFFF) |
                              ((kInvD - (p & 0xFFFF)) & 0xFFFF));
}

__device__ __forceinline__ void put_pay(const Outs& o, int first,
                                        long long at, unsigned v) {
  o.p[first][at] = v >> 18;
  o.p[first + 1][at] = v & 0xFFFF;
  o.p[first + 2][at] = (v >> 16) & 3;
}

// "best" keeps A's 23 bits a position (32-bit words), "lean" A, B and C
// in one 64-bit word: A | B << 23 | C << 46, C = (len / 4) << 16 | dist.
template <bool LEAN>
using Packed = typename std::conditional<LEAN, unsigned long long,
                                         unsigned>::type;

template <int W, bool LEAN>
__global__ void __launch_bounds__(kTile)
segment_probe_kernel(const unsigned char* __restrict__ bp,
                     const long long* __restrict__ keys, Outs outs,
                     Packed<LEAN>* packed, int* done, int seg, int n,
                     int shift, int pos_bits, int junk, int depth,
                     int tiles) {
  __shared__ int s_hash[kStride];
  __shared__ int s_pos[kStride];
  __shared__ unsigned s_pay[W * kStride];
  __shared__ int s_last;

  const long long row = blockIdx.x / tiles;
  const int t0 = (int)(blockIdx.x % tiles) * kTile;
  const int tid = threadIdx.x;
  const long long* rk = keys + row * seg;
  const int per_row = n / seg;             // segments a batch row
  const unsigned* row_words = reinterpret_cast<const unsigned*>(
      bp + (row / per_row) * (long long)n);
  const int seg_off = (int)(row % per_row) * seg + shift;
  const int nwords = n >> 2;
  const long long mask = (1LL << pos_bits) - 1;
  const long long base = row * seg;

  // slot j's hash, position and payload, to shared memory at i
  auto load = [&](int j, int i, int& h, int& lp, unsigned* pay) {
    const long long k = rk[j];
    h = (int)(k >> pos_bits);
    lp = (int)(k & mask);
    const int q = seg_off + lp;
    const int w0 = q >> 2, sh = (q & 3) * 8;
    unsigned w[W + 1];
#pragma unroll
    for (int e = 0; e <= W; ++e)
      w[e] = w0 + e < nwords ? __ldg(row_words + w0 + e) : 0u;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      pay[e] = __funnelshift_r(w[e], w[e + 1], sh);
      s_pay[e * kStride + i] = pay[e];
    }
    s_hash[i] = h;
    s_pos[i] = lp;
  };

  const int j = t0 + tid;
  const int mine = tid + depth;            // own slot's index in shared
  int h = 0, lp = 0;
  unsigned pay[W];
  if (j < seg) load(j, mine, h, lp, pay);
  if (tid < depth && t0 - depth + tid >= 0) {
    int hh, ll;
    unsigned pp[W];
    load(t0 - depth + tid, tid, hh, ll, pp);
  }
  __syncthreads();

  if (j < seg) {
    const bool gate = h != junk;
    int a = 0;
    int c = kInvD;
    for (int d = 1; d <= depth; ++d) {
      const int p = probe_pack<W>(s_hash, s_pos, s_pay, mine - d,
                                  gate && j >= d, h, lp, pay);
      if (d == 1) c = p;
      a = max(a, p);
    }
    if constexpr (!LEAN) {
      packed[base + lp] = (unsigned)pay_of(a);
    } else {
      const int inv_a = a & 0xFFFF;
      int b = 0;
      for (int d = 1; d <= depth; ++d) {
        const int p = probe_pack<W>(s_hash, s_pos, s_pay, mine - d,
                                    gate && j >= d, h, lp, pay);
        if ((p & 0xFFFF) != inv_a) b = max(b, p);
      }
      // C: probe 1's (len / 4 capped at 3) and its dist
      const unsigned long long cc =
          ((unsigned long long)min(c >> 20, 3) << 16) |
          ((kInvD - (c & 0xFFFF)) & 0xFFFF);
      packed[base + lp] = pay_of(a) | (b != 0 ? pay_of(b) << 23 : 0ULL) |
                          cc << 46;
    }
  }

  // the segment's last block to finish turns its packed words into the
  // outputs, coalesced (the threadFenceReduction pattern)
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done + row, 1) == tiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < seg; i += kTile) {
    const Packed<LEAN> v = __ldcg(packed + base + i);
    put_pay(outs, 0, base + i, (unsigned)(v & 0x7FFFFF));
    if constexpr (LEAN) {
      put_pay(outs, 3, base + i, (unsigned)((v >> 23) & 0x7FFFFF));
      outs.p[6][base + i] = (long long)((v >> 62) << 2);
      outs.p[7][base + i] = (long long)((v >> 46) & 0xFFFF);
      outs.p[8][base + i] = 0;
    }
  }
}

template <int W, bool LEAN>
int launch(const unsigned char* bp, const long long* keys, const Outs& o,
           void* packed, int* done, int rows, int seg, int n, int shift,
           int pos_bits, int junk, int depth, cudaStream_t stream) {
  const int tiles = (seg + kTile - 1) / kTile;
  const long long blocks = (long long)rows * tiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    segment_probe_kernel<W, LEAN><<<(unsigned)blocks, kTile, 0, stream>>>(
        bp, keys, o, static_cast<Packed<LEAN>*>(packed), done, seg, n, shift,
        pos_bits, junk, depth, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// C5.  bp: the bytes, uint8 [B, n]; keys: the sorted keys, int64 [rows,
// seg] with rows x seg = B x n; outs: 3 (lean 0) or 9 (lean 1) int64
// arrays of B x n, every element written; packed: scratch of B x n
// 32-bit (best) or 64-bit (lean) words; done: int32 [rows], zero;
// width 8 or 16 payload bytes.
extern "C" int segment_probe_launch(const unsigned char* bp,
                                    const long long* keys, void* const* outs,
                                    void* packed, int* done, int lean,
                                    int width, int rows, int seg, int n,
                                    int shift, int pos_bits, int junk,
                                    int depth, void* stream) {
  if (!(lean == 0 || lean == 1) || !(width == 8 || width == 16) ||
      depth < 1 || depth > kMaxDepth || seg < 1 || n < 0 || rows < 0 ||
      n % seg != 0 || n % 4 != 0 || shift < 0 || (n > 0 && shift >= n) ||
      pos_bits < 1 || pos_bits > 30 || (1LL << pos_bits) < seg)
    return (int)cudaErrorInvalidValue;
  Outs o{};
  for (int i = 0; i < (lean ? 9 : 3); ++i)
    o.p[i] = static_cast<long long*>(outs[i]);
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 16)
    return lean ? launch<4, true>(bp, keys, o, packed, done, rows, seg, n,
                                  shift, pos_bits, junk, depth, s)
                : launch<4, false>(bp, keys, o, packed, done, rows, seg, n,
                                   shift, pos_bits, junk, depth, s);
  return lean ? launch<2, true>(bp, keys, o, packed, done, rows, seg, n,
                                shift, pos_bits, junk, depth, s)
              : launch<2, false>(bp, keys, o, packed, done, rows, seg, n,
                                 shift, pos_bits, junk, depth, s);
}
