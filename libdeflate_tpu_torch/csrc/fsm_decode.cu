// FSM raw-DEFLATE decoder (F1), for Hopper (sm_90a).
//
// Replaces libdeflate_tpu/decompress/tpu.py::deflate_decompress_chunk
// (vmapped by decompress_chunks), which XLA compiles from nested
// lax.while_loops: it is not a Pallas kernel.  Plain version:
// decode_chunks_fsm_plain in libdeflate_tpu_torch/decompress/fsm.py, which
// this file follows step for step.
//
// What it computes: for each stream b, the raw-DEFLATE stream at the start
// of bufs[b, :N] (in_lens[b] bytes; bytes at and past min(in_lens[b], N)
// read as zero) decoded into out[b, :out_cap]; the output length, the
// consumed bytes min((bit_pos + 7) >> 3, in_lens[b]) and the result (0 OK,
// 1 BAD_DATA, 3 INSUFFICIENT_SPACE).  Every observable result equals the
// JAX decoder's, so the control flow is its own: the block loop with the
// 49-bit overread budget (hard_limit), the count-based canonical decode
// (count, first_code, first_idx and the symbols sorted by (length,
// symbol), unused ones last, zlib-lax incomplete codes patched to a
// complete 1-bit code), a literal written whenever it fits out_cap even
// when its codeword ends past hard_limit, and the error before
// INSUFFICIENT_SPACE.
//
// What bounds it on this card: bytes, in principle -- each input byte read
// once and each output byte written once, microseconds for a 16 MiB batch.
// In practice the serial dependence of DEFLATE: each symbol's bit position
// depends on the symbol before, so a stream is a chain of dependent table
// loads on one warp, and at B = 16 streams 16 of 132 SMs work.  What sat
// on that chain before this design -- five byte loads from global memory
// a peek (four peeks a match), a 15-length compare of 30 shared loads a
// symbol, a global store a literal and an L2 round trip a match -- the
// design takes off it: a lookup is one shared-memory load and a few
// register operations, and everything else runs beside the chain.
//
// Design: one warp a stream, one warp a block.  Every lane walks the same
// blocks and symbols in step (each value on the chain is warp-uniform, so
// no value is broadcast) and the lanes split the work that is not on the
// chain.
// - Input: the row is staged by cp.async into a 16 KiB shared-memory ring
//   of 512-word segments that runs ahead of the cursor (Ring), and a 64-bit
//   LSB-first bit buffer in registers takes the next ring word, loaded
//   ahead, whenever it holds fewer than 32 bits (Bits), so a symbol costs a
//   shift and a refill waits for no load.  Rows start b * N bytes apart
//   with any N, so the ring holds the aligned words from the one at or
//   below the row's start, and the bit cursor is offset by the row's lead
//   bytes; a word that lies wholly in the row's first min(in_len, N) bytes
//   is copied by cp.async, a word past them is stored as zero, and the (at
//   most two) words across the row's ends are put together byte by byte
//   with the bytes outside read as zero.  A stored block skips the buffer
//   forward to its end (within the buffer, or by restaging the ring there);
//   its bytes are copied from the row in global memory under the same zero
//   rule.
// - Decode: each code's canonical tables (count, first_code, first_idx,
//   syms) are built by the warp in shared memory as before: counts by
//   shared atomics, the (length, symbol) order by __match_any_sync ranks.
//   From them the warp builds a root table of 2^R entries (R = 11 for
//   litlen, 10 for offsets, 7 for the precode): for each R-bit window the
//   entry of the shortest code length l <= R whose l-bit prefix lies in its
//   code range, with the length or offset symbol's base and extra bits, or
//   0 where no length up to R matches.  Those windows, and only those,
//   take the 15-length compare (decode_sym), so every table build_table
//   makes decodes exactly as the compare decodes it.  The litlen root then
//   pairs a short literal with the literal that fits the rest of its
//   window.  The static tables and their roots are built once a stream.
// - Output: literals and matches go to a 64 KiB LZ window in shared memory
//   (twice the DEFLATE window, so a match source is always there); each
//   finished 32 KiB half is flushed to out in 16-byte stores (4-byte or
//   single-byte stores where the row is not so aligned), and at the end,
//   on a failure too, the warp flushes up to the output length and zeros
//   out past it, so out is written once and the wrapper allocates it
//   uninitialized.  Every lane stores each literal (and a pair's second
//   byte, or junk past a single literal that the next store overwrites);
//   the lanes copy a match, byte k from op - dist + (k mod dist), a byte
//   that existed before the match, so an overlapping period repeats
//   without a byte-by-byte chain; one __syncwarp() before a match orders
//   the window stores before its loads.
// - The chain: a literal (or pair) found at the root within every bound
//   takes one branch; the next lookup's index is the buffer shifted by the
//   entry's length, and that load is issued before the stores, the
//   bookkeeping and the refill.  A match found at both roots within every
//   bound takes one branch too: its offset's entry and the next lookup
//   take their indices from the 64 bits ahead of the cursor (the buffer
//   and the word loaded after it), so neither waits for a refill, and the
//   next lookup leaves before the copy; a match at most 32 bytes long and
//   32 or more back is one load and one store a lane.  Every other step
//   (a code longer than the root, a bound reached, a failure and its bit
//   cursor, an EOB) takes the third path, as symbol_loop walks it.  The window, ring, tables and roots
//   take about 113 KiB of dynamic shared memory; the launcher raises the
//   limit once per device.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSyms = 288;      // largest alphabet (litlen)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOk = 0, kBad = 1, kInsufficient = 3;

// root widths: litlen, offsets, precode
constexpr int kLLR = 11, kOFR = 10, kPreR = 7;
constexpr uint32_t kLLM = (1u << kLLR) - 1, kOFM = (1u << kOFR) - 1,
                   kPreM = (1u << kPreR) - 1;
enum Role { kPrecode, kLitLen, kOffset };

// the input ring: kRingSegs segments of kSegW words, kRingAhead in flight
constexpr int kSegW = 512;
constexpr int kRingSegs = 8;
constexpr int kRingW = kSegW * kRingSegs;
constexpr int kRingAhead = 2;
// the LZ window: output byte p at p & kWinM, flushed a half at a time
constexpr int kWinB = 65536;
constexpr int kWinM = kWinB - 1;
constexpr int kFlushB = 32768;

__constant__ int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int kOffBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,    25,
    33,   49,   65,   97,   129,  193,   257,   385,   513,   769,
    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
__constant__ int kOffExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                  4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                  9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
__constant__ int kPerm[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                              11, 4,  12, 3, 13, 2, 14, 1, 15};

struct Table {
  int count[16];
  int first_code[16];
  int first_idx[16];
  int syms[kMaxSyms];
};

struct Smem {
  uint8_t win[kWinB];            // at offset 0: 16-byte aligned for the flush
  uint32_t ring[kRingW];
  uint32_t st_ll_root[1 << kLLR], ll_root[1 << kLLR];
  uint32_t st_of_root[1 << kOFR], of_root[1 << kOFR];
  uint32_t pre_root[1 << kPreR];
  Table st_ll, st_of;            // the static code, built once
  Table ll, of, pre;             // the current dynamic block's
  int lens[kMaxSyms + 32];       // code lengths (litlen then offsets)
  int pre_lens[19];
  int cursor[16];                // sort cursors, one a length class
  uint8_t modt[32 * 32];         // modt[d * 32 + k] = k % d, 1 <= d < 32
};

// ---- input -------------------------------------------------------------

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kRingAhead of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRingAhead) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The row's words in a ring: word g is the 4 bytes at words + g, where
// words is the aligned word at or below the row's start (lead bytes
// before it), with every byte outside the row's first n read as zero.
// Segment s (words [s * kSegW, (s + 1) * kSegW)) lives in slot
// s % kRingSegs.  Segments [0, issued) have been issued, the last
// kRingAhead of them maybe still in flight.  The cursor never moves back,
// so a slot is reused once the cursor has passed its segment.
struct Ring {
  const uint8_t* row;
  const uint32_t* words;
  int lead;
  int n;
  uint32_t* ring;
  int issued;
  int limit;   // the first cursor word at which advance has work

  __device__ void issue(int seg, int lane) {
    uint32_t* dst = ring + (seg & (kRingSegs - 1)) * kSegW;
    const int w0 = seg * kSegW;
    for (int k = lane; k < kSegW; k += 32) {
      const int j = 4 * (w0 + k) - lead;   // the row byte at the word's start
      if (j >= 0 && j + 4 <= n) {
        cp_async4(dst + k, words + w0 + k);
      } else if (j >= n) {
        dst[k] = 0u;
      } else {
        uint32_t v = 0;
        for (int i = 0; i < 4; ++i)
          if (j + i >= 0 && j + i < n)
            v |= (uint32_t)__ldg(row + j + i) << (8 * i);
        dst[k] = v;
      }
    }
    cp_async_commit();
  }

  // Make words [tw, tw + 2560] readable: segments tw / kSegW and the next
  // five complete, the two after them issued.  Warp-uniform.
  __device__ void advance(int tw, int lane) {
    if (tw < limit) return;
    const int s0 = tw / kSegW;
    // a new segment would land on the slot of one still in flight
    if (s0 + kRingSegs - issued > kRingSegs - kRingAhead) cp_async_wait_all();
    issued = max(issued, s0);
    while (issued < s0 + kRingSegs) issue(issued++, lane);
    limit = kSegW * (issued - kRingSegs + 1);
    cp_async_wait_ahead();
    __syncwarp();
  }
};

// The bit buffer: ring bits [32 * g - n, 32 * g) in the low n bits of buf,
// zeros above them, and ring word g loaded ahead in nw, so that a refill
// waits for no load.  Between steps 32 <= n < 64.
struct Bits {
  uint64_t buf;
  int n;
  int g;       // the next ring word to take
  uint32_t nw;  // ring word g

  __device__ __forceinline__ void consume(int c) {
    buf >>= c;
    n -= c;
  }

  // back to 32 or more bits: word g when fewer are left, no branch; then
  // the next word is loaded for the refill after
  __device__ __forceinline__ void refill(const uint32_t* ring) {
    const bool r = n < 32;
    buf |= r ? (uint64_t)nw << n : 0ull;
    n += r ? 32 : 0;
    g += r;
    nw = ring[g & (kRingW - 1)];
  }

  // restart at ring bit q, made readable by the caller
  __device__ void seek(const uint32_t* ring, int q) {
    g = q >> 5;
    buf = ring[g & (kRingW - 1)] >> (q & 31);
    n = 32 - (q & 31);
    ++g;
    nw = ring[g & (kRingW - 1)];
    refill(ring);
  }

  // move on k >= 0 bits: from the buffer when it holds them, else by a
  // seek, which lands at or past word g, so the cursor never moves back
  __device__ void skip(Ring& rg, int k, int lane) {
    if (k < n) {
      consume(k);
      refill(rg.ring);
    } else {
      const int q = 32 * g - n + k;
      rg.advance(q >> 5, lane);
      seek(rg.ring, q);
    }
  }
};

// ---- tables ------------------------------------------------------------

// The canonical tables of lens[0, nsyms) (symbols past nsyms unused), by
// the warp (_canon_tables).  Returns whether the code is usable.
__device__ bool build_table(const int* lens, int nsyms, Table& t,
                            int* cursor, int lane) {
  if (lane < 16) t.count[lane] = 0;
  __syncwarp();
  for (int s = lane; s < kMaxSyms; s += 32) {
    const int l = s < nsyms ? lens[s] : 0;
    if (l) atomicAdd(&t.count[l], 1);
  }
  __syncwarp();
  int codespace = 0;
#pragma unroll
  for (int l = 1; l < 16; ++l) codespace += t.count[l] << (15 - l);
  constexpr int full = 1 << 15;
  const bool single_ok = codespace == (full >> 1) && t.count[1] == 1;
  const bool empty_ok = codespace == 0;
  const bool incomplete = codespace < full;
  const bool bad =
      codespace > full || (incomplete && !(single_ok || empty_ok));
  const bool patch = incomplete && !bad;
  int patch_sym = 0;                   // the empty code decodes symbol 0
  if (patch && !empty_ok) {
    for (int r = 0; r < kMaxSyms / 32; ++r) {
      const int s = r * 32 + lane;
      const unsigned m = __ballot_sync(kFull, s < nsyms && lens[s] == 1);
      if (m) {
        patch_sym = r * 32 + __ffs(m) - 1;
        break;
      }
    }
  }
  __syncwarp();                        // every lane has read the counts
  if (patch && lane < 16) t.count[lane] = lane == 1 ? 2 : 0;
  __syncwarp();
  if (lane == 0) {
    int code = 0, idx = 0;
    t.first_code[0] = 0;
    t.first_idx[0] = 0;
    for (int l = 1; l < 16; ++l) {
      t.first_code[l] = code;
      code = (code + t.count[l]) << 1;
      idx += t.count[l - 1];
      t.first_idx[l] = idx;
      cursor[l] = idx;
    }
    // the unused symbols after every used one
    cursor[0] = patch ? 1 : idx + t.count[15];
  }
  __syncwarp();
  // a stable order by (length, symbol): each lane's rank among the lanes
  // of its length class in this round, after the rounds before
  for (int r = 0; r < kMaxSyms / 32; ++r) {
    const int s = r * 32 + lane;
    int l = s < nsyms ? lens[s] : 0;
    if (patch) l = s == patch_sym ? 1 : 0;
    const unsigned grp = __match_any_sync(kFull, l);
    const int rank = __popc(grp & ((1u << lane) - 1u));
    t.syms[cursor[l] + rank] = s;
    __syncwarp();
    if (rank == 0) cursor[l] += __popc(grp);
    __syncwarp();
  }
  if (patch && lane == 0) t.syms[1] = t.syms[0];
  __syncwarp();
  return !bad;
}

struct Sym {
  int sym, len;
  bool ok;
};

// The symbol of the 15-bit window at the low end of bits (_decode_sym):
// the shortest length whose prefix lies in its code range.
__device__ Sym decode_sym(const Table& t, uint32_t bits) {
  const int rev = (int)(__brev(bits & 0x7FFFu) >> 17);
  int ln = 0, off = 0;
#pragma unroll
  for (int l = 15; l >= 1; --l) {
    const int o = (rev >> (15 - l)) - t.first_code[l];
    if (o >= 0 && o < t.count[l]) {
      ln = l;
      off = o;
    }
  }
  const bool ok = ln != 0;
  if (!ok) {
    ln = 1;
    off = (rev >> 14) - t.first_code[1];
  }
  const int idx = min(max(t.first_idx[ln] + off, 0), kMaxSyms - 1);
  return {t.syms[idx], ln, ok};
}

// A root entry: bits 0-3 the codeword length, 4-12 the symbol, 13-16 the
// extra bits and 17-31 the base of a length or offset symbol (an offset
// symbol past 29 takes slot 29's, as the decoder does).  Length 0: decode
// by the compare.
__device__ uint32_t make_entry(int role, int sym, int len) {
  uint32_t e = (uint32_t)len | ((uint32_t)sym << 4);
  if (role == kLitLen && sym >= 257 && sym <= 285) {
    const int s = sym - 257;
    e |= ((uint32_t)kLenExtra[s] << 13) | ((uint32_t)kLenBase[s] << 17);
  } else if (role == kOffset) {
    const int s = min(sym, 29);
    e |= ((uint32_t)kOffExtra[s] << 13) | ((uint32_t)kOffBase[s] << 17);
  }
  return e;
}

// The root table of t over R-bit windows, by the warp: for each window the
// entry of the shortest length l <= R whose l-bit prefix lies in its code
// range, 0 where none does (decode_sym's choice among lengths 1..R, which
// a longer length cannot beat).
template <int R>
__device__ void build_root(const Table& t, int role, uint32_t* root,
                           int lane) {
  int fc[R + 1], cnt[R + 1];
#pragma unroll
  for (int l = 1; l <= R; ++l) {
    fc[l] = t.first_code[l];
    cnt[l] = t.count[l];
  }
  for (int w = lane; w < (1 << R); w += 32) {
    const int rev = (int)(__brev((uint32_t)w) >> (32 - R));
    int ln = 0, off = 0;
#pragma unroll
    for (int l = R; l >= 1; --l) {
      const int o = (rev >> (R - l)) - fc[l];
      if (o >= 0 && o < cnt[l]) {
        ln = l;
        off = o;
      }
    }
    root[w] = ln ? make_entry(role, t.syms[min(t.first_idx[ln] + off,
                                                 kMaxSyms - 1)], ln)
                 : 0u;
  }
  __syncwarp();
}

// A pair entry: a literal whose code is shorter than the litlen root and
// the literal whose code fits the root's rest, bits 0-3 their two lengths'
// sum, 4-11 the first, 13-16 the first's length, 17-24 the second and bit
// 26 set (a bit no single litlen entry sets: a length's base ends at bit
// 25).  The warp pairs the root's literal entries in place, 32 windows
// a round from the top: the second's entry, at window w >> l1 below the
// round (or in round 0, read before any lane writes), is still single.
constexpr int kPairBit = 26;

__device__ void pair_literals(uint32_t* root, int lane) {
  for (int base = (1 << kLLR) - 32; base >= 0; base -= 32) {
    const int w = base + lane;
    const uint32_t e1 = root[w];
    const int l1 = (int)(e1 & 15), s1 = (int)((e1 >> 4) & 511);
    const bool cand = l1 != 0 && s1 < 256 && l1 < kLLR;
    const uint32_t e2 = cand ? root[w >> l1] : 0u;
    __syncwarp();
    const int l2 = (int)(e2 & 15), s2 = (int)((e2 >> 4) & 511);
    if (cand && l2 != 0 && s2 < 256 && l1 + l2 <= kLLR)
      root[w] = (uint32_t)(l1 + l2) | ((uint32_t)s1 << 4) |
                ((uint32_t)l1 << 13) | ((uint32_t)s2 << 17) |
                (1u << kPairBit);
    __syncwarp();
  }
}

// the first literal of a pair entry as a single entry; others as they are
__device__ __forceinline__ uint32_t first_of(uint32_t e) {
  return (e >> kPairBit) & 1 ? ((e >> 13) & 15) | (e & 0xFF0) : e;
}

// the root entry of the window at the low end of bits, by the compare
// where the root has none; ok is false only when no length matches
__device__ __forceinline__ uint32_t lookup(const Table& t, int role,
                                           uint32_t e, uint32_t bits,
                                           bool& ok) {
  ok = true;
  if (e & 15) return e;
  const Sym d = decode_sym(t, bits);
  ok = d.ok;
  return make_entry(role, d.sym, d.len);
}

// ---- output ------------------------------------------------------------

// The stream's output: the window, its row of out and how much of the row
// holds its bytes.
struct Out {
  uint8_t* win;
  uint8_t* dst;
  int cap;       // out_cap
  int op;        // bytes decoded, at most cap
  int flushed;   // bytes of dst written, a multiple of kFlushB

  // dst[flushed, to) from the window, by all lanes; to - flushed <= kFlushB,
  // so the bytes lie in one half of the window (16-byte aligned)
  __device__ void flush(int to, int lane) {
    const int nb = to - flushed;
    __syncwarp();
    const uint8_t* src = win + (flushed & kWinM);
    uint8_t* d = dst + flushed;
    int done = 0;
    if (!(reinterpret_cast<uintptr_t>(d) & 15)) {
      for (int k = lane; k < nb >> 4; k += 32)
        reinterpret_cast<uint4*>(d)[k] = reinterpret_cast<const uint4*>(src)[k];
      done = nb & ~15;
    } else if (!(reinterpret_cast<uintptr_t>(d) & 3)) {
      for (int k = lane; k < nb >> 2; k += 32)
        reinterpret_cast<uint32_t*>(d)[k] =
            reinterpret_cast<const uint32_t*>(src)[k];
      done = nb & ~3;
    }
    for (int k = done + lane; k < nb; k += 32) d[k] = src[k];
    __syncwarp();
  }

  __device__ __forceinline__ void flush_if_full(int lane) {
    if (op - flushed >= kFlushB) {
      flush(flushed + kFlushB, lane);
      flushed += kFlushB;
    }
  }

  // the rest of the output, then zeros in dst[op, cap)
  __device__ void finish(int lane) {
    flush(op, lane);
    uint8_t* d = dst + op;
    const int nb = cap - op;
    const int h =
        min((int)((16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15), nb);
    const int m = (nb - h) >> 4;
    if (lane < h) d[lane] = 0;
    uint4* v = reinterpret_cast<uint4*>(d + h);
    for (int k = lane; k < m; k += 32) v[k] = make_uint4(0, 0, 0, 0);
    for (int k = h + 16 * m + lane; k < nb; k += 32) d[k] = 0;
  }
};

// Window bytes [op, op + len) of a match at distance dist (1 <= dist <= op),
// by the warp: byte op + i from op - dist + (i mod dist), which existed
// before the match.  Warp-uniform.
__device__ __forceinline__ void copy_match(uint8_t* win, const uint8_t* modt,
                                           int op, int dist, int len,
                                           int lane) {
  if ((dist >= 32) & (len <= 32)) {   // one step, most matches
    if (lane < len) win[(op + lane) & kWinM] = win[(op - dist + lane) & kWinM];
    return;
  }
  // r = (i + lane) mod dist at step i, moved on by step = 32 mod dist
  int r = lane, step = dist == 32 ? 0 : 32;
  if (dist < 32) {
    r = modt[dist * 32 + lane];
    const int r31 = __shfl_sync(kFull, r, 31) + 1;
    step = r31 == dist ? 0 : r31;
  }
  const int src = op - dist;
  for (int i = 0; i < len; i += 32) {
    if (i + lane < len) win[(op + i + lane) & kWinM] = win[(src + r) & kWinM];
    r += step;
    r -= r >= dist ? dist : 0;
  }
}

// A stored block's bytes: row bytes [from, from + length), zero at and past
// n, into the window, in pieces that end at the next flush.
__device__ void copy_stored(const Ring& rg, int from, int length, Out& o,
                            int lane) {
  while (length > 0) {
    const int piece = min(length, kFlushB - (o.op - o.flushed));
#pragma unroll 8
    for (int k = lane; k < piece; k += 32) {
      const int j = from + k;
      o.win[(o.op + k) & kWinM] = j < rg.n ? __ldg(rg.row + j) : 0;
    }
    o.op += piece;
    from += piece;
    length -= piece;
    o.flush_if_full(lane);
  }
}

// ---- the decoder -------------------------------------------------------

struct State {
  int bit_pos, result;
  bool running;
};

// The header of a dynamic block from bit_pos (block_dynamic): the precode,
// the RLE of the code lengths, the two tables and their roots.  Leaves
// bit_pos after the last length read; returns whether the block's codes
// are usable.  The buffer holds 32 or more bits.
__device__ bool dynamic_header(Bits& br, Ring& rg, State& s, int hard,
                               Smem& sm, int lane) {
  const uint32_t bits = (uint32_t)br.buf;
  const int num_litlen = 257 + (int)(bits & 31);
  const int num_offsets = 1 + (int)((bits >> 5) & 31);
  const int num_explicit = 4 + (int)((bits >> 10) & 15);
  br.consume(14);
  int bp = s.bit_pos + 14 + 3 * num_explicit;
  if (lane < 19) sm.pre_lens[lane] = 0;
  __syncwarp();
  for (int i = 0; i < num_explicit; ++i) {
    br.refill(rg.ring);
    if (lane == 0) sm.pre_lens[kPerm[i]] = (int)(br.buf & 7);
    br.consume(3);
  }
  __syncwarp();
  bool ok = build_table(sm.pre_lens, 19, sm.pre, sm.cursor, lane);
  if (ok) build_root<kPreR>(sm.pre, kPrecode, sm.pre_root, lane);
  const int total = num_litlen + num_offsets;
  int i = 0, prev = 0;                 // prev: lens[i - 1]
  while (ok && i < total) {
    if (br.g >= rg.limit) rg.advance(br.g, lane);
    br.refill(rg.ring);
    bool dok;
    const uint32_t e = lookup(sm.pre, kPrecode,
                              sm.pre_root[(uint32_t)br.buf & kPreM],
                              (uint32_t)br.buf, dok);
    const int len = (int)(e & 15), sym = (int)((e >> 4) & 511);
    br.consume(len);
    const int nbp = bp + len;
    const uint32_t bits2 = (uint32_t)br.buf;
    int rep, xb, val;
    if (sym < 16) {
      rep = 1, xb = 0, val = sym;
    } else if (sym == 16) {
      rep = 3 + (int)(bits2 & 3), xb = 2, val = prev;
    } else if (sym == 17) {
      rep = 3 + (int)(bits2 & 7), xb = 3, val = 0;
    } else {
      rep = 11 + (int)(bits2 & 127), xb = sym == 18 ? 7 : 0, val = 0;
    }
    const bool bad = !dok || (sym == 16 && i == 0) || i + rep > total ||
                     nbp + xb > hard;
    if (!bad) {
      for (int k = lane; k < rep; k += 32) sm.lens[i + k] = val;
      prev = val;
    }
    br.consume(xb);
    bp = nbp + xb;
    i += rep;
    ok = !bad;
  }
  s.bit_pos = bp;
  __syncwarp();
  if (!ok) return false;
  const bool ll_ok = build_table(sm.lens, num_litlen, sm.ll, sm.cursor, lane);
  const bool of_ok =
      build_table(sm.lens + num_litlen, num_offsets, sm.of, sm.cursor, lane);
  if (!(ll_ok && of_ok)) return false;
  build_root<kLLR>(sm.ll, kLitLen, sm.ll_root, lane);
  pair_literals(sm.ll_root, lane);
  build_root<kOFR>(sm.of, kOffset, sm.of_root, lane);
  return true;
}

// One Huffman block's symbols (symbol_loop), up to its EOB or a failure.
// The buffer holds 32 or more bits at every step's start.
__device__ void symbol_loop(Bits& br, Ring& rg, const Table& ll,
                            const Table& of, const uint32_t* llr,
                            const uint32_t* ofr, State& s, int hard, Out& o,
                            const uint8_t* modt, int lane) {
  uint32_t e = llr[(uint32_t)br.buf & kLLM];
  while (true) {
    // one literal or a pair found at the root, within hard_limit, out_cap
    // and the window's half, with the ring ready: one branch.  Every lane
    // stores both bytes (the second is junk after a single literal), so
    // the store that overwrites the junk is the same lane's, later in its
    // own program order; a store by one lane over another lane's is
    // ordered only by a __syncwarp().
    const int len0 = (int)(e & 15), sym0 = (int)((e >> 4) & 511);
    const int pair = (int)((e >> kPairBit) & 1);
    if ((len0 != 0) & (sym0 < 256) & (s.bit_pos + len0 <= hard) &
        (o.op + pair < min(o.cap, o.flushed + kFlushB - 1)) &
        (br.g < rg.limit)) {
      br.consume(len0);
      s.bit_pos += len0;
      // the next lookup leaves before the stores: 21 or more bits remain
      const uint32_t en = llr[(uint32_t)br.buf & kLLM];
      br.refill(rg.ring);
      o.win[o.op & kWinM] = (uint8_t)sym0;
      o.win[(o.op + 1) & kWinM] = (uint8_t)(e >> 17);
      o.op += 1 + pair;
      e = en;
      continue;
    }
    // a match found at both roots, within every bound: one branch.  The
    // buffer and the word loaded after it hold the 64 bits from the
    // cursor (the buffer holds 32 or more), the whole match (at most 48)
    // and the next lookup's index, so both loads leave before the refills
    const uint64_t w64 = br.buf | ((uint64_t)br.nw << br.n);
    const int lxb0 = (int)((e >> 13) & 15), c1 = len0 + lxb0;
    const uint32_t oe0 = ofr[(uint32_t)(w64 >> c1) & kOFM];
    const int olen0 = (int)(oe0 & 15), oxb0 = (int)((oe0 >> 13) & 15);
    const int total = c1 + olen0 + oxb0;
    const uint32_t e_after = llr[(uint32_t)(w64 >> total) & kLLM];
    const int length0 =
        (int)(e >> 17) + (int)((uint32_t)(w64 >> len0) & ((1u << lxb0) - 1u));
    const int offset0 = (int)(oe0 >> 17) +
                        (int)((uint32_t)(w64 >> (c1 + olen0)) &
                              ((1u << oxb0) - 1u));
    if ((len0 != 0) & (sym0 >= 257) & (sym0 <= 285) & (olen0 != 0) &
        (((oe0 >> 4) & 511) < 30) & (offset0 <= o.op) &
        (s.bit_pos + total <= hard) & (o.op + length0 <= o.cap) &
        (br.g < rg.limit)) {
      br.consume(c1);
      br.refill(rg.ring);
      br.consume(olen0 + oxb0);
      br.refill(rg.ring);
      s.bit_pos += total;
      __syncwarp();                   // the window's stores before its loads
      copy_match(o.win, modt, o.op, offset0, length0, lane);
      o.op += length0;
      o.flush_if_full(lane);
      e = e_after;
      continue;
    }
    // every other step, as symbol_loop takes it, a pair as its first
    // literal
    if (br.g >= rg.limit) rg.advance(br.g, lane);
    bool ok;
    e = lookup(ll, kLitLen, first_of(e), (uint32_t)br.buf, ok);
    const int len = (int)(e & 15), sym = (int)((e >> 4) & 511);
    const int nbp = s.bit_pos + len;
    const bool bad = !ok || sym >= 286 || nbp > hard;
    br.consume(len);
    s.bit_pos = nbp;
    if (sym < 256) {
      if (o.op < o.cap) {
        const uint32_t en = llr[(uint32_t)br.buf & kLLM];
        br.refill(rg.ring);
        // written even when bad: the JAX decoder's do_lit ignores it
        o.win[o.op & kWinM] = (uint8_t)sym;
        ++o.op;
        if (!bad) {
          o.flush_if_full(lane);
          e = en;
          continue;
        }
        s.result = kBad;
      } else {
        s.result = bad ? kBad : kInsufficient;
      }
      s.running = false;
      return;
    }
    if (sym == 256 || bad) {
      if (bad) {
        s.result = kBad;
        s.running = false;
      }
      br.refill(rg.ring);
      return;
    }
    // a length symbol: base and extra bits from its entry.  The offset's
    // root entry leaves before the refill (12 or more bits remain after
    // the extra bits); the refill leaves 32 or more, enough for the
    // offset's code and extra bits (at most 28), and the next lookup waits
    // for the second refill
    const int lxb = (int)((e >> 13) & 15);
    const int length =
        (int)(e >> 17) + (int)((uint32_t)br.buf & ((1u << lxb) - 1u));
    const uint32_t oroot = ofr[(uint32_t)(br.buf >> lxb) & kOFM];
    br.consume(lxb);
    br.refill(rg.ring);
    bool ook;
    const uint32_t oe = lookup(of, kOffset, oroot, (uint32_t)br.buf, ook);
    const int olen = (int)(oe & 15), osym = (int)((oe >> 4) & 511);
    const int oxb = (int)((oe >> 13) & 15);
    const int offset = (int)(oe >> 17) +
                       (int)((uint32_t)(br.buf >> olen) & ((1u << oxb) - 1u));
    br.consume(olen + oxb);
    br.refill(rg.ring);
    e = llr[(uint32_t)br.buf & kLLM];
    s.bit_pos = nbp + lxb + olen + oxb;
    if (!ook || osym >= 30 || offset > o.op || s.bit_pos > hard) {
      s.result = kBad;
      s.running = false;
      return;
    }
    if (o.op + length > o.cap) {
      s.result = kInsufficient;
      s.running = false;
      return;
    }
    __syncwarp();                     // the window's stores before its loads
    copy_match(o.win, modt, o.op, offset, length, lane);
    o.op += length;
    o.flush_if_full(lane);
  }
}

__global__ void __launch_bounds__(32)
    fsm_decode_kernel(const uint8_t* __restrict__ bufs, int N,
                      const int* __restrict__ in_lens, int out_cap,
                      uint8_t* out, int* out_lens, int* consumed,
                      int* result) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int in_nbytes = in_lens[b];
  const uint8_t* row = bufs + (size_t)b * N;
  const int lead = (int)(reinterpret_cast<uintptr_t>(row) & 3);
  Ring rg{row, reinterpret_cast<const uint32_t*>(row - lead), lead,
          min(max(in_nbytes, 0), N), sm.ring, 0, 0};
  Out o{sm.win, out + (size_t)b * out_cap, out_cap, 0, 0};
  const long long total_bits = (long long)in_nbytes * 8;
  // the implicit-zero overread budget; bit positions stay below 2^31
  const int hard = (int)max(min(total_bits + 49, (long long)INT_MAX),
                            (long long)INT_MIN);

  rg.advance(0, lane);
  for (int d = 1; d < 32; ++d) sm.modt[d * 32 + lane] = (uint8_t)(lane % d);
  for (int k = lane; k < kMaxSyms + 32; k += 32)
    sm.lens[k] = k < 144 ? 8 : k < 256 ? 9 : k < 280 ? 7 : k < 288 ? 8 : 5;
  __syncwarp();
  build_table(sm.lens, kMaxSyms, sm.st_ll, sm.cursor, lane);
  build_table(sm.lens + kMaxSyms, 32, sm.st_of, sm.cursor, lane);
  build_root<kLLR>(sm.st_ll, kLitLen, sm.st_ll_root, lane);
  pair_literals(sm.st_ll_root, lane);
  build_root<kOFR>(sm.st_of, kOffset, sm.st_of_root, lane);
  Bits br;
  br.seek(sm.ring, 8 * lead);

  State s{0, kOk, true};
  bool is_final = false;
  while (s.running && !is_final) {
    if (br.g >= rg.limit) rg.advance(br.g, lane);
    const uint32_t bits = (uint32_t)br.buf;
    is_final = bits & 1;
    const int btype = (int)((bits >> 1) & 3);
    const bool overran = s.bit_pos + 3 > hard;
    br.consume(3);
    s.bit_pos += 3;
    br.refill(rg.ring);
    if (overran || btype == 3) {
      s.result = kBad;
      s.running = false;
    } else if (btype == 0) {
      const int byte = (s.bit_pos + 7) >> 3;
      br.consume(byte * 8 - s.bit_pos);
      br.refill(rg.ring);
      const uint32_t w = (uint32_t)br.buf;
      const int length = (int)(w & 0xFFFF);
      const bool ok = (length ^ 0xFFFF) == (int)(w >> 16);
      const bool fits_in = byte + 4 + length <= in_nbytes;
      const bool fits_out = (long long)o.op + length <= out_cap;
      s.running = ok && fits_in && fits_out;
      if (s.running) {
        __syncwarp();
        copy_stored(rg, byte + 4, length, o, lane);
        s.bit_pos = (byte + 4 + length) * 8;
        br.skip(rg, 32 + 8 * length, lane);
      } else {
        s.result = ok && !fits_out ? kInsufficient : kBad;
      }
    } else {
      const Table* ll = &sm.st_ll;
      const Table* of = &sm.st_of;
      const uint32_t* llr = sm.st_ll_root;
      const uint32_t* ofr = sm.st_of_root;
      bool good = true;
      if (btype == 2) {
        good = dynamic_header(br, rg, s, hard, sm, lane);
        ll = &sm.ll;
        of = &sm.of;
        llr = sm.ll_root;
        ofr = sm.of_root;
        br.refill(rg.ring);
      }
      if (good) {
        symbol_loop(br, rg, *ll, *of, llr, ofr, s, hard, o, sm.modt, lane);
      } else {
        s.result = kBad;
        s.running = false;
      }
    }
  }
  cp_async_wait_all();
  o.finish(lane);
  if (lane == 0) {
    const bool ok = s.running && s.bit_pos <= total_bits;
    out_lens[b] = o.op;
    consumed[b] = min((s.bit_pos + 7) >> 3, in_nbytes);
    result[b] = ok ? kOk : s.result == kOk ? kBad : s.result;
  }
}

}  // namespace

// bufs uint8 [B][N], in_lens int32 [B], out uint8 [B][out_cap] (written
// whole), out_lens/consumed/result int32 [B].  One block of one warp a
// stream, with fsm_decode_smem_bytes() of dynamic shared memory.  Returns
// the CUDA error of the launch.
extern "C" int fsm_decode_launch(const uint8_t* bufs, int B, int N,
                                 const int* in_lens, int out_cap,
                                 uint8_t* out, int* out_lens, int* consumed,
                                 int* result, void* stream) {
  // the shared-memory limit, raised at the first launch on each device (a
  // bit per device; one past the 64th raises it at every launch)
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(fsm_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit);
  }
  if (B > 0)
    fsm_decode_kernel<<<B, 32, sizeof(Smem), (cudaStream_t)stream>>>(
        bufs, N, in_lens, out_cap, out, out_lens, consumed, result);
  return (int)cudaGetLastError();
}

// the kernel's dynamic shared memory a block, in bytes
extern "C" int fsm_decode_smem_bytes() { return (int)sizeof(Smem); }
