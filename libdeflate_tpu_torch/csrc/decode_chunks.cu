// Scalar raw-DEFLATE decoder (K3), for Hopper (sm_90a).
//
// Replaces libdeflate_tpu/decompress/pallas_decode.py::decompress_chunks_pallas
// (kernel body _decode_kernel, table builder _build_table_scalar).  Plain
// version: decode_chunks_plain in libdeflate_tpu_torch/decompress/decode.py,
// which this file follows step for step.
//
// What it computes: for each chunk b, the raw-DEFLATE stream in the padded
// words comp[b, :W] (comp_len[b] bytes, zero-padded by at least 2048 words)
// decoded into out[b, :out_bytes]; status (0 OK, 1 BAD_DATA), the output
// length and the consumed bytes min((t+7)>>3, comp_len) per chunk.  In
// known-size mode an output length other than out_len[b] is BAD_DATA.
// Every observable result equals the Pallas kernel's, so the control flow
// and bounds are the reference's: the block loop, the literal burst of at
// most min(max(bits_left-64,0)>>4, max(room-8,0)>>1) entries (room counts
// to the next 32 KiB boundary and to out_len) followed by one item, the
// decode-past-end guard, the stored copy bounded by the staged window, and
// the staging base bb itself, carried as bookkeeping: it moves exactly
// where the reference's ensure() moves it, while the ring runs ahead.
//
// What bounds it on this card: bytes, in principle -- each compressed byte
// read once and each output byte written once, a few microseconds of HBM
// time for a 16 MiB batch.  In practice the serial dependence of DEFLATE
// rules: every symbol's bit position depends on the previous symbol, so a
// chunk is a chain of dependent shared-memory table loads, one load
// latency per lookup at best, and at B = 16 chunks 16 of 132 SMs work.
//
// Design: one warp per chunk, on the reader of the tokenize-only kernel
// (K4, inflate_common.cuh): the row staged into a 16 KiB shared ring by
// cp.async, a 64-bit bit buffer in registers, the table builds split over
// the lanes, and K4's token loop (the next entry loaded before the tests
// that gate it, one exit branch per item, branch-free refills).  Output
// goes to a 64 KiB LZ window in shared memory, as the reference keeps it:
// twice the DEFLATE window, so a match source (at most 32 KiB back) is
// always live.  When the output crosses a 32 KiB boundary the warp
// flushes the finished half to out in 16-byte stores; at the end, on a
// failure too, it flushes [flushed, min(op, out_bytes)), so out holds
// every decoded byte below out_len and the caller's zeros after it.  Bytes
// past out_bytes stay in the window for later matches and are never
// written.  The stores stay off the token chain, which only table loads
// and the bit buffer feed, and add no branch to it: every lane stores a
// burst literal's two bytes, and an item is one masked load and one store
// a lane (byte k of the item from op - dist + k, or a literal's byte),
// which is the whole of a match no nearer than 32 and at most 32 long;
// the others (3% of the matches of zlib-6 text, 0.5% of skew) take
// copy_match, where byte op + i comes from op - dist + (i mod dist), a
// byte that existed before the match, so a short period repeats without a
// byte-by-byte chain and 32 bytes move a step.  Bytes stored past the
// output's end are junk that later stores overwrite before anything reads
// them.  One __syncwarp() at each item's start orders the window stores
// before the item's load.
// A stored block is copied by the lanes from the ring under the
// reference's bounds, and the next block restages the ring at its landing
// segment.  The window, K4's shared state and a small modulo table take
// ~100 KB of dynamic shared memory, so the launch raises the kernel's
// limit once per device.

#include <atomic>

#include "inflate_common.cuh"

namespace {

constexpr int kWinB = 65536;         // the LZ window: output byte p at p & kWinM
constexpr int kWinM = kWinB - 1;

struct DecSmem {
  uint8_t win[kWinB];     // at offset 0: 16-byte aligned for the flush
  WarpSmem w;
  uint8_t modt[32 * 32];  // modt[d * 32 + k] = k % d, for 1 <= d < 32
};

// The chunk's output: the window, the row of out and how much of it holds
// its bytes.
struct Out {
  uint8_t* win;
  uint8_t* dst;
  int out_bytes;
  int op;        // bytes decoded
  int flushed;   // bytes of out written, a multiple of kFlushB until the end

  // out[flushed, min(to, out_bytes)) from the window, by all lanes: 16-byte
  // stores where the row allows them, 4-byte ones where it does not (out_bytes
  // is a multiple of 4), single bytes for the tail.  to - flushed <= kFlushB
  // (a finished half, or the rest at the end), so the span is contiguous in
  // the window.
  __device__ void flush(int to, int lane) {
    const int n = min(to, out_bytes) - flushed;
    __syncwarp();
    if (n > 0) {
      const uint8_t* src = win + (flushed & kWinM);
      uint8_t* d = dst + flushed;
      int done;
      if (!(reinterpret_cast<uintptr_t>(d) & 15)) {
        for (int k = lane; k < n >> 4; k += 32)
          reinterpret_cast<uint4*>(d)[k] = reinterpret_cast<const uint4*>(src)[k];
        done = n & ~15;
      } else {
        for (int k = lane; k < n >> 2; k += 32)
          reinterpret_cast<uint32_t*>(d)[k] =
              reinterpret_cast<const uint32_t*>(src)[k];
        done = n & ~3;
      }
      for (int k = done + lane; k < n; k += 32) d[k] = src[k];
    }
    __syncwarp();
  }
};

// Window bytes [op, op + len) of a match at distance dist (1 <= dist <= op),
// by the warp.  It reads only bytes below op, which the item's
// __syncwarp() has ordered after their stores.  Warp-uniform.
__device__ __forceinline__ void copy_match(uint8_t* win, const uint8_t* modt,
                                           int op, int dist, int len,
                                           int lane) {
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

// do_stored, from the bit after the block header; the buffer holds 45 or
// more bits from t.  The copy runs in pieces bounded by the staged window,
// the next 32 KiB boundary and what is left, each from the ring.
__device__ int dec_stored(Bits& br, Ring& rg, Out& o, int olen, int base_max,
                          int& t, int& bb, int lane) {
  const int t2 = (t + 7) & ~7;
  ensure(t2, 1, base_max, bb);
  br.consume(t2 - t);
  const uint32_t v = (uint32_t)br.buf;
  const int ln = (int)(v & 0xFFFF);
  int ib = (t2 + 32) >> 3;
  t = ib << 3;
  if ((uint32_t)(ln ^ 0xFFFF) != ((v >> 16) & 0xFFFF) ||
      (long long)o.op + ln > olen)
    return kBad;
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(rg.ring);
  int rem = ln;
  while (rem > 0) {
    ensure(ib << 3, 3, base_max, bb);
    const int stage_left = 4 * (bb + kStageW) - ib - 8;
    if (stage_left <= 0) return kBad;
    const int room =
        min(min(stage_left, kFlushB - (o.op & (kFlushB - 1))), rem);
    // bb <= ib / 4, so the piece lies within the 2560 words made readable
    rg.advance(ib >> 2, lane);
    __syncwarp();
    for (int k = lane; k < room; k += 32)
      o.win[(o.op + k) & kWinM] = rb[(ib + k) & (4 * kRingW - 1)];
    __syncwarp();
    ib += room;
    rem -= room;
    t = ib << 3;
    o.op += room;
    if (o.op - o.flushed >= kFlushB) {
      o.flush(o.flushed + kFlushB, lane);
      o.flushed += kFlushB;
    }
  }
  return kOK;
}

// do_huffman: table setup, then the group loop of a literal burst and one
// item, K4's loop with the output written.  A burst never reaches the
// next 32 KiB boundary (it stops 8 bytes short), so only an item crosses
// one, by at most 258 bytes, and the half behind it is flushed at the
// item's exit branch.
__device__ int dec_huffman(Bits& br, Ring& rg, DecSmem& sm, Out& o, int btype,
                           int olen, int guard, int base_max, int& bb,
                           int lane) {
  if (!read_tables_warp(br, rg.ring, sm.w, btype, base_max, bb, lane))
    return kBad;
  const uint32_t* ll = sm.w.ll;
  const uint32_t* of = sm.w.of;
  uint8_t* win = o.win;
  // the block's start made words up to 2560 past it readable, and the
  // table setup read at most ~150 of them: enough for the first iteration
  br.fill48(rg.ring);
  uint32_t e = ll[(uint32_t)br.buf & kLLM];
  for (;;) {
    const int t = br.pos();
    const int tw = t >> 5;
    ensure(t, 3, base_max, bb);
    // past the guard the iteration still runs, then the loop stops
    const bool past_guard = tw > guard;
    const int room = min(kFlushB - (o.op & (kFlushB - 1)), olen - o.op);
    int nn = min(max(((bb + kStageW - 1) << 5) - t - 64, 0) >> 4,
                 max(room - 8, 0) >> 1);
    // the burst: a literal takes at most kLTB bits and one halfword comes
    // back, so 48 or more bits stay valid at every lookup
    uint32_t h = ring_half(rg.ring, br.nh);
    int op = o.op;
    for (;;) {
      const int c = (int)(e & 0xFF);
      const uint32_t en = ll[((uint32_t)br.buf >> c) & kLLM];
      if ((e & 0x3000) | (nn <= 0)) break;
      // every lane stores both bytes (a single literal's second is junk
      // past op), so each lane has written every burst literal itself
      win[op & kWinM] = (uint8_t)(e >> 16);
      win[(op + 1) & kWinM] = (uint8_t)(e >> 24);
      op += 1 + (int)((e >> 14) & 1);
      --nn;
      br.n -= c;
      const bool r = br.n < 48;
      br.buf = (br.buf >> c) | ((uint64_t)h << br.n);
      br.nh += r;
      br.n += r ? 16 : 0;
      h = ring_half(rg.ring, br.nh);
      e = en;
    }
    o.op = op;

    // One item: a literal, a match, the EOB or a bad codeword.  As in K4
    // the offset entry is loaded before the subtable test (one branch for
    // both tables) and the next iteration's entry before the item's tests;
    // every shift below is under 32 (an item reads at most 48 bits).  The
    // __syncwarp() orders every window store before it (other lanes' item
    // bytes) before the item's window load, and waits off the chain.
    __syncwarp();
    const uint64_t v = ring_bits48(rg.ring, br.nh);
    const uint32_t w = (uint32_t)br.buf;
    uint32_t consume = e & 0xFF;
    uint32_t oe = of[(w >> consume) & kOFM];
    if (((e & 0x3000) == (kSub << 12)) | ((oe & 0x3000) == (kSub << 12))) {
      if ((e & 0x3000) == (kSub << 12)) {
        e = ll[(e >> 16) + ((w >> kLTB) & low_mask((e >> 8) & 0xF))];
        consume = e & 0xFF;
        oe = of[(w >> consume) & kOFM];
      }
      if ((oe & 0x3000) == (kSub << 12))
        oe = of[(oe >> 16) + (((uint32_t)(br.buf >> consume) >> kOTB) &
                              low_mask((oe >> 8) & 0xF))];
    }
    const uint32_t kind = (e >> 12) & 3;
    const uint32_t ocons = oe & 0xFF, ocl = (oe >> 8) & 0xF;
    const bool is_mat = kind == kBase;
    const int adv = (int)consume + (is_mat ? (int)ocons : 0);
    const uint32_t w2 = (uint32_t)(br.buf >> consume);
    uint32_t e_next;
    {
      const int n1 = br.n - adv;
      e_next = ll[((uint32_t)(br.buf >> adv) |
                   __funnelshift_lc(0u, (uint32_t)v, (uint32_t)n1)) &
                  kLLM];
      const int kf = (63 - n1) >> 4;
      br.buf = (br.buf >> adv) | (v << n1);
      br.n = n1 + 16 * kf;
      br.nh += kf;
    }
    const uint32_t dist =
        (oe >> 16) + ((w2 >> ocl) & ((1u << (ocons - ocl)) - 1));
    // byte op - dist + lane of the window, masked, so any item may load it
    const uint8_t cb = win[(o.op - (int)dist + lane) & kWinM];
    const uint32_t cl = (e >> 8) & 0xF, payload = e >> 16;
    const bool is_lit = kind == kLit;
    const bool is_eob = (kind == kEob) & (payload == 0);
    const bool is_badk = ((kind == kEob) & (payload != 0)) | (kind == kSub);
    const int length =
        (int)(payload + ((w >> cl) & ((1u << ((consume - cl) & 31)) - 1)));
    const int nb = 1 + (int)((e >> 14) & 1);
    // op stays in [0, max(olen, 0)], so dist > op compares as unsigned
    const int room_item = olen - o.op;
    const bool bad =
        is_badk |
        (is_mat & ((((oe >> 12) & 3) != kBase) | (dist > (uint32_t)o.op) |
                   (length > room_item))) |
        (is_lit & (nb > room_item));
    // The item's bytes, with no branch: lane k stores window byte op + k,
    // byte k & 1 of a literal item or cb.  That is the whole of a match at
    // most 32 bytes long and no nearer than 32; copy_match redoes the
    // others.  Bytes past the item's end are junk that later stores
    // overwrite before anything reads or flushes them: by the same lane
    // (both bytes of a burst literal, the copy's first step) or after the
    // next item's __syncwarp().
    win[(o.op + lane) & kWinM] =
        is_lit ? (uint8_t)(e >> (16 + 8 * (lane & 1))) : cb;
    if (is_mat & !bad & ((dist < 32) | (length > 32)))
      copy_match(win, sm.modt, o.op, (int)dist, length, lane);
    o.op += (bad | is_eob) ? 0 : (is_lit ? nb : length);
    e = e_next;
    const int twn = br.pos() >> 5;
    const bool full = o.op - o.flushed >= kFlushB;
    if (bad | past_guard | is_eob | (twn >= rg.limit) | full) {
      if (full) {
        o.flush(o.flushed + kFlushB, lane);
        o.flushed += kFlushB;
      }
      if (bad | past_guard | is_eob) return (bad | past_guard) ? kBad : kOK;
      rg.advance(twn, lane);
    }
  }
}

__global__ void __launch_bounds__(32)
decode_chunks_kernel(const uint32_t* __restrict__ comp, int W, int Wp,
                     const int* __restrict__ comp_len,
                     const int* __restrict__ out_len, int strict,
                     const int* __restrict__ consts, uint8_t* out,
                     int out_bytes, int* status_out, int* olen_out,
                     int* cons_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DecSmem& sm = *reinterpret_cast<DecSmem*>(smem_raw);
  const int b = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < kNConsts; i += 32) sm.w.consts[i] = consts[i];
  for (int d = 1; d < 32; ++d) sm.modt[d * 32 + lane] = (uint8_t)(lane % d);
  __syncwarp();
  Out o{sm.win, out + (size_t)b * out_bytes, out_bytes, 0, 0};
  const int clen = comp_len[b];
  const int olen = out_len[b];
  const long long in_words = ((long long)clen + 3) >> 2;
  int status = kOK, t = 0, cons = 0;
  if (clen < 0 || in_words + kStageW > W) {
    // outside the input contract: no decode
    status = kBad;
  } else {
    const int guard = (int)in_words + kStageW;
    const int base_max = Wp - kStageW;
    Ring rg{comp + (size_t)b * W, W, Wp, sm.w.ring, 0, 0};
    Bits br;
    int bb = 0;
    for (;;) {
      if ((t >> 5) >= Wp) { status = kBad; break; }
      ensure(t, 1, base_max, bb);
      rg.advance(t >> 5, lane);
      br.seek(rg.ring, t);
      const uint32_t hdr = (uint32_t)br.buf;
      br.consume(3);
      t += 3;
      const int btype = (int)((hdr >> 1) & 3);
      int stat;
      if (btype == 0) {
        stat = dec_stored(br, rg, o, olen, base_max, t, bb, lane);
      } else if (btype == 3) {
        stat = kBad;
      } else {
        stat = dec_huffman(br, rg, sm, o, btype, olen, guard, base_max, bb,
                           lane);
        t = br.pos();
      }
      if (stat != kOK) { status = stat; break; }
      if (hdr & 1) break;
    }
    cp_async_wait_all();
    if (status == kOK && strict && o.op != olen) status = kBad;
    cons = min((t + 7) >> 3, clen);
  }
  // the rest of the output, on a failure too
  o.flush(o.op, lane);
  if (lane == 0) {
    status_out[b] = status;
    olen_out[b] = o.op;
    cons_out[b] = cons;
  }
}

}  // namespace

// comp uint32 [B][W] (W >= 2048), comp_len/out_len int32 [B], consts int32
// [457], out uint8 [B][out_bytes] (zeroed by the caller, out_bytes a
// multiple of 4), status/out_lens/consumed int32 [B].  One block of one
// warp per chunk, with sizeof(DecSmem) bytes of dynamic shared memory.
// Returns the CUDA error of the launch.
extern "C" int decode_chunks_launch(const uint32_t* comp, int B, int W,
                                    int Wp, const int* comp_len,
                                    const int* out_len, int strict,
                                    const int* consts, uint8_t* out,
                                    int out_bytes, int* status, int* out_lens,
                                    int* consumed, void* stream) {
  // the shared-memory limit, raised at the first launch on each device (a
  // bit per device; one past the 64th raises it at every launch)
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(decode_chunks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(DecSmem));
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit);
  }
  if (B > 0)
    decode_chunks_kernel<<<B, 32, sizeof(DecSmem), (cudaStream_t)stream>>>(
        comp, W, Wp, comp_len, out_len, strict, consts, out, out_bytes,
        status, out_lens, consumed);
  return (int)cudaGetLastError();
}
