// Shared parts of the scalar DEFLATE kernels: the decoder (K3,
// decode_chunks.cu) and its tokenize-only ceiling (K4, tokenize_chunks.cu).
//
// They follow libdeflate_tpu/decompress/pallas_decode.py (ensure,
// _make_entry, _build_table_scalar, do_huffman's table setup) and their
// plain versions in libdeflate_tpu_torch/decompress/tables.py and decode.py
// step for step.  The staging-base bookkeeping (ensure) and the packed
// table entry (make_entry) serve both kernels, and so does the one reader,
// on one warp per chunk: the row staged into a shared-memory ring by
// cp.async (Ring), a 64-bit bit buffer in registers (Bits), and the table
// build split over the 32 lanes (build_table_warp, read_tables_warp), with
// the tables in shared memory.  They give the same tables, bits consumed
// and staging-base moves as the reference's one-thread reader.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLTB = 11, kOTB = 8, kPTB = 7;
constexpr int kLLSize = (1 << kLTB) + 294;
constexpr int kOFSize = (1 << kOTB) + 146;
constexpr int kPreSize = 1 << kPTB;
constexpr int kStageW = 2048;
constexpr int kFlushB = 32768;
constexpr uint32_t kLit = 0, kBase = 1, kEob = 2, kSub = 3;
constexpr uint32_t kLLM = (1u << kLTB) - 1, kOFM = (1u << kOTB) - 1;
constexpr int kOK = 0, kBad = 1;
// the packed constant table (decompress/tables.py CONSTS)
constexpr int kNConsts = 457;
constexpr int kCLB = 0, kCLE = 29, kCOB = 58, kCOE = 88, kCPP = 118,
              kCSL = 137;

__device__ __forceinline__ uint32_t low_mask(uint32_t n) {
  return n >= 32u ? 0xFFFFFFFFu : (1u << n) - 1u;
}

// the reference's ensure(): move the staging base when word(t) + margin
// leaves the window [base, base + STAGE_W)
__device__ __forceinline__ void ensure(int t, int margin, int base_max,
                                       int& bb) {
  const int tw = t >> 5;
  if (tw + margin - bb >= kStageW) bb = (min(tw, base_max) >> 10) << 10;
}

__device__ uint32_t make_entry(int role, int sym, int len, const int* c) {
  const uint32_t l = (uint32_t)len;
  if (role == 0) return ((uint32_t)sym << 16) | (l << 8) | l;
  const uint32_t bad = (1u << 16) | (kEob << 12) | (l << 8) | l;
  if (role == 1) {
    if (sym < 256) return ((uint32_t)sym << 16) | (kLit << 12) | (l << 8) | l;
    if (sym == 256) return (kEob << 12) | (l << 8) | l;
    if (sym > 285) return bad;
    const int ls = sym - 257;
    return ((uint32_t)c[kCLB + ls] << 16) | (kBase << 12) | (l << 8) |
           (l + (uint32_t)c[kCLE + ls]);
  }
  if (sym >= 30) return bad;
  return ((uint32_t)c[kCOB + sym] << 16) | (kBase << 12) | (l << 8) |
         (l + (uint32_t)c[kCOE + sym]);
}

// ---- the reader and the warp table build ------------------------------

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSegW = 512;                   // words per ring segment
constexpr int kRingSegs = 8;                 // 16 KiB of ring
constexpr int kRingW = kSegW * kRingSegs;
constexpr int kRingAhead = 2;                // segments left in flight
constexpr int kRingHMask = 2 * kRingW - 1;   // the ring in halfwords

struct WarpSmem {
  uint32_t ll[kLLSize];
  uint32_t of[kOFSize];
  uint32_t pre[kPreSize];
  uint32_t ring[kRingW];
  int lens[320];
  int plens[19];
  int consts[kNConsts];
  int count[17];    // symbols per code length
  int offs[16];     // sorted position of a length's first symbol
  int fcode[16];    // its canonical code
  int rank[288];    // a symbol's rank among those of its length
  int order[288];   // sorted position -> symbol, codes longer than the root
};

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

// The padded row in a ring of kRingSegs segments of kSegW words: segment
// s (words [s * kSegW, (s + 1) * kSegW) of the row, zero past W and word
// W_pad - 1 again past W_pad) lives in slot s % kRingSegs.  Segments [0, issued) have been
// copied in by cp.async, the last kRingAhead of them maybe still in
// flight.  The cursor never moves back, so a slot is reused once the
// cursor has passed its segment.
struct Ring {
  const uint32_t* row;
  int W;
  int Wp;
  uint32_t* ring;
  int issued;
  int limit;   // the first cursor word at which advance has work

  // one segment, kSegW / 32 words a lane: cp.async where the word lies in
  // the row, a direct zero store in the padding past W
  __device__ void issue(int seg, int lane) {
    uint32_t* dst = ring + (seg & (kRingSegs - 1)) * kSegW;
    const int w0 = seg * kSegW;
    for (int k = lane; k < kSegW; k += 32) {
      const int j = min(w0 + k, Wp - 1);
      if (j < W)
        cp_async4(dst + k, row + j);
      else
        dst[k] = 0u;
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

__device__ __forceinline__ uint32_t ring_half(const uint32_t* ring, int h) {
  return reinterpret_cast<const uint16_t*>(ring)[h & kRingHMask];
}

// 48 or more bits of the row from halfword h on, from the two words that
// hold them
__device__ __forceinline__ uint64_t ring_bits48(const uint32_t* ring, int h) {
  const int i = h >> 1;
  const uint64_t pair = (uint64_t)ring[i & (kRingW - 1)] |
                        ((uint64_t)ring[(i + 1) & (kRingW - 1)] << 32);
  return pair >> ((h & 1) << 4);
}

// The bit buffer: bits [pos, pos + n) of the row in the low n bits of buf;
// the bits above them are zero or the row's own next bits, so a refill
// may OR halfwords in at n that are already there.  nh is the next
// halfword to load.  n < 64.
struct Bits {
  uint64_t buf;
  int n;
  int nh;

  __device__ __forceinline__ int pos() const { return (nh << 4) - n; }

  __device__ __forceinline__ void consume(int c) {
    buf >>= c;
    n -= c;
  }

  // top up to 48..63 valid bits with 0-3 halfwords, no branch: the three
  // loads do not wait for n
  __device__ __forceinline__ void fill48(const uint32_t* ring) {
    const uint64_t v = (uint64_t)ring_half(ring, nh) |
                       ((uint64_t)ring_half(ring, nh + 1) << 16) |
                       ((uint64_t)ring_half(ring, nh + 2) << 32);
    const int k = (63 - n) >> 4;
    buf |= (v & ((1ull << (16 * k)) - 1)) << n;
    nh += k;
    n += 16 * k;
  }

  // restart at bit t of the row
  __device__ __forceinline__ void seek(const uint32_t* ring, int t) {
    buf = ring_half(ring, t >> 4) >> (t & 15);
    n = 16 - (t & 15);
    nh = (t >> 4) + 1;
    fill48(ring);
  }
};

// tables.build_table (_build_table_scalar) on the 32 lanes of a warp: the
// same table, entry for entry, wherever a lookup can reach it.
// Warp-uniform; returns ok.
__device__ bool build_table_warp(const int* lens, int nsyms, int role,
                                 uint32_t* table, WarpSmem& sm, int lane) {
  const int tb = role == 0 ? kPTB : role == 1 ? kLTB : kOTB;
  const int enough = role == 0 ? kPreSize : role == 1 ? kLLSize : kOFSize;
  const int nt = 1 << tb;
  const unsigned below = (1u << lane) - 1;
  if (lane < 17) sm.count[lane] = 0;
  __syncwarp();
  // each symbol's rank among the symbols of its length, in symbol order
  for (int i0 = 0; i0 < nsyms; i0 += 32) {
    const int i = i0 + lane;
    const int l = i < nsyms ? lens[i] : 0;
    const unsigned m = __match_any_sync(kFull, l);
    const int before = sm.count[l];
    __syncwarp();
    if (l > 0) {
      sm.rank[i] = before + __popc(m & below);
      if (!(m & below)) sm.count[l] = before + __popc(m);
    }
    __syncwarp();
  }
  const bool len_lane = lane >= 1 && lane < 16;
  const int cnt = len_lane ? sm.count[lane] : 0;
  const int space = __reduce_add_sync(kFull, len_lane ? cnt << (15 - lane)
                                                      : 0);
  if (space != 1 << 15) {
    // zlib-lax: the empty code and one length-1 codeword are accepted
    const bool bad = space != 0 && (space != (1 << 14) || sm.count[1] != 1);
    int sym = -1;
    for (int i0 = 0; i0 < nsyms && sym < 0; i0 += 32) {
      const unsigned one = __ballot_sync(
          kFull, i0 + lane < nsyms && lens[i0 + lane] == 1);
      if (one) sym = i0 + __ffs(one) - 1;
    }
    if (space == 0 || sym < 0) sym = 0;
    const uint32_t e = make_entry(role, sym, 1, sm.consts);
    for (int i = lane; i < nt; i += 32) table[i] = e;
    __syncwarp();
    return !bad;
  }
  const int total = __reduce_add_sync(kFull, cnt);
  if (len_lane) {
    int o = 0, c = 0;
    for (int j = 1; j < lane; ++j) {
      o += sm.count[j];
      c = (c + sm.count[j]) << 1;
    }
    sm.offs[lane] = o;
    sm.fcode[lane] = c;
  }
  __syncwarp();

  // root entries: a lane fills its own symbol's (at most 16), all lanes
  // together one symbol's 32 or more; codes past the root go to order[]
  for (int i0 = 0; i0 < nsyms; i0 += 32) {
    const int i = i0 + lane;
    const int l = i < nsyms ? lens[i] : 0;
    int rc = 0;
    uint32_t e = 0;
    if (l > 0) {
      rc = (int)(__brev((uint32_t)(sm.fcode[l] + sm.rank[i])) >> (32 - l));
      if (l <= tb)
        e = make_entry(role, i, l, sm.consts);
      else
        sm.order[sm.offs[l] + sm.rank[i]] = i;
    }
    if (l > 0 && l <= tb && tb - l <= 4)
      for (int idx = rc; idx < nt; idx += 1 << l) table[idx] = e;
    unsigned wide = __ballot_sync(kFull, l > 0 && tb - l > 4);
    while (wide) {
      const int src = __ffs(wide) - 1;
      wide &= wide - 1;
      const int wl = __shfl_sync(kFull, l, src);
      const int wrc = __shfl_sync(kFull, rc, src);
      const uint32_t we = __shfl_sync(kFull, e, src);
      for (int idx = wrc + (lane << wl); idx < nt; idx += 32 << wl)
        table[idx] = we;
    }
  }
  __syncwarp();

  // one subtable per shared root prefix, in canonical order: lane 0 lays
  // out the pointers, then each lane fills its long symbols' entries
  int ok = 1;
  if (lane == 0) {
    const int mask = nt - 1;
    auto code_at = [&](int k, int& l) {
      l = lens[sm.order[k]];
      return (int)(__brev((uint32_t)(sm.fcode[l] + k - sm.offs[l])) >>
                   (32 - l));
    };
    int cur = nt, k = sm.offs[tb + 1];
    while (k < total) {
      int l;
      const int prefix = code_at(k, l) & mask;
      int lmax = l, j = k + 1;
      while (j < total) {
        int lj;
        if ((code_at(j, lj) & mask) != prefix) break;
        lmax = lj;
        ++j;
      }
      const int sub_bits = lmax - tb;
      const int start = cur;
      cur += 1 << sub_bits;
      if (cur > enough) {
        ok = 0;
        break;
      }
      table[prefix] = ((uint32_t)start << 16) | (kSub << 12) |
                      ((uint32_t)sub_bits << 8);
      k = j;
    }
  }
  ok = __shfl_sync(kFull, ok, 0);
  __syncwarp();
  if (!ok) return false;
  for (int i0 = 0; i0 < nsyms; i0 += 32) {
    const int i = i0 + lane;
    const int l = i < nsyms ? lens[i] : 0;
    if (l > tb) {
      const int rc =
          (int)(__brev((uint32_t)(sm.fcode[l] + sm.rank[i])) >> (32 - l));
      const uint32_t p = table[rc & (nt - 1)];
      const int start = (int)(p >> 16), sub_bits = (int)((p >> 8) & 0xF);
      const uint32_t e = make_entry(role, i, l, sm.consts);
      for (int idx = rc >> tb; idx < (1 << sub_bits); idx += 1 << (l - tb))
        table[start + idx] = e;
    }
  }
  __syncwarp();

  if (role == 1) {
    // two-literal pairing.  The serial pass runs in descending index order
    // and reads table[idx >> l1] before it is paired; here each lane
    // takes one index of 32, top chunk first, and every lane reads before
    // any writes.  A chunk's reads below it are of entries no later chunk
    // has written, and only the chunk at 0 reads inside itself.
    for (int base = nt - 32; base >= 0; base -= 32) {
      const int idx = base + lane;
      const uint32_t e1 = table[idx];
      const int l1 = (int)(e1 & 0xFF);
      const bool cand = ((e1 >> 12) & 3) == kLit && l1 >= 1 && l1 < tb &&
                        !(e1 & 0x4000);
      const uint32_t e2 = cand ? table[idx >> l1] : 0u;
      __syncwarp();
      const int l2 = (int)(e2 & 0xFF);
      if (cand && ((e2 >> 12) & 3) == kLit && !(e2 & 0x4000) &&
          l1 + l2 <= tb)
        table[idx] = ((e2 >> 16) << 24) | ((e1 >> 16) << 16) | (1u << 14) |
                     (kLit << 12) | (uint32_t)(l1 + l2);
    }
    __syncwarp();
  }
  return true;
}

// decode.read_tables on the bit buffer and the warp table build: the same
// tables, bits consumed and staging-base moves.  The caller has made the
// ring readable from the block's start.  Warp-uniform; returns ok.
__device__ bool read_tables_warp(Bits& br, const uint32_t* ring,
                                 WarpSmem& sm, int btype, int base_max,
                                 int& bb, int lane) {
  int num_ll, num_of;
  if (btype == 1) {
    for (int i = lane; i < 320; i += 32) sm.lens[i] = sm.consts[kCSL + i];
    __syncwarp();
    num_ll = 288;
    num_of = 32;
  } else {
    br.fill48(ring);
    ensure(br.pos(), 1, base_max, bb);
    const uint32_t v = (uint32_t)br.buf;
    num_ll = 257 + (int)(v & 31);
    num_of = 1 + (int)((v >> 5) & 31);
    const int num_pre = 4 + (int)((v >> 10) & 15);
    br.consume(14);
    if (lane < 19) sm.plens[lane] = 0;
    __syncwarp();
    for (int i = 0; i < num_pre; ++i) {
      br.fill48(ring);
      ensure(br.pos(), 1, base_max, bb);
      if (lane == 0) sm.plens[sm.consts[kCPP + i]] = (int)(br.buf & 7);
      br.consume(3);
    }
    __syncwarp();
    bool ok = build_table_warp(sm.plens, 19, 0, sm.pre, sm, lane);
    // RLE-decode the litlen + offset lengths; prev is lens[i - 1]
    const int total = num_ll + num_of;
    int i = 0, prev = 0;
    while (ok && i < total) {
      br.fill48(ring);
      ensure(br.pos(), 1, base_max, bb);
      const uint32_t e = sm.pre[(uint32_t)br.buf & (kPreSize - 1)];
      const int sym = (int)(e >> 16);
      br.consume((int)(e & 0xFF));
      ensure(br.pos(), 1, base_max, bb);
      const uint32_t w2 = (uint32_t)br.buf;
      if (sym < 16) {
        if (lane == 0) sm.lens[i] = sym;
        prev = sym;
        ++i;
        continue;
      }
      int rep, ebits, val = 0;
      if (sym == 16) {
        rep = 3 + (int)(w2 & 3);
        ebits = 2;
        val = prev;
      } else if (sym == 17) {
        rep = 3 + (int)(w2 & 7);
        ebits = 3;
      } else {
        rep = 11 + (int)(w2 & 127);
        ebits = 7;
      }
      if ((sym == 16 && i == 0) || i + rep > total) {
        ok = false;
      } else {
        for (int k = lane; k < rep; k += 32) sm.lens[i + k] = val;
        prev = val;
      }
      i += rep;
      br.consume(ebits);
    }
    __syncwarp();
    if (!ok) return false;
  }
  const bool ok_l = build_table_warp(sm.lens, num_ll, 1, sm.ll, sm, lane);
  const bool ok_o =
      build_table_warp(sm.lens + num_ll, num_of, 2, sm.of, sm, lane);
  return ok_l && ok_o;
}

}  // namespace
