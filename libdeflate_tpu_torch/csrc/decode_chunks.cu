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
// most min(max(bits_left-64,0)>>4, max(room-8,0)>>1) entries followed by
// one item, the decode-past-end guard, the stored copy bounded by the
// staged window, and the staging base itself, carried as bookkeeping
// although input is read straight from global memory.
//
// What bounds it on this card: bytes, in principle -- each compressed byte
// read once and each output byte written once, a few microseconds of HBM
// time for a 16 MiB batch.  In practice the serial dependence of DEFLATE
// rules: every symbol's bit position depends on the previous symbol, so a
// chunk is one thread's dependent chain of shared-memory table probes and
// global loads, and at B = 16 chunks the card is nearly idle.  This first
// version is right and simple and sits far above its bound.
//
// Design: one block of one thread per chunk.  The decode tables (litlen
// 2342, offset 402, precode 128 entries), the code lengths, the constants
// and the builder's scratch live in ~19 KB of static shared memory; the
// thread builds them for each block as the reference does.  Output goes
// straight to out, which holds the whole 32 KiB window, so there is no ring
// and no flush; overlapping matches copy forward byte by byte.  Bytes past
// out_bytes are dropped.  Shifts of 32 or more give 0, as XLA's do.

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
constexpr int kOK = 0, kBad = 1;
// the packed constant table (decompress/tables.py CONSTS)
constexpr int kNConsts = 457;
constexpr int kCLB = 0, kCLE = 29, kCOB = 58, kCOE = 88, kCPP = 118,
              kCSL = 137;

struct Smem {
  uint32_t ll[kLLSize];
  uint32_t of[kOFSize];
  uint32_t pre[kPreSize];
  int lens[320];
  int plens[19];
  int consts[kNConsts];
  int count[17];
  int order[288];
  int stash_rc[288];
  int stash_len[288];
  int stash_sym[288];
};

struct Input {
  const uint32_t* row;
  int W;       // words in the row
  int Wp;      // W rounded up to 1024 (the reference's W_pad)

  // word i of the zero-padded row; past W_pad, word W_pad - 1
  __device__ __forceinline__ uint32_t word(int i) const {
    const int j = min(i, Wp - 1);
    return j < W ? __ldg(row + j) : 0u;
  }
  // the 32 bits from bit t
  __device__ __forceinline__ uint32_t peek(int t) const {
    const int i = t >> 5, s = t & 31;
    return (word(i) >> s) | ((word(i + 1) << (31 - s)) << 1);
  }
  __device__ __forceinline__ uint32_t byte(int ib) const {
    return (word(ib >> 2) >> ((ib & 3) * 8)) & 0xFFu;
  }
};

__device__ __forceinline__ uint32_t shr(uint32_t x, uint32_t s) {
  return s >= 32u ? 0u : x >> s;
}

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

// _build_table_scalar / tables.build_table: returns ok
__device__ bool build_table(const int* lens, int nsyms, int role,
                            uint32_t* table, Smem& sm) {
  const int tb = role == 0 ? kPTB : role == 1 ? kLTB : kOTB;
  const int enough = role == 0 ? kPreSize : role == 1 ? kLLSize : kOFSize;
  int* count = sm.count;
  for (int l = 0; l < 17; ++l) count[l] = 0;
  for (int i = 0; i < nsyms; ++i)
    if (lens[i] > 0) count[lens[i]]++;
  int space = 0;
  for (int l = 1; l < 16; ++l) space += count[l] << (15 - l);

  if (space != 1 << 15) {
    // zlib-lax: the empty code and one length-1 codeword are accepted
    const bool bad = space != 0 && (space != (1 << 14) || count[1] != 1);
    int sym = -1;
    for (int i = 0; i < nsyms; ++i)
      if (lens[i] == 1) { sym = i; break; }
    if (space == 0 || sym < 0) sym = 0;
    const uint32_t e = make_entry(role, sym, 1, sm.consts);
    for (int i = 0; i < (1 << tb); ++i) table[i] = e;
    return !bad;
  }

  int acc = 0;
  for (int l = 1; l < 16; ++l) {
    const int c = count[l];
    count[l] = acc;
    acc += c;
  }
  for (int i = 0; i < nsyms; ++i) {
    const int l = lens[i];
    if (l > 0) sm.order[count[l]++] = i;
  }

  // canonical walk; codewords longer than tb go to the stash
  int code = 0, prev = 1, nstash = 0;
  for (int oi = 0; oi < acc; ++oi) {
    const int sym = sm.order[oi];
    const int l = lens[sym];
    code <<= l - prev;
    const int rc = (int)(__brev((uint32_t)code) >> (32 - l));
    if (l <= tb) {
      const uint32_t e = make_entry(role, sym, l, sm.consts);
      for (int idx = rc; idx < (1 << tb); idx += 1 << l) table[idx] = e;
    } else {
      sm.stash_rc[nstash] = rc;
      sm.stash_len[nstash] = l;
      sm.stash_sym[nstash] = sym;
      ++nstash;
    }
    ++code;
    prev = l;
  }

  // one subtable per shared main-table prefix
  const int mask = (1 << tb) - 1;
  int i = 0, cur = 1 << tb;
  bool ok = true;
  while (i < nstash) {
    const int prefix = sm.stash_rc[i] & mask;
    int j = i;
    while (j < nstash && (sm.stash_rc[j] & mask) == prefix) ++j;
    const int sub_bits = sm.stash_len[j - 1] - tb;
    const int start = cur;
    cur += 1 << sub_bits;
    if (cur > enough) { ok = false; break; }
    table[prefix] = ((uint32_t)start << 16) | (kSub << 12) |
                    ((uint32_t)sub_bits << 8);
    for (int k = i; k < j; ++k) {
      const int l = sm.stash_len[k];
      const uint32_t e = make_entry(role, sm.stash_sym[k], l, sm.consts);
      for (int idx = sm.stash_rc[k] >> tb; idx < (1 << sub_bits);
           idx += 1 << (l - tb))
        table[start + idx] = e;
    }
    i = j;
  }

  if (role == 1) {
    // two-literal pairing, descending index order
    for (int idx = (1 << tb) - 1; idx >= 0; --idx) {
      const uint32_t e1 = table[idx];
      const int l1 = (int)(e1 & 0xFF);
      if (((e1 >> 12) & 3) != kLit || l1 < 1 || l1 >= tb || (e1 & 0x4000))
        continue;
      const uint32_t e2 = table[idx >> l1];
      const int l2 = (int)(e2 & 0xFF);
      if (((e2 >> 12) & 3) == kLit && !(e2 & 0x4000) && l1 + l2 <= tb)
        table[idx] = ((e2 >> 16) << 24) | ((e1 >> 16) << 16) | (1u << 14) |
                     (kLit << 12) | (uint32_t)(l1 + l2);
    }
  }
  return ok;
}

struct Out {
  uint8_t* dst;
  int out_bytes;
  int op;

  __device__ __forceinline__ void put(uint32_t byte) {
    if (op < out_bytes) dst[op] = (uint8_t)byte;
    ++op;
  }
};

// do_stored, from the bit after the block header
__device__ int stored(const Input& in, Out& o, int olen, int base_max,
                      int& t, int& bb) {
  const int t2 = (t + 7) & ~7;
  ensure(t2, 1, base_max, bb);
  const uint32_t v = in.peek(t2);
  const int ln = (int)(v & 0xFFFF);
  int ib = (t2 + 32) >> 3;
  t = ib << 3;
  if ((uint32_t)(ln ^ 0xFFFF) != ((v >> 16) & 0xFFFF) ||
      (long long)o.op + ln > olen)
    return kBad;
  int rem = ln;
  while (rem > 0) {
    ensure(ib << 3, 3, base_max, bb);
    const int stage_left = 4 * (bb + kStageW) - ib - 8;
    if (stage_left <= 0) return kBad;
    const int room =
        min(min(stage_left, kFlushB - (o.op & (kFlushB - 1))), rem);
    for (int k = 0; k < room; ++k) o.put(in.byte(ib + k));
    ib += room;
    rem -= room;
    t = ib << 3;
  }
  return kOK;
}

// the group loop of do_huffman: a literal burst, then one item
__device__ int group_loop(const Input& in, Smem& sm, Out& o, int olen,
                          int guard, int base_max, int& t, int& bb) {
  constexpr uint32_t kLLM = (1u << kLTB) - 1, kOFM = (1u << kOTB) - 1;
  for (;;) {
    const int tw = t >> 5;
    ensure(t, 3, base_max, bb);
    // past the guard the iteration still runs, then the loop stops
    const int stt = tw > guard ? kBad : kOK;
    const int bits_left = ((bb + kStageW - 1) << 5) - t;
    const int room = min(kFlushB - (o.op & (kFlushB - 1)), olen - o.op);
    int niter = min(max(bits_left - 64, 0) >> 4, max(room - 8, 0) >> 1);
    uint32_t w = in.peek(t);
    uint32_t e = sm.ll[w & kLLM];
    while (niter > 0 && !(e & 0x3000)) {
      const uint32_t p = e >> 16;
      o.put(p & 0xFF);
      if (e & 0x4000) o.put(p >> 8);
      t += (int)(e & 0xFF);
      w = in.peek(t);
      e = sm.ll[w & kLLM];
      --niter;
    }

    uint32_t kind = (e >> 12) & 3;
    if (kind == kSub) {
      e = sm.ll[(e >> 16) + (shr(w, kLTB) & low_mask((e >> 8) & 0xF))];
      kind = (e >> 12) & 3;
    }
    const uint32_t consume = e & 0xFF;
    const int t4 = t + (int)consume;
    if (kind == kLit) {
      t = t4;
      const uint32_t p = e >> 16;
      const int nb = (e & 0x4000) ? 2 : 1;
      if ((long long)o.op + nb > olen) return kBad;
      o.put(p & 0xFF);
      if (nb == 2) o.put(p >> 8);
    } else if (kind == kBase) {
      const uint32_t cl = (e >> 8) & 0xF;
      const int length =
          (int)((e >> 16) + (shr(w, cl) & low_mask(consume - cl)));
      uint32_t oe = sm.of[shr(w, consume) & kOFM];
      const uint32_t w2 = in.peek(t4);
      if (((oe >> 12) & 3) == kSub)
        oe = sm.of[(oe >> 16) + (shr(w2, kOTB) & low_mask((oe >> 8) & 0xF))];
      const uint32_t ocons = oe & 0xFF, ocl = (oe >> 8) & 0xF;
      const int dist =
          (int)((oe >> 16) + (shr(w2, ocl) & low_mask(ocons - ocl)));
      t = t4 + (int)ocons;
      if (((oe >> 12) & 3) != kBase || dist > o.op ||
          (long long)o.op + length > olen)
        return kBad;
      // forward byte copy: overlapping matches repeat their period
      const int n = max(min(length, o.out_bytes - o.op), 0);
      uint8_t* d = o.dst + o.op;
      for (int k = 0; k < n; ++k) d[k] = d[k - dist];
      o.op += length;
    } else if (kind == kEob && (e >> 16) == 0) {
      t = t4;
      return stt;
    } else {  // invalid codeword or a stray subtable pointer
      t = t4;
      return kBad;
    }
    if (stt != kOK) return stt;
  }
}

// do_huffman: table setup for a static (btype 1) or dynamic block, then
// the group loop
__device__ int huffman(const Input& in, Smem& sm, Out& o, int btype,
                       int olen, int guard, int base_max, int& t, int& bb) {
  int num_ll, num_of;
  if (btype == 1) {
    for (int i = 0; i < 320; ++i) sm.lens[i] = sm.consts[kCSL + i];
    num_ll = 288;
    num_of = 32;
  } else {
    ensure(t, 1, base_max, bb);
    const uint32_t v = in.peek(t);
    num_ll = 257 + (int)(v & 31);
    num_of = 1 + (int)((v >> 5) & 31);
    const int num_pre = 4 + (int)((v >> 10) & 15);
    t += 14;
    for (int i = 0; i < 19; ++i) sm.plens[i] = 0;
    for (int i = 0; i < num_pre; ++i) {
      ensure(t, 1, base_max, bb);
      sm.plens[sm.consts[kCPP + i]] = (int)(in.peek(t) & 7);
      t += 3;
    }
    bool ok = build_table(sm.plens, 19, 0, sm.pre, sm);
    // RLE-decode the litlen + offset lengths
    const int total = num_ll + num_of;
    int i = 0;
    while (ok && i < total) {
      ensure(t, 1, base_max, bb);
      const uint32_t e = sm.pre[in.peek(t) & (kPreSize - 1)];
      const int sym = (int)(e >> 16);
      t += (int)(e & 0xFF);
      ensure(t, 1, base_max, bb);
      const uint32_t w2 = in.peek(t);
      if (sym < 16) {
        sm.lens[i++] = sym;
        continue;
      }
      int rep, ebits, val = 0;
      if (sym == 16) {
        rep = 3 + (int)(w2 & 3);
        ebits = 2;
        val = i > 0 ? sm.lens[i - 1] : 0;
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
        for (int k = 0; k < rep; ++k) sm.lens[i + k] = val;
      }
      i += rep;
      t += ebits;
    }
    if (!ok) return kBad;
  }
  const bool ok_l = build_table(sm.lens, num_ll, 1, sm.ll, sm);
  const bool ok_o = build_table(sm.lens + num_ll, num_of, 2, sm.of, sm);
  if (!ok_l || !ok_o) return kBad;
  return group_loop(in, sm, o, olen, guard, base_max, t, bb);
}

__global__ void __launch_bounds__(1)
decode_chunks_kernel(const uint32_t* __restrict__ comp, int W, int Wp,
                     const int* __restrict__ comp_len,
                     const int* __restrict__ out_len, int strict,
                     const int* __restrict__ consts, uint8_t* out,
                     int out_bytes, int* status_out, int* olen_out,
                     int* cons_out) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  for (int i = 0; i < kNConsts; ++i) sm.consts[i] = consts[i];
  const Input in{comp + (size_t)b * W, W, Wp};
  Out o{out + (size_t)b * out_bytes, out_bytes, 0};
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
    int bb = 0;
    for (;;) {
      if ((t >> 5) >= Wp) { status = kBad; break; }
      ensure(t, 1, base_max, bb);
      const uint32_t hdr = in.peek(t);
      t += 3;
      const int btype = (int)((hdr >> 1) & 3);
      int stat;
      if (btype == 0)
        stat = stored(in, o, olen, base_max, t, bb);
      else if (btype == 3)
        stat = kBad;
      else
        stat = huffman(in, sm, o, btype, olen, guard, base_max, t, bb);
      if (stat != kOK) { status = stat; break; }
      if (hdr & 1) break;
    }
    if (status == kOK && strict && o.op != olen) status = kBad;
    cons = min((t + 7) >> 3, clen);
  }
  status_out[b] = status;
  olen_out[b] = o.op;
  cons_out[b] = cons;
}

}  // namespace

// comp uint32 [B][W] (W >= 2048), comp_len/out_len int32 [B], consts int32
// [457], out uint8 [B][out_bytes] (zeroed by the caller), status/out_lens/
// consumed int32 [B].  One block of one thread per chunk.  Returns the CUDA
// error of the launch.
extern "C" int decode_chunks_launch(const uint32_t* comp, int B, int W,
                                    int Wp, const int* comp_len,
                                    const int* out_len, int strict,
                                    const int* consts, uint8_t* out,
                                    int out_bytes, int* status, int* out_lens,
                                    int* consumed, void* stream) {
  if (B > 0)
    decode_chunks_kernel<<<B, 1, 0, (cudaStream_t)stream>>>(
        comp, W, Wp, comp_len, out_len, strict, consts, out, out_bytes,
        status, out_lens, consumed);
  return (int)cudaGetLastError();
}
