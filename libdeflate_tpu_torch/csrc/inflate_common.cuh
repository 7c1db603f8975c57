// Shared parts of the scalar DEFLATE kernels: the decoder (K3,
// decode_chunks.cu) and its tokenize-only ceiling (K4, tokenize_chunks.cu).
//
// The bit reader over a padded row of words, the staging-base bookkeeping
// (ensure), the packed table entry (make_entry), the table builder
// (build_table) and a block's table setup (read_tables).  They follow
// libdeflate_tpu/decompress/pallas_decode.py (peek32, ensure, _make_entry,
// _build_table_scalar, do_huffman's table setup) and their plain versions
// in libdeflate_tpu_torch/decompress/tables.py and decode.py step for step.
// Everything runs on one thread per chunk; the tables live in shared memory.

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

// do_huffman's table setup / decode.read_tables: the litlen and offset
// tables of a static (btype 1) or dynamic block into sm.ll and sm.of, from
// the bit after the block header.  Returns ok.
__device__ bool read_tables(const Input& in, Smem& sm, int btype,
                            int base_max, int& t, int& bb) {
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
    if (!ok) return false;
  }
  const bool ok_l = build_table(sm.lens, num_ll, 1, sm.ll, sm);
  const bool ok_o = build_table(sm.lens + num_ll, num_of, 2, sm.of, sm);
  return ok_l && ok_o;
}

}  // namespace
