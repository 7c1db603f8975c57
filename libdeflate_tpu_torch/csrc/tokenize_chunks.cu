// Tokenize-only ceiling of the scalar DEFLATE decoder (K4), for Hopper
// (sm_90a).
//
// Replaces scripts/exp_tokenize_ceiling.py::tokenize_chunks (kernel body
// _tok_kernel).  Plain version: tokenize_chunks_plain in
// libdeflate_tpu_torch/experiments/exp_tokenize_ceiling.py, which this file
// follows step for step.
//
// What it computes: K3's block loop, table setup and token loop with no
// output written.  Per chunk: status (0 OK, 1 BAD_DATA), the output length
// op that the tokens imply, and acc, an XOR digest of the tokens: every
// burst literal XORs its raw table entry, every item (ln << 16) ^ dist,
// where dist comes from the offset-table lookup on the bits after the
// item, which runs for literals and the EOB too.  Where it differs from
// K3 it follows _tok_kernel: a stored block is one token that checks only
// NLEN and op + LEN <= out_len and jumps the bit cursor by 32 + 8 * LEN,
// with no staging bound; the burst budget is min(max(bits_left-64,0)>>4,
// max(out_len-op,0)>>1), with no 32 KiB boundary.  The decode-past-end
// guard and the staging base bb are K3's, carried as bookkeeping: bb moves
// exactly where the reference's ensure() moves it and sets the burst
// budget, while what the ring holds runs ahead of it.
//
// What bounds it on this card: bytes, in principle -- each compressed
// byte read once, a few microseconds for 16 MiB of output.  In practice
// the serial chain of table probes, each symbol's position depending on
// the previous one: one shared-memory load latency per lookup at best.
//
// Design: one warp per chunk (inflate_common.cuh's reader, K3's too).  The
// row is staged into a 16 KiB shared-memory ring by cp.async, segments
// copied ahead of the cursor by all 32 lanes; a stored block's jump
// restages from the segment it lands in.  The bits come from a 64-bit
// buffer in registers holding 48 or more valid bits at each lookup, so a
// lookup index is a register AND and a burst step's chain is one table
// load, its length byte, a shift and the mask; the item's offset bits
// come from the same buffer.  The token chain runs warp-uniformly on all
// lanes; the 32 lanes split the table builds (fills, subtables, the
// two-literal pairing pass) and the ring copies.  UNROLL and STORE are
// template parameters, in the six configurations of the reference's
// script: UNROLL > 1 runs UNROLL select-committed burst steps per loop
// test (a non-literal or a spent budget freezes the state), STORE writes
// one token per burst lookup and per item into a 2048-entry shared buffer.
// The buffer is never read, so the stores go through a volatile pointer,
// which keeps nvcc from deleting them (cuobjdump -sass shows the extra STS
// instructions).  With a cycles array the kernel also records, per chunk,
// its clock64() cycles in all and in the table setups.

#include "inflate_common.cuh"

namespace {

constexpr int kTokMask = 2047;

struct Tok {
  int op;
  uint32_t acc;
  int ntok;
};

// do_stored of the reference: one token, no copy.  t is the bit after the
// header; the buffer holds 45 or more bits from it.
__device__ int tok_stored(Bits& br, Tok& k, int olen, int base_max, int& t,
                          int& bb) {
  const int t2 = (t + 7) & ~7;
  ensure(t2, 1, base_max, bb);
  br.consume(t2 - t);
  const uint32_t v = (uint32_t)br.buf;
  const int ln = (int)(v & 0xFFFF);
  const bool bad = (uint32_t)(ln ^ 0xFFFF) != ((v >> 16) & 0xFFFF) ||
                   (long long)k.op + ln > olen;
  t = t2 + 32 + (ln << 3);
  if (!bad) k.op += ln;
  k.acc ^= (uint32_t)ln;
  ++k.ntok;
  return bad ? kBad : kOK;
}

// do_huffman of the reference: table setup, then the group loop.  One
// warp runs it uniformly; its cost is the chain of dependent table loads
// and the branches between them, so a next entry is loaded before the
// tests of the step that leads to it (it reads the table only, and is
// dropped when the loop leaves).
template <int UNROLL, bool STORE>
__device__ __forceinline__ int tok_huffman(Bits& br, Ring& rg, WarpSmem& sm,
                                           volatile uint32_t* tok, Tok& k,
                                           int btype, int olen, int guard,
                                           int base_max, int& bb,
                                           long long& table_cycles,
                                           int lane) {
  const long long c0 = clock64();
  const bool ok = read_tables_warp(br, rg.ring, sm, btype, base_max, bb,
                                   lane);
  table_cycles += clock64() - c0;
  if (!ok) return kBad;
  const uint32_t* ll = sm.ll;
  const uint32_t* of = sm.of;
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
    int nn = min(max(((bb + kStageW - 1) << 5) - t - 64, 0) >> 4,
                 max(olen - k.op, 0) >> 1);
    // A burst literal takes at most kLTB bits and one halfword comes back,
    // so 48 or more bits stay valid at every lookup; an index needs only
    // the buffer's low word.
    if (UNROLL == 1) {
      uint32_t h = ring_half(rg.ring, br.nh);
      for (;;) {
        const int c = (int)(e & 0xFF);
        const uint32_t en = ll[((uint32_t)br.buf >> c) & kLLM];
        if ((e & 0x3000) | (nn <= 0)) break;
        if (STORE) tok[k.ntok & kTokMask] = e;
        k.acc ^= e;
        k.op += 1 + (int)((e >> 14) & 1);
        ++k.ntok;
        --nn;
        br.n -= c;
        const bool r = br.n < 48;
        br.buf = (br.buf >> c) | ((uint64_t)h << br.n);
        br.nh += r;
        br.n += r ? 16 : 0;
        h = ring_half(rg.ring, br.nh);
        e = en;
      }
    } else {
      while (!(e & 0x3000) && nn > 0) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const bool is_l = !(e & 0x3000) && nn > 0;
          if (STORE && is_l) tok[k.ntok & kTokMask] = e;
          k.acc ^= is_l ? e : 0u;
          k.op += is_l ? 1 + (int)((e >> 14) & 1) : 0;
          k.ntok += is_l;
          nn -= is_l;
          const int c = is_l ? (int)(e & 0xFF) : 0;
          const uint32_t h = ring_half(rg.ring, br.nh);
          const uint32_t en = ll[((uint32_t)br.buf >> c) & kLLM];
          if (is_l) e = en;
          br.n -= c;
          const bool r = br.n < 48;
          br.buf = (br.buf >> c) | ((uint64_t)h << br.n);
          br.nh += r;
          br.n += r ? 16 : 0;
        }
      }
    }

    // One item: a literal, a match, the EOB or a bad codeword; the offset
    // lookup runs for every item.  Every entry the table build makes
    // consumes at most 20 bits (litlen) or 28 (offset) and has at most 13
    // extra bits, so the item reads at most 48 bits and every shift below
    // is under 32.  The offset entry is loaded before the subtable test
    // (one branch for both tables), the next iteration's entry before the
    // item's tests, and the tests and the ring's check fold into one exit
    // branch: each branch a single warp meets waits for its operands.
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
      // the next entry's index: the buffer's low word past adv, and the
      // refill's first halfword where fewer than kLTB bits are left
      const int n1 = br.n - adv;
      e_next = ll[((uint32_t)(br.buf >> adv) |
                   __funnelshift_lc(0u, (uint32_t)v, (uint32_t)n1)) &
                  kLLM];
      const int kf = (63 - n1) >> 4;
      br.buf = (br.buf >> adv) | (v << n1);
      br.n = n1 + 16 * kf;
      br.nh += kf;
    }
    const uint32_t cl = (e >> 8) & 0xF, payload = e >> 16;
    const bool is_lit = kind == kLit;
    const bool is_eob = (kind == kEob) & (payload == 0);
    const bool is_badk = ((kind == kEob) & (payload != 0)) | (kind == kSub);
    // length counts for a match only, whose extra bits are consume - cl
    const int length =
        (int)(payload + ((w >> cl) & ((1u << ((consume - cl) & 31)) - 1)));
    const uint32_t dist =
        (oe >> 16) + ((w2 >> ocl) & ((1u << (ocons - ocl)) - 1));
    const int nb = 1 + (int)((e >> 14) & 1);
    // op stays in [0, max(olen, 0)]: room does not overflow, and dist > op
    // compares as unsigned
    const int room = olen - k.op;
    const bool bad =
        is_badk |
        (is_mat & ((((oe >> 12) & 3) != kBase) | (dist > (uint32_t)k.op) |
                   (length > room))) |
        (is_lit & (nb > room));
    const int ln = (bad | is_eob) ? 0 : (is_lit ? nb : length);
    if (STORE) tok[k.ntok & kTokMask] = ((uint32_t)ln << 16) | dist;
    ++k.ntok;
    k.acc ^= ((uint32_t)ln << 16) ^ dist;
    k.op += ln;
    e = e_next;
    const int twn = br.pos() >> 5;
    if (bad | past_guard | is_eob | (twn >= rg.limit)) {
      if (bad | past_guard | is_eob) return (bad | past_guard) ? kBad : kOK;
      rg.advance(twn, lane);
    }
  }
}

template <int UNROLL, bool STORE>
__global__ void __launch_bounds__(32)
tokenize_chunks_kernel(const uint32_t* __restrict__ comp, int W, int Wp,
                       const int* __restrict__ comp_len,
                       const int* __restrict__ out_len,
                       const int* __restrict__ consts, int* status_out,
                       int* op_out, int* acc_out, long long* cycles) {
  __shared__ WarpSmem sm;
  __shared__ uint32_t tokbuf[STORE ? kTokMask + 1 : 1];
  volatile uint32_t* tok = tokbuf;
  const long long c_start = clock64();
  const int b = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < kNConsts; i += 32) sm.consts[i] = consts[i];
  __syncwarp();
  const int clen = comp_len[b];
  const int olen = out_len[b];
  const long long in_words = ((long long)clen + 3) >> 2;
  Tok k{0, 0u, 0};
  int status = kOK;
  long long table_cycles = 0;
  if (clen < 0 || in_words + kStageW > W) {
    // outside the input contract: no tokenizing
    status = kBad;
  } else {
    const int guard = (int)in_words + kStageW;
    const int base_max = Wp - kStageW;
    Ring rg{comp + (size_t)b * W, W, Wp, sm.ring, 0, 0};
    Bits br;
    int t = 0, bb = 0;
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
        stat = tok_stored(br, k, olen, base_max, t, bb);
      } else if (btype == 3) {
        stat = kBad;
      } else {
        stat = tok_huffman<UNROLL, STORE>(br, rg, sm, tok, k, btype, olen,
                                          guard, base_max, bb, table_cycles,
                                          lane);
        t = br.pos();
      }
      if (stat != kOK) { status = stat; break; }
      if (hdr & 1) break;
    }
    cp_async_wait_all();
  }
  if (lane == 0) {
    status_out[b] = status;
    op_out[b] = k.op;
    acc_out[b] = (int)k.acc;
    if (cycles) {
      cycles[2 * b] = clock64() - c_start;
      cycles[2 * b + 1] = table_cycles;
    }
  }
}

template <int UNROLL, bool STORE>
void launch(const uint32_t* comp, int B, int W, int Wp, const int* comp_len,
            const int* out_len, const int* consts, int* status, int* op,
            int* acc, long long* cycles, cudaStream_t stream) {
  tokenize_chunks_kernel<UNROLL, STORE><<<B, 32, 0, stream>>>(
      comp, W, Wp, comp_len, out_len, consts, status, op, acc, cycles);
}

// A ring of kChase indices in shared memory, walked by one thread: every
// load's address is the previous load's value.
constexpr int kChase = 1024;

__global__ void shared_chase_kernel(int steps, long long* out) {
  __shared__ int next[kChase];
  for (int i = 0; i < kChase; ++i) next[i] = (i + 97) % kChase;
  __syncwarp();
  int j = 0;
  for (int i = 0; i < 64; ++i) j = next[j];   // warm up
  long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const long long c0 = clock64();
  for (int i = 0; i < steps; ++i) j = next[j];
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  out[0] = c1 - c0;
  out[1] = ns1 - ns0;
  out[2] = j;
}

}  // namespace

// comp uint32 [B][W] (W >= 2048), comp_len/out_len int32 [B], consts int32
// [457], status/op/acc int32 [B]; cycles int64 [B][2] (clock64() cycles
// per chunk in all and in its table setups) or null.  (unroll,
// store_tokens) is one of (1, 0), (2, 0), (4, 0), (8, 0), (1, 1), (4, 1).
// One block of one warp per chunk.  Returns the CUDA error of the launch
// (cudaErrorInvalidValue for another configuration).
extern "C" int tokenize_chunks_launch(const uint32_t* comp, int B, int W,
                                      int Wp, const int* comp_len,
                                      const int* out_len, const int* consts,
                                      int unroll, int store_tokens,
                                      int* status, int* op, int* acc,
                                      long long* cycles, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaGetLastError();
  const int cfg = unroll * 2 + (store_tokens ? 1 : 0);
  switch (cfg) {
    case 2: launch<1, false>(comp, B, W, Wp, comp_len, out_len, consts,
                             status, op, acc, cycles, s); break;
    case 4: launch<2, false>(comp, B, W, Wp, comp_len, out_len, consts,
                             status, op, acc, cycles, s); break;
    case 8: launch<4, false>(comp, B, W, Wp, comp_len, out_len, consts,
                             status, op, acc, cycles, s); break;
    case 16: launch<8, false>(comp, B, W, Wp, comp_len, out_len, consts,
                              status, op, acc, cycles, s); break;
    case 3: launch<1, true>(comp, B, W, Wp, comp_len, out_len, consts,
                            status, op, acc, cycles, s); break;
    case 9: launch<4, true>(comp, B, W, Wp, comp_len, out_len, consts,
                            status, op, acc, cycles, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out int64 [3]: clock64() cycles and %globaltimer nanoseconds of `steps`
// dependent shared-memory loads on one thread, and the last index.
extern "C" int shared_chase_launch(int steps, long long* out, void* stream) {
  shared_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(steps, out);
  return (int)cudaGetLastError();
}
