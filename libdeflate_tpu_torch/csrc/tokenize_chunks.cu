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
// guard and the staging base are K3's, carried as bookkeeping.
//
// What bounds it on this card: bytes, in principle -- each compressed
// byte read once, a few microseconds for 16 MiB of output.  In practice
// the serial chain of table probes, as for K3: one thread per chunk, each
// symbol's position depending on the previous one.  The kernel measures
// how much of K3's time that chain is, with the output writes removed.
//
// Design: K3's, one block of one thread per chunk with the tables in
// shared memory, sharing its bit reader, table builder and table setup
// (inflate_common.cuh).  UNROLL and STORE are template parameters, in the
// six configurations of the reference's script: UNROLL > 1 runs UNROLL
// select-committed burst steps per loop test (a non-literal or a spent
// budget freezes the state), STORE writes one token per burst lookup and
// per item into a 2048-entry shared buffer.  The buffer is never read, so
// the stores go through a volatile pointer, which keeps nvcc from deleting
// them (cuobjdump -sass shows the extra STS instructions).

#include "inflate_common.cuh"

namespace {

constexpr int kTokMask = 2047;

struct Tok {
  int op;
  uint32_t acc;
  int ntok;
};

// do_stored of the reference: one token, no copy
__device__ int tok_stored(const Input& in, Tok& k, int olen, int base_max,
                          int& t, int& bb) {
  const int t2 = (t + 7) & ~7;
  ensure(t2, 1, base_max, bb);
  const uint32_t v = in.peek(t2);
  const int ln = (int)(v & 0xFFFF);
  const bool bad = (uint32_t)(ln ^ 0xFFFF) != ((v >> 16) & 0xFFFF) ||
                   (long long)k.op + ln > olen;
  t = t2 + 32 + (ln << 3);
  if (!bad) k.op += ln;
  k.acc ^= (uint32_t)ln;
  ++k.ntok;
  return bad ? kBad : kOK;
}

// do_huffman of the reference: table setup, then the group loop
template <int UNROLL, bool STORE>
__device__ int tok_huffman(const Input& in, Smem& sm, volatile uint32_t* tok,
                           Tok& k, int btype, int olen, int guard,
                           int base_max, int& t, int& bb) {
  if (!read_tables(in, sm, btype, base_max, t, bb)) return kBad;
  for (;;) {
    ensure(t, 3, base_max, bb);
    // past the guard the iteration still runs, then the loop stops
    int stt = (t >> 5) > guard ? kBad : kOK;
    const int bits_left = ((bb + kStageW - 1) << 5) - t;
    int nn = min(max(bits_left - 64, 0) >> 4, max(olen - k.op, 0) >> 1);
    uint32_t w = in.peek(t);
    uint32_t e = sm.ll[w & kLLM];
    if (UNROLL == 1) {
      while (!(e & 0x3000) && nn > 0) {
        if (STORE) tok[k.ntok & kTokMask] = e;
        k.acc ^= e;
        k.op += 1 + (int)((e >> 14) & 1);
        t += (int)(e & 0xFF);
        w = in.peek(t);
        e = sm.ll[w & kLLM];
        ++k.ntok;
        --nn;
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
          t += is_l ? (int)(e & 0xFF) : 0;
          nn -= is_l;
          w = in.peek(t);
          if (is_l) e = sm.ll[w & kLLM];
        }
      }
    }

    // one item: a literal, a match, the EOB or a bad codeword; the offset
    // lookup runs for every item
    uint32_t kind = (e >> 12) & 3;
    if (kind == kSub) {
      e = sm.ll[(e >> 16) + (shr(w, kLTB) & low_mask((e >> 8) & 0xF))];
      kind = (e >> 12) & 3;
    }
    const uint32_t consume = e & 0xFF, cl = (e >> 8) & 0xF, payload = e >> 16;
    const bool is_lit = kind == kLit;
    const bool is_eob = kind == kEob && payload == 0;
    const bool is_badk = (kind == kEob && payload != 0) || kind == kSub;
    const bool is_mat = kind == kBase;
    const int length = (int)(payload + (shr(w, cl) & low_mask(consume - cl)));
    const int t4 = t + (int)consume;
    uint32_t oe = sm.of[shr(w, consume) & kOFM];
    const uint32_t w2 = in.peek(t4);
    if (((oe >> 12) & 3) == kSub)
      oe = sm.of[(oe >> 16) + (shr(w2, kOTB) & low_mask((oe >> 8) & 0xF))];
    const uint32_t ocons = oe & 0xFF, ocl = (oe >> 8) & 0xF;
    const uint32_t dist = (oe >> 16) + (shr(w2, ocl) & low_mask(ocons - ocl));
    t = t4 + (is_mat ? (int)ocons : 0);
    const int nb = 1 + (int)((e >> 14) & 1);
    const bool bad =
        is_badk ||
        (is_mat && (((oe >> 12) & 3) != kBase || (long long)dist > k.op ||
                    (long long)k.op + length > olen)) ||
        (is_lit && (long long)k.op + nb > olen);
    if (bad) stt = kBad;
    const int ln = (bad || is_eob) ? 0 : (is_lit ? nb : length);
    if (STORE) tok[k.ntok & kTokMask] = ((uint32_t)ln << 16) | dist;
    ++k.ntok;
    k.acc ^= ((uint32_t)ln << 16) ^ dist;
    k.op += ln;
    if (stt != kOK) return stt;
    if (is_eob) return kOK;
  }
}

template <int UNROLL, bool STORE>
__global__ void __launch_bounds__(1)
tokenize_chunks_kernel(const uint32_t* __restrict__ comp, int W, int Wp,
                       const int* __restrict__ comp_len,
                       const int* __restrict__ out_len,
                       const int* __restrict__ consts, int* status_out,
                       int* op_out, int* acc_out) {
  __shared__ Smem sm;
  __shared__ uint32_t tokbuf[STORE ? kTokMask + 1 : 1];
  volatile uint32_t* tok = tokbuf;
  const int b = blockIdx.x;
  for (int i = 0; i < kNConsts; ++i) sm.consts[i] = consts[i];
  const Input in{comp + (size_t)b * W, W, Wp};
  const int clen = comp_len[b];
  const int olen = out_len[b];
  const long long in_words = ((long long)clen + 3) >> 2;
  Tok k{0, 0u, 0};
  int status = kOK;
  if (clen < 0 || in_words + kStageW > W) {
    // outside the input contract: no tokenizing
    status = kBad;
  } else {
    const int guard = (int)in_words + kStageW;
    const int base_max = Wp - kStageW;
    int t = 0, bb = 0;
    for (;;) {
      if ((t >> 5) >= Wp) { status = kBad; break; }
      ensure(t, 1, base_max, bb);
      const uint32_t hdr = in.peek(t);
      t += 3;
      const int btype = (int)((hdr >> 1) & 3);
      int stat;
      if (btype == 0)
        stat = tok_stored(in, k, olen, base_max, t, bb);
      else if (btype == 3)
        stat = kBad;
      else
        stat = tok_huffman<UNROLL, STORE>(in, sm, tok, k, btype, olen, guard,
                                          base_max, t, bb);
      if (stat != kOK) { status = stat; break; }
      if (hdr & 1) break;
    }
  }
  status_out[b] = status;
  op_out[b] = k.op;
  acc_out[b] = (int)k.acc;
}

template <int UNROLL, bool STORE>
void launch(const uint32_t* comp, int B, int W, int Wp, const int* comp_len,
            const int* out_len, const int* consts, int* status, int* op,
            int* acc, cudaStream_t stream) {
  tokenize_chunks_kernel<UNROLL, STORE><<<B, 1, 0, stream>>>(
      comp, W, Wp, comp_len, out_len, consts, status, op, acc);
}

}  // namespace

// comp uint32 [B][W] (W >= 2048), comp_len/out_len int32 [B], consts int32
// [457], status/op/acc int32 [B].  (unroll, store_tokens) is one of (1, 0),
// (2, 0), (4, 0), (8, 0), (1, 1), (4, 1).  One block of one thread per
// chunk.  Returns the CUDA error of the launch (cudaErrorInvalidValue for
// another configuration).
extern "C" int tokenize_chunks_launch(const uint32_t* comp, int B, int W,
                                      int Wp, const int* comp_len,
                                      const int* out_len, const int* consts,
                                      int unroll, int store_tokens,
                                      int* status, int* op, int* acc,
                                      void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaGetLastError();
  const int cfg = unroll * 2 + (store_tokens ? 1 : 0);
  switch (cfg) {
    case 2: launch<1, false>(comp, B, W, Wp, comp_len, out_len, consts,
                             status, op, acc, s); break;
    case 4: launch<2, false>(comp, B, W, Wp, comp_len, out_len, consts,
                             status, op, acc, s); break;
    case 8: launch<4, false>(comp, B, W, Wp, comp_len, out_len, consts,
                             status, op, acc, s); break;
    case 16: launch<8, false>(comp, B, W, Wp, comp_len, out_len, consts,
                              status, op, acc, s); break;
    case 3: launch<1, true>(comp, B, W, Wp, comp_len, out_len, consts,
                            status, op, acc, s); break;
    case 9: launch<4, true>(comp, B, W, Wp, comp_len, out_len, consts,
                            status, op, acc, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
