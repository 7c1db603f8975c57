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
// out_bytes are dropped.  Shifts of 32 or more give 0, as XLA's do.  The
// bit reader, the table builder and a block's table setup are shared with
// the tokenize-only kernel (K4) through inflate_common.cuh.

#include "inflate_common.cuh"

namespace {

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
  if (!read_tables(in, sm, btype, base_max, t, bb)) return kBad;
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
