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
// once and each output byte written once.  In practice the serial
// dependence of DEFLATE rules: each symbol's bit position depends on the
// previous symbol, so a stream is a chain of dependent loads, and at
// B = 16 streams 16 of 132 SMs work.
//
// Design (simple and right first): one warp a stream, one warp a block.
// Every lane walks the same blocks and symbols in step -- each value on the
// chain is warp-uniform, so the warp's walk is lane 0's and no value is
// broadcast -- and the lanes split the work that is not on the chain:
// - each code's canonical tables are built by the warp in shared memory:
//   counts by shared atomics, the (length, symbol) order by
//   __match_any_sync ranks within each 32-symbol round;
// - a symbol decode is the JAX decoder's 15-length compare, unrolled, so
//   its 30 table loads are independent of each other;
// - lane 0 stores a literal; the lanes copy a stored block and every match
//   straight into out in global memory, byte k of a match from
//   op - dist + (k mod dist), a byte that existed before the match, so an
//   overlapping period repeats without a byte-by-byte chain.  The decoder
//   keeps its whole output, so it needs no ring; __syncwarp() orders the
//   stores before a match reads them;
// - at the end the lanes zero out past the output length, so out is
//   written once and the wrapper allocates it uninitialized.
// The static tables are built once a stream.  Making it fast (a bit buffer
// in registers, a lookup table instead of the compare, output staged in
// shared memory) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSyms = 288;      // largest alphabet (litlen)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOk = 0, kBad = 1, kInsufficient = 3;

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
  Table st_ll, st_of;            // the static code, built once
  Table ll, of, pre;             // the current dynamic block's
  int lens[kMaxSyms + 32];       // code lengths (litlen then offsets)
  int pre_lens[19];
  int cursor[16];                // sort cursors, one a length class
};

// The stream's bytes: the first n of row, zeros past them.
struct In {
  const uint8_t* __restrict__ row;
  int n;

  __device__ uint32_t byte_at(int j) const {
    return j < n ? (uint32_t)__ldg(row + j) : 0u;
  }
  // the 32 bits at bit p, LSB first
  __device__ uint32_t peek(int p) const {
    const int b = p >> 3;
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) v |= (uint64_t)byte_at(b + k) << (8 * k);
    return (uint32_t)(v >> (p & 7));
  }
};

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

struct State {
  int bit_pos, out_pos, result;
  bool running;
};

// The header of a dynamic block from bit_pos (block_dynamic): the precode,
// the RLE of the code lengths and the two tables.  Leaves bit_pos after
// the last length read; returns whether the block's codes are usable.
__device__ bool dynamic_header(const In& in, State& s, long long hard_limit,
                               Smem& sm, int lane) {
  const uint32_t bits = in.peek(s.bit_pos);
  const int num_litlen = 257 + (int)(bits & 31);
  const int num_offsets = 1 + (int)((bits >> 5) & 31);
  const int num_explicit = 4 + (int)((bits >> 10) & 15);
  int bp = s.bit_pos + 14;
  if (lane < 19) sm.pre_lens[lane] = 0;
  __syncwarp();
  if (lane < num_explicit)
    sm.pre_lens[kPerm[lane]] = (int)(in.peek(bp + 3 * lane) & 7);
  bp += 3 * num_explicit;
  __syncwarp();
  bool ok = build_table(sm.pre_lens, 19, sm.pre, sm.cursor, lane);
  const int total = num_litlen + num_offsets;
  for (int k = lane; k < kMaxSyms + 32; k += 32) sm.lens[k] = 0;
  __syncwarp();
  int i = 0;
  while (ok && i < total) {
    const Sym d = decode_sym(sm.pre, in.peek(bp));
    const int nbp = bp + d.len;
    const uint32_t bits2 = in.peek(nbp);
    int rep, xb, val;
    if (d.sym < 16) {
      rep = 1, xb = 0, val = d.sym;
    } else if (d.sym == 16) {
      rep = 3 + (int)(bits2 & 3), xb = 2, val = sm.lens[max(i - 1, 0)];
    } else if (d.sym == 17) {
      rep = 3 + (int)(bits2 & 7), xb = 3, val = 0;
    } else {
      rep = 11 + (int)(bits2 & 127), xb = d.sym == 18 ? 7 : 0, val = 0;
    }
    const bool bad = !d.ok || (d.sym == 16 && i == 0) || i + rep > total ||
                     (long long)nbp + xb > hard_limit;
    if (!bad)
      for (int k = lane; k < rep; k += 32) sm.lens[i + k] = val;
    __syncwarp();
    bp = nbp + xb;
    i += rep;
    ok = !bad;
  }
  s.bit_pos = bp;
  if (!ok) return false;
  const bool ll_ok = build_table(sm.lens, num_litlen, sm.ll, sm.cursor, lane);
  const bool of_ok =
      build_table(sm.lens + num_litlen, num_offsets, sm.of, sm.cursor, lane);
  return ll_ok && of_ok;
}

// One Huffman block's symbols (symbol_loop), up to its EOB or a failure.
__device__ void symbol_loop(const In& in, const Table& ll, const Table& of,
                            State& s, long long hard_limit, int out_cap,
                            uint8_t* dst, int lane) {
  while (true) {
    const Sym d = decode_sym(ll, in.peek(s.bit_pos));
    const int nbp = s.bit_pos + d.len;
    const bool bad = !d.ok || d.sym >= 286 || nbp > hard_limit;
    if (d.sym < 256) {
      s.bit_pos = nbp;
      if (s.out_pos < out_cap) {
        // written even when bad: the JAX decoder's do_lit ignores it
        if (lane == 0) dst[s.out_pos] = (uint8_t)d.sym;
        ++s.out_pos;
        if (!bad) continue;
        s.result = kBad;
      } else {
        s.result = bad ? kBad : kInsufficient;
      }
      s.running = false;
      return;
    }
    if (d.sym == 256 || bad) {
      s.bit_pos = nbp;
      if (bad) {
        s.result = kBad;
        s.running = false;
      }
      return;
    }
    const int lslot = d.sym - 257;
    const int lxb = kLenExtra[lslot];
    const int length =
        kLenBase[lslot] + (int)(in.peek(nbp) & ((1u << lxb) - 1u));
    const int bp2 = nbp + lxb;
    const Sym o = decode_sym(of, in.peek(bp2));
    const int bp3 = bp2 + o.len;
    const int oslot = min(o.sym, 29);
    const int oxb = kOffExtra[oslot];
    const int offset =
        kOffBase[oslot] + (int)(in.peek(bp3) & ((1u << oxb) - 1u));
    s.bit_pos = bp3 + oxb;
    if (!o.ok || o.sym >= 30 || offset > s.out_pos || s.bit_pos > hard_limit) {
      s.result = kBad;
      s.running = false;
      return;
    }
    if ((long long)s.out_pos + length > out_cap) {
      s.result = kInsufficient;
      s.running = false;
      return;
    }
    __syncwarp();                     // lane 0's literals are visible
    const int src = s.out_pos - offset;
    for (int k = lane; k < length; k += 32)
      dst[s.out_pos + k] = dst[src + (offset >= length ? k : k % offset)];
    __syncwarp();
    s.out_pos += length;
  }
}

__global__ void __launch_bounds__(32)
    fsm_decode_kernel(const uint8_t* __restrict__ bufs, int N,
                      const int* __restrict__ in_lens, int out_cap,
                      uint8_t* out, int* out_lens, int* consumed,
                      int* result) {
  __shared__ Smem sm;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int in_nbytes = in_lens[b];
  const In in{bufs + (size_t)b * N, min(max(in_nbytes, 0), N)};
  uint8_t* dst = out + (size_t)b * out_cap;
  const long long total_bits = (long long)in_nbytes * 8;
  const long long hard_limit = total_bits + 49;  // implicit-zero overread

  for (int k = lane; k < kMaxSyms + 32; k += 32)
    sm.lens[k] = k < 144 ? 8 : k < 256 ? 9 : k < 280 ? 7 : k < 288 ? 8 : 5;
  __syncwarp();
  build_table(sm.lens, kMaxSyms, sm.st_ll, sm.cursor, lane);
  build_table(sm.lens + kMaxSyms, 32, sm.st_of, sm.cursor, lane);

  State s{0, 0, kOk, true};
  bool is_final = false;
  while (s.running && !is_final) {
    const uint32_t bits = in.peek(s.bit_pos);
    is_final = bits & 1;
    const int btype = (int)((bits >> 1) & 3);
    const bool overran = s.bit_pos + 3 > hard_limit;
    s.bit_pos += 3;
    if (overran || btype == 3) {
      s.result = kBad;
      s.running = false;
    } else if (btype == 0) {
      const int byte = ((s.bit_pos + 7) & ~7) >> 3;
      const uint32_t w = in.peek(byte * 8);
      const int length = (int)(w & 0xFFFF);
      const bool ok = (length ^ 0xFFFF) == (int)(w >> 16);
      const bool fits_in = byte + 4 + length <= in_nbytes;
      const bool fits_out = (long long)s.out_pos + length <= out_cap;
      s.running = ok && fits_in && fits_out;
      if (s.running) {
        for (int k = lane; k < length; k += 32)
          dst[s.out_pos + k] = (uint8_t)in.byte_at(byte + 4 + k);
        __syncwarp();
        s.out_pos += length;
        s.bit_pos = (byte + 4 + length) * 8;
      } else {
        s.result = ok && !fits_out ? kInsufficient : kBad;
      }
    } else {
      const Table* ll = &sm.st_ll;
      const Table* of = &sm.st_of;
      bool good = true;
      if (btype == 2) {
        good = dynamic_header(in, s, hard_limit, sm, lane);
        ll = &sm.ll;
        of = &sm.of;
      }
      if (good) {
        symbol_loop(in, *ll, *of, s, hard_limit, out_cap, dst, lane);
      } else {
        s.result = kBad;
        s.running = false;
      }
    }
  }
  for (int k = s.out_pos + lane; k < out_cap; k += 32) dst[k] = 0;
  if (lane == 0) {
    const bool ok = s.running && s.bit_pos <= total_bits;
    out_lens[b] = s.out_pos;
    consumed[b] = min((s.bit_pos + 7) >> 3, in_nbytes);
    result[b] = ok ? kOk : s.result == kOk ? kBad : s.result;
  }
}

}  // namespace

extern "C" int fsm_decode_launch(const uint8_t* bufs, int B, int N,
                                 const int* in_lens, int out_cap,
                                 uint8_t* out, int* out_lens, int* consumed,
                                 int* result, void* stream) {
  if (B > 0)
    fsm_decode_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
        bufs, N, in_lens, out_cap, out, out_lens, consumed, result);
  return (int)cudaGetLastError();
}
