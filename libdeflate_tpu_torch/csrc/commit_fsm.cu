// Commit FSM with same-distance merging over independent segments, for
// Hopper (sm_90a).
//
// Replaces XLA loop code, not a Pallas kernel:
// libdeflate_tpu/compress/tpu_pipeline.py::_greedy_commit_merge (its
// lax.scan over the segment's steps, then the reverse log-shift min).
// Plain version: greedy_commit_merge in
// libdeflate_tpu_torch/compress/pipeline.py (a Python loop of torch ops,
// one step a launch group).
//
// What it computes, per lane (one seg-position segment of the flat
// [B, n] arrays; lane l holds positions l*seg .. l*seg + seg-1), with
// trunc = min(span[t], seg - t), a match where is_match[t] and
// trunc >= 3, and eff[t] = trunc for a match, else 1:
//   - the FSM: commits at t = 0, then at t + eff[t] after each commit t.
//     It carries the pending run (pdist, pbud): a committed match whose
//     distance equals pdist, with pdist > 0 and pbud + eff <= 258, is
//     absorbed (pbud += eff, no head); any other commit starts a new run
//     (pdist = dist or 0, pbud = eff or 0) and is a head;
//   - heads[t]: committed and not absorbed;
//   - out[t]: at a head, the next head strictly after t (the segment end
//     if none) minus t; elsewhere eff[t].
//
// What bounds it on this card: bytes.  Reading span (int64), is_match
// (bool) and dist (int64) once and writing heads (bool) and out (int64)
// once is 26 bytes a position, 109 MB for the lean path's 4 x 1 MiB
// batch: 0.033 ms at 3.35 TB/s.  The work is a few integer operations a
// position; the carried chain is one step a commit (at most seg a lane).
//
// Design (simple first): one thread a lane, 32 lanes a block, so the
// lean path's 4096 lanes are a warp on each of 128 SMs.
// - Forward, the thread jumps from one commit to the next (only committed
//   positions change the carry) and writes heads for every position its
//   commit covers: the head flag at the commit, 0 for the eff - 1
//   positions it skips.  The commits tile the segment (trunc stops a
//   match at its end), so every head is written once and the kernel
//   needs no memset.
// - Backward, it sweeps t = seg-1 .. 0 holding the next head after t
//   (the reverse cummin of the plain version) and writes out[t]; it
//   reads back its own heads.
// - Lanes lie seg elements apart, so a warp's loads touch 32 lines at a
//   time (L1 holds them across the next 15 steps of int64); coalescing
//   them through shared memory is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLen = 258;       // DEFLATE's longest match
constexpr int kThreads = 32;       // lanes a block

__device__ __forceinline__ int step_eff(long long sp, unsigned char im,
                                        int rem, bool* is_m) {
  const long long trunc = sp < rem ? sp : (long long)rem;
  *is_m = im != 0 && trunc >= 3;
  return *is_m ? (int)trunc : 1;
}

__global__ void __launch_bounds__(kThreads)
commit_fsm_kernel(const long long* __restrict__ span,
                  const unsigned char* __restrict__ is_match,
                  const long long* __restrict__ dist,
                  unsigned char* heads, long long* __restrict__ out, int seg,
                  int lanes) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const long long base = (long long)lane * seg;
  span += base;
  is_match += base;
  dist += base;
  heads += base;
  out += base;

  long long pdist = 0;
  int pbud = 0;
  for (int t = 0; t < seg;) {
    bool m;
    const int e = step_eff(span[t], is_match[t], seg - t, &m);
    const long long dd = dist[t];
    const bool absorb = m && pdist == dd && pdist > 0 && pbud + e <= kMaxLen;
    if (absorb) {
      pbud += e;
    } else {
      pdist = m ? dd : 0;
      pbud = m ? e : 0;
    }
    heads[t] = absorb ? 0 : 1;
    for (int j = 1; j < e; ++j) heads[t + j] = 0;
    t += e;
  }

  int next = seg;
#pragma unroll 4
  for (int t = seg - 1; t >= 0; --t) {
    bool m;
    const int e = step_eff(span[t], is_match[t], seg - t, &m);
    const bool h = heads[t] != 0;
    out[t] = h ? next - t : e;
    if (h) next = t;
  }
}

}  // namespace

// Inputs: span and dist int64, is_match bool (one byte), all contiguous
// [B, n] with B * n = lanes * seg; heads (bool) and out (int64) of the
// same shape, every element written.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int commit_fsm_launch(const long long* span,
                                 const unsigned char* is_match,
                                 const long long* dist, unsigned char* heads,
                                 long long* out, int seg, int lanes,
                                 void* stream) {
  if (lanes <= 0) return 0;
  if (seg <= 0) return (int)cudaErrorInvalidValue;
  commit_fsm_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(span, is_match, dist, heads,
                                              out, seg, lanes);
  return (int)cudaGetLastError();
}
