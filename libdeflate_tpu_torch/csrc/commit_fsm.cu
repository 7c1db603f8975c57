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
// batch: 0.033 ms at 3.35 TB/s.  The carried chain is one step a commit,
// at most seg a lane; from shared memory that is ~45 cycles a step.
//
// Design: a block owns 32 contiguous lanes (contiguous memory, since lane
// l holds l*seg ..), 8 warps, and walks them in windows of kW = 64
// positions of every lane, double-buffered in shared memory.
// - Staging: every thread loads its share of the next window into
//   registers (each warp 4 lanes' rows, 32 consecutive positions an
//   instruction: coalesced at any seg and any alignment) before the
//   current window's work, and converts it into the other buffer after:
//   a record a position (eff for a match; minus the length of the run of
//   literals it starts, cut at the window's end, for a literal: the first
//   non-literal position after it, from a ballot) and dist at its full
//   int64 width (pdist == dist must stay exact).  eff is int32: it can
//   exceed 65535 when seg does.
// - The chain: warp 0, one thread a lane, jumps from commit to commit
//   through the records in shared memory, carrying (t, pdist, pbud) from
//   window to window; a jump past the window's end carries into the next
//   one (or skips windows a long match covers).  A run of literals is one
//   step: every position in it from where the chain enters is a commit
//   and a head (pdist and pbud become 0).  A step loads its record and
//   dist together and takes no branch, so the 32 chains of a warp do not
//   diverge: it marks a match's head 1 (absorbed 0) and a run's entry 2.
// - While warp 0 walks window k, warps 1-7 finish window k-1, a warp a
//   lane row, with ballots instead of scans: a literal position is a head
//   when the last entry mark at or before it lies after the last
//   non-literal position at or before it; the next head after each
//   position is the lowest head bit above it.  A head's out is next - t,
//   any other position's its eff.  The last head of a lane's window has
//   no next head there: it stays pending (one a lane, in shared memory)
//   and is written when a later window's first head, or the segment end,
//   is found.  heads and out are stored coalesced, 32 consecutive
//   positions an instruction.
// - Any seg: windows do not assume that seg is a multiple of kW or that
//   a lane fits in shared memory; the last window of a lane is cut at
//   seg.  A lane of a whole chunk (seg = n_pad, up to ~130 560) walks
//   ~2 000 windows.
// - Rows of the staging buffers are padded (kW + 1 words) so that the 32
//   chain threads' reads at equal offsets fall in different banks.  The
//   two buffers take 54 KB, above the 48 KB default, raised once per
//   device with cudaFuncSetAttribute.

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLen = 258;       // DEFLATE's longest match
constexpr int kLanes = 32;         // lanes a block, one chain thread each
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kW = 64;             // positions of each lane a window holds
constexpr int kM = kW / 32;        // positions of a row a thread holds
constexpr int kRow = kW + 1;       // padded row of rec and dist
constexpr int kHRow = kW + 4;      // padded row of the marks (bytes)
constexpr int kRowsPerWarp = kLanes / kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kLanes == 32, "warp 0 runs one chain a lane");
static_assert(kW % 32 == 0 && kLanes % kWarps == 0, "rows split evenly");

struct Stage {
  int rec[kLanes * kRow];           // eff of a match, -run of a literal
  long long dist[kLanes * kRow];
  unsigned char mark[kLanes * kHRow];   // 1 head, 2 run entry, else 0
};

struct Smem {
  Stage st[2];
  int pend[kLanes];                 // a lane's pending head, or -1
};

struct Regs {                       // one window's raw loads of a thread
  long long sp[kRowsPerWarp][kM];
  long long dd[kRowsPerWarp][kM];
  unsigned char im[kRowsPerWarp][kM];
};

// The window starting at wbeg, rows warp + kWarps * c of the block.
__device__ __forceinline__ void load_window(
    Regs& g, const long long* __restrict__ span,
    const unsigned char* __restrict__ is_match,
    const long long* __restrict__ dist, int lane0, int lanes, int seg,
    int wbeg, int warp, int q) {
#pragma unroll
  for (int c = 0; c < kRowsPerWarp; ++c) {
    const int lane = lane0 + warp + kWarps * c;
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const int t = wbeg + q + 32 * i;
      if (lane < lanes && t < seg) {
        const long long a = (long long)lane * seg + t;
        g.sp[c][i] = span[a];
        g.dd[c][i] = dist[a];
        g.im[c][i] = is_match[a];
      }
    }
  }
}

// Records of the window starting at wbeg into st: eff of a match, minus
// the run of literals from a literal position (the first non-literal
// position at or after it, by ballots; the window's end and seg close a
// run), dist, and marks of 0.
__device__ __forceinline__ void convert_window(Stage& st, const Regs& g,
                                               int lane0, int lanes, int seg,
                                               int wbeg, int warp, int q) {
  const unsigned at_or_above = ~0u << q;
#pragma unroll
  for (int c = 0; c < kRowsPerWarp; ++c) {
    const int s = warp + kWarps * c;
    if (lane0 + s >= lanes) continue;          // warp-uniform
    int eff[kM];
    unsigned sep[kM];                          // non-literal positions
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const int t = wbeg + q + 32 * i;
      bool lit = false;
      eff[i] = 1;
      if (t < seg) {
        const long long rem = seg - t;
        const long long trunc = g.sp[c][i] < rem ? g.sp[c][i] : rem;
        const bool m = g.im[c][i] != 0 && trunc >= 3;
        eff[i] = m ? (int)trunc : 1;
        lit = !m;
      }
      sep[i] = __ballot_sync(kFull, !lit);
    }
    int next = kW;                  // the first separator of later chunks
#pragma unroll
    for (int i = kM - 1; i >= 0; --i) {
      const int local = q + 32 * i;
      const unsigned x = sep[i] & at_or_above;
      const int first = x ? 32 * i + __ffs(x) - 1 : next;
      if (wbeg + local < seg) {
        st.rec[s * kRow + local] = first == local ? eff[i] : -(first - local);
        st.dist[s * kRow + local] = g.dd[c][i];
      }
      st.mark[s * kHRow + local] = 0;
      if (sep[i]) next = 32 * i + __ffs(sep[i]) - 1;
    }
  }
}

// The chain of one lane through the window [wbeg, wend): one step a
// commit of a match or a run of literals, both loads issued at once and
// no branch.  It marks a match's head 1 (absorbed: 0) and the position
// where it enters a run of literals 2; the flush turns the run's rest
// into heads.
__device__ __forceinline__ void chain_window(Stage& st, int q, int wbeg,
                                             int wend, int& t,
                                             long long& pdist, int& pbud) {
  const int* rec = st.rec + q * kRow;
  const long long* dist = st.dist + q * kRow;
  unsigned char* mark = st.mark + q * kHRow;
  while (t < wend) {
    const int off = t - wbeg;
    const int r = rec[off];
    const long long dd = dist[off];
    const bool lit = r < 0;
    const bool absorb =
        !lit && pdist == dd && pdist > 0 && r <= kMaxLen - pbud;
    mark[off] = lit ? 2 : (absorb ? 0 : 1);
    pbud = absorb ? pbud + r : (lit ? 0 : r);
    pdist = absorb ? pdist : (lit ? 0 : dd);
    t += lit ? -r : r;
  }
}

// heads and out of the window starting at wbeg, rows warp - 1 + 7c of
// the block.  A literal position is a head when the chain entered its run
// at or before it: the last entry mark at or before it lies after the
// last non-literal position at or before it.  The next head after each
// position is the lowest head bit above it.
__device__ __forceinline__ void flush_window(
    const Stage& st, int* pend, unsigned char* __restrict__ heads,
    long long* __restrict__ out, int lane0, int lanes, int seg, int wbeg,
    int warp, int q) {
  const unsigned at_or_below = ~0u >> (31 - q);
  const unsigned above = q < 31 ? ~0u << (q + 1) : 0u;
  for (int s = warp - 1; s < kLanes; s += kWarps - 1) {
    const int lane = lane0 + s;
    if (lane >= lanes) break;                  // warp-uniform
    const long long base = (long long)lane * seg;
    int r[kM];
    bool h[kM];
    unsigned hm[kM];
    int last_entry = -1, last_sep = -1;        // before the chunk
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const int local = q + 32 * i;
      const bool in = wbeg + local < seg;
      r[i] = in ? st.rec[s * kRow + local] : 0;
      const int mk = st.mark[s * kHRow + local];
      const unsigned em = __ballot_sync(kFull, mk == 2);
      const unsigned sm = __ballot_sync(kFull, !in || r[i] >= 0);
      const unsigned e = em & at_or_below, x = sm & at_or_below;
      const int le = e ? 32 * i + 31 - __clz(e) : last_entry;
      const int ls = x ? 32 * i + 31 - __clz(x) : last_sep;
      h[i] = in && (mk == 1 || (r[i] < 0 && le > ls));
      hm[i] = __ballot_sync(kFull, h[i]);
      if (em) last_entry = 32 * i + 31 - __clz(em);
      if (sm) last_sep = 32 * i + 31 - __clz(sm);
    }
    int first = kW;                            // the window's first head
    int nh[kM];
#pragma unroll
    for (int i = kM - 1; i >= 0; --i) {
      const unsigned x = hm[i] & above;
      nh[i] = x ? 32 * i + __ffs(x) - 1 : first;
      if (hm[i]) first = 32 * i + __ffs(hm[i]) - 1;
    }
    // the window's first head ends the pending one
    const int old = pend[s];
    __syncwarp();
    if (q == 0 && first < kW && old >= 0) out[base + old] = wbeg + first - old;
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const int local = q + 32 * i;
      const int t = wbeg + local;
      if (t >= seg) continue;
      heads[base + t] = h[i];
      if (!h[i]) {
        out[base + t] = r[i] < 0 ? 1 : r[i];
      } else if (nh[i] < kW) {
        out[base + t] = nh[i] - local;
      } else {
        pend[s] = t;                           // the window's last head
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
commit_fsm_kernel(const long long* __restrict__ span,
                  const unsigned char* __restrict__ is_match,
                  const long long* __restrict__ dist,
                  unsigned char* __restrict__ heads,
                  long long* __restrict__ out, int seg, int lanes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x >> 5, q = threadIdx.x & 31;
  const int lane0 = blockIdx.x * kLanes;
  const int nw = (seg + kW - 1) / kW;
  if (threadIdx.x < kLanes) sm.pend[threadIdx.x] = -1;

  Regs g;
  load_window(g, span, is_match, dist, lane0, lanes, seg, 0, warp, q);
  convert_window(sm.st[0], g, lane0, lanes, seg, 0, warp, q);
  __syncthreads();

  int t = 0, pbud = 0;              // warp 0: the chain's carry
  long long pdist = 0;
  const bool chain_lane = warp == 0 && lane0 + q < lanes;
  for (int k = 0; k <= nw; ++k) {
    const bool more = k + 1 < nw;
    if (more)
      load_window(g, span, is_match, dist, lane0, lanes, seg, (k + 1) * kW,
                  warp, q);
    if (warp == 0) {
      if (k < nw && chain_lane) {
        const int wbeg = k * kW;
        const int wend = wbeg + kW < seg ? wbeg + kW : seg;
        chain_window(sm.st[k & 1], q, wbeg, wend, t, pdist, pbud);
      }
    } else if (k >= 1) {
      flush_window(sm.st[(k - 1) & 1], sm.pend, heads, out, lane0, lanes,
                   seg, (k - 1) * kW, warp, q);
    }
    __syncthreads();
    if (more) {
      convert_window(sm.st[(k + 1) & 1], g, lane0, lanes, seg, (k + 1) * kW,
                     warp, q);
      __syncthreads();
    }
  }
  // the last pending head of each lane ends at the segment end
  if (threadIdx.x < kLanes && lane0 + threadIdx.x < lanes) {
    const int p = sm.pend[threadIdx.x];
    if (p >= 0) out[(long long)(lane0 + threadIdx.x) * seg + p] = seg - p;
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
  // the shared-memory limit, raised at the first launch on each device (a
  // bit per device; one past the 64th raises it at every launch)
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(commit_fsm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit);
  }
  commit_fsm_kernel<<<(lanes + kLanes - 1) / kLanes, kThreads, sizeof(Smem),
                      (cudaStream_t)stream>>>(span, is_match, dist, heads,
                                              out, seg, lanes);
  return (int)cudaGetLastError();
}
