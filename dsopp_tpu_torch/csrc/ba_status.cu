// K11 ba_point_status: the outlier rejection after the windowed BA's solve.
//
// Replaces dsopp_tpu/solvers/pba.py::_point_status_kernel after its
// evaluation (K7): the outlier threshold — the 75th percentile of the ok
// patch energies with linear interpolation between the two neighbouring
// order statistics, as nanquantile computes it, plus sigma^2 / 2 (0 +
// sigma^2 / 2 when no group is ok) — then per (anchor, landmark) over its
// targets: RES_OUTLIER where ok and above the threshold, the inlier count,
// the relative baseline max(old, idepth |t_i - t_j|) over the inliers, the
// landmark's outlier flag and its optimization count.
//
// Bound: bytes (9 bytes per (anchor, target, landmark) group in, 4 out: 1.3
// MB at K = 17, N = 340).  Design, three kernels behind one entry, spread over
// the card, nothing read on the host: a radix select of the two order
// statistics (ranks lo and hi = lo + 1 of the m ok energies; energies are >= 0,
// so their float bits order as unsigned integers) by digits of 11, 11 and 10
// bits, then the statuses.
//  1. count_kernel, a grid of blocks of 1024 groups: the ok groups and the
//     histogram of the top digit.  A block counts in shared memory (lanes that
//     share a bin add once, by __match_any_sync: energies of one magnitude fall
//     into few bins) and adds its non-zero bins into the workspace's; integer
//     atomics, so the counts are exact and independent of the order.  The
//     block that takes the last ticket loads the bins (8 a thread), picks each
//     rank's bin by one block scan, zeroes the bins it read and the ticket.
//  2. collect_kernel, the same grid and one more block: each block appends the
//     ok groups under either rank's top digit (the candidates, a few per cent
//     of them) to a list in the workspace, one atomic a block, and counts
//     their middle digit into the rank's histogram in the workspace; the
//     extra block writes the frames' distances |t_i - t_j|.  The last block
//     picks the middle digits as count_kernel's picks the top, then counts
//     the bottom digit of the candidates under both ranks' 22 high bits in
//     shared memory (8 loads a thread at once) and picks it, and writes the
//     threshold.  While the ranks share their high bits they share one
//     histogram; where they part, the hi rank counts in a second one.
//  3. status_kernel, a block per (anchor, 32 landmarks): warp w walks the
//     targets j = w, w + 8, ... (a lane a landmark, loads of all its targets
//     at once), writes the statuses and leaves each inlier's idepth |t_i -
//     t_j| in shared memory; warp 0 then takes the max in target order with
//     fmaxf from 0, as the one-thread walk did (the same bits for NaN, -0
//     and negative idepths), and the count.
// The workspace (a StatusWorkspace a sequence) is zero between launches but
// for the selection it hands from kernel to kernel, which each call writes
// before it reads (kernels.py::workspace); the candidates lie in a buffer of
// their own, written before they are read (kernels.py::scratch).
//
// Sequence axis (seq_axis.cuh): every kernel has grid z a sequence, with a
// header of its own at z kWorkspaceHeader (its tickets and counts: the last
// block is found among sequence z's blocks) and its candidates at z k k n,
// so the headers lie where they lie whatever the shape and the count of the
// sequences of a call; the window's old baselines, outlier
// flags and optimization counts are read at `bank_seq[z]`, the solved state
// (poses, idepth, the landmark mask) at `state_seq[z]` (null inside the LM
// loop: its carried state), the evaluation and the outputs at z.

#include "ba_body.cuh"
#include "ba_entries.cuh"
#include "seq_axis.cuh"

namespace {

using namespace ba;

constexpr int kSelectThreads = 256;
constexpr int kPerThread = 4;
constexpr int kSelectGroups = kSelectThreads * kPerThread;  // groups a block
constexpr int kBins = 2048;                                  // 11-bit digits
constexpr int kBinsPerThread = kBins / kSelectThreads;
constexpr int kStatusWarps = 8;
constexpr int kMaxFrames = 40;  // as ba_linearize.cu
constexpr int kResOutlier = 2;  // solvers/pba.py::RES_OUTLIER
constexpr int kTopShift = 21;   // the top digit: bits 21..31
// the bytes of a sequence's header in the workspace (kernels.py
// STATUS_WORKSPACE_BYTES)
constexpr int kWorkspaceHeader = 32768;

struct StatusWorkspace {
  unsigned int ticket;          // blocks of the kernel done; zero between kernels
  unsigned int count;           // ok groups; zero between launches
  unsigned int candidates;      // groups collected; zero between launches
  unsigned int hist[kBins];     // the top digit's counts; zero between launches
  unsigned int mid[2][kBins];   // the lo and the hi rank's middle digit; zero between launches
  unsigned int prefix[2];       // the bits of each rank known so far
  int rank[2];                  // each rank within its prefix
  int m;                        // ok groups
  float dist[kMaxFrames][kMaxFrames];   // |t_i - t_j| of the frames' positions
};
static_assert(sizeof(StatusWorkspace) <= kWorkspaceHeader, "the header outgrew its bytes");

// sequence z's header
template <class W>
__device__ __forceinline__ W* workspace_of(W* ws) {
  return (W*)((char*)ws + (size_t)blockIdx.z * kWorkspaceHeader);
}

// lanes of a warp that share a bin add once
__device__ __forceinline__ void add_shared(unsigned int* hist, unsigned int bin, bool take) {
  const unsigned active = __ballot_sync(kFull, take);
  if (!take) return;
  const unsigned peers = __match_any_sync(active, bin);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], (unsigned)__popc(peers));
}

// exclusive block scans of two values a thread (kSelectThreads threads) →
// the sums of the threads before this one
__device__ __forceinline__ uint2 block_exclusive2(uint2 v, uint2* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint2 inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int x = __shfl_up_sync(kFull, inc.x, off);
    const unsigned int y = __shfl_up_sync(kFull, inc.y, off);
    if (lane >= off) {
      inc.x += x;
      inc.y += y;
    }
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  uint2 before = make_uint2(0u, 0u);
  for (int w = 0; w < warp; ++w) {
    before.x += warp_sums[w].x;
    before.y += warp_sums[w].y;
  }
  return make_uint2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

// the bin of ``rank`` among the thread's bins ``h`` (``below`` counted before
// them; the thread holds ``per`` bins from index threadIdx.x · per, the rest of
// ``h`` zero), with the rank left within it, from the thread that holds it
__device__ __forceinline__ void pick_bin(const unsigned int (&h)[kBinsPerThread],
                                         unsigned int below, unsigned int sum, int rank,
                                         int per, int* picked) {
  if ((unsigned)rank < below || (unsigned)rank >= below + sum) return;
  int bin = 0;
#pragma unroll
  for (int b = 0; b < kBinsPerThread; ++b) {
    if (bin == b && below + h[b] <= (unsigned)rank) {
      below += h[b];
      bin = b + 1;
    }
  }
  picked[0] = threadIdx.x * per + bin;
  picked[1] = rank - (int)below;
}

// whether this block takes the grid's last ticket (its writes fenced first)
__device__ __forceinline__ bool last_block(StatusWorkspace* ws, bool* last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(&ws->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (*last) __threadfence();
  return *last;
}

// the ok groups and the top digit's histogram; the last block picks both
// ranks' top digits
__global__ void __launch_bounds__(kSelectThreads)
count_kernel(const float* __restrict__ energy, const unsigned char* __restrict__ ok,
             int groups, float quantile, StatusWorkspace* __restrict__ ws) {
  energy = seq::at(energy, blockIdx.z, groups);
  ok = seq::at(ok, blockIdx.z, groups);
  ws = workspace_of(ws);
  __shared__ unsigned int hist[kBins];
  __shared__ uint2 warp_sums[kSelectThreads / 32];
  __shared__ int picked[2][2];
  __shared__ int rank[2];
  __shared__ bool last;
  const int tid = threadIdx.x;
  for (int b = tid; b < kBins; b += kSelectThreads) hist[b] = 0;
  unsigned int bits[kPerThread];
  bool is_ok[kPerThread];
  const int base = blockIdx.x * kSelectGroups + tid;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int g = base + r * kSelectThreads;
    is_ok[r] = g < groups && ok[g] != 0;
    bits[r] = g < groups ? __float_as_uint(energy[g]) : 0u;
  }
  __syncthreads();
  unsigned int count = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    add_shared(hist, bits[r] >> kTopShift, is_ok[r]);
    count += is_ok[r] ? 1u : 0u;
  }
  count = __reduce_add_sync(kFull, count);
  if ((tid & 31) == 0 && count) atomicAdd(&ws->count, count);
  __syncthreads();
  for (int b = tid; b < kBins; b += kSelectThreads)
    if (hist[b]) atomicAdd(&ws->hist[b], hist[b]);
  if (!last_block(ws, &last)) return;

  // the last block: the count and this thread's bins in one wave of loads
  if (tid == 0) {
    const int m = (int)__ldcg(&ws->count);
    // position quantile * (m - 1), exact in f32 for m < 2^22
    const float at = quantile * (float)(m - 1);
    rank[0] = (int)floorf(at);
    rank[1] = (int)ceilf(at);
    ws->m = m;
    ws->count = 0;
    ws->ticket = 0;
  }
  const int first = tid * kBinsPerThread;
  unsigned int h[kBinsPerThread];
  unsigned int sum = 0;
#pragma unroll
  for (int b = 0; b < kBinsPerThread; ++b) {
    h[b] = __ldcg(&ws->hist[first + b]);
    sum += h[b];
  }
  if (tid < 4) (&picked[0][0])[tid] = tid & 1 ? 0 : kBins - 1;
  const unsigned int below = block_exclusive2(make_uint2(sum, 0u), warp_sums).x;
  pick_bin(h, below, sum, rank[0], kBinsPerThread, picked[0]);
  pick_bin(h, below, sum, rank[1], kBinsPerThread, picked[1]);
#pragma unroll
  for (int b = 0; b < kBinsPerThread; ++b)
    if (h[b]) ws->hist[first + b] = 0u;
  __syncthreads();
  if (tid < 2) {
    ws->prefix[tid] = (unsigned)picked[tid][0] << kTopShift;
    ws->rank[tid] = picked[tid][1];
  }
}

// the candidates under either rank's top digit, appended to a list, and
// their middle digit counted per rank; the last block picks the middle digits,
// selects the bottom digit among the candidates and writes the threshold.
// The grid's extra block (the last index) has no groups: it writes the
// frames' distances.
__global__ void __launch_bounds__(kSelectThreads)
collect_kernel(const float* __restrict__ energy, const unsigned char* __restrict__ ok,
               int groups, float quantile, float sigma, const float* __restrict__ t_lin_q,
               const float* __restrict__ t_lin_t, const float* __restrict__ eps, int k,
               StatusWorkspace* __restrict__ ws, unsigned int* __restrict__ cand,
               float* __restrict__ thresh, const int* __restrict__ state_seq) {
  {
    const int z = blockIdx.z, ss = seq::of(state_seq);
    energy = seq::at(energy, z, groups);
    ok = seq::at(ok, z, groups);
    t_lin_q = seq::at(t_lin_q, ss, 4 * k);
    t_lin_t = seq::at(t_lin_t, ss, 3 * k);
    eps = seq::at(eps, ss, 8 * k);
    ws = workspace_of(ws);
    cand = seq::at(cand, z, (size_t)groups);
    thresh = seq::at(thresh, z, 1);
  }
  constexpr int kLowBins = 1024;  // the bottom digit: bits 0..9
  constexpr int kChunk = 8;       // candidates a thread loads at once
  __shared__ unsigned int low[2][kLowBins];
  __shared__ uint2 warp_sums[kSelectThreads / 32];
  __shared__ int picked[2][2];
  __shared__ unsigned int prefix[2];
  __shared__ int rank[2];
  __shared__ unsigned int at_list, total, length;
  __shared__ bool last;
  __shared__ Vec3 pos[kMaxFrames];
  const int tid = threadIdx.x;
  const unsigned int top0 = __ldcg(&ws->prefix[0]), top1 = __ldcg(&ws->prefix[1]);
  const bool parted_top = top0 != top1;
  const unsigned int known = ~0u << kTopShift;
  if (blockIdx.x == gridDim.x - 1) {
    if (tid < k) pos[tid] = frame_pose(t_lin_q, t_lin_t, eps, tid).t;
    __syncthreads();
    for (int e = tid; e < k * k; e += kSelectThreads) {
      const int i = e / k, j = e % k;
      const float dx = pos[i].x - pos[j].x, dy = pos[i].y - pos[j].y, dz = pos[i].z - pos[j].z;
      ws->dist[i][j] = sqrtf((dx * dx + dy * dy) + dz * dz);
    }
  }
  unsigned int bits[kPerThread];
  bool take[kPerThread];
  const int base = blockIdx.x * kSelectGroups + tid;
  unsigned int mine = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int g = base + r * kSelectThreads;
    const bool is_ok = g < groups && ok[g] != 0;
    bits[r] = g < groups ? __float_as_uint(energy[g]) : 0u;
    const unsigned int high = bits[r] & known, d = (bits[r] >> 10) & 0x7FFu;
    const bool lo = is_ok && high == top0, hi = is_ok && !lo && parted_top && high == top1;
    take[r] = lo || hi;
    mine += take[r] ? 1u : 0u;
    if (take[r]) atomicAdd(&ws->mid[lo ? 0 : 1][d], 1u);
  }
  // the block's place in the list: one scan, one atomic
  unsigned int at = block_exclusive2(make_uint2(mine, 0u), warp_sums).x;
  if (tid == kSelectThreads - 1) total = at + mine;
  __syncthreads();
  if (tid == 0) at_list = total ? atomicAdd(&ws->candidates, total) : 0u;
  __syncthreads();
  at += at_list;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
    if (take[r]) cand[at++] = bits[r];
  if (!last_block(ws, &last)) return;

  // the last block: the middle digits from their counts (8 bins a thread of
  // each rank's, one wave of loads, one block scan of the pair) ...
  if (tid == 0) {
    length = __ldcg(&ws->candidates);
    ws->candidates = 0;
    ws->ticket = 0;
    rank[0] = __ldcg(&ws->rank[0]);
    rank[1] = __ldcg(&ws->rank[1]);
  }
  for (int b = tid; b < 2 * kLowBins; b += kSelectThreads) (&low[0][0])[b] = 0;
  if (tid < 4) (&picked[0][0])[tid] = tid & 1 ? 0 : kBins - 1;
  const int first = tid * kBinsPerThread;
  unsigned int h_lo[kBinsPerThread], h_hi[kBinsPerThread];
  uint2 sum = make_uint2(0u, 0u);
#pragma unroll
  for (int b = 0; b < kBinsPerThread; ++b) {
    h_lo[b] = __ldcg(&ws->mid[0][first + b]);
    h_hi[b] = parted_top ? __ldcg(&ws->mid[1][first + b]) : h_lo[b];
    sum.x += h_lo[b];
    sum.y += h_hi[b];
  }
  const uint2 below = block_exclusive2(sum, warp_sums);
  pick_bin(h_lo, below.x, sum.x, rank[0], kBinsPerThread, picked[0]);
  pick_bin(h_hi, below.y, sum.y, rank[1], kBinsPerThread, picked[1]);
#pragma unroll
  for (int b = 0; b < kBinsPerThread; ++b) {
    if (h_lo[b]) ws->mid[0][first + b] = 0u;
    if (parted_top && h_hi[b]) ws->mid[1][first + b] = 0u;
  }
  __syncthreads();
  if (tid < 2) {
    prefix[tid] = (tid ? top1 : top0) | ((unsigned)picked[tid][0] << 10);
    rank[tid] = picked[tid][1];
    picked[tid][0] = kLowBins - 1;
    picked[tid][1] = 0;
  }
  __syncthreads();
  // ... then the bottom digit over the candidates under both ranks' 22 high
  // bits, kChunk loads a thread at once
  const unsigned int p0 = prefix[0], p1 = prefix[1];
  const bool parted = p0 != p1;
  const int len = (int)length;
  for (int start = tid; start < len; start += kSelectThreads * kChunk) {
    unsigned int v[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int i = start + c * kSelectThreads;
      v[c] = i < len ? __ldcg(&cand[i]) : 0u;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (start + c * kSelectThreads >= len) continue;
      const unsigned int high = v[c] & (~0u << 10);
      if (high == p0) atomicAdd(&low[0][v[c] & 0x3FFu], 1u);
      else if (parted && high == p1) atomicAdd(&low[1][v[c] & 0x3FFu], 1u);
    }
  }
  __syncthreads();
  // 4 bins a thread over the 1024
  constexpr int kLowPerThread = kLowBins / kSelectThreads;
  unsigned int l_lo[kBinsPerThread], l_hi[kBinsPerThread];
  uint2 lsum = make_uint2(0u, 0u);
#pragma unroll
  for (int b = 0; b < kBinsPerThread; ++b) {
    const bool in = b < kLowPerThread;
    l_lo[b] = in ? low[0][tid * kLowPerThread + b] : 0u;
    l_hi[b] = in ? low[parted ? 1 : 0][tid * kLowPerThread + b] : 0u;
    lsum.x += l_lo[b];
    lsum.y += l_hi[b];
  }
  const uint2 lbelow = block_exclusive2(lsum, warp_sums);
  pick_bin(l_lo, lbelow.x, lsum.x, rank[0], kLowPerThread, picked[0]);
  pick_bin(l_hi, lbelow.y, lsum.y, rank[1], kLowPerThread, picked[1]);
  __syncthreads();
  if (tid == 0) {
    const unsigned int v_lo_bits = p0 | (unsigned)picked[0][0];
    const unsigned int v_hi_bits = p1 | (unsigned)picked[1][0];
    const int m = ws->m;
    float q = 0.0f;
    if (m > 0) {
      const float at_q = quantile * (float)(m - 1);
      const float w = at_q - floorf(at_q);
      const float v_lo = __uint_as_float(v_lo_bits), v_hi = __uint_as_float(v_hi_bits);
      // torch.lerp
      const float diff = v_hi - v_lo;
      q = w < 0.5f ? v_lo + w * diff : v_hi - diff * (1.0f - w);
    }
    thresh[0] = q + 0.5f * sigma * sigma;
  }
}

__global__ void __launch_bounds__(kStatusWarps * 32)
status_kernel(const float* __restrict__ energy, const unsigned char* __restrict__ ok,
              const int* __restrict__ candidate, const float* __restrict__ thresh,
              const StatusWorkspace* __restrict__ ws, const float* __restrict__ lm_idepth,
              const unsigned char* __restrict__ lm_mask,
              const float* __restrict__ old_baseline,
              const unsigned char* __restrict__ old_outlier,
              const int* __restrict__ old_opt_count, int k, int n, int min_valid,
              int* __restrict__ new_status, float* __restrict__ baseline,
              int* __restrict__ inliers, unsigned char* __restrict__ outlier,
              int* __restrict__ opt_count, const int* __restrict__ bank_seq,
              const int* __restrict__ state_seq) {
  {
    const int z = blockIdx.z, sb = seq::of(bank_seq), ss = seq::of(state_seq);
    const size_t kn = (size_t)k * n, groups = kn * k;
    energy = seq::at(energy, z, groups);
    ok = seq::at(ok, z, groups);
    candidate = seq::at(candidate, z, groups);
    thresh = seq::at(thresh, z, 1);
    ws = workspace_of(ws);
    lm_idepth = seq::at(lm_idepth, ss, kn);
    lm_mask = seq::at(lm_mask, ss, kn);
    old_baseline = seq::at(old_baseline, sb, kn);
    old_outlier = seq::at(old_outlier, sb, kn);
    old_opt_count = seq::at(old_opt_count, sb, kn);
    new_status = seq::at(new_status, z, groups);
    baseline = seq::at(baseline, z, kn);
    inliers = seq::at(inliers, z, kn);
    outlier = seq::at(outlier, z, kn);
    opt_count = seq::at(opt_count, z, kn);
  }
  constexpr int kTargets = (kMaxFrames + kStatusWarps - 1) / kStatusWarps;
  __shared__ float rel[kMaxFrames][32];
  __shared__ unsigned char inl[kMaxFrames][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (n + 31) / 32;
  const int i = blockIdx.x / chunks;
  const int ln = (blockIdx.x % chunks) * 32 + lane;
  const bool live = ln < n;
  const int lm = i * n + ln;
  const float thr = __ldg(thresh);
  const float d = live ? lm_idepth[lm] : 0.0f;
  float e[kTargets];
  bool is_ok[kTargets];
  int cand[kTargets];
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int j = warp + t * kStatusWarps;
    const size_t g = ((size_t)i * k + j) * n + ln;
    const bool in = live && j < k;
    e[t] = in ? energy[g] : 0.0f;
    is_ok[t] = in && ok[g] != 0;
    cand[t] = in ? candidate[g] : 0;
  }
#pragma unroll
  for (int t = 0; t < kTargets; ++t) {
    const int j = warp + t * kStatusWarps;
    if (!live || j >= k) continue;
    const size_t g = ((size_t)i * k + j) * n + ln;
    new_status[g] = (is_ok[t] && e[t] > thr) ? kResOutlier : cand[t];
    const bool inlier = is_ok[t] && e[t] <= thr;
    inl[j][lane] = inlier ? 1 : 0;
    if (inlier) rel[j][lane] = d * ws->dist[i][j];
  }
  __syncthreads();
  if (warp != 0 || !live) return;
  float rel_max = 0.0f;
  int count = 0;
  for (int j = 0; j < k; ++j) {
    if (inl[j][lane]) {
      rel_max = fmaxf(rel_max, rel[j][lane]);
      ++count;
    }
  }
  baseline[lm] = fmaxf(old_baseline[lm], rel_max);
  inliers[lm] = count;
  outlier[lm] = (old_outlier[lm] || (lm_mask[lm] && count < min_valid)) ? 1 : 0;
  opt_count[lm] = old_opt_count[lm] + (count > 0 ? 1 : 0);
}

}  // namespace

// Evaluation at the solved state: energy_patch [k,k,n], ok [k,k,n] u8,
// status_candidate [k,k,n] int32.  Window: t_lin_q [k,4], t_lin_t [k,3], eps
// [k,8], lm_idepth [k,n], lm_mask [k,n] u8 (valid landmark of a valid
// frame), lm_baseline [k,n], lm_outlier [k,n] u8, lm_opt_count [k,n] int32.
// workspace: workspace_bytes >= 32768 bytes of device memory a sequence (its
// header), zero before the first launch on its stream (each launch leaves it
// so); candidates: k k n words a sequence, any contents.  Outputs: thresh [1], res_status [k,k,n] int32,
// baseline [k,n], inliers [k,n] int32, outlier [k,n] u8, opt_count [k,n]
// int32.  Sequence axis (seq_axis.cuh): `seqs` sequences, grid z, each with
// its header and its candidates; lm_baseline,
// lm_outlier and lm_opt_count are [B, ...] stacks read at bank_seq[z], the
// poses, eps, lm_idepth and lm_mask at state_seq[z] (null lists: z); the
// evaluation and the outputs are [seqs, ...] at z.  Returns
// cudaErrorInvalidValue (1) for k above 40 or a smaller workspace.
extern "C" int ba_point_status(const float* energy, const unsigned char* ok,
                               const int* candidate, const float* t_lin_q,
                               const float* t_lin_t, const float* eps,
                               const float* lm_idepth, const unsigned char* lm_mask,
                               const float* old_baseline, const unsigned char* old_outlier,
                               const int* old_opt_count, int k, int n, float quantile,
                               float sigma, int min_valid, void* workspace,
                               int workspace_bytes, unsigned int* candidates, float* thresh,
                               int* new_status,
                               float* baseline, int* inliers, unsigned char* outlier,
                               int* opt_count, int seqs, const int* bank_seq,
                               const int* state_seq, void* stream) {
  if (k < 1 || k > kMaxFrames || n < 1 || workspace == nullptr || candidates == nullptr ||
      !seq::valid_count(seqs) || (size_t)workspace_bytes < (size_t)kWorkspaceHeader * seqs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  StatusWorkspace* ws = (StatusWorkspace*)workspace;
  const int groups = k * k * n;
  const int blocks = (groups + kSelectGroups - 1) / kSelectGroups;
  count_kernel<<<dim3(blocks, 1, seqs), kSelectThreads, 0, s>>>(energy, ok, groups, quantile,
                                                                ws);
  collect_kernel<<<dim3(blocks + 1, 1, seqs), kSelectThreads, 0, s>>>(
      energy, ok, groups, quantile, sigma, t_lin_q, t_lin_t, eps, k, ws, candidates, thresh,
      state_seq);
  status_kernel<<<dim3(k * ((n + 31) / 32), 1, seqs), kStatusWarps * 32, 0, s>>>(
      energy, ok, candidate, thresh, ws, lm_idepth, lm_mask, old_baseline, old_outlier,
      old_opt_count, k, n, min_valid, new_status, baseline, inliers, outlier, opt_count,
      bank_seq, state_seq);
  return (int)cudaGetLastError();
}
