// K15p marg_policy: the sparse frame-marginalization policy of a keyframe.
//
// Replaces dsopp_tpu/tracker/marginalization.py::flags_device and
// ::kept_first_perm (the XLA ops of the keyframe program; the port's plain
// version is tracker/marginalization.py::flags_device_plain).  It computes
//  1. frame flags: a frame older than the last two whose live share fell
//     below keep_fraction of its total (its live landmarks and its valid
//     immature points; exclusive cumsum of the candidates against
//     minimum_size), then, while the window is still above maximum_size, the
//     first argmax of DSO eq (20)
//     sqrt|t_i - t_newest| * sum_j 1 / (1e-5 + |t_i - t_j|);
//  2. landmark triage from res_status[:, newest]: a live landmark whose
//     residual to the newest frame is not Ok (or whose frame is flagged)
//     is marginalized when it was optimized at least once, else made an
//     outlier; a long-lived, well-observed one is marginalized too; every
//     live landmark of a flagged frame leaves;
//  3. perm: the stable kept-frames-first order of the slots.
// It takes the window's raw tensors and the immature banks' valid mask: the
// frames' positions T_lin exp(eps) are composed here (ba_body.cuh's
// frame_pose, the bits of K13's and K14's poses, within
// testing/parity.py::KERNEL_POSE_ULPS of window.poses()), and the valid
// immature points are counted here, so the wrapper runs no torch operator.
//
// Bound: bytes (the [k, n] landmark fields, res_status[:, newest] and the
// [k, m] immature mask: about 0.1 MB at k = 17, n = 340, m = 1200); the work
// is a few thousand compares, and the time is latency: the design keeps the
// chains of dependent steps short and overlaps them.  One block of 1024
// threads.  First every thread issues the loads of its triage entries (the
// terms that do not depend on the flags, 4 bits an entry in a register); a
// thread a frame composes its position (the chain of dependent loads and
// trig) while a warp a frame counts the frame's live landmarks and valid
// immature points, 16 bytes a lane by consecutive lanes, then a shuffle
// reduce (integer sums: their order does not matter); a thread a frame sums
// its eq (20) row in slot order; warp 0 takes the flag decision in slot
// order (the exclusive count of candidates and the kept-first order by
// ballots, the first argmax by one lane) and writes perm; then every thread
// combines its held terms with the flags and writes its entries.  Nothing
// is read on the host.  Sequence axis (seq_axis.cuh): grid z is a sequence,
// one block each; the window's fields and the immature mask are [B, ...]
// stacks read at `seq[z]`, the outputs [S, ...] at z.

#include <stdint.h>

#include "ba_body.cuh"
#include "seq_axis.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFrames = 40;  // tracker/marginalization.py::_POLICY_MAX_FRAMES
constexpr int kResOk = 0;
constexpr int kKeepFramesFromEnd = 2;
constexpr int kMinFrameAge = 1;
constexpr float kEpsDist = 1e-5f;
// triage entries a thread holds from the start (4 bits each): k n up to
// 8 * 1024, as at the dense point (17 x 340)
constexpr int kHeldEntries = 8;

// The bytes of the 4-byte word at byte offset `first` that lie inside
// [lo, hi) and have their low bit set (bool bytes: 0 or 1)
__device__ __forceinline__ int count_word(unsigned x, size_t first, size_t lo, size_t hi) {
  if (first >= hi || first + 4 <= lo) return 0;
  const int from = first < lo ? (int)(lo - first) : 0;
  const int to = hi - first < 4 ? (int)(hi - first) : 4;
  const unsigned keep = (to == 4 ? 0xffffffffu : (1u << (8 * to)) - 1u) & (0xffffffffu << (8 * from));
  return __popc(x & keep & 0x01010101u);
}

// The number of bytes b in [lo, hi) with a[b] set and, where `b_not` is
// given, b_not[b] clear (bool bytes: 0 or 1), summed over a warp's lanes;
// 16-byte loads by consecutive lanes where both arrays are 16-byte aligned
// (a row of the dense point's immature mask, 1200 bytes, is 3 loads a lane)
__device__ int warp_count(const unsigned char* __restrict__ a,
                          const unsigned char* __restrict__ b_not, size_t lo, size_t hi,
                          int lane) {
  int count = 0;
  const uintptr_t bases = (uintptr_t)a | (uintptr_t)(b_not != nullptr ? b_not : a);
  if ((bases & 15) == 0) {
    const uint4* a16 = reinterpret_cast<const uint4*>(a);
    const uint4* b16 = reinterpret_cast<const uint4*>(b_not);
#pragma unroll 4
    for (size_t w = lo / 16 + lane; 16 * w < hi; w += 32) {
      uint4 x = __ldg(a16 + w);
      if (b_not != nullptr) {
        const uint4 y = __ldg(b16 + w);
        x.x &= ~y.x, x.y &= ~y.y, x.z &= ~y.z, x.w &= ~y.w;
      }
      const size_t first = 16 * w;
      count += count_word(x.x, first, lo, hi) + count_word(x.y, first + 4, lo, hi) +
               count_word(x.z, first + 8, lo, hi) + count_word(x.w, first + 12, lo, hi);
    }
  } else {
#pragma unroll 4
    for (size_t e = lo + lane; e < hi; e += 32)
      count += (a[e] != 0 && (b_not == nullptr || b_not[e] == 0)) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(ba::kFull, count, off);
  return count;
}

__global__ void __launch_bounds__(kThreads, 1)
policy_kernel(const unsigned char* __restrict__ frame_valid,
              const unsigned char* __restrict__ lm_valid,
              const unsigned char* __restrict__ lm_outlier,
              const int* __restrict__ lm_inliers, const int* __restrict__ lm_opt_count,
              const int* __restrict__ frame_id, const int* __restrict__ res_status,
              const float* __restrict__ t_lin_q, const float* __restrict__ t_lin_t,
              const float* __restrict__ eps, const unsigned char* __restrict__ imm_valid,
              int k, int n, int m, int minimum_size, int maximum_size, float keep_fraction,
              unsigned char* __restrict__ frame_flags, unsigned char* __restrict__ lm_flags,
              unsigned char* __restrict__ new_outliers, long long* __restrict__ perm,
              const int* __restrict__ bank_seq) {
  {
    const int z = blockIdx.z, sb = seq::of(bank_seq);
    const size_t kn = (size_t)k * n;
    frame_valid = seq::at(frame_valid, sb, k);
    lm_valid = seq::at(lm_valid, sb, kn);
    lm_outlier = seq::at(lm_outlier, sb, kn);
    lm_inliers = seq::at(lm_inliers, sb, kn);
    lm_opt_count = seq::at(lm_opt_count, sb, kn);
    frame_id = seq::at(frame_id, sb, k);
    res_status = seq::at(res_status, sb, kn * k);
    t_lin_q = seq::at(t_lin_q, sb, 4 * k);
    t_lin_t = seq::at(t_lin_t, sb, 3 * k);
    eps = seq::at(eps, sb, 8 * k);
    imm_valid = seq::at(imm_valid, sb, (size_t)k * m);
    frame_flags = seq::at(frame_flags, z, k);
    lm_flags = seq::at(lm_flags, z, kn);
    new_outliers = seq::at(new_outliers, z, kn);
    perm = seq::at(perm, z, k);
  }
  __shared__ float pos[kMaxFrames][3];
  __shared__ int ids[kMaxFrames];
  __shared__ unsigned char valid[kMaxFrames];
  __shared__ int active[kMaxFrames];
  __shared__ float score[kMaxFrames];
  __shared__ unsigned char flag[kMaxFrames];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = ba::valid_frames(frame_valid, k);   // each warp counts by itself
  const int newest = f > 0 ? f - 1 : 0;
  const int entries = k * n;

  // the triage's landmark terms that do not depend on the frame flags, for
  // this thread's first kHeldEntries entries e = tid + j * kThreads: their
  // loads go out first, to arrive while the rest of the block works
  const int min_good = (minimum_size + 1) / 2;
  const int good_opts = maximum_size * 2;
  auto terms = [&](int e) {
    const int i = e / n, l = e % n;
    const bool live = lm_valid[e] && !lm_outlier[e];
    const bool not_ok = res_status[((size_t)i * k + newest) * n + l] != kResOk;
    const bool valid_marg = lm_inliers[e] >= min_good && lm_opt_count[e] > good_opts;
    const bool sufficient = lm_opt_count[e] > 0;
    return (live ? 1u : 0u) | (not_ok ? 2u : 0u) | (valid_marg ? 4u : 0u) |
           (sufficient ? 8u : 0u);
  };
  unsigned held = 0;                          // 4 bits an entry
#pragma unroll
  for (int j = 0; j < kHeldEntries; ++j) {
    const int e = tid + j * kThreads;
    if (e < entries) held |= terms(e) << (4 * j);
  }

  // the frames' positions, a thread a frame
  if (tid < k) {
    const ba::Rigid pose = ba::frame_pose(t_lin_q, t_lin_t, eps, tid);
    pos[tid][0] = pose.t.x;
    pos[tid][1] = pose.t.y;
    pos[tid][2] = pose.t.z;
    ids[tid] = frame_id[tid];
    valid[tid] = frame_valid[tid];
  }
  // a warp a frame, from the last warp down (the first warps compose the
  // poses): live landmarks + valid immature points
  for (int i = kWarps - 1 - warp; i < k; i += kWarps) {
    const int live = warp_count(lm_valid, lm_outlier, (size_t)i * n, (size_t)(i + 1) * n, lane);
    const int imm = warp_count(imm_valid, nullptr, (size_t)i * m, (size_t)(i + 1) * m, lane);
    if (lane == 0) active[i] = live + imm;
  }
  __syncthreads();

  // DSO eq (20), a thread a frame; the row sum in slot order
  if (tid < k) {
    const int i = tid;
    const bool elig1 = i < f - kKeepFramesFromEnd;
    const int newest_id = ids[newest];
    const float xi = pos[i][0], yi = pos[i][1], zi = pos[i][2];
    float inv_sum = 0.0f;
    for (int j = 0; j < k; ++j) {
      const bool elig_j = (j < f - kKeepFramesFromEnd) && ids[j] + kMinFrameAge <= newest_id + 1;
      float term = 0.0f;
      if (elig_j && j != i) {
        const float dx = xi - pos[j][0], dy = yi - pos[j][1], dz = zi - pos[j][2];
        term = 1.0f / (kEpsDist + sqrtf((dx * dx + dy * dy) + dz * dz));
      }
      inv_sum = inv_sum + term;
    }
    const float dx = xi - pos[newest][0], dy = yi - pos[newest][1], dz = zi - pos[newest][2];
    const bool elig_i = elig1 && ids[i] + kMinFrameAge <= newest_id;
    score[i] = elig_i ? sqrtf(sqrtf((dx * dx + dy * dy) + dz * dz)) * inv_sum : 0.0f;
  }
  __syncthreads();
  // the frame flags and perm, warp 0 with lane l on frames l and l + 32 (the
  // slot-order rules as ballots and prefix counts)
  if (warp == 0) {
    const unsigned below = (1u << lane) - 1u;
    // 1. too few live points, with the budget of the frames flagged before:
    //    a candidate's prior is the candidates before it
    bool cand[2], flag1[2], kept[2];
    unsigned cand_m[2], flag1_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      const int total = i < k ? active[i] : 0;
      cand[h] = i < k && i < f - kKeepFramesFromEnd && total > 0 &&
                (float)total < keep_fraction * (float)total;
      cand_m[h] = __ballot_sync(ba::kFull, cand[h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int prior = (h == 1 ? __popc(cand_m[0]) : 0) + __popc(cand_m[h] & below);
      flag1[h] = cand[h] && f - prior > minimum_size;
      flag1_m[h] = __ballot_sync(ba::kFull, flag1[h]);
    }
    const int flagged1 = __popc(flag1_m[0]) + __popc(flag1_m[1]);
    // 2. the first argmax of the score, in slot order
    int best = 0;
    if (lane == 0)
      for (int i = 1; i < k; ++i)
        if (score[i] > score[best]) best = i;
    best = __shfl_sync(ba::kFull, best, 0);
    const bool flag2 = f > maximum_size + flagged1 && score[best] > 0.0f;
    unsigned kept_m[2], rest_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      const bool fl = flag1[h] || (flag2 && i == best);
      if (i < k) {
        flag[i] = fl ? 1 : 0;
        frame_flags[i] = fl ? 1 : 0;
      }
      kept[h] = i < k && valid[i] && !fl;
      kept_m[h] = __ballot_sync(ba::kFull, kept[h]);
      rest_m[h] = __ballot_sync(ba::kFull, i < k && !kept[h]);
    }
    // 3. the stable kept-frames-first order
    const int n_kept = __popc(kept_m[0]) + __popc(kept_m[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      if (i < k) {
        const unsigned* mask = kept[h] ? kept_m : rest_m;
        const int at = (kept[h] ? 0 : n_kept) + (h == 1 ? __popc(mask[0]) : 0) +
                       __popc(mask[h] & below);
        perm[at] = i;
      }
    }
  }
  __syncthreads();
  // 4. landmark triage: the held terms with the frame flags; entries past
  //    the held ones (more than kHeldEntries * kThreads) read theirs here
  const bool tri_f = f > kKeepFramesFromEnd;
  for (int j = 0, e = tid; e < entries; ++j, e += kThreads) {
    const unsigned t = j < kHeldEntries ? (held >> (4 * j)) & 15u : terms(e);
    const int i = e / n;
    const bool tri = i < f - 1 && tri_f;
    const bool live = t & 1u, valid_marg = t & 4u, sufficient = t & 8u;
    const bool oob = (t & 2u) || flag[i];
    const bool out = tri && live && oob && !sufficient;
    bool marg = tri && live && !out && (oob || valid_marg);
    marg = marg || (i < f && flag[i] && live && !out);
    new_outliers[e] = out ? 1 : 0;
    lm_flags[e] = marg ? 1 : 0;
  }
}

}  // namespace

// Window fields: frame_valid [k] u8, lm_valid, lm_outlier [k,n] u8,
// lm_inliers, lm_opt_count [k,n] int32, frame_id [k] int32, res_status
// [k,k,n] int32, t_lin_q [k,4], t_lin_t [k,3], eps [k,8]; imm_valid [k,m] u8
// (the immature banks' valid mask).  Outputs: frame_flags [k] u8, lm_flags,
// new_outliers [k,n] u8, perm [k] int64.  Sequence axis (seq_axis.cuh):
// `seqs` sequences, grid z; the inputs are [B, ...] stacks read at seq[z]
// (null: z), the outputs [seqs, ...] at z.  Returns cudaErrorInvalidValue (1)
// for k above 40.
extern "C" int marg_policy(const unsigned char* frame_valid, const unsigned char* lm_valid,
                           const unsigned char* lm_outlier, const int* lm_inliers,
                           const int* lm_opt_count, const int* frame_id,
                           const int* res_status, const float* t_lin_q, const float* t_lin_t,
                           const float* eps, const unsigned char* imm_valid, int k, int n,
                           int m, int minimum_size, int maximum_size, float keep_fraction,
                           unsigned char* frame_flags, unsigned char* lm_flags,
                           unsigned char* new_outliers, long long* perm, int seqs,
                           const int* seq_list, void* stream) {
  if (k < 1 || k > kMaxFrames || n < 0 || m < 0 || !seq::valid_count(seqs))
    return (int)cudaErrorInvalidValue;
  policy_kernel<<<dim3(1, 1, seqs), kThreads, 0, (cudaStream_t)stream>>>(
      frame_valid, lm_valid, lm_outlier, lm_inliers, lm_opt_count, frame_id, res_status,
      t_lin_q, t_lin_t, eps, imm_valid, k, n, m, minimum_size, maximum_size, keep_fraction,
      frame_flags, lm_flags, new_outliers, perm, seq_list);
  return (int)cudaGetLastError();
}
