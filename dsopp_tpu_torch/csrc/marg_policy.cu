// K15p marg_policy: the sparse frame-marginalization policy of a keyframe.
//
// Replaces dsopp_tpu/tracker/marginalization.py::flags_device and
// ::kept_first_perm (the XLA ops of the keyframe program; the port's plain
// version is tracker/marginalization.py::flags_device_plain).  It computes
//  1. frame flags: a frame older than the last two whose live share fell
//     below keep_fraction of its total (exclusive cumsum of the candidates
//     against minimum_size), then, while the window is still above
//     maximum_size, the first argmax of DSO eq (20)
//     sqrt|t_i - t_newest| * sum_j 1 / (1e-5 + |t_i - t_j|);
//  2. landmark triage from res_status[:, newest]: a live landmark whose
//     residual to the newest frame is not Ok (or whose frame is flagged)
//     is marginalized when it was optimized at least once, else made an
//     outlier; a long-lived, well-observed one is marginalized too; every
//     live landmark of a flagged frame leaves;
//  3. perm: the stable kept-frames-first order of the slots.
// The frames' translations come in as torch computed them (poses_t), so the
// scores see the same positions as the plain version.
//
// Bound: bytes (the [k, n] landmark fields and res_status[:, newest]: about
// 0.1 MB at k = 17, n = 340); the work is a few thousand compares.  Design:
// one block; one thread per frame counts its live landmarks and sums its
// eq (20) row in slot order; one thread decides the frame flags in slot
// order (the cumsum, the first argmax) and writes perm; all threads then
// triage the k x n landmarks.  Nothing is read on the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFrames = 40;  // tracker/marginalization.py::_POLICY_MAX_FRAMES
constexpr int kResOk = 0;
constexpr int kKeepFramesFromEnd = 2;
constexpr int kMinFrameAge = 1;
constexpr float kEpsDist = 1e-5f;

__global__ void __launch_bounds__(kThreads)
policy_kernel(const unsigned char* __restrict__ frame_valid,
              const unsigned char* __restrict__ lm_valid,
              const unsigned char* __restrict__ lm_outlier,
              const int* __restrict__ lm_inliers, const int* __restrict__ lm_opt_count,
              const int* __restrict__ frame_id, const int* __restrict__ res_status,
              const float* __restrict__ poses_t, const long long* __restrict__ imm_counts,
              int k, int n, int minimum_size, int maximum_size, float keep_fraction,
              unsigned char* __restrict__ frame_flags,
              unsigned char* __restrict__ lm_flags, unsigned char* __restrict__ new_outliers,
              long long* __restrict__ perm) {
  __shared__ unsigned char valid[kMaxFrames], flag[kMaxFrames];
  __shared__ long long active[kMaxFrames];
  __shared__ float score[kMaxFrames];
  __shared__ int frames;
  const int tid = threadIdx.x;
  if (tid < k) valid[tid] = frame_valid[tid];
  __syncthreads();
  if (tid == 0) {
    int f = 0;
    for (int i = 0; i < k; ++i) f += valid[i] ? 1 : 0;
    frames = f;
  }
  __syncthreads();
  const int f = frames;
  const int newest = f > 0 ? f - 1 : 0;
  if (tid < k) {
    const int i = tid;
    int live = 0;
    for (int l = 0; l < n; ++l) {
      const int e = i * n + l;
      live += (lm_valid[e] && !lm_outlier[e]) ? 1 : 0;
    }
    active[i] = live + imm_counts[i];
    // DSO eq (20); the row sum in slot order
    const bool elig1 = i < f - kKeepFramesFromEnd;
    const int newest_id = frame_id[newest];
    const float xi = poses_t[3 * i], yi = poses_t[3 * i + 1], zi = poses_t[3 * i + 2];
    float inv_sum = 0.0f;
    for (int j = 0; j < k; ++j) {
      const bool elig_j = (j < f - kKeepFramesFromEnd) && frame_id[j] + kMinFrameAge <= newest_id + 1;
      float term = 0.0f;
      if (elig_j && j != i) {
        const float dx = xi - poses_t[3 * j], dy = yi - poses_t[3 * j + 1],
                    dz = zi - poses_t[3 * j + 2];
        term = 1.0f / (kEpsDist + sqrtf((dx * dx + dy * dy) + dz * dz));
      }
      inv_sum = inv_sum + term;
    }
    const float dx = xi - poses_t[3 * newest], dy = yi - poses_t[3 * newest + 1],
                dz = zi - poses_t[3 * newest + 2];
    const bool elig_i = elig1 && frame_id[i] + kMinFrameAge <= newest_id;
    score[i] = elig_i ? sqrtf(sqrtf((dx * dx + dy * dy) + dz * dz)) * inv_sum : 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    // 1. too few live points, with the budget of the frames flagged before
    int prior = 0, flagged1 = 0;
    for (int i = 0; i < k; ++i) {
      const long long total = active[i];
      const bool cand = i < f - kKeepFramesFromEnd && total > 0 &&
                        (float)active[i] < keep_fraction * (float)total;
      flag[i] = (cand && f - prior > minimum_size) ? 1 : 0;
      flagged1 += flag[i];
      prior += cand ? 1 : 0;
    }
    // 2. the first argmax of the score
    int best = 0;
    for (int i = 1; i < k; ++i)
      if (score[i] > score[best]) best = i;
    if (f > maximum_size + flagged1 && score[best] > 0.0f) flag[best] = 1;
    for (int i = 0; i < k; ++i) frame_flags[i] = flag[i];
    // 3. the stable kept-frames-first order
    int at = 0;
    for (int i = 0; i < k; ++i)
      if (valid[i] && !flag[i]) perm[at++] = i;
    for (int i = 0; i < k; ++i)
      if (!(valid[i] && !flag[i])) perm[at++] = i;
  }
  __syncthreads();
  // 4. landmark triage
  const int min_good = (minimum_size + 1) / 2;
  const int good_opts = maximum_size * 2;
  for (int e = tid; e < k * n; e += kThreads) {
    const int i = e / n, l = e % n;
    const bool tri = i < f - 1 && f > kKeepFramesFromEnd;
    const bool live = lm_valid[e] && !lm_outlier[e];
    const bool oob = res_status[((size_t)i * k + newest) * n + l] != kResOk || flag[i];
    const bool valid_marg = lm_inliers[e] >= min_good && lm_opt_count[e] > good_opts;
    const bool sufficient = lm_opt_count[e] > 0;
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
// [k,k,n] int32; poses_t [k,3] (T_lin exp(eps) as torch computed it);
// imm_counts [k] int64 (valid immature points per bank).  Outputs:
// frame_flags [k] u8, lm_flags, new_outliers [k,n] u8, perm [k] int64.
// Returns cudaErrorInvalidValue (1) for k above 40.
extern "C" int marg_policy(const unsigned char* frame_valid, const unsigned char* lm_valid,
                           const unsigned char* lm_outlier, const int* lm_inliers,
                           const int* lm_opt_count, const int* frame_id,
                           const int* res_status, const float* poses_t,
                           const long long* imm_counts, int k, int n, int minimum_size,
                           int maximum_size, float keep_fraction,
                           unsigned char* frame_flags, unsigned char* lm_flags,
                           unsigned char* new_outliers, long long* perm, void* stream) {
  if (k < 1 || k > kMaxFrames || n < 0) return (int)cudaErrorInvalidValue;
  policy_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      frame_valid, lm_valid, lm_outlier, lm_inliers, lm_opt_count, frame_id, res_status,
      poses_t, imm_counts, k, n, minimum_size, maximum_size, keep_fraction,
      frame_flags, lm_flags, new_outliers, perm);
  return (int)cudaGetLastError();
}
