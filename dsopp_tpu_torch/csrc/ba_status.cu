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
// MB at K = 17, N = 340).  Design, two kernels behind one entry:
//  1. quantile_kernel, one block, no sort: patch energies are >= 0, so their
//     float bits order as unsigned integers; a radix select narrows the
//     wanted order statistic 8 bits at a time (a 256-bin histogram in shared
//     memory per pass, integer atomics, so the result is exact and the same
//     on every run), four passes per statistic, two statistics.
//  2. status_kernel, one thread per (anchor, landmark) walking its targets;
//     the frames' positions t of T_lin exp(eps) are computed once per block.

#include "ba_body.cuh"
#include "ba_entries.cuh"

namespace {

using namespace ba;

constexpr int kSelectThreads = 1024;
constexpr int kStatusThreads = 256;
constexpr int kMaxFrames = 40;  // as ba_linearize.cu
constexpr int kResOutlier = 2;  // solvers/pba.py::RES_OUTLIER

// the rank-th smallest (0-based) of the ok energies' bit patterns
__device__ unsigned radix_select(const float* __restrict__ energy,
                                 const unsigned char* __restrict__ ok, int groups, int rank,
                                 int* hist, int* pick) {
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (threadIdx.x < 256) hist[threadIdx.x] = 0;
    __syncthreads();
    for (int g = threadIdx.x; g < groups; g += kSelectThreads) {
      if (!ok[g]) continue;
      const unsigned bits = __float_as_uint(energy[g]);
      if ((bits & mask) == prefix) atomicAdd(&hist[(bits >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int bin = 0, below = 0;
      while (bin < 255 && below + hist[bin] <= rank) below += hist[bin++];
      pick[0] = bin;
      pick[1] = rank - below;
    }
    __syncthreads();
    prefix |= (unsigned)pick[0] << shift;
    mask |= 255u << shift;
    rank = pick[1];
    __syncthreads();
  }
  return prefix;
}

__global__ void __launch_bounds__(kSelectThreads)
quantile_kernel(const float* __restrict__ energy, const unsigned char* __restrict__ ok,
                int groups, float quantile, float sigma, float* __restrict__ thresh) {
  __shared__ int hist[256];
  __shared__ int pick[2];
  __shared__ int warp_count[kSelectThreads / 32];
  int count = 0;
  for (int g = threadIdx.x; g < groups; g += kSelectThreads) count += ok[g] ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
  if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = count;
  __syncthreads();
  int m = 0;
  for (int w = 0; w < kSelectThreads / 32; ++w) m += warp_count[w];

  float q = 0.0f;
  if (m > 0) {
    // position quantile * (m - 1), exact in f32 for m < 2^22
    const float pos = quantile * (float)(m - 1);
    const float below = floorf(pos);
    const int lo = (int)below, hi = (int)ceilf(pos);
    const float w = pos - below;
    const float v_lo = __uint_as_float(radix_select(energy, ok, groups, lo, hist, pick));
    const float v_hi =
        hi == lo ? v_lo : __uint_as_float(radix_select(energy, ok, groups, hi, hist, pick));
    // torch.lerp
    const float diff = v_hi - v_lo;
    q = w < 0.5f ? v_lo + w * diff : v_hi - diff * (1.0f - w);
  }
  if (threadIdx.x == 0) thresh[0] = q + 0.5f * sigma * sigma;
}

__global__ void __launch_bounds__(kStatusThreads)
status_kernel(const float* __restrict__ energy, const unsigned char* __restrict__ ok,
              const int* __restrict__ candidate, const float* __restrict__ thresh,
              const float* __restrict__ t_lin_q, const float* __restrict__ t_lin_t,
              const float* __restrict__ eps, const float* __restrict__ lm_idepth,
              const unsigned char* __restrict__ lm_mask,
              const float* __restrict__ old_baseline,
              const unsigned char* __restrict__ old_outlier,
              const int* __restrict__ old_opt_count, int k, int n, int min_valid,
              int* __restrict__ new_status, float* __restrict__ baseline,
              int* __restrict__ inliers, unsigned char* __restrict__ outlier,
              int* __restrict__ opt_count) {
  __shared__ Vec3 pos[kMaxFrames];
  if (threadIdx.x < k) pos[threadIdx.x] = frame_pose(t_lin_q, t_lin_t, eps, threadIdx.x).t;
  __syncthreads();
  const int lm = blockIdx.x * kStatusThreads + threadIdx.x;
  if (lm >= k * n) return;
  const int i = lm / n, ln = lm % n;
  const float thr = thresh[0];
  const float d = lm_idepth[lm];
  float rel_max = 0.0f;
  int count = 0;
  for (int j = 0; j < k; ++j) {
    const size_t g = ((size_t)i * k + j) * n + ln;
    const float e = energy[g];
    const bool is_ok = ok[g] != 0;
    new_status[g] = (is_ok && e > thr) ? kResOutlier : candidate[g];
    if (is_ok && e <= thr) {
      const float dx = pos[i].x - pos[j].x, dy = pos[i].y - pos[j].y, dz = pos[i].z - pos[j].z;
      rel_max = fmaxf(rel_max, d * sqrtf((dx * dx + dy * dy) + dz * dz));
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
// Outputs: thresh [1], res_status [k,k,n] int32, baseline [k,n], inliers
// [k,n] int32, outlier [k,n] u8, opt_count [k,n] int32.  Returns
// cudaErrorInvalidValue (1) for k above 40.
extern "C" int ba_point_status(const float* energy, const unsigned char* ok,
                               const int* candidate, const float* t_lin_q,
                               const float* t_lin_t, const float* eps,
                               const float* lm_idepth, const unsigned char* lm_mask,
                               const float* old_baseline, const unsigned char* old_outlier,
                               const int* old_opt_count, int k, int n, float quantile,
                               float sigma, int min_valid, float* thresh, int* new_status,
                               float* baseline, int* inliers, unsigned char* outlier,
                               int* opt_count, void* stream) {
  if (k < 1 || k > kMaxFrames || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  quantile_kernel<<<1, kSelectThreads, 0, s>>>(energy, ok, k * k * n, quantile, sigma, thresh);
  status_kernel<<<(k * n + kStatusThreads - 1) / kStatusThreads, kStatusThreads, 0, s>>>(
      energy, ok, candidate, thresh, t_lin_q, t_lin_t, eps, lm_idepth, lm_mask, old_baseline,
      old_outlier, old_opt_count, k, n, min_valid, new_status, baseline, inliers, outlier,
      opt_count);
  return (int)cudaGetLastError();
}
