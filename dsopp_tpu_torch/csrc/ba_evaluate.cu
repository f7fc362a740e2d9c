// K7 ba_evaluate: the photometric residuals of the windowed BA at a state
// (eps, idepth).
//
// Replaces dsopp_tpu/solvers/pba.py::_evaluate: for every (anchor i, target
// j, landmark n, pattern point p) reproject, read each of the target's C
// channel planes (C = 1: its intensity image; C > 1: a frame embedder's
// channels) with the 10x10-window rule of core/interpolate.py::sample_window —
// one window per (i, j, n), based at floor(reprojected pattern center) - 4;
// a point whose bilinear corners plus the +-1 gradient halo leave that
// window or the image is invalid; pixels outside the image read as 0;
// gradients are half central differences of raw intensities — then the C
// residuals of the point, the whole-patch Huber energy and weight over all
// C * 8 residuals (sigma sqrt(C), given by the caller), the candidate status
// (out of bounds) and the ok mask.  A point's validity does not depend on the
// channel: its window and position are the same in every plane.
//
// Bound: bytes (about 2.5 MB of outputs and 12 scattered pixel reads per
// residual at K = 10, N = 250).  Design: one thread per residual (layout of
// ba_body.cuh); thread 0 of a block computes the pair's relative pose
// T_j^-1 T_i at the current eps and the brightness terms into shared memory;
// the window base comes from the center lane by shuffle; the validity AND
// and the sum of squares over the 8 pattern points are shuffles; a thread
// runs over the C channels of its point, the sum of squares in channel
// order; C = 1 is its own instance of the kernel (kMulti false, the
// single-channel kernel's code), C > 1 the other with C at run time.  Inside the
// LM loop the kernel takes the loop's state and returns at once when the loop
// is done.

#include "ba_body.cuh"
#include "ba_lm_state.cuh"

namespace {

using namespace ba;

constexpr int kResOob = 1;  // solvers/pba.py::RES_OOB

struct PairTerms {
  Rigid rel;
  float scale, b_anchor, b_target;
  int pair_live;
};

template <bool kMulti>
__global__ void __launch_bounds__(kThreads)
ba_evaluate_kernel(const float* __restrict__ t_lin_q, const float* __restrict__ t_lin_t,
                   const float* __restrict__ eps, const float* __restrict__ affine0,
                   const float* __restrict__ exposure, const float* __restrict__ lm_uv,
                   const float* __restrict__ idepth, const float* __restrict__ lm_patch,
                   const unsigned char* __restrict__ lm_mask,
                   const unsigned char* __restrict__ frame_valid,
                   const int* __restrict__ res_status, const float* __restrict__ images,
                   size_t image_stride, int k, int n, int h, int w, int channels_in, Camera cam,
                   float sigma, const int* __restrict__ lm_state,
                   float* __restrict__ residuals,
                   float* __restrict__ energy_patch, float* __restrict__ weight,
                   int* __restrict__ status_candidate, float* __restrict__ out_gx,
                   float* __restrict__ out_gy, unsigned char* __restrict__ out_ok) {
  if (lm_done(lm_state)) return;
  __shared__ PairTerms terms;
  const int channels = kMulti ? channels_in : 1;
  const int pair = blockIdx.y;
  const int i = pair / k, j = pair % k;
  if (threadIdx.x == 0) {
    terms.rel = relative_pose(t_lin_q, t_lin_t, eps, i, j);
    const float a_i = affine0[2 * i] + eps[8 * i + 6];
    const float a_j = affine0[2 * j] + eps[8 * j + 6];
    terms.b_anchor = affine0[2 * i + 1] + eps[8 * i + 7];
    terms.b_target = affine0[2 * j + 1] + eps[8 * j + 7];
    const float ratio = exposure[j] / fmaxf(exposure[i], 1e-12f);
    terms.scale = ratio * expf(a_j - a_i);
    terms.pair_live = frame_valid[i] && frame_valid[j] && i != j;
  }
  __syncthreads();
  const Rigid rel = terms.rel;

  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const bool active = idx < n * kPattern;
  const int cl = active ? idx : n * kPattern - 1;  // idle lanes repeat the last residual
  const int ln = cl / kPattern, p = cl % kPattern;
  const int lm = i * n + ln;

  // reproject (core/reproject.py::reproject, Pinhole.project)
  const float d = idepth[lm];
  const float u = lm_uv[2 * lm] + kPatternX[p];
  const float v = lm_uv[2 * lm + 1] + kPatternY[p];
  Vec3 ray;
  const Vec3 q = scaled_target_point(cam, u, v, d, rel, &ray);
  const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
  const float x = cam.fx * q.x / z_safe + cam.cx;
  const float y = cam.fy * q.y / z_safe + cam.cy;
  const bool valid = reprojection_valid(cam, q.z, x, y, d);

  // one window per landmark, based at the reprojected pattern center
  const int center_lane = (threadIdx.x & 31 & ~(kPattern - 1)) + kCenter;
  const float xc = __shfl_sync(kFull, x, center_lane);
  const float yc = __shfl_sync(kFull, y, center_lane);
  const int bx = window_base(xc, w), by = window_base(yc, h);
  const float* frame = images + (size_t)j * image_stride;
  const WindowSample smp = sample_window(frame, h, w, x, y, bx, by);   // channel 0

  const bool geom_ok = all_of_pattern((valid && smp.ok) ? 1 : 0) != 0;
  const size_t group = (size_t)pair * n + ln;
  const int status = res_status[group];
  const bool live = terms.pair_live && lm_mask[lm];
  const bool ok = live && geom_ok && status == 0;

  // residual (group, c, p) of the [k, k, n, C, 8] outputs
  const size_t plane = (size_t)h * w;
  float r2 = 0.0f;
  for (int c = 0; c < channels; ++c) {
    const WindowSample s =
        c == 0 ? smp : sample_window(frame + (size_t)c * plane, h, w, x, y, bx, by);
    const float corrected =
        terms.scale * (lm_patch[((size_t)lm * channels + c) * kPattern + p] - terms.b_anchor);
    float r = (s.val - terms.b_target) - corrected;
    r = ok ? r : 0.0f;
    r2 += r * r;
    if (active) {
      const size_t res = (group * channels + c) * kPattern + p;
      residuals[res] = r;
      out_gx[res] = s.gx;
      out_gy[res] = s.gy;
    }
  }
  r2 += __shfl_xor_sync(kFull, r2, 1);
  r2 += __shfl_xor_sync(kFull, r2, 2);
  r2 += __shfl_xor_sync(kFull, r2, 4);

  if (!active) return;
  if (p == 0) {
    // solvers/measure.py::huber_energy_weight on the whole patch
    const float sigma_sq = sigma * sigma;
    const float norm = sqrtf(fmaxf(r2, 1e-30f));
    const bool linear = r2 > sigma_sq;
    const float energy = linear ? sigma * norm - 0.5f * sigma_sq : 0.5f * r2;
    const float wgt = linear ? sigma / norm : 1.0f;
    energy_patch[group] = ok ? energy : 0.0f;
    weight[group] = ok ? wgt : 0.0f;
    status_candidate[group] = (live && !geom_ok) ? kResOob : status;
    out_ok[group] = ok ? 1 : 0;
  }
}

}  // namespace

// Window: t_lin_q [k,4], t_lin_t [k,3], affine0 [k,2], exposure [k], lm_uv
// [k,n,2], lm_patch [k,n,C*8] channel-major; eps [k,8], idepth [k,n] (the
// state), lm_mask [k,n] u8, frame_valid [k] u8, res_status [k,k,n] int32 and
// the frames' channel planes (`images` + f * image_stride + c * h * w is
// channel c of frame f, [h,w]).  sigma: the Huber sigma of C channels.
// Outputs: residuals, gx, gy [k,k,n,C,8]; energy_patch, weight [k,k,n];
// status_candidate [k,k,n] int32; ok [k,k,n] u8.  lm_state: the LM loop's
// state or nullptr.
extern "C" int ba_evaluate(const float* t_lin_q, const float* t_lin_t, const float* eps,
                           const float* affine0, const float* exposure,
                           const float* lm_uv, const float* idepth, const float* lm_patch,
                           const unsigned char* lm_mask, const unsigned char* frame_valid,
                           const int* res_status, const float* images, int image_stride,
                           int k, int n, int h, int w, int channels, float fx, float fy, float cx,
                           float cy, float width, float height, float sigma,
                           const int* lm_state, float* residuals, float* energy_patch,
                           float* weight, int* status_candidate, float* gx, float* gy,
                           unsigned char* ok, void* stream) {
  if (channels < 1) return (int)cudaErrorInvalidValue;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  const dim3 grid((n * ba::kPattern + ba::kThreads - 1) / ba::kThreads, k * k);
  auto kernel = channels == 1 ? ba_evaluate_kernel<false> : ba_evaluate_kernel<true>;
  kernel<<<grid, ba::kThreads, 0, (cudaStream_t)stream>>>(
      t_lin_q, t_lin_t, eps, affine0, exposure, lm_uv, idepth, lm_patch, lm_mask,
      frame_valid, res_status, images, (size_t)image_stride, k, n, h, w, channels, cam, sigma,
      lm_state, residuals, energy_patch, weight, status_candidate, gx, gy, ok);
  return (int)cudaGetLastError();
}
