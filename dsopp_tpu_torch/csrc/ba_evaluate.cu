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
// ba_body.cuh).  Each thread first issues its landmark's loads (idepth, uv,
// the reference patch, the mask, the group's status); meanwhile lanes 0 and 1
// compose the two frame poses T_lin exp(eps) of the pair (the trig of the
// exponential, the block's longest dependent chain) and lane 32 the
// brightness terms, into shared memory; after the one barrier every thread
// composes T_j^-1 T_i itself (relative_pose's arithmetic, so its bits).  The
// window base comes from the center lane by shuffle; the validity AND and the
// sum of squares over the 8 pattern points are shuffles; a thread runs over
// the C channels of its point, the sum of squares in channel order; C = 1 is
// its own instance of the kernel (kMulti false, the single-channel kernel's
// code), C > 1 the other with C at run time.
//
// Inside the LM loop (ba_lm.cu::ba_solve_loop) the kernel takes the loop's
// state, returns at once when the loop is done, and writes its trial into the
// evaluation buffer that does not hold the carried evaluation
// (ba_lm_state.cuh); with a null state it writes buffer 0.  `lm_mask` may be
// the window's lm_valid: a landmark of an invalid anchor frame is dead anyway
// (its pairs are), so lm_valid gives the outputs of lm_valid & frame_valid;
// where `mask_out` is given the kernel writes that AND for K11.
//
// Sequence axis (seq_axis.cuh): grid z is a sequence; the window's fields
// (exposure, lm_uv, lm_patch, lm_mask, frame_valid, the channel planes) are
// read at `bank_seq[z]`, the state (t_lin_q, t_lin_t, eps, affine0, idepth,
// res_status) at `state_seq[z]` (the window's sequence, or null inside the LM
// loop, whose carried state is the launch's own), the loop state and the
// outputs at z.

#include "ba_body.cuh"
#include "ba_entries.cuh"
#include "ba_lm_state.cuh"
#include "seq_axis.cuh"

namespace {

using namespace ba;

constexpr int kResOob = 1;  // solvers/pba.py::RES_OOB

// the pair's brightness terms, from lane 32
struct PairTerms {
  float scale, b_anchor, b_target;
  int pair_live;
};

// one evaluation buffer: residuals, gx, gy [k,k,n,C,8]; energy_patch, weight
// [k,k,n]; status_candidate [k,k,n] int32; ok [k,k,n] u8
struct EvalOut {
  float* residuals;
  float* energy_patch;
  float* weight;
  int* status_candidate;
  float* gx;
  float* gy;
  unsigned char* ok;

  // sequence z's buffer, of `groups` (anchor, target, landmark) groups
  __device__ EvalOut at(int z, size_t groups, int channels) const {
    const size_t res = groups * channels * kPattern;
    return {seq::at(residuals, z, res), seq::at(energy_patch, z, groups),
            seq::at(weight, z, groups),  seq::at(status_candidate, z, groups),
            seq::at(gx, z, res),         seq::at(gy, z, res),
            seq::at(ok, z, groups)};
  }
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
                   float sigma, const int* __restrict__ lm_state, EvalOut out0, EvalOut out1,
                   unsigned char* __restrict__ mask_out, const int* __restrict__ bank_seq,
                   const int* __restrict__ state_seq) {
  const int z = blockIdx.z;
  lm_state = seq::at(lm_state, z, kLmFields);
  if (lm_done(lm_state)) return;
  {
    const int sb = seq::of(bank_seq), ss = seq::of(state_seq);
    const size_t kn = (size_t)k * n, groups = kn * k;
    t_lin_q = seq::at(t_lin_q, ss, 4 * k);
    t_lin_t = seq::at(t_lin_t, ss, 3 * k);
    eps = seq::at(eps, ss, 8 * k);
    affine0 = seq::at(affine0, ss, 2 * k);
    idepth = seq::at(idepth, ss, kn);
    res_status = seq::at(res_status, ss, groups);
    exposure = seq::at(exposure, sb, k);
    lm_uv = seq::at(lm_uv, sb, 2 * kn);
    lm_patch = seq::at(lm_patch, sb, kn * channels_in * kPattern);
    lm_mask = seq::at(lm_mask, sb, kn);
    frame_valid = seq::at(frame_valid, sb, k);
    images = seq::at(images, sb, k * image_stride);
    out0 = out0.at(z, groups, channels_in);
    out1 = out1.at(z, groups, channels_in);
    mask_out = seq::at(mask_out, z, kn);
  }
  __shared__ Rigid pose_s[2];  // frame poses of the target (0) and the anchor (1)
  __shared__ PairTerms terms;
  const int channels = kMulti ? channels_in : 1;
  const int pair = blockIdx.y;
  const int i = pair / k, j = pair % k;

  // this thread's landmark: its loads go out before the pose is composed
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const bool active = idx < n * kPattern;
  const int cl = active ? idx : n * kPattern - 1;  // idle lanes repeat the last residual
  const int ln = cl / kPattern, p = cl % kPattern;
  const int lm = i * n + ln;
  const size_t group = (size_t)pair * n + ln;
  const float d = idepth[lm];
  const float u = lm_uv[2 * lm] + kPatternX[p];
  const float v = lm_uv[2 * lm + 1] + kPatternY[p];
  const float patch0 = lm_patch[(size_t)lm * channels * kPattern + p];
  const bool mask = lm_mask[lm] != 0;
  const int status = res_status[group];

  if (threadIdx.x < 2) {
    pose_s[threadIdx.x] = frame_pose(t_lin_q, t_lin_t, eps, threadIdx.x == 0 ? j : i);
  } else if (threadIdx.x == 32) {
    const float a_i = affine0[2 * i] + eps[8 * i + 6];
    const float a_j = affine0[2 * j] + eps[8 * j + 6];
    terms.b_anchor = affine0[2 * i + 1] + eps[8 * i + 7];
    terms.b_target = affine0[2 * j + 1] + eps[8 * j + 7];
    const float ratio = exposure[j] / fmaxf(exposure[i], 1e-12f);
    terms.scale = ratio * expf(a_j - a_i);
    terms.pair_live = frame_valid[i] && frame_valid[j] && i != j;
  }
  __syncthreads();
  // T_j^-1 T_i (ba_body.cuh::relative_pose)
  const Rigid rel = compose(inverse(pose_s[0]), pose_s[1]);
  const EvalOut o = trial_buffer(lm_state) ? out1 : out0;

  // reproject (core/reproject.py::reproject, Pinhole.project)
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
  const bool live = terms.pair_live && mask;
  const bool ok = live && geom_ok && status == 0;

  // residual (group, c, p) of the [k, k, n, C, 8] outputs
  const size_t plane = (size_t)h * w;
  float r2 = 0.0f;
  for (int c = 0; c < channels; ++c) {
    const WindowSample s =
        c == 0 ? smp : sample_window(frame + (size_t)c * plane, h, w, x, y, bx, by);
    const float patch = c == 0 ? patch0 : lm_patch[((size_t)lm * channels + c) * kPattern + p];
    const float corrected = terms.scale * (patch - terms.b_anchor);
    float r = (s.val - terms.b_target) - corrected;
    r = ok ? r : 0.0f;
    r2 += r * r;
    if (active) {
      const size_t res = (group * channels + c) * kPattern + p;
      o.residuals[res] = r;
      o.gx[res] = s.gx;
      o.gy[res] = s.gy;
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
    o.energy_patch[group] = ok ? energy : 0.0f;
    o.weight[group] = ok ? wgt : 0.0f;
    o.status_candidate[group] = (live && !geom_ok) ? kResOob : status;
    o.ok[group] = ok ? 1 : 0;
    if (mask_out != nullptr && j == 0) mask_out[lm] = (mask && frame_valid[i]) ? 1 : 0;
  }
}

}  // namespace

// Window: t_lin_q [k,4], t_lin_t [k,3], affine0 [k,2], exposure [k], lm_uv
// [k,n,2], lm_patch [k,n,C*8] channel-major; eps [k,8], idepth [k,n] (the
// state), lm_mask [k,n] u8 (the window's lm_valid, or a narrower mask),
// frame_valid [k] u8, res_status [k,k,n] int32 and the frames' channel planes
// (`images` + f * image_stride + c * h * w is channel c of frame f, [h,w]).
// sigma: the Huber sigma of C channels.  Outputs: two evaluation buffers,
// each residuals, gx, gy [k,k,n,C,8]; energy_patch, weight [k,k,n];
// status_candidate [k,k,n] int32; ok [k,k,n] u8 — buffer 0 is written when
// lm_state is nullptr (buffer 1 may then be null), else the one that
// ba_lm_state.cuh::trial_buffer names; mask_out [k,n] u8 or nullptr:
// lm_mask & frame_valid of the anchor frame.  Sequence axis (seq_axis.cuh):
// `seqs` sequences, grid z; the window's fields of every argument above are
// [B, ...] stacks read at bank_seq[z], the state (t_lin_q, t_lin_t, eps,
// affine0, idepth, res_status) at state_seq[z] (null lists: z), lm_state
// [seqs, 9] and the outputs [seqs, ...] at z.
extern "C" int ba_evaluate(const float* t_lin_q, const float* t_lin_t, const float* eps,
                           const float* affine0, const float* exposure,
                           const float* lm_uv, const float* idepth, const float* lm_patch,
                           const unsigned char* lm_mask, const unsigned char* frame_valid,
                           const int* res_status, const float* images, int image_stride,
                           int k, int n, int h, int w, int channels, float fx, float fy, float cx,
                           float cy, float width, float height, float sigma,
                           const int* lm_state, float* residuals, float* energy_patch,
                           float* weight, int* status_candidate, float* gx, float* gy,
                           unsigned char* ok, float* residuals1, float* energy_patch1,
                           float* weight1, int* status_candidate1, float* gx1, float* gy1,
                           unsigned char* ok1, unsigned char* mask_out, int seqs,
                           const int* bank_seq, const int* state_seq, void* stream) {
  if (channels < 1 || k < 1 || n < 1 || !seq::valid_count(seqs))
    return (int)cudaErrorInvalidValue;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  const EvalOut out0 = {residuals, energy_patch, weight, status_candidate, gx, gy, ok};
  const EvalOut out1 = {residuals1, energy_patch1, weight1, status_candidate1, gx1, gy1, ok1};
  const dim3 grid((n * ba::kPattern + ba::kThreads - 1) / ba::kThreads, k * k, seqs);
  auto kernel = channels == 1 ? ba_evaluate_kernel<false> : ba_evaluate_kernel<true>;
  kernel<<<grid, ba::kThreads, 0, (cudaStream_t)stream>>>(
      t_lin_q, t_lin_t, eps, affine0, exposure, lm_uv, idepth, lm_patch, lm_mask,
      frame_valid, res_status, images, (size_t)image_stride, k, n, h, w, channels, cam, sigma,
      lm_state, out0, out1, mask_out, bank_seq, state_seq);
  return (int)cudaGetLastError();
}
