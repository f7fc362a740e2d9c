// K4 epipolar_update: one epipolar update of every immature bank [K, N]
// against a new frame: the banks' relative poses, each landmark's geometry,
// the SSD sweep with uniqueness and subpixel Gauss-Newton refine, the
// gradient-angle error model, the 11-step interval shrink and the status
// machine, in one launch.
//
// Replaces dsopp_tpu/tracker/depth_estimation.py::estimate_depths (the
// whole function, lines 107-340, over ops/patch.py::patch_center_row,
// sample_values_rows and sample_pattern_rows), vmapped over the banks with
// the relative poses of dsopp_tpu/tracker/fused_tick.py:204-213.
//
// Bound: latency of scattered reads.  A landmark reads 32 samples x 8
// pattern points x 4 bilinear corners from the target image at
// data-dependent addresses, then runs 4 dependent GN steps; the geometry
// before and the shrink after are a few hundred flops.  Design: a block per
// 4 landmarks of one bank (grid y = bank), whose thread 0 composes the
// bank's target-from-host pose inverse(T_w_t) * pose[k], the exposure ratio
// and the brightness scale once into shared memory; then a warp per
// landmark.  Every lane forms the landmark's geometry (the same values on
// each lane), lanes 0..7 the pattern points' rotated rays and corrected
// reference (broadcast by shuffles), lane s = epiline sample s of the sweep
// (S = 32), argmin / second-best / GN sums as warp shuffles, GN on lanes
// 0..7 = pattern points, the shrink's 11 radii on lanes 0..10 with the
// widest valid one taken by ballot.  Lane 0 writes every output, inactive
// landmarks included (their old values), so nothing is cleared first.
//
// Bits.  The geometry, the error model and the shrink repeat the operations
// of tracker/depth_estimation.py's plain version as PyTorch runs them on the
// card, so that they give its bits on the same inputs (the pose helpers of
// torch_lie.cuh): the library is built with --fmad=false, torch.linalg.cross
// forms a_i b_j - a_j b_i as one fma (fma(a_i, b_j, -(a_j b_i))), a sum over
// 4 quaternion components adds (q0^2 + q2^2) + (q1^2 + q3^2), and a division
// by a Python scalar (the camera's unproject, (u - cx) / fx) multiplies by
// the scalar's f32 reciprocal.  The sweep and the refine keep the arithmetic
// of the kernel that ran them alone before (its rays divide by fx).  linspace
// is the two-sided formula of torch.linspace.  Everything is f32.
//
// B sequences (the batched tick) are one launch: grid z runs over them, and
// every [K, N] bank field, window field and frame input is read at its
// sequence's offset in a [B, ...] stack, the target image at img_stride
// floats a sequence.  A sequence's blocks run the code of its own launch, so
// its outputs are that launch's to the bit.
//
// Validity rules kept from the TPU path exactly: samples 4s..4s+3 share one
// 10x10 window based at floor(group-mean center) - 4; a pattern point whose
// bilinear corners leave that window is invalid; GN reads one window at the
// sweep winner and needs the +-1 gradient halo inside it; pixels outside
// the image read as 0; GN gradients are 1/2 central differences of raw
// intensities.

#include <cuda_runtime.h>
#include <math.h>

#include "torch_lie.cuh"

namespace {

using torch_lie::cross;
using torch_lie::Q4;
using torch_lie::quat_multiply;
using torch_lie::quat_normalize;
using torch_lie::quat_rotate;
using torch_lie::V3;

constexpr int kS = 32;       // epiline samples = lanes
constexpr int kP = 8;        // pattern points
constexpr int kShrink = 11;  // error radii of the interval shrink
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// tracker/depth_estimation.py's statuses and constants
constexpr int kGood = 0, kOob = 1, kOutlier = 2, kSkipped = 3, kIll = 4, kUninitialized = 5;
constexpr float kInitialIdepthMax = 1000.0f;   // 1 / MIN_DEPTH
constexpr float kSampleIdepthMax = 1010.0f;    // INITIAL_IDEPTH_MAX * 1.01 in f32
constexpr float kMinQz = 1e-3f;
constexpr float kMinEpilineSize = 2.0f;
constexpr float kMinDepthScale = 0.75f, kMaxDepthScale = 1.5f;
constexpr float kMaxError = 10.0f;
constexpr float kMinEpilineForUniqueness = 10.0f;
constexpr float kMaxEnergyInlier = 1152.0f;    // 8 * 12^2
constexpr float kMinIdepth = -1e-4f, kMaxIdepth = 1010.0f;  // core/camera.py

// core/pattern.py::_OFFSETS, (x, y)
__constant__ float kPatternX[kP] = {0.f, -1.f, 1.f, -2.f, 0.f, 2.f, -1.f, 0.f};
__constant__ float kPatternY[kP] = {2.f, 1.f, 1.f, 0.f, 0.f, 0.f, -1.f, -2.f};

struct Cam {
  float fx, fy, cx, cy, inv_fx, inv_fy, width, height;
};

// torch.linspace(start, end, steps)[i]: the lower half from start, the upper from end
__device__ __forceinline__ float linspace_at(float start, float end, int steps, int i) {
  const float step = (end - start) / (float)(steps - 1);
  return i < steps / 2 ? start + step * (float)i : end - step * (float)(steps - i - 1);
}

__device__ __forceinline__ float clamp_abs_min(float v) {
  return fabsf(v) < 1e-12f ? 1e-12f : v;
}

// core/camera.py::Pinhole.project with its validity (border 4)
__device__ __forceinline__ bool project(const Cam& cam, V3 q, float* u, float* v) {
  const float z = clamp_abs_min(q.z);
  *u = cam.fx * q.x / z + cam.cx;
  *v = cam.fy * q.y / z + cam.cy;
  return q.z >= 1e-3f && *u >= 4.0f && *v >= 4.0f && *u <= cam.width - 4.0f - 1.0f &&
         *v <= cam.height - 4.0f - 1.0f;
}

__device__ __forceinline__ float pix(const float* __restrict__ img, int h,
                                     int w, int y, int x) {
  return (x >= 0 && y >= 0 && x < w && y < h) ? __ldg(img + (size_t)y * w + x)
                                              : 0.0f;
}

// _triangulate_idepth: the reference idepth whose target ray is (vx, vy, 1)
__device__ __forceinline__ float triangulate(V3 pr, V3 t, float vx, float vy) {
  const float den_x = t.x - vx * t.z;
  const float den_y = t.y - vy * t.z;
  const float num_x = vx * pr.z - pr.x;
  const float num_y = vy * pr.z - pr.y;
  const bool use_x = fabsf(den_x) > fabsf(den_y);
  return (use_x ? num_x : num_y) / clamp_abs_min(use_x ? den_x : den_y);
}

__device__ __forceinline__ bool valid_idepth(float d) {
  return d > kMinIdepth && d < kMaxIdepth;
}

__device__ __forceinline__ int floor_clamp(float v, int lo, int hi) {
  return min(max((int)floorf(v), lo), hi);
}

// bilinear value from the window based at (bx, by); corners anywhere in it
__device__ __forceinline__ float window_value(const float* __restrict__ img,
                                              int h, int w, float x, float y,
                                              int bx, int by, bool* ok) {
  const bool inside = x >= 0.0f && y >= 0.0f && x <= (float)(w - 1) &&
                      y <= (float)(h - 1);
  const int ix = floor_clamp(x, 0, w - 2);
  const int iy = floor_clamp(y, 0, h - 2);
  const float ax = x - (float)ix, ay = y - (float)iy;
  const int dxi = ix - bx, dyi = iy - by;
  *ok = inside && dxi >= 0 && dxi <= 8 && dyi >= 0 && dyi <= 8;
  const int col = bx + min(max(dxi, 0), 8);
  const int row = by + min(max(dyi, 0), 8);
  const float t0 = pix(img, h, w, row, col) * (1.0f - ay) +
                   pix(img, h, w, row + 1, col) * ay;
  const float t1 = pix(img, h, w, row, col + 1) * (1.0f - ay) +
                   pix(img, h, w, row + 1, col + 1) * ay;
  return t0 * (1.0f - ax) + t1 * ax;
}

// value + 1/2 central-difference gradients; corners and halo in the window
__device__ __forceinline__ void window_gradient(const float* __restrict__ img,
                                                int h, int w, float x, float y,
                                                int bx, int by, float* val,
                                                float* gx, float* gy, bool* ok) {
  const bool inside = x >= 0.0f && y >= 0.0f && x <= (float)(w - 1) &&
                      y <= (float)(h - 1);
  const int ix = floor_clamp(x, 0, w - 2);
  const int iy = floor_clamp(y, 0, h - 2);
  const float ax = x - (float)ix, ay = y - (float)iy;
  const int dxi = ix - bx, dyi = iy - by;
  *ok = inside && dxi >= 1 && dxi <= 7 && dyi >= 1 && dyi <= 7;
  const int col = bx + min(max(dxi, 1), 7);
  const int row = by + min(max(dyi, 1), 7);
  const float wx0 = 1.0f - ax, wx1 = ax, wy0 = 1.0f - ay, wy1 = ay;
  float ty[4], tx[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    ty[d] = pix(img, h, w, row, col + d - 1) * wy0 +
            pix(img, h, w, row + 1, col + d - 1) * wy1;
    tx[d] = pix(img, h, w, row + d - 1, col) * wx0 +
            pix(img, h, w, row + d - 1, col + 1) * wx1;
  }
  *val = ty[1] * wx0 + ty[2] * wx1;
  *gx = ((ty[0] * (-0.5f * wx0) + ty[1] * (-0.5f * wx1)) + ty[2] * (0.5f * wx0)) +
        ty[3] * (0.5f * wx1);
  *gy = ((tx[0] * (-0.5f * wy0) + tx[1] * (-0.5f * wy1)) + tx[2] * (0.5f * wy0)) +
        tx[3] * (0.5f * wy1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

struct Banks {  // [K, N] fields of tracker/depth_estimation.py::ImmaturePoints
  const float* uv;
  const float* patch;
  const float* gradient;
  const float* idepth_min;
  const float* idepth_max;
  const int* status;
  const unsigned char* traced;
  const float* uniqueness;
  const float* search_interval;
  const unsigned char* valid;
};

struct Frame {  // the new frame and the window
  const float* pose_q;        // [4] T_w_t
  const float* pose_t;        // [3]
  const float* win_q;         // [K, 4] T_w_k
  const float* win_t;         // [K, 3]
  const float* win_affine;    // [K, 2]
  const float* affine_tgt;    // [2]
  const float* exposure;      // [1]
  const float* win_exposure;  // [K]
};

struct Out {
  float* idepth_min;
  float* idepth_max;
  int* status;
  unsigned char* traced;
  float* uniqueness;
  float* search_interval;
};

struct Debug {  // all null, or all set: the sweep's intermediates
  int* best_idx;
  float* best_energy;
  float* second_best;
  unsigned char* any_sample;
  float* refined_energy;
  float* best_delta;
  float* rel_pose;  // [K, 7]: q, t of inverse(T_w_t) * T_w_k
};

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
epipolar_update_kernel(Banks in, int n, Frame fr, const float* __restrict__ img,
                       size_t img_stride, int h, int w, Cam cam, float sigma,
                       float max_search, Out out, Debug dbg) {
  __shared__ float s_pose[7];
  __shared__ float s_scale, s_b_ref;
  // the bank's index among every sequence's banks; the sequence's frame
  const int seq = blockIdx.z;
  const int k = seq * gridDim.y + blockIdx.y;
  img += seq * img_stride;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const bool in_range = i < n;
  const size_t lm = (size_t)k * n + (in_range ? i : 0);
  // the landmark's fields are loaded while thread 0 composes the pose
  const int st_in = in_range ? in.status[lm] : 0;
  const bool valid = in_range && in.valid[lm];
  const float dmin = in_range ? in.idepth_min[lm] : 0.0f;
  const float dmax = in_range ? in.idepth_max[lm] : 0.0f;
  const bool traced = in_range && in.traced[lm] != 0;
  const float u0 = in_range ? in.uv[2 * lm] : 0.0f;
  const float v0 = in_range ? in.uv[2 * lm + 1] : 0.0f;
  if (threadIdx.x == 0) {
    // T_t_k = inverse(T_w_t) * T_w_k, as SE3.inverse and SE3.compose
    const float* pq = fr.pose_q + 4 * seq;
    const float* pt = fr.pose_t + 3 * seq;
    const Q4 qw = {pq[0], pq[1], pq[2], pq[3]};
    const V3 tw = {pt[0], pt[1], pt[2]};
    const Q4 qi = {qw.w, -qw.x, -qw.y, -qw.z};
    const V3 rt = quat_rotate(qi, tw);
    const V3 ti = {-rt.x, -rt.y, -rt.z};
    const Q4 qk = {fr.win_q[4 * k], fr.win_q[4 * k + 1], fr.win_q[4 * k + 2], fr.win_q[4 * k + 3]};
    const V3 tk = {fr.win_t[3 * k], fr.win_t[3 * k + 1], fr.win_t[3 * k + 2]};
    const Q4 q = quat_normalize(quat_multiply(qi, qk));
    const V3 r2 = quat_rotate(qi, tk);
    const float pose[7] = {q.w, q.x, q.y, q.z, r2.x + ti.x, r2.y + ti.y, r2.z + ti.z};
    for (int c = 0; c < 7; ++c) s_pose[c] = pose[c];
    const float ratio = fr.exposure[seq] / fmaxf(fr.win_exposure[k], 1e-12f);
    s_scale = ratio * expf(fr.affine_tgt[2 * seq] - fr.win_affine[2 * k]);
    s_b_ref = fr.win_affine[2 * k + 1];
    if (dbg.rel_pose != nullptr && blockIdx.x == 0)
      for (int c = 0; c < 7; ++c) dbg.rel_pose[7 * k + c] = pose[c];
  }
  __syncthreads();
  if (!in_range) return;  // the whole warp leaves together
  const bool active = valid && (st_in == kGood || st_in == kSkipped || st_in == kIll ||
                                st_in == kUninitialized);
  if (!active) {
    if (lane == 0) {
      out.idepth_min[lm] = dmin;
      out.idepth_max[lm] = dmax;
      out.status[lm] = st_in;
      out.traced[lm] = traced ? 1 : 0;
      out.uniqueness[lm] = in.uniqueness[lm];
      out.search_interval[lm] = in.search_interval[lm];
      if (dbg.best_idx != nullptr) {
        dbg.best_idx[lm] = 0;
        dbg.best_energy[lm] = INFINITY;
        dbg.second_best[lm] = INFINITY;
        dbg.any_sample[lm] = 0;
        dbg.refined_energy[lm] = INFINITY;
        dbg.best_delta[lm] = 0.0f;
      }
    }
    return;
  }

  // ---- geometry (sweep_inputs), the same values on every lane ------------
  const Q4 rq = {s_pose[0], s_pose[1], s_pose[2], s_pose[3]};
  const V3 t = {s_pose[4], s_pose[5], s_pose[6]};
  const V3 pr = quat_rotate(rq, {(u0 - cam.cx) * cam.inv_fx, (v0 - cam.cy) * cam.inv_fy, 1.0f});
  const float rho_min = dmin < 0.0f ? 0.0f : dmin;
  float rho_max = dmax > kInitialIdepthMax ? kInitialIdepthMax : dmax;
  const float rho_limit = (kMinQz - pr.z) / clamp_abs_min(t.z);
  if (t.z < 0.0f && pr.z + rho_max * t.z < kMinQz) rho_max = fmaxf(rho_limit, rho_min);
  float uax, uay, ubx, uby;
  const bool valid_a = project(cam, {pr.x + rho_min * t.x, pr.y + rho_min * t.y,
                                     pr.z + rho_min * t.z}, &uax, &uay);
  const bool valid_b = project(cam, {pr.x + rho_max * t.x, pr.y + rho_max * t.y,
                                     pr.z + rho_max * t.z}, &ubx, &uby);
  const float depth_scale = pr.z + rho_min * t.z;
  const bool scale_bad = dmin >= 0.0f && (depth_scale < kMinDepthScale ||
                                          depth_scale > kMaxDepthScale);
  const float sgx = ubx - uax, sgy = uby - uay;
  const float seg_len = sqrtf(sgx * sgx + sgy * sgy);
  const bool too_short = seg_len < kMinEpilineSize;
  const float seg_div = seg_len < 1e-12f ? 1e-12f : seg_len;
  const float dx = sgx / seg_div, dy = sgy / seg_div;
  const float slen = traced ? seg_len : fminf(seg_len, max_search);
  const float bt = fr.affine_tgt[2 * seq + 1];
  // lanes 0..7: the pattern points' rotated rays and corrected reference
  V3 my_prp = {0.0f, 0.0f, 0.0f};
  float my_ref = 0.0f;
  if (lane < kP) {
    const float pu = u0 + kPatternX[lane], pv = v0 + kPatternY[lane];
    my_prp = quat_rotate(rq, {(pu - cam.cx) * cam.inv_fx, (pv - cam.cy) * cam.inv_fy, 1.0f});
    my_ref = s_scale * (in.patch[lm * kP + lane] - s_b_ref);
  }

  // ---- sweep: lane = sample ----------------------------------------------
  const float step_s = linspace_at(0.0f, 1.0f, kS, lane) * slen;
  const float us = uax + step_s * dx, vs = uay + step_s * dy;
  const float rho = triangulate(pr, t, (us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy);
  const int g = lane >> 2;
  const float step_g = ((4.0f * (float)g + 1.5f) / (float)(kS - 1)) * slen;
  const float ugx = uax + step_g * dx, ugy = uay + step_g * dy;
  const int bx = floor_clamp(ugx, 0, w - 1) - 4;
  const int by = floor_clamp(ugy, 0, h - 1) - 4;

  float pu[kP], pv[kP];
  bool ok_all = rho > -1e-4f && rho < kSampleIdepthMax;
  float ssd = 0.0f;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const float rx = __shfl_sync(kFull, my_prp.x, p);
    const float ry = __shfl_sync(kFull, my_prp.y, p);
    const float rz = __shfl_sync(kFull, my_prp.z, p);
    const float cref = __shfl_sync(kFull, my_ref, p);
    const float qx = rx + rho * t.x, qy = ry + rho * t.y, qz = rz + rho * t.z;
    const float zs = clamp_abs_min(qz);
    pu[p] = cam.fx * qx / zs + cam.cx;
    pv[p] = cam.fy * qy / zs + cam.cy;
    const bool proj_ok = qz >= 1e-3f && pu[p] >= 4.0f && pv[p] >= 4.0f &&
                         pu[p] <= cam.width - 4.0f - 1.0f &&
                         pv[p] <= cam.height - 4.0f - 1.0f;
    bool in_ok;
    const float val = window_value(img, h, w, pu[p], pv[p], bx, by, &in_ok);
    const float r = (val - bt) - cref;
    ssd += r * r;
    ok_all = ok_all && proj_ok && in_ok;
  }
  const float energy = ok_all ? ssd : INFINITY;

  // argmin, ties to the lowest sample index
  float be = energy;
  int bi = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oe = __shfl_xor_sync(kFull, be, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (oe < be || (oe == be && oi < bi)) {
      be = oe;
      bi = oi;
    }
  }
  const bool any = __any_sync(kFull, ok_all);

  // second best outside +-radius samples
  const float spacing = slen / (float)(kS - 1);
  const float radius = ceilf(2.0f / fmaxf(spacing, 1e-6f));
  float second = (fabsf((float)(lane - bi)) > radius) ? energy : INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    second = fminf(second, __shfl_xor_sync(kFull, second, off));

  // ---- GN refine along the epiline: lane = pattern point ---------------
  const float step_b = linspace_at(0.0f, 1.0f, kS, bi) * slen;
  const float ubest_x = uax + step_b * dx, ubest_y = uay + step_b * dy;
  float px = 0.0f, py = 0.0f;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const float sx = __shfl_sync(kFull, pu[p], bi);
    const float sy = __shfl_sync(kFull, pv[p], bi);
    if (lane == p) {
      px = sx;
      py = sy;
    }
  }
  const int rbx = floor_clamp(ubest_x, 0, w - 1) - 4;
  const int rby = floor_clamp(ubest_y, 0, h - 1) - 4;
  const bool is_pt = lane < kP;
  float delta = 0.0f, e_best = INFINITY, best_delta = 0.0f;
  for (int it = 0; it < 4; ++it) {
    float hh = 0.0f, bb = 0.0f, ee = 0.0f;
    bool ok = true;
    if (is_pt) {
      float val, gx, gy;
      window_gradient(img, h, w, px - delta * dx, py - delta * dy, rbx, rby,
                      &val, &gx, &gy, &ok);
      const float r = (val - bt) - my_ref;
      const float wgt = sigma / fmaxf(fabsf(r), sigma);
      const float gt = gx * dx + gy * dy;
      hh = wgt * gt * gt;
      bb = wgt * r * gt;
      ee = fminf(fmaxf(r, -sigma), sigma) * r;
    }
    const float hs = warp_sum(hh), bs = warp_sum(bb), es = warp_sum(ee);
    const bool all_ok = __all_sync(kFull, ok);
    const float step = fminf(fmaxf(bs / fmaxf(hs, 1e-9f), -0.3f), 0.3f);
    const float e = all_ok ? es : INFINITY;
    if (e < e_best) {
      e_best = e;
      best_delta = delta;
    }
    delta = delta + step;
  }

  // ---- error model, interval shrink, status (update_from_sweep) ----------
  const float uniqueness = second / fmaxf(be, 1e-12f);
  const float best_energy = isfinite(e_best) ? e_best : be;
  const float shift = -best_delta;
  const float gx0 = in.gradient[2 * lm], gy0 = in.gradient[2 * lm + 1];
  const float a_in = dx * gx0 + dy * gy0;
  const float b_in = dy * gx0 - dx * gy0;
  const float a_term = a_in * a_in, b_term = b_in * b_in;
  float error = 0.2f + (0.2f * (a_term + b_term)) / fmaxf(a_term, 1e-12f);
  const bool ill = error > slen * 0.5f && traced;
  error = fminf(error, kMaxError);
  // lanes 0..10: radius error * linspace(1, 0, 11)[lane]; the widest valid one wins
  float rho_lo = 0.0f, rho_hi = 0.0f;
  bool pair_valid = false;
  if (lane < kShrink) {
    const float err = error * linspace_at(1.0f, 0.0f, kShrink, lane);
    const float lo = shift - err, hi = shift + err;
    const float lx = ubest_x + lo * dx, ly = ubest_y + lo * dy;
    const float hx = ubest_x + hi * dx, hy = ubest_y + hi * dy;
    rho_lo = triangulate(pr, t, (lx - cam.cx) * cam.inv_fx, (ly - cam.cy) * cam.inv_fy);
    rho_hi = triangulate(pr, t, (hx - cam.cx) * cam.inv_fx, (hy - cam.cy) * cam.inv_fy);
    pair_valid = valid_idepth(rho_lo) && valid_idepth(rho_hi);
  }
  const unsigned ballot = __ballot_sync(kFull, pair_valid);
  const bool has_valid = ballot != 0u;
  const int first = has_valid ? __ffs(ballot) - 1 : 0;
  rho_lo = __shfl_sync(kFull, rho_lo, first);
  rho_hi = __shfl_sync(kFull, rho_hi, first);

  const bool oob = (!valid_a && !valid_b) || !any || scale_bad || !has_valid;
  int status = kGood;
  if (ill) status = kIll;
  if (best_energy > kMaxEnergyInlier) status = kOutlier;
  if (too_short) status = kSkipped;
  if (oob) status = kOob;
  const bool good = status == kGood;

  if (lane == 0) {
    out.idepth_min[lm] = good ? fminf(rho_lo, rho_hi) : dmin;
    out.idepth_max[lm] = good ? fmaxf(rho_lo, rho_hi) : dmax;
    out.status[lm] = status;
    out.traced[lm] = (traced || good) ? 1 : 0;
    out.uniqueness[lm] = (slen > kMinEpilineForUniqueness && good) ? uniqueness
                                                                    : in.uniqueness[lm];
    out.search_interval[lm] = good ? 2.0f * error : ((too_short || ill) ? slen : 0.0f);
    if (dbg.best_idx != nullptr) {
      dbg.best_idx[lm] = bi;
      dbg.best_energy[lm] = be;
      dbg.second_best[lm] = second;
      dbg.any_sample[lm] = any ? 1 : 0;
      dbg.refined_energy[lm] = e_best;
      dbg.best_delta[lm] = best_delta;
    }
  }
}

}  // namespace

// Banks [k, n]: uv [k,n,2], patch [k,n,8], gradient [k,n,2], idepth_min,
// idepth_max [k,n], status [k,n] int32, traced [k,n] u8, uniqueness,
// search_interval [k,n], valid [k,n] u8; img [h,w] (the new frame's level-0
// intensities); pose_q [4], pose_t [3] (T_w_t); win_q [k,4], win_t [k,3]
// (T_w_k), win_affine [k,2], affine_tgt [2], exposure [1], win_exposure [k];
// inv_fx, inv_fy: the f32 reciprocals of fx, fy; max_search: the f32 longest
// untraced search.  The six outputs are [k,n], every entry written.  The
// debug outputs (all null, or all set): best sample (int32), its sweep
// energy, second best outside the uniqueness radius, any valid sample (u8),
// refined energy, GN shift, each [k,n], and the relative poses [k,7].
// batch > 1: B sequences, every array above a [B, ...] stack of them, the
// images img_stride floats apart.
extern "C" int epipolar_update(
    const float* uv, const float* patch, const float* gradient, const float* idepth_min,
    const float* idepth_max, const int* status, const unsigned char* traced,
    const float* uniqueness, const float* search_interval, const unsigned char* valid,
    int k, int n, int batch, const float* img, int img_stride, int h, int w,
    const float* pose_q, const float* pose_t,
    const float* win_q, const float* win_t, const float* win_affine, const float* affine_tgt,
    const float* exposure, const float* win_exposure, float fx, float fy, float cx, float cy,
    float inv_fx, float inv_fy, float width, float height, float sigma, float max_search,
    float* out_idepth_min, float* out_idepth_max, int* out_status, unsigned char* out_traced,
    float* out_uniqueness, float* out_search_interval, int* dbg_best, float* dbg_best_e,
    float* dbg_second, unsigned char* dbg_any, float* dbg_ref_e, float* dbg_delta,
    float* dbg_pose, void* stream) {
  const Banks in = {uv, patch, gradient, idepth_min, idepth_max, status, traced,
                    uniqueness, search_interval, valid};
  const Frame fr = {pose_q, pose_t, win_q, win_t, win_affine, affine_tgt, exposure,
                    win_exposure};
  const Cam cam = {fx, fy, cx, cy, inv_fx, inv_fy, width, height};
  const Out out = {out_idepth_min, out_idepth_max, out_status, out_traced, out_uniqueness,
                   out_search_interval};
  const Debug dbg = {dbg_best, dbg_best_e, dbg_second, dbg_any, dbg_ref_e, dbg_delta,
                     dbg_pose};
  if (batch < 1 || batch > 65535 || img_stride < 0) return (int)cudaErrorInvalidValue;
  if (k > 0 && n > 0) {
    const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, k, batch);
    epipolar_update_kernel<<<grid, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        in, n, fr, img, (size_t)img_stride, h, w, cam, sigma, max_search, out, dbg);
  }
  return (int)cudaGetLastError();
}
