// Rigid transforms of core/lie.py as PyTorch's CUDA kernels round them, for
// the kernels that compose poses which the plain versions compose in torch
// (K4 epipolar.cu, K16 depth_maps.cu): with the library built with
// --fmad=false, these give the bits of the torch operators on the card.
//
// What the card's torch does, measured with throwaway probes comparing
// compiled candidates against torch's CUDA ops:
// * torch.linalg.cross forms a_i b_j - a_j b_i as one fma: fma(a_i, b_j, -(a_j b_i));
// * a sum over the last axis of 4 entries adds (x0 + x2) + (x1 + x3), of 3
//   entries (x0 + x2) + x1 (two lanes share an output, the first taking
//   entries 0 and 2);
// * a division by a Python scalar multiplies by the scalar's f32 reciprocal;
// * torch.sin / torch.cos are sinf / cosf (no fast-math), a tensor division
//   and torch.sqrt are IEEE.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace torch_lie {

constexpr float kSmall = 1e-6f;   // core/lie.py::_SMALL, compared in f32

struct V3 {
  float x, y, z;
};

struct Q4 {
  float w, x, y, z;
};

struct Pose {
  Q4 q;
  V3 t;
};

// torch.linalg.cross as the card computes it
static __device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
          __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

// core/lie.py::quat_rotate: v + 2 (w (u x v) + u x (u x v))
static __device__ __forceinline__ V3 quat_rotate(Q4 q, V3 v) {
  const V3 u = {q.x, q.y, q.z};
  const V3 uv = cross(u, v);
  const V3 uuv = cross(u, uv);
  return {v.x + 2.0f * (q.w * uv.x + uuv.x), v.y + 2.0f * (q.w * uv.y + uuv.y),
          v.z + 2.0f * (q.w * uv.z + uuv.z)};
}

static __device__ __forceinline__ Q4 quat_multiply(Q4 a, Q4 b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

// core/lie.py::quat_normalize, the card's order of the 4-term sum
static __device__ __forceinline__ Q4 quat_normalize(Q4 q) {
  const float n2 = (q.w * q.w + q.y * q.y) + (q.x * q.x + q.z * q.z);
  const float n = sqrtf(fmaxf(n2, 1e-30f));
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

// SE3.inverse
static __device__ __forceinline__ Pose inverse(Pose a) {
  const Q4 qi = {a.q.w, -a.q.x, -a.q.y, -a.q.z};
  const V3 rt = quat_rotate(qi, a.t);
  return {qi, {-rt.x, -rt.y, -rt.z}};
}

// SE3.compose: a * b
static __device__ __forceinline__ Pose compose(Pose a, Pose b) {
  const V3 rt = quat_rotate(a.q, b.t);
  return {quat_normalize(quat_multiply(a.q, b.q)), {rt.x + a.t.x, rt.y + a.t.y, rt.z + a.t.z}};
}

// SE3.exp of a tangent [upsilon, omega]: so3_exp_quat and _apply_V with their
// small-angle branches
static __device__ __forceinline__ Pose se3_exp(V3 ups, V3 om) {
  const float theta_sq = (om.x * om.x + om.z * om.z) + om.y * om.y;
  const float theta = sqrtf(fmaxf(theta_sq, 1e-30f));
  const bool small = theta_sq < kSmall;
  const float k = small ? 0.5f - theta_sq * (1.0f / 48.0f) : sinf(0.5f * theta) / theta;
  const float w = small ? 1.0f - theta_sq * (1.0f / 8.0f) : cosf(0.5f * theta);
  const float a = small ? 0.5f - theta_sq * (1.0f / 24.0f)
                        : (1.0f - cosf(theta)) / fmaxf(theta_sq, 1e-30f);
  const float b = small ? (float)(1.0 / 6.0) - theta_sq * (1.0f / 120.0f)
                        : (theta - sinf(theta)) / fmaxf(theta_sq * theta, 1e-30f);
  const V3 c1 = cross(om, ups);
  const V3 c2 = cross(om, c1);
  return {quat_normalize({w, k * om.x, k * om.y, k * om.z}),
          {(ups.x + a * c1.x) + b * c2.x, (ups.y + a * c1.y) + b * c2.y,
           (ups.z + a * c1.z) + b * c2.z}};
}

// Window.poses() of frame f: T_lin,f * exp(eps_f[:6])
static __device__ __forceinline__ Pose window_pose(const float* __restrict__ t_lin_q,
                                                  const float* __restrict__ t_lin_t,
                                                  const float* __restrict__ eps, int f) {
  const Pose lin = {{t_lin_q[4 * f], t_lin_q[4 * f + 1], t_lin_q[4 * f + 2], t_lin_q[4 * f + 3]},
                    {t_lin_t[3 * f], t_lin_t[3 * f + 1], t_lin_t[3 * f + 2]}};
  const float* xi = eps + 8 * f;
  return compose(lin, se3_exp({xi[0], xi[1], xi[2]}, {xi[3], xi[4], xi[5]}));
}

}  // namespace torch_lie
