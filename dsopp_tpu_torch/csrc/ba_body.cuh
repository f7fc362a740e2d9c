// Shared device code of the windowed-BA kernels K6 (ba_fej.cu) and K7
// (ba_evaluate.cu): the residual pattern, rigid transforms on quaternion +
// translation with the formulas and small-angle branches of core/lie.py,
// and the relative pose T_j^-1 T_i of an (anchor i, target j) pair.
//
// Both kernels use one thread per residual (i, j, n, p): blockIdx.y is the
// pair i * K + j, and the block's threads run over n * 8 + p, so the 8
// pattern points of a landmark are 8 neighbouring lanes of one warp and
// per-landmark reductions are shuffles over those lanes.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ba {

constexpr int kThreads = 256;
constexpr int kPattern = 8;
constexpr int kCenter = 4;  // core/pattern.py::PATTERN_CENTER
constexpr unsigned kFull = 0xffffffffu;

// core/pattern.py::_OFFSETS, (x, y)
static __constant__ float kPatternX[kPattern] = {0.f, -1.f, 1.f, -2.f, 0.f, 2.f, -1.f, 0.f};
static __constant__ float kPatternY[kPattern] = {2.f, 1.f, 1.f, 0.f, 0.f, 0.f, -1.f, -2.f};

struct Vec3 {
  float x, y, z;
};

struct Quat {
  float w, x, y, z;
};

struct Rigid {
  Quat q;
  Vec3 t;
};

struct Camera {
  float fx, fy, cx, cy, width, height;
};

static __device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

static __device__ __forceinline__ Vec3 quat_rotate(Quat q, Vec3 v) {
  const Vec3 u = {q.x, q.y, q.z};
  const Vec3 uv = cross(u, v);
  const Vec3 uuv = cross(u, uv);
  return {v.x + 2.0f * (q.w * uv.x + uuv.x), v.y + 2.0f * (q.w * uv.y + uuv.y),
          v.z + 2.0f * (q.w * uv.z + uuv.z)};
}

static __device__ __forceinline__ Quat quat_normalize(Quat q) {
  const float n = sqrtf(fmaxf(((q.w * q.w + q.x * q.x) + q.y * q.y) + q.z * q.z, 1e-30f));
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

static __device__ __forceinline__ Quat quat_multiply(Quat a, Quat b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

// SE3.compose: a * b
static __device__ __forceinline__ Rigid compose(Rigid a, Rigid b) {
  const Vec3 rt = quat_rotate(a.q, b.t);
  return {quat_normalize(quat_multiply(a.q, b.q)),
          {rt.x + a.t.x, rt.y + a.t.y, rt.z + a.t.z}};
}

static __device__ __forceinline__ Rigid inverse(Rigid a) {
  const Quat qi = {a.q.w, -a.q.x, -a.q.y, -a.q.z};
  const Vec3 rt = quat_rotate(qi, a.t);
  return {qi, {-rt.x, -rt.y, -rt.z}};
}

// SE3.exp of a tangent [upsilon, omega]
static __device__ Rigid se3_exp(const float* xi) {
  const Vec3 ups = {xi[0], xi[1], xi[2]};
  const Vec3 om = {xi[3], xi[4], xi[5]};
  const float theta_sq = (om.x * om.x + om.y * om.y) + om.z * om.z;
  const float theta = sqrtf(fmaxf(theta_sq, 1e-30f));
  const float half = 0.5f * theta;
  const bool small = theta_sq < 1e-6f;
  const float k = small ? 0.5f - theta_sq / 48.0f : sinf(half) / theta;
  const float w = small ? 1.0f - theta_sq / 8.0f : cosf(half);
  const float a = small ? 0.5f - theta_sq / 24.0f
                        : (1.0f - cosf(theta)) / fmaxf(theta_sq, 1e-30f);
  const float b = small ? 1.0f / 6.0f - theta_sq / 120.0f
                        : (theta - sinf(theta)) / fmaxf(theta_sq * theta, 1e-30f);
  const Vec3 c1 = cross(om, ups);
  const Vec3 c2 = cross(om, c1);
  return {quat_normalize({w, k * om.x, k * om.y, k * om.z}),
          {ups.x + a * c1.x + b * c2.x, ups.y + a * c1.y + b * c2.y,
           ups.z + a * c1.z + b * c2.z}};
}

// Current pose of frame f: T_lin exp(eps_pose); eps == nullptr means eps = 0
static __device__ Rigid frame_pose(const float* t_lin_q, const float* t_lin_t,
                                   const float* eps, int f) {
  const Rigid lin = {{t_lin_q[4 * f], t_lin_q[4 * f + 1], t_lin_q[4 * f + 2], t_lin_q[4 * f + 3]},
                     {t_lin_t[3 * f], t_lin_t[3 * f + 1], t_lin_t[3 * f + 2]}};
  float xi[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (eps != nullptr)
    for (int c = 0; c < 6; ++c) xi[c] = eps[8 * f + c];
  return compose(lin, se3_exp(xi));
}

// T_j^-1 T_i, as solvers/pba.py::_relative_poses
static __device__ Rigid relative_pose(const float* t_lin_q, const float* t_lin_t,
                                      const float* eps, int i, int j) {
  return compose(inverse(frame_pose(t_lin_q, t_lin_t, eps, j)),
                 frame_pose(t_lin_q, t_lin_t, eps, i));
}

// Scaled target point q = R ray + d t of pixel (u, v) with inverse depth d
static __device__ __forceinline__ Vec3 scaled_target_point(const Camera& cam, float u,
                                                           float v, float d,
                                                           const Rigid& rel, Vec3* ray) {
  *ray = {(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, 1.0f};
  const Vec3 rot = quat_rotate(rel.q, *ray);
  return {rot.x + d * rel.t.x, rot.y + d * rel.t.y, rot.z + d * rel.t.z};
}

// validity of a reprojection: in front, inside the image less the border,
// and a sane inverse depth (core/camera.py, core/reproject.py)
static __device__ __forceinline__ bool reprojection_valid(const Camera& cam, float z,
                                                          float u_t, float v_t, float d) {
  const bool proj = z >= 1e-3f && u_t >= 4.0f && v_t >= 4.0f &&
                    u_t <= cam.width - 4.0f - 1.0f && v_t <= cam.height - 4.0f - 1.0f;
  const bool ok_z = z >= 1e-3f * fmaxf(d, 0.0f) + 1e-12f;
  const bool ok_d = d > -1e-4f && d < 1010.0f;
  return proj && ok_z && ok_d;
}

// AND of a flag over the 8 lanes of a landmark's pattern
static __device__ __forceinline__ int all_of_pattern(int flag) {
  flag &= __shfl_xor_sync(kFull, flag, 1);
  flag &= __shfl_xor_sync(kFull, flag, 2);
  flag &= __shfl_xor_sync(kFull, flag, 4);
  return flag;
}

}  // namespace ba
