// K6 ba_fej: the first-estimate-Jacobian cache of the windowed BA.
//
// Replaces dsopp_tpu/solvers/pba.py::_fej_cache: for every (anchor i,
// target j, landmark n, pattern point p) the reprojection Jacobians at the
// linearization point (eps_pose = 0) — d uv / d eps_anchor and d uv /
// d eps_target [2, 6], d uv / d idepth [2] — the brightness-corrected
// reference patch, the frozen brightness scale of the pair and the
// per-landmark validity of the reprojection.
//
// Bound: bytes.  The inputs are a few hundred KB; the outputs are 27 floats
// per residual (21.6 MB at K = 10, N = 250), written once.  Design: one
// thread per residual (layout of ba_body.cuh); thread 0 of a block computes
// the pair's relative pose and scale into shared memory; each thread writes
// its 12 + 12 + 2 + 1 values to consecutive addresses.  All K * K pairs are
// computed, dead ones included, as the plain version does.  Inside the LM
// loop the kernel takes the loop's state and returns at once unless the last
// step relinearized (the cache depends on the linearization point only).

#include "ba_body.cuh"
#include "ba_lm_state.cuh"

namespace {

using namespace ba;

__global__ void __launch_bounds__(kThreads)
ba_fej_kernel(const float* __restrict__ t_lin_q, const float* __restrict__ t_lin_t,
              const float* __restrict__ affine0, const float* __restrict__ exposure,
              const float* __restrict__ lm_uv, const float* __restrict__ lm_idepth,
              const float* __restrict__ lm_patch, int k, int n, Camera cam,
              const int* __restrict__ lm_state, float* __restrict__ d_uv_ref,
              float* __restrict__ d_uv_tgt, float* __restrict__ d_uv_idepth,
              float* __restrict__ corrected_ref, float* __restrict__ scale0,
              unsigned char* __restrict__ geom_valid) {
  if (lm_state != nullptr && (lm_state[kLmDone] != 0 || lm_state[kLmRelin] == 0)) return;
  __shared__ Rigid rel_s;
  __shared__ float scale_s;
  const int pair = blockIdx.y;
  const int i = pair / k, j = pair % k;
  if (threadIdx.x == 0) {
    rel_s = relative_pose(t_lin_q, t_lin_t, nullptr, i, j);
    const float ratio = exposure[j] / fmaxf(exposure[i], 1e-12f);
    scale_s = ratio * expf(affine0[2 * j] - affine0[2 * i]);
    if (blockIdx.x == 0) scale0[pair] = scale_s;
  }
  __syncthreads();
  const Rigid rel = rel_s;
  const float scale = scale_s;

  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const bool active = idx < n * kPattern;
  const int cl = active ? idx : n * kPattern - 1;  // idle lanes repeat the last residual
  const int ln = cl / kPattern, p = cl % kPattern;
  const int lm = i * n + ln;

  const float d = lm_idepth[lm];
  const float u = lm_uv[2 * lm] + kPatternX[p];
  const float v = lm_uv[2 * lm + 1] + kPatternY[p];
  Vec3 ray;
  const Vec3 q = scaled_target_point(cam, u, v, d, rel, &ray);
  const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
  const float iz = 1.0f / z_safe;
  const float iz2 = iz * iz;
  const float u_t = cam.fx * q.x * iz + cam.cx;
  const float v_t = cam.fy * q.y * iz + cam.cy;
  const int valid = all_of_pattern(reprojection_valid(cam, q.z, u_t, v_t, d) ? 1 : 0);

  // J = d(uv)/d(point) rows; A = J R
  const Vec3 j0 = {cam.fx * iz, 0.0f, -cam.fx * q.x * iz2};
  const Vec3 j1 = {0.0f, cam.fy * iz, -cam.fy * q.y * iz2};
  const float qw = rel.q.w, qx = rel.q.x, qy = rel.q.y, qz = rel.q.z;
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const Vec3 r0 = {1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)};
  const Vec3 r1 = {2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)};
  const Vec3 r2 = {2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)};
  const Vec3 a0 = {j0.x * r0.x + j0.z * r2.x, j0.x * r0.y + j0.z * r2.y,
                   j0.x * r0.z + j0.z * r2.z};
  const Vec3 a1 = {j1.y * r1.x + j1.z * r2.x, j1.y * r1.y + j1.z * r2.y,
                   j1.y * r1.z + j1.z * r2.z};
  const Vec3 ar0 = cross(a0, ray), ar1 = cross(a1, ray);
  const Vec3 jq0 = cross(j0, q), jq1 = cross(j1, q);

  if (!active) return;
  const size_t res = ((size_t)pair * n + ln) * kPattern + p;
  float* ref = d_uv_ref + res * 12;
  ref[0] = d * a0.x;  ref[1] = d * a0.y;  ref[2] = d * a0.z;
  ref[3] = -ar0.x;    ref[4] = -ar0.y;    ref[5] = -ar0.z;
  ref[6] = d * a1.x;  ref[7] = d * a1.y;  ref[8] = d * a1.z;
  ref[9] = -ar1.x;    ref[10] = -ar1.y;   ref[11] = -ar1.z;
  float* tgt = d_uv_tgt + res * 12;
  tgt[0] = -d * j0.x; tgt[1] = -d * j0.y; tgt[2] = -d * j0.z;
  tgt[3] = jq0.x;     tgt[4] = jq0.y;     tgt[5] = jq0.z;
  tgt[6] = -d * j1.x; tgt[7] = -d * j1.y; tgt[8] = -d * j1.z;
  tgt[9] = jq1.x;     tgt[10] = jq1.y;    tgt[11] = jq1.z;
  d_uv_idepth[res * 2] = (j0.x * rel.t.x + j0.y * rel.t.y) + j0.z * rel.t.z;
  d_uv_idepth[res * 2 + 1] = (j1.x * rel.t.x + j1.y * rel.t.y) + j1.z * rel.t.z;
  corrected_ref[res] = scale * (lm_patch[(size_t)lm * kPattern + p] - affine0[2 * i + 1]);
  if (p == 0) geom_valid[(size_t)pair * n + ln] = (unsigned char)valid;
}

}  // namespace

// Window: t_lin_q [k,4], t_lin_t [k,3], affine0 [k,2], exposure [k], lm_uv
// [k,n,2], lm_idepth [k,n], lm_patch [k,n,8].  Outputs: d_uv_ref, d_uv_tgt
// [k,k,n,8,2,6], d_uv_idepth [k,k,n,8,2], corrected_ref [k,k,n,8], scale0
// [k,k], geom_valid [k,k,n] u8.  lm_state: the LM loop's state or nullptr.
extern "C" int ba_fej(const float* t_lin_q, const float* t_lin_t, const float* affine0,
                      const float* exposure, const float* lm_uv, const float* lm_idepth,
                      const float* lm_patch, int k, int n, float fx, float fy, float cx,
                      float cy, float width, float height, const int* lm_state,
                      float* d_uv_ref,
                      float* d_uv_tgt, float* d_uv_idepth, float* corrected_ref,
                      float* scale0, unsigned char* geom_valid, void* stream) {
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  const dim3 grid((n * ba::kPattern + ba::kThreads - 1) / ba::kThreads, k * k);
  ba_fej_kernel<<<grid, ba::kThreads, 0, (cudaStream_t)stream>>>(
      t_lin_q, t_lin_t, affine0, exposure, lm_uv, lm_idepth, lm_patch, k, n, cam,
      lm_state, d_uv_ref, d_uv_tgt, d_uv_idepth, corrected_ref, scale0, geom_valid);
  return (int)cudaGetLastError();
}
