// Shared device code of the frontend pose alignment: one reference point's
// residual and its terms of the 8x8 Gauss-Newton system
// (align::accumulate_point), which the residual pass of K2 (csrc/align.cu)
// and the LM loop K3 (csrc/align_level.cu) both run, and K2's block pass.
//
// A map of C channels ([3C, h, w]: values C | dx C | dy C; a frame
// embedder's, dsopp_tpu/solvers/pose_alignment.py:101-161) gives a point C
// residuals: accumulate_channels sums their squares for the whole-point
// Huber (sigma sqrt(C), given by the caller) and adds one Jacobian row a
// channel.  C = 1 runs accumulate_point, the single-channel code; the kernels
// that call them are templates on kMulti, so that the C = 1 instance is the
// single-channel kernel's code and registers.
//
// K2's block works on one pose hypothesis: 256 threads stride over the
// points, each accumulating its 36 upper-triangle H entries, 8 b entries,
// the energy and the count in registers; then a fixed-order reduction (warp
// butterfly, then warps in index order) — deterministic, no atomics, because
// the caller ranks hypotheses by an argmin over energies.  K3 spreads a
// hypothesis over a cluster of blocks and reduces its own way.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace align {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 36 + 8 + 1;  // H upper triangle, b, energy
constexpr int kSys = kAcc + 1;    // ... and the count of valid points (int bits)
constexpr int kEnergy = 44;
constexpr int kCount = 45;

struct Vec3 {
  float x, y, z;
};

// Reference points of one pyramid level (intensity [n] at C = 1, [n, C]
// else), the target's [3C, h, w] map, the camera of that level and the
// reference frame's brightness.
struct Problem {
  const float* uv;
  const float* idepth;
  const float* intensity;
  const unsigned char* valid;
  int n;
  const float* map;
  int h, w, channels;
  float fx, fy, cx, cy, width, height;
  float a_r, b_r, ratio;
  float sigma;
};

// One hypothesis: t_target_ref as quaternion + translation, target affine.
struct Pose {
  float qw;
  Vec3 qu;
  Vec3 t;
  float a, b;
};

static __device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// v + 2 (w (u x v) + u x (u x v)), as core/lie.py::quat_rotate
static __device__ __forceinline__ Vec3 quat_rotate(float qw, Vec3 u, Vec3 v) {
  Vec3 uv = cross(u, v);
  Vec3 uuv = cross(u, uv);
  return {v.x + 2.0f * (qw * uv.x + uuv.x), v.y + 2.0f * (qw * uv.y + uuv.y),
          v.z + 2.0f * (qw * uv.z + uuv.z)};
}

// One reference point's terms for hypothesis `ps`: ray = its normalised
// image coordinates ((u - cx) / fx, (v - cy) / fy), d its inverse depth, ib
// its intensity minus the reference's affine b, scale = ratio exp(a - a_r).
// Adds its 36 upper-triangle H entries, 8 b entries and energy to
// acc[0..kAcc) and returns true, or returns false where the point projects
// out of the image or fails a depth test.
static __device__ __forceinline__ bool accumulate_point(const Problem& prob, const Pose& ps,
                                                        float scale, float rx, float ry,
                                                        float d, float ib, float* acc) {
  const float sigma = prob.sigma, sigma_sq = prob.sigma * prob.sigma;
  const float fx = prob.fx, fy = prob.fy, cx = prob.cx, cy = prob.cy;
  const int h = prob.h, w = prob.w;
  const size_t plane = (size_t)h * w;
  const Vec3 ray = {rx, ry, 1.0f};
  const Vec3 rot = quat_rotate(ps.qw, ps.qu, ray);
  const Vec3 q = {rot.x + d * ps.t.x, rot.y + d * ps.t.y, rot.z + d * ps.t.z};
  const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
  const float iz = 1.0f / z_safe;
  const float iz2 = iz * iz;
  const float u_t = fx * q.x * iz + cx;
  const float v_t = fy * q.y * iz + cy;
  const bool ok_proj = (q.z >= 1e-3f) && u_t >= 4.0f && v_t >= 4.0f &&
                       u_t <= prob.width - 4.0f - 1.0f && v_t <= prob.height - 4.0f - 1.0f;
  const bool ok_z = q.z >= 1e-3f * fmaxf(d, 0.0f) + 1e-12f;
  const bool ok_d = d > -1e-4f && d < 1010.0f;
  const bool inside = u_t >= 0.0f && v_t >= 0.0f && u_t <= (float)(w - 1) &&
                      v_t <= (float)(h - 1);
  if (!(ok_proj && ok_z && ok_d && inside)) return false;

  // bilinear sample of (I, dx, dy): weights against the floor, index clamped
  const float fxl = floorf(u_t), fyl = floorf(v_t);
  const float ax = u_t - fxl, ay = v_t - fyl;
  const int ix = min(max((int)fxl, 0), w - 2);
  const int iy = min(max((int)fyl, 0), h - 2);
  const size_t base = (size_t)iy * w + ix;
  const float w00 = (1.0f - ax) * (1.0f - ay), w01 = ax * (1.0f - ay);
  const float w10 = (1.0f - ax) * ay, w11 = ax * ay;
  float s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* m = prob.map + c * plane + base;
    s[c] = ((__ldg(m) * w00 + __ldg(m + 1) * w01) + __ldg(m + w) * w10) +
           __ldg(m + w + 1) * w11;
  }

  const float corrected = scale * ib;
  const float r = (s[0] - ps.b) - corrected;
  const float r2 = r * r;
  const float norm = sqrtf(fmaxf(r2, 1e-30f));
  const bool linear = r2 > sigma_sq;
  const float energy = linear ? sigma * norm - 0.5f * sigma_sq : 0.5f * r2;
  const float weight = linear ? sigma / norm : 1.0f;

  // d(uv)/d(left tangent of t_t_r) = [d J | -(J rows x q)]
  const Vec3 j0 = {fx * iz, 0.0f, -fx * q.x * iz2};
  const Vec3 j1 = {0.0f, fy * iz, -fy * q.y * iz2};
  const Vec3 c0 = cross(j0, q), c1 = cross(j1, q);
  const float du0[6] = {d * j0.x, d * j0.y, d * j0.z, -c0.x, -c0.y, -c0.z};
  const float du1[6] = {d * j1.x, d * j1.y, d * j1.z, -c1.x, -c1.y, -c1.z};
  float jac[8];
#pragma unroll
  for (int i = 0; i < 6; ++i) jac[i] = s[1] * du0[i] + s[2] * du1[i];
  jac[6] = -corrected;
  jac[7] = -1.0f;

  int k = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float wj = jac[i] * weight;
#pragma unroll
    for (int j = i; j < 8; ++j) acc[k++] += wj * jac[j];
    acc[36 + i] += wj * r;
  }
  acc[kEnergy] += energy;
  return true;
}

// accumulate_point for a map of C > 1 channels: point `p`'s intensities are
// intensity[p * C + c]; its C residuals' squares are summed for one Huber
// weight, then each channel adds the H and b terms of its Jacobian row.
static __device__ bool accumulate_channels(const Problem& prob, const Pose& ps, float scale,
                                           float rx, float ry, float d, int p, float* acc) {
  const float sigma = prob.sigma, sigma_sq = prob.sigma * prob.sigma;
  const float fx = prob.fx, fy = prob.fy, cx = prob.cx, cy = prob.cy;
  const int h = prob.h, w = prob.w, nc = prob.channels;
  const size_t plane = (size_t)h * w;
  const Vec3 ray = {rx, ry, 1.0f};
  const Vec3 rot = quat_rotate(ps.qw, ps.qu, ray);
  const Vec3 q = {rot.x + d * ps.t.x, rot.y + d * ps.t.y, rot.z + d * ps.t.z};
  const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
  const float iz = 1.0f / z_safe;
  const float iz2 = iz * iz;
  const float u_t = fx * q.x * iz + cx;
  const float v_t = fy * q.y * iz + cy;
  const bool ok_proj = (q.z >= 1e-3f) && u_t >= 4.0f && v_t >= 4.0f &&
                       u_t <= prob.width - 4.0f - 1.0f && v_t <= prob.height - 4.0f - 1.0f;
  const bool ok_z = q.z >= 1e-3f * fmaxf(d, 0.0f) + 1e-12f;
  const bool ok_d = d > -1e-4f && d < 1010.0f;
  const bool inside = u_t >= 0.0f && v_t >= 0.0f && u_t <= (float)(w - 1) &&
                      v_t <= (float)(h - 1);
  if (!(ok_proj && ok_z && ok_d && inside)) return false;

  const float fxl = floorf(u_t), fyl = floorf(v_t);
  const float ax = u_t - fxl, ay = v_t - fyl;
  const int ix = min(max((int)fxl, 0), w - 2);
  const int iy = min(max((int)fyl, 0), h - 2);
  const size_t base = (size_t)iy * w + ix;
  const float w00 = (1.0f - ax) * (1.0f - ay), w01 = ax * (1.0f - ay);
  const float w10 = (1.0f - ax) * ay, w11 = ax * ay;
  auto bilinear = [&](int plane_index) {
    const float* m = prob.map + plane_index * plane + base;
    return ((__ldg(m) * w00 + __ldg(m + 1) * w01) + __ldg(m + w) * w10) + __ldg(m + w + 1) * w11;
  };
  const float* ref = prob.intensity + (size_t)p * nc;

  // the point's C residuals, squared and summed in channel order
  float r2 = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const float r = (bilinear(c) - ps.b) - scale * (ref[c] - prob.b_r);
    r2 += r * r;
  }
  const float norm = sqrtf(fmaxf(r2, 1e-30f));
  const bool linear = r2 > sigma_sq;
  const float energy = linear ? sigma * norm - 0.5f * sigma_sq : 0.5f * r2;
  const float weight = linear ? sigma / norm : 1.0f;

  const Vec3 j0 = {fx * iz, 0.0f, -fx * q.x * iz2};
  const Vec3 j1 = {0.0f, fy * iz, -fy * q.y * iz2};
  const Vec3 c0 = cross(j0, q), c1 = cross(j1, q);
  const float du0[6] = {d * j0.x, d * j0.y, d * j0.z, -c0.x, -c0.y, -c0.z};
  const float du1[6] = {d * j1.x, d * j1.y, d * j1.z, -c1.x, -c1.y, -c1.z};
  for (int c = 0; c < nc; ++c) {
    const float corrected = scale * (ref[c] - prob.b_r);
    const float r = (bilinear(c) - ps.b) - corrected;
    const float gx = bilinear(nc + c), gy = bilinear(2 * nc + c);
    float jac[8];
#pragma unroll
    for (int i = 0; i < 6; ++i) jac[i] = gx * du0[i] + gy * du1[i];
    jac[6] = -corrected;
    jac[7] = -1.0f;
    int k = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wj = jac[i] * weight;
#pragma unroll
      for (int j = i; j < 8; ++j) acc[k++] += wj * jac[j];
      acc[36 + i] += wj * r;
    }
  }
  acc[kEnergy] += energy;
  return true;
}

// Residuals and the 8x8 Gauss-Newton system of hypothesis `ps`, without the
// affine priors.  Every thread of the block calls it; `part` is block
// scratch.  On return (a __syncthreads() has passed) sys[0..35] is H's upper
// triangle by rows, sys[36..43] b, sys[kEnergy] the energy and sys[kCount]
// the number of valid points as int bits.
template <bool kMulti>
static __device__ void residual_system_block(const Problem& prob, const Pose& ps,
                                             float (*part)[kSys], float* sys) {
  const float scale = prob.ratio * expf(ps.a - prob.a_r);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  int count = 0;

  for (int p = threadIdx.x; p < prob.n; p += kThreads) {
    if (!prob.valid[p]) continue;
    const float rx = (prob.uv[2 * p] - prob.cx) / prob.fx;
    const float ry = (prob.uv[2 * p + 1] - prob.cy) / prob.fy;
    const bool ok = kMulti
                        ? accumulate_channels(prob, ps, scale, rx, ry, prob.idepth[p], p, acc)
                        : accumulate_point(prob, ps, scale, rx, ry, prob.idepth[p],
                                           prob.intensity[p] - prob.b_r, acc);
    if (ok) ++count;
  }

  // fixed-order reduction: butterfly within warps, then warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][i] = v;
  }
  int cnt = count;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) part[warp][kCount] = __int_as_float(cnt);
  __syncthreads();

  if (threadIdx.x < kAcc) {
    float v = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) v += part[wi][threadIdx.x];
    sys[threadIdx.x] = v;
  } else if (threadIdx.x == kAcc) {
    int c = 0;
    for (int wi = 0; wi < kWarps; ++wi) c += __float_as_int(part[wi][kCount]);
    sys[kCount] = __int_as_float(c);
  }
  __syncthreads();
}

}  // namespace align
