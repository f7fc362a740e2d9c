// Shared device code of the windowed-BA kernels K7 (ba_evaluate.cu) and K8
// (ba_linearize.cu) and of the kernels that reproject or sample as they do
// (K5, K10, K11, K13, K14, K15p, K16): the residual pattern, rigid transforms
// on quaternion + translation with the formulas and small-angle branches of
// core/lie.py, the relative pose T_j^-1 T_i of an (anchor i, target j) pair,
// the first-estimate Jacobians of a pattern point (fej_point), the 10x10-window
// sampling rule of core/interpolate.py::sample_window, a block scan and the
// count of valid frames.
//
// K7 and K8 use one thread per residual (i, j, n, p) of a pair's block, the
// block's threads running over n * 8 + p, so the 8 pattern points of a
// landmark are 8 neighbouring lanes of one warp and per-landmark reductions
// are shuffles over those lanes.

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

// The first-estimate Jacobians of one pattern point (dsopp_tpu/solvers/
// pba.py::_fej_cache, pba.py::_fej_cache_plain here): pattern point (u, v)
// of a landmark with inverse depth d, reprojected by the pair's relative
// pose at the linearization point.  K8 forms them where it reads them; they
// were once kernel K6's cache.  The geometry is the point's, shared by its C
// residuals (one a channel); valid is the point's own reprojection test (the
// landmark's is the AND over its pattern, all_of_pattern).  Each channel's
// residual adds its frozen affine column, fej_corrected.
struct Fej {
  float ref[12];     // d uv / d eps_anchor, rows u then v: [d A | -(A x ray)], A = J R
  float tgt[12];     // d uv / d eps_target, rows u then v: [-d J | J x q]
  float idepth[2];   // d uv / d idepth: J t
  bool valid;
};

// a channel's reference intensity `patch` corrected into the target's
// brightness: scale (patch - b_anchor)
static __device__ __forceinline__ float fej_corrected(float scale, float patch, float b_anchor) {
  return scale * (patch - b_anchor);
}

static __device__ __forceinline__ Fej fej_point(const Camera& cam, const Rigid& rel, float u,
                                                float v, float d) {
  Vec3 ray;
  const Vec3 q = scaled_target_point(cam, u, v, d, rel, &ray);
  const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
  const float iz = 1.0f / z_safe;
  const float iz2 = iz * iz;
  const float u_t = cam.fx * q.x * iz + cam.cx;
  const float v_t = cam.fy * q.y * iz + cam.cy;
  Fej f;
  f.valid = reprojection_valid(cam, q.z, u_t, v_t, d);

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

  f.ref[0] = d * a0.x;  f.ref[1] = d * a0.y;  f.ref[2] = d * a0.z;
  f.ref[3] = -ar0.x;    f.ref[4] = -ar0.y;    f.ref[5] = -ar0.z;
  f.ref[6] = d * a1.x;  f.ref[7] = d * a1.y;  f.ref[8] = d * a1.z;
  f.ref[9] = -ar1.x;    f.ref[10] = -ar1.y;   f.ref[11] = -ar1.z;
  f.tgt[0] = -d * j0.x; f.tgt[1] = -d * j0.y; f.tgt[2] = -d * j0.z;
  f.tgt[3] = jq0.x;     f.tgt[4] = jq0.y;     f.tgt[5] = jq0.z;
  f.tgt[6] = -d * j1.x; f.tgt[7] = -d * j1.y; f.tgt[8] = -d * j1.z;
  f.tgt[9] = jq1.x;     f.tgt[10] = jq1.y;    f.tgt[11] = jq1.z;
  f.idepth[0] = (j0.x * rel.t.x + j0.y * rel.t.y) + j0.z * rel.t.z;
  f.idepth[1] = (j1.x * rel.t.x + j1.y * rel.t.y) + j1.z * rel.t.z;
  return f;
}

// AND of a flag over the 8 lanes of a landmark's pattern
static __device__ __forceinline__ int all_of_pattern(int flag) {
  flag &= __shfl_xor_sync(kFull, flag, 1);
  flag &= __shfl_xor_sync(kFull, flag, 2);
  flag &= __shfl_xor_sync(kFull, flag, 4);
  return flag;
}

// core/interpolate.py::window_base along one axis: the window of a group of
// points is based at floor(center) - 4, the center clamped into the image
static __device__ __forceinline__ int window_base(float center, int size) {
  return min(max((int)floorf(center), 0), size - 1) - 4;
}

struct WindowSample {
  float val, gx, gy;
  bool ok;  // inside the image and, with the +-1 gradient halo, inside the window
};

// core/interpolate.py::sample_window at (x, y) of the [h, w] image `img`, for
// the 10x10 window based at (bx, by): bilinear value and half central
// differences of raw intensities; a point whose bilinear corners plus the
// +-1 halo leave the window (corner offsets outside [1, 7]) or the image is
// not ok; pixels outside the image read as 0
static __device__ __forceinline__ WindowSample sample_window(const float* __restrict__ img,
                                                             int h, int w, float x, float y,
                                                             int bx, int by) {
  constexpr int kWinLo = 1, kWinHi = 7;  // PATCH_WIN - 3
  const bool inside = x >= 0.0f && y >= 0.0f && x <= (float)(w - 1) && y <= (float)(h - 1);
  const int ix = min(max((int)floorf(x), 0), w - 2);
  const int iy = min(max((int)floorf(y), 0), h - 2);
  const float fx = x - (float)ix, fy = y - (float)iy;
  const int dxi = ix - bx, dyi = iy - by;
  const bool in_win = dxi >= kWinLo && dxi <= kWinHi && dyi >= kWinLo && dyi <= kWinHi;
  const int col = bx + min(max(dxi, kWinLo), kWinHi);
  const int row = by + min(max(dyi, kWinLo), kWinHi);

  // the 4x4 neighbourhood less its corners; zero outside the image
  float px[4][4];
#pragma unroll
  for (int dr = 0; dr < 4; ++dr) {
#pragma unroll
    for (int dc = 0; dc < 4; ++dc) {
      if ((dr == 0 || dr == 3) && (dc == 0 || dc == 3)) {
        px[dr][dc] = 0.0f;
        continue;
      }
      const int rr = row + dr - 1, cc = col + dc - 1;
      px[dr][dc] = (rr >= 0 && rr < h && cc >= 0 && cc < w) ? __ldg(img + (size_t)rr * w + cc) : 0.0f;
    }
  }
  const float wy0 = 1.0f - fy, wy1 = fy, wx0 = 1.0f - fx, wx1 = fx;
  // y contracted first for the value and d/dx, x first for d/dy
  float ty[4], tx[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ty[c] = px[1][c] * wy0 + px[2][c] * wy1;
    tx[c] = px[c][1] * wx0 + px[c][2] * wx1;
  }
  WindowSample out;
  out.val = ty[1] * wx0 + ty[2] * wx1;
  out.gx = ((ty[0] * (-0.5f * wx0) + ty[1] * (-0.5f * wx1)) + ty[2] * (0.5f * wx0)) +
           ty[3] * (0.5f * wx1);
  out.gy = ((tx[0] * (-0.5f * wy0) + tx[1] * (-0.5f * wy1)) + tx[2] * (0.5f * wy0)) +
           tx[3] * (0.5f * wy1);
  out.ok = inside && in_win;
  return out;
}

// the count of valid frames of the window; every lane of the calling warp
// must reach it (each warp counts by itself)
static __device__ __forceinline__ int valid_frames(const unsigned char* __restrict__ frame_valid,
                                                   int k) {
  int count = 0;
  for (int base = 0; base < k; base += 32) {
    const int f = base + (threadIdx.x & 31);
    count += __popc(__ballot_sync(kFull, f < k && frame_valid[f] != 0));
  }
  return count;
}

// exclusive prefix sum of `v` over the block's threads (kT of them, a
// multiple of 32); the block total lands in sums[32]
template <int kT>
static __device__ int block_exclusive_scan(int v, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += up;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < kT / 32 ? sums[lane] : 0;
    int winc = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(kFull, winc, off);
      if (lane >= off) winc += up;
    }
    sums[lane] = winc - own;
    if (lane == 31) sums[32] = winc;
  }
  __syncthreads();
  return inc - v + sums[warp];
}

}  // namespace ba
