// K2 align_residual_system: residuals and the 8x8 Gauss-Newton system of
// the frontend pose alignment, for a batch of pose hypotheses.
//
// Replaces the with_jacobian=True body of
// dsopp_tpu/solvers/pose_alignment.py::_residual_system (C = 1) together
// with core/reproject.py::reproject_jacobian and the bilinear sampling of
// ops/sample.py (sampled directly from the [3, H, W] map, no corner
// packing).  The affine priors are added by the caller.
//
// Bound: latency.  One call touches <= 2000 points (~50 KB of scattered
// map reads) and the LM driver around it runs up to 50 dependent
// iterations per level, so what costs is the launch-to-result time, not
// bytes or flops.  Design: one block per hypothesis, 256 threads striding
// over the points, each accumulating its 36 upper-triangle H entries, 8 b
// entries, energy and count in registers; then a fixed-order reduction
// (warp butterfly, then warps in index order) — deterministic, no atomics,
// because the caller ranks hypotheses by an argmin over energies.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 36 + 8 + 1;  // H upper triangle, b, energy

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// v + 2 (w (u x v) + u x (u x v)), as dsopp_tpu core/lie.py::quat_rotate
__device__ __forceinline__ Vec3 quat_rotate(float qw, Vec3 u, Vec3 v) {
  Vec3 uv = cross(u, v);
  Vec3 uuv = cross(u, uv);
  return {v.x + 2.0f * (qw * uv.x + uuv.x), v.y + 2.0f * (qw * uv.y + uuv.y),
          v.z + 2.0f * (qw * uv.z + uuv.z)};
}

__global__ void __launch_bounds__(kThreads)
align_residual_kernel(const float* __restrict__ uv,
                      const float* __restrict__ idepth,
                      const float* __restrict__ intensity,
                      const unsigned char* __restrict__ valid, int n,
                      const float* __restrict__ map, int h, int w,
                      const float* __restrict__ pose_q,
                      const float* __restrict__ pose_t,
                      const float* __restrict__ affine,
                      const float* __restrict__ ref,  // a_r, b_r, ratio
                      float fx, float fy, float cx, float cy, float width,
                      float height, float sigma, float* __restrict__ out_h,
                      float* __restrict__ out_b, float* __restrict__ out_e,
                      int* __restrict__ out_n) {
  const int hyp = blockIdx.x;
  const float qw = pose_q[4 * hyp + 0];
  const Vec3 qu = {pose_q[4 * hyp + 1], pose_q[4 * hyp + 2], pose_q[4 * hyp + 3]};
  const Vec3 tt = {pose_t[3 * hyp + 0], pose_t[3 * hyp + 1], pose_t[3 * hyp + 2]};
  const float a_t = affine[2 * hyp + 0];
  const float b_t = affine[2 * hyp + 1];
  const float a_r = ref[0], b_r = ref[1], ratio = ref[2];
  const float scale = ratio * expf(a_t - a_r);
  const float sigma_sq = sigma * sigma;
  const size_t plane = (size_t)h * w;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  int count = 0;

  for (int p = threadIdx.x; p < n; p += kThreads) {
    if (!valid[p]) continue;
    const float d = idepth[p];
    const Vec3 ray = {(uv[2 * p] - cx) / fx, (uv[2 * p + 1] - cy) / fy, 1.0f};
    const Vec3 rot = quat_rotate(qw, qu, ray);
    const Vec3 q = {rot.x + d * tt.x, rot.y + d * tt.y, rot.z + d * tt.z};
    const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
    const float iz = 1.0f / z_safe;
    const float iz2 = iz * iz;
    const float u_t = fx * q.x * iz + cx;
    const float v_t = fy * q.y * iz + cy;
    const bool ok_proj = (q.z >= 1e-3f) && u_t >= 4.0f && v_t >= 4.0f &&
                         u_t <= width - 4.0f - 1.0f && v_t <= height - 4.0f - 1.0f;
    const bool ok_z = q.z >= 1e-3f * fmaxf(d, 0.0f) + 1e-12f;
    const bool ok_d = d > -1e-4f && d < 1010.0f;
    const bool inside = u_t >= 0.0f && v_t >= 0.0f && u_t <= (float)(w - 1) &&
                        v_t <= (float)(h - 1);
    if (!(ok_proj && ok_z && ok_d && inside)) continue;

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
      const float* m = map + c * plane + base;
      s[c] = ((__ldg(m) * w00 + __ldg(m + 1) * w01) + __ldg(m + w) * w10) +
             __ldg(m + w + 1) * w11;
    }

    const float corrected = scale * (intensity[p] - b_r);
    const float r = (s[0] - b_t) - corrected;
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
    acc[44] += energy;
    ++count;
  }

  // fixed-order reduction: butterfly within warps, then warps in order
  __shared__ float part[kWarps][kAcc + 1];
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
  if (lane == 0) part[warp][kAcc] = __int_as_float(cnt);
  __syncthreads();

  if (threadIdx.x < kAcc) {
    float v = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) v += part[wi][threadIdx.x];
    const int i = threadIdx.x;
    if (i < 36) {
      // upper-triangle index -> (row, col); write both halves
      int row = 0, rem = i;
      while (rem >= 8 - row) {
        rem -= 8 - row;
        ++row;
      }
      const int col = row + rem;
      out_h[64 * hyp + 8 * row + col] = v;
      out_h[64 * hyp + 8 * col + row] = v;
    } else if (i < 44) {
      out_b[8 * hyp + (i - 36)] = v;
    } else {
      out_e[hyp] = v;
    }
  } else if (threadIdx.x == kAcc) {
    int c = 0;
    for (int wi = 0; wi < kWarps; ++wi) c += __float_as_int(part[wi][kAcc]);
    out_n[hyp] = c;
  }
}

}  // namespace

// Points [n] (uv [n,2], idepth, intensity f32; valid u8), map [3,h,w] f32,
// hypotheses [num_hyp] (pose_q [.,4], pose_t [.,3], affine [.,2]), ref [3] =
// (a_ref, b_ref, exposure ratio).  Outputs: H [num_hyp,8,8], b [num_hyp,8],
// energy [num_hyp] (no priors), num_valid [num_hyp] int32.
extern "C" int align_residual_system(
    const float* uv, const float* idepth, const float* intensity,
    const unsigned char* valid, int n, const float* map, int h, int w,
    const float* pose_q, const float* pose_t, const float* affine,
    const float* ref, int num_hyp, float fx, float fy, float cx, float cy,
    float width, float height, float sigma, float* out_h, float* out_b,
    float* out_e, int* out_n, void* stream) {
  align_residual_kernel<<<num_hyp, kThreads, 0, (cudaStream_t)stream>>>(
      uv, idepth, intensity, valid, n, map, h, w, pose_q, pose_t, affine, ref,
      fx, fy, cx, cy, width, height, sigma, out_h, out_b, out_e, out_n);
  return (int)cudaGetLastError();
}
