// K5 flow_statistic: the RMS ray-space flow of the frontend's flow set under
// the tracked pose T and under T without its rotation (the keyframe
// strategy's two statistics).
//
// Replaces dsopp_tpu/tracker/depth_map.py::mean_square_flows: for each of
// <= 8192 points (uv, idepth) of the newest keyframe, reproject into the
// current frame, unproject the reprojected pixel and take the squared
// distance to the source ray; mean over the points that are valid at the
// source (inside the image less the border, idepth > 1e-6) and after
// core/reproject.py::reproject; square root.  Both poses share the
// unprojected source ray.
//
// Bound: bytes (16 bytes of input per point, two floats out) — at 8192
// points the launch itself is the cost.  Design: one block, one launch, no
// host read; each thread strides over the points with f64 partial sums and
// integer counts, then a fixed-order reduction (warp butterfly, warps in
// index order), so the statistic that decides a keyframe is the same on every
// run.  The projection is Pinhole.project's division form (fx * x / z + cx),
// as the plain version rounds.

#include "ba_body.cuh"

namespace {

using namespace ba;

constexpr int kFlowThreads = 1024;
constexpr int kFlowWarps = kFlowThreads / 32;

__global__ void __launch_bounds__(kFlowThreads)
flow_kernel(const float* __restrict__ uv, const float* __restrict__ idepth,
            const unsigned char* __restrict__ valid, int n, const float* __restrict__ pose_q,
            const float* __restrict__ pose_t, Camera cam, float border,
            float* __restrict__ out) {
  __shared__ double sum_s[2][kFlowWarps];
  __shared__ int cnt_s[2][kFlowWarps];
  const Rigid pose[2] = {
      {{pose_q[0], pose_q[1], pose_q[2], pose_q[3]}, {pose_t[0], pose_t[1], pose_t[2]}},
      {{1.0f, 0.0f, 0.0f, 0.0f}, {pose_t[0], pose_t[1], pose_t[2]}}};
  double sum[2] = {0.0, 0.0};
  int cnt[2] = {0, 0};

  for (int p = threadIdx.x; p < n; p += kFlowThreads) {
    const float u = uv[2 * p], v = uv[2 * p + 1], d = idepth[p];
    const bool src_ok = valid[p] && d > 1e-6f && u >= border && u < cam.width - border &&
                        v >= border && v < cam.height - border;
    if (!src_ok) continue;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      Vec3 ray;
      const Vec3 q = scaled_target_point(cam, u, v, d, pose[s], &ray);
      const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
      const float u_t = cam.fx * q.x / z_safe + cam.cx;
      const float v_t = cam.fy * q.y / z_safe + cam.cy;
      if (!reprojection_valid(cam, q.z, u_t, v_t, d)) continue;
      const float dx = ray.x - (u_t - cam.cx) / cam.fx;
      const float dy = ray.y - (v_t - cam.cy) / cam.fy;
      sum[s] += (double)(dx * dx + dy * dy);
      ++cnt[s];
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    double a = sum[s];
    int c = cnt[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(kFull, a, off);
      c += __shfl_xor_sync(kFull, c, off);
    }
    if (lane == 0) {
      sum_s[s][warp] = a;
      cnt_s[s][warp] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    double a = 0.0;
    int c = 0;
    for (int w = 0; w < kFlowWarps; ++w) {
      a += sum_s[threadIdx.x][w];
      c += cnt_s[threadIdx.x][w];
    }
    out[threadIdx.x] = sqrtf((float)a / (float)max(c, 1));
  }
}

}  // namespace

// Points: uv [n,2], idepth [n], valid [n] u8; pose_q [4], pose_t [3] (target
// <- reference).  Output: out [2] = (flow, flow without rotation).
extern "C" int flow_statistic(const float* uv, const float* idepth,
                              const unsigned char* valid, int n, const float* pose_q,
                              const float* pose_t, float fx, float fy, float cx, float cy,
                              float width, float height, float border, float* out,
                              void* stream) {
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  flow_kernel<<<1, kFlowThreads, 0, (cudaStream_t)stream>>>(uv, idepth, valid, n, pose_q,
                                                           pose_t, cam, border, out);
  return (int)cudaGetLastError();
}
