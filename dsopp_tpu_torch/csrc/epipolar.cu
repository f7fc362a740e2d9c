// K4 epipolar_sweep: the epipolar SSD sweep, uniqueness and subpixel
// Gauss-Newton refine of every immature landmark against a new frame.
//
// Replaces the sweep, uniqueness and GN-refine part of
// dsopp_tpu/tracker/depth_estimation.py::estimate_depths (lines 188-281),
// over ops/patch.py::patch_center_row, sample_values_rows and
// sample_pattern_rows.  The per-landmark geometry before the sweep and the
// error model / interval shrink / status machine after it stay in PyTorch.
//
// Bound: latency of scattered reads.  A landmark reads 32 samples x 8
// pattern points x 4 bilinear corners from the target image at
// data-dependent addresses, then runs 4 dependent GN steps; the arithmetic
// is small.  Design: one warp per landmark, lane s = epiline sample s
// (S = 32), the image read through the read-only path (__ldg), argmin /
// second-best / GN sums as warp shuffles (no shared memory, no atomics).
// GN runs on lanes 0..7 = pattern points.
//
// Validity rules kept from the TPU path exactly: samples 4s..4s+3 share one
// 10x10 window based at floor(group-mean center) - 4; a pattern point whose
// bilinear corners leave that window is invalid; GN reads one window at the
// sweep winner and needs the +-1 gradient halo inside it; pixels outside
// the image read as 0; GN gradients are 1/2 central differences of raw
// intensities.  Everything is f32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kS = 32;  // epiline samples = lanes
constexpr int kP = 8;   // pattern points
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, width, height;
};

__device__ __forceinline__ float pix(const float* __restrict__ img, int h,
                                     int w, int y, int x) {
  return (x >= 0 && y >= 0 && x < w && y < h) ? __ldg(img + (size_t)y * w + x)
                                              : 0.0f;
}

__device__ __forceinline__ float triangulate(float prx, float pry, float prz,
                                             float tx, float ty, float tz,
                                             float vx, float vy) {
  const float den_x = tx - vx * tz;
  const float den_y = ty - vy * tz;
  const float num_x = vx * prz - prx;
  const float num_y = vy * prz - pry;
  const bool use_x = fabsf(den_x) > fabsf(den_y);
  float den = use_x ? den_x : den_y;
  const float num = use_x ? num_x : num_y;
  if (fabsf(den) < 1e-12f) den = 1e-12f;
  return num / den;
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

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
epipolar_kernel(const unsigned char* __restrict__ active, int m,
                const float* __restrict__ uv_a, const float* __restrict__ dir,
                const float* __restrict__ search_len,
                const float* __restrict__ pr, const float* __restrict__ tvec,
                const float* __restrict__ pr_p,
                const float* __restrict__ corr_ref,
                const float* __restrict__ b_tgt,
                const float* __restrict__ alphas,
                const float* __restrict__ alpha_g,
                const float* __restrict__ img, int h, int w, Cam cam,
                float sigma, float rho_max, int* __restrict__ out_best,
                float* __restrict__ out_best_e, float* __restrict__ out_second,
                unsigned char* __restrict__ out_any,
                float* __restrict__ out_ref_e, float* __restrict__ out_delta) {
  const int lane = threadIdx.x & 31;
  const int lm = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (lm >= m) return;  // the whole warp leaves together
  if (!active[lm]) {
    if (lane == 0) {
      out_best[lm] = 0;
      out_best_e[lm] = INFINITY;
      out_second[lm] = INFINITY;
      out_any[lm] = 0;
      out_ref_e[lm] = INFINITY;
      out_delta[lm] = 0.0f;
    }
    return;
  }

  const float uax = uv_a[2 * lm], uay = uv_a[2 * lm + 1];
  const float dx = dir[2 * lm], dy = dir[2 * lm + 1];
  const float slen = search_len[lm];
  const float prx = pr[3 * lm], pry = pr[3 * lm + 1], prz = pr[3 * lm + 2];
  const float tx = tvec[3 * lm], ty = tvec[3 * lm + 1], tz = tvec[3 * lm + 2];
  const float bt = b_tgt[0];

  // ---- sweep: lane = sample --------------------------------------------
  const float step_s = alphas[lane] * slen;
  const float us = uax + step_s * dx, vs = uay + step_s * dy;
  const float rho = triangulate(prx, pry, prz, tx, ty, tz, (us - cam.cx) / cam.fx,
                                (vs - cam.cy) / cam.fy);
  const float step_g = alpha_g[lane >> 2] * slen;
  const float ugx = uax + step_g * dx, ugy = uay + step_g * dy;
  const int bx = floor_clamp(ugx, 0, w - 1) - 4;
  const int by = floor_clamp(ugy, 0, h - 1) - 4;

  float pu[kP], pv[kP];
  bool ok_all = rho > -1e-4f && rho < rho_max;
  float ssd = 0.0f;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const float* rp = pr_p + (size_t)lm * kP * 3 + 3 * p;
    const float qx = rp[0] + rho * tx, qy = rp[1] + rho * ty, qz = rp[2] + rho * tz;
    const float zs = fabsf(qz) < 1e-12f ? 1e-12f : qz;
    pu[p] = cam.fx * qx / zs + cam.cx;
    pv[p] = cam.fy * qy / zs + cam.cy;
    const bool proj_ok = qz >= 1e-3f && pu[p] >= 4.0f && pv[p] >= 4.0f &&
                         pu[p] <= cam.width - 4.0f - 1.0f &&
                         pv[p] <= cam.height - 4.0f - 1.0f;
    bool in_ok;
    const float val = window_value(img, h, w, pu[p], pv[p], bx, by, &in_ok);
    const float r = (val - bt) - corr_ref[(size_t)lm * kP + p];
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
  const float ubx = __shfl_sync(kFull, us, bi);
  const float uby = __shfl_sync(kFull, vs, bi);
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
  const int rbx = floor_clamp(ubx, 0, w - 1) - 4;
  const int rby = floor_clamp(uby, 0, h - 1) - 4;
  const bool is_pt = lane < kP;
  const float cref = is_pt ? corr_ref[(size_t)lm * kP + lane] : 0.0f;
  float delta = 0.0f, e_best = INFINITY, best_delta = 0.0f;
  for (int it = 0; it < 4; ++it) {
    float hh = 0.0f, bb = 0.0f, ee = 0.0f;
    bool ok = true;
    if (is_pt) {
      float val, gx, gy;
      window_gradient(img, h, w, px - delta * dx, py - delta * dy, rbx, rby,
                      &val, &gx, &gy, &ok);
      const float r = (val - bt) - cref;
      const float wgt = sigma / fmaxf(fabsf(r), sigma);
      const float g = gx * dx + gy * dy;
      hh = wgt * g * g;
      bb = wgt * r * g;
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

  if (lane == 0) {
    out_best[lm] = bi;
    out_best_e[lm] = be;
    out_second[lm] = second;
    out_any[lm] = any ? 1 : 0;
    out_ref_e[lm] = e_best;
    out_delta[lm] = best_delta;
  }
}

}  // namespace

// m landmarks (inactive ones are skipped and get best 0, energies inf):
// uv_a, dir [m,2]; search_len [m]; pr, t [m,3]; pr_p [m,8,3]; corr_ref
// [m,8]; b_tgt [1]; alphas [32]; alpha_g [8]; img [h,w].  Outputs per
// landmark: best sample (int32), its sweep energy, second best outside the
// uniqueness radius, any valid sample (u8), refined energy, GN shift.
extern "C" int epipolar_sweep(
    const unsigned char* active, int m, const float* uv_a, const float* dir,
    const float* search_len, const float* pr, const float* tvec,
    const float* pr_p, const float* corr_ref, const float* b_tgt,
    const float* alphas, const float* alpha_g, const float* img, int h, int w,
    float fx, float fy, float cx, float cy, float width, float height,
    float sigma, float rho_max, int* out_best, float* out_best_e,
    float* out_second, unsigned char* out_any, float* out_ref_e,
    float* out_delta, void* stream) {
  const Cam cam = {fx, fy, cx, cy, width, height};
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    epipolar_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        active, m, uv_a, dir, search_len, pr, tvec, pr_p, corr_ref, b_tgt,
        alphas, alpha_g, img, h, w, cam, sigma, rho_max, out_best, out_best_e,
        out_second, out_any, out_ref_e, out_delta);
  }
  return (int)cudaGetLastError();
}
