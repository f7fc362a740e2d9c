// K13 activation: which ready immature points activate at a keyframe.
//
// Replaces dsopp_tpu/tracker/activation.py::_activation_kernel: the active
// landmarks and the ready immature points of all banks are reprojected into
// the newest keyframe; a candidate activates when it reprojects validly and
// no active landmark's projection lies within min_distance of its own;
// candidates whose status is dead, or that are ready and leave the image, are
// deleted.
//
// Bound: operations (pairs of a ready, validly reprojected candidate and an
// active projection, 5 operations each; the inputs are about 0.5 MB).
// Design: no [candidates x landmarks] matrix exists.  (1) one thread per
// landmark reprojects it and appends the projection of an active one to a
// compact list (an atomic counter: the order of the list is free, a minimum
// does not depend on it; the counter is n_active, exact).  (2) one thread per
// candidate reprojects it, and only a candidate that is ready and valid walks
// the list, staged through shared memory in tiles, keeping the least
// dx^2 + dy^2 in the plain version's operation order; then sqrtf and the
// comparison with min_distance, read from the device.  fminf drops a NaN
// where torch.min would keep it: a candidate with a NaN projection is not
// valid and never activates, so the two agree on every output.

#include "ba_body.cuh"

namespace {

using namespace ba;

// depth_estimation.py statuses
constexpr int kGood = 0, kOob = 1, kOutlier = 2, kSkipped = 3, kIllConditioned = 4;

struct Projection {
  float u, v;
  bool valid;
};

// core/reproject.py::reproject (Pinhole.project's division form)
__device__ __forceinline__ Projection project_into(const Camera& cam, float u, float v,
                                                   float d, const float* __restrict__ rel_q,
                                                   const float* __restrict__ rel_t, int frame) {
  const Rigid rel = {{rel_q[4 * frame], rel_q[4 * frame + 1], rel_q[4 * frame + 2],
                      rel_q[4 * frame + 3]},
                     {rel_t[3 * frame], rel_t[3 * frame + 1], rel_t[3 * frame + 2]}};
  Vec3 ray;
  const Vec3 q = scaled_target_point(cam, u, v, d, rel, &ray);
  const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
  Projection out;
  out.u = cam.fx * q.x / z_safe + cam.cx;
  out.v = cam.fy * q.y / z_safe + cam.cy;
  out.valid = reprojection_valid(cam, q.z, out.u, out.v, d);
  return out;
}

__global__ void __launch_bounds__(kThreads)
active_projections_kernel(const float* __restrict__ lm_uv, const float* __restrict__ lm_idepth,
                          const unsigned char* __restrict__ act_mask,
                          const float* __restrict__ rel_q, const float* __restrict__ rel_t,
                          int total, int n, Camera cam, float* __restrict__ act_uv,
                          unsigned long long* __restrict__ n_active) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= total || act_mask[p] == 0) return;
  const Projection pr = project_into(cam, lm_uv[2 * p], lm_uv[2 * p + 1], lm_idepth[p], rel_q,
                                     rel_t, p / n);
  if (!pr.valid) return;
  const unsigned long long at = atomicAdd(n_active, 1ULL);
  act_uv[2 * at] = pr.u;
  act_uv[2 * at + 1] = pr.v;
}

__global__ void __launch_bounds__(kThreads)
candidates_kernel(const float* __restrict__ uv, const float* __restrict__ idepth_min,
                  const float* __restrict__ idepth_max, const int* __restrict__ status,
                  const unsigned char* __restrict__ traced, const float* __restrict__ uniqueness,
                  const float* __restrict__ search_interval,
                  const unsigned char* __restrict__ valid, const float* __restrict__ rel_q,
                  const float* __restrict__ rel_t, const long long* __restrict__ newest,
                  int total, int m, Camera cam, float max_interval, float min_uniqueness,
                  const float* __restrict__ act_uv,
                  const unsigned long long* __restrict__ n_active,
                  const float* __restrict__ min_distance, unsigned char* __restrict__ activate,
                  unsigned char* __restrict__ drop) {
  __shared__ float au[kThreads], av[kThreads];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = c < total;
  const int cc = in_range ? c : total - 1;
  const int bank = cc / m;
  const int st = status[cc];
  const float d = 0.5f * (idepth_min[cc] + idepth_max[cc]);
  const bool status_ok = st == kGood || st == kSkipped || st == kIllConditioned || st == kOob;
  const bool is_valid = valid[cc] != 0;
  const bool ready = is_valid && traced[cc] != 0 && status_ok &&
                     search_interval[cc] < max_interval && uniqueness[cc] > min_uniqueness &&
                     d > 0.0f && (long long)bank != newest[0];
  const Projection pr = project_into(cam, uv[2 * cc], uv[2 * cc + 1], d, rel_q, rel_t, bank);
  const bool walks = in_range && ready && pr.valid;

  const int count = (int)n_active[0];
  float least = INFINITY;
  for (int base = 0; base < count; base += kThreads) {
    __syncthreads();
    if (base + threadIdx.x < count) {
      au[threadIdx.x] = act_uv[2 * (base + threadIdx.x)];
      av[threadIdx.x] = act_uv[2 * (base + threadIdx.x) + 1];
    }
    __syncthreads();
    if (!walks) continue;
    const int len = min(kThreads, count - base);
    for (int j = 0; j < len; ++j) {
      const float dx = pr.u - au[j], dy = pr.v - av[j];
      least = fminf(least, dx * dx + dy * dy);
    }
  }
  if (!in_range) return;
  // with no active landmark the least distance stays +inf: spaced
  const bool spaced = sqrtf(least) > min_distance[0];
  activate[c] = (walks && spaced) ? 1 : 0;
  const bool dead = st == kOutlier || (st == kOob && !ready);
  drop[c] = (is_valid && (dead || (ready && !pr.valid))) ? 1 : 0;
}

}  // namespace

// Window: lm_uv [k,n,2], lm_idepth [k,n], act_mask [k,n] u8 (live, not
// outlier), rel_q [k,4] / rel_t [k,3] (newest <- each frame), newest [1]
// int64.  Banks [k,m]: uv [.,2], idepth_min, idepth_max, uniqueness,
// search_interval f32, status int32, traced, valid u8.  min_distance [1] f32
// on the device.  Scratch: act_uv [k*n,2] f32.  Outputs: activate, drop
// [k,m] u8; n_active [1] int64 (zeroed here).
extern "C" int activation(const float* lm_uv, const float* lm_idepth,
                          const unsigned char* act_mask, const float* rel_q,
                          const float* rel_t, const long long* newest, int k, int n, int m,
                          float fx, float fy, float cx, float cy, float width, float height,
                          const float* uv, const float* idepth_min, const float* idepth_max,
                          const int* status, const unsigned char* traced,
                          const float* uniqueness, const float* search_interval,
                          const unsigned char* valid, float max_interval, float min_uniqueness,
                          const float* min_distance, float* act_uv, unsigned char* activate,
                          unsigned char* drop, unsigned long long* n_active, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  cudaMemsetAsync(n_active, 0, sizeof(unsigned long long), s);
  active_projections_kernel<<<(k * n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      lm_uv, lm_idepth, act_mask, rel_q, rel_t, k * n, n, cam, act_uv, n_active);
  candidates_kernel<<<(k * m + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      uv, idepth_min, idepth_max, status, traced, uniqueness, search_interval, valid, rel_q,
      rel_t, newest, k * m, m, cam, max_interval, min_uniqueness, act_uv, n_active,
      min_distance, activate, drop);
  return (int)cudaGetLastError();
}
