// K13 activation: which ready immature points activate at a keyframe.
//
// Replaces dsopp_tpu/tracker/activation.py::_activation_kernel: the active
// landmarks and the ready immature points of all banks are reprojected into
// the newest keyframe; a candidate activates when it reprojects validly and
// no active landmark's projection lies within min_distance of its own;
// candidates whose status is dead, or that are ready and leave the image, are
// deleted.
//
// The kernels take the window's raw tensors and derive the rest themselves:
// the newest slot (the count of valid frames less one), the poses newest <-
// each frame (ba_body.cuh's frame_pose / relative_pose, as K7 and K8), the active
// mask (live landmark of a valid frame, not an outlier) and the start idepth
// 0.5 (idepth_min + idepth_max).  Every output entry is written here.
//
// Bound: bytes (the banks, the landmarks and the outputs, about 0.7 MB at
// 17 x 1200 candidates and 17 x 340 landmarks; the reprojections are ~1.6 M
// operations).  A test of every pair of a ready candidate and an active
// projection would be operations-bound (~40 M pairs at that size); the walk
// below tests only the pairs whose rows are close enough to decide.
// Design, two launches and no memset:
//  (1) activation_landmarks_kernel: each block composes the frame poses once
//      per frame (a thread a frame), then the poses newest <- each frame,
//      with its own landmarks' loads in flight; a thread per landmark slot
//      writes the projection of an active, validly reprojecting landmark,
//      +inf otherwise; block 0 also writes the poses and the newest slot for
//      (2);
//  (2) activation_walk_kernel: a block per 256 candidates copies the active
//      projections into shared memory with cp.async while it loads its
//      candidates and the poses, reprojects its candidates (drop and the
//      non-walkers' activate are final there), compacts the ready-and-valid
//      ones (the walkers), and sorts the staged projections into kBands
//      bands of image rows (counted, scanned, scattered; chunks of kChunk
//      entries).  A walker only tests the bands within min_distance (+ a
//      margin) of its row, and stops at the first projection within
//      min_distance; the walks of a warp end when all its lanes are decided.  "Within" is d2 <= T, T the largest
//      float whose sqrtf is <= min_distance: since sqrtf is monotone this is
//      the plain version's sqrt(min d2) <= min_distance, decided pair by pair
//      on d2 rounded as the plain version rounds it, so the result does not
//      depend on the order of the bands' entries (shared atomics) or on the
//      exit.  n_active, the staged count, is exact; every block counts it and
//      block 0 writes it.
// Every projection staged or walked is valid, so finite: the plain version's
// NaN rule (torch.min keeps a NaN) is never met; a NaN min_distance decides
// "not spaced" where there is an active landmark, as the plain comparison
// does.  testing/activation_models.py mirrors the walk on the host.
// Sequence axis (seq_axis.cuh): grid z is a sequence of the call, both
// launches serve all S.  The window, the immature banks and the density
// controller's min_distance are [B, ...] stacks read at seq[z]; the scratch
// and the outputs are [S, ...] at z, so a sequence's blocks do what a launch
// of it alone does.

#include <float.h>

#include "ba_body.cuh"
#include "seq_axis.cuh"
#include "shared_opt_in.cuh"

namespace {

using namespace ba;

// depth_estimation.py statuses
constexpr int kGood = 0, kOob = 1, kOutlier = 2, kSkipped = 3, kIllConditioned = 4;
constexpr int kMaxFrames = 64;     // tracker/activation.py::_ACTIVATION_MAX_FRAMES
constexpr int kBandsPerThread = 4;
constexpr int kBands = kBandsPerThread * kThreads;   // bands of image rows
constexpr int kChunk = 8192;       // active projections a block stages at a time (2 x 64 KB)
constexpr float kReachPx = 1e-3f;  // a walker's bands reach this far beyond min_distance

struct Projection {
  float u, v;
  bool valid;
};

// core/reproject.py::reproject (Pinhole.project's division form)
__device__ __forceinline__ Projection project_into(const Camera& cam, float u, float v,
                                                   float d, const Rigid& rel) {
  Vec3 ray;
  const Vec3 q = scaled_target_point(cam, u, v, d, rel, &ray);
  const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
  Projection out;
  out.u = cam.fx * q.x / z_safe + cam.cx;
  out.v = cam.fy * q.y / z_safe + cam.cy;
  out.valid = reprojection_valid(cam, q.z, out.u, out.v, d);
  return out;
}

// the largest float T with sqrtf(T) <= md (-1 for a negative or NaN md): a
// squared distance d2 >= 0 lies within md exactly when d2 <= T
__device__ float within_threshold(float md) {
  if (!(md >= 0.0f)) return -1.0f;
  if (isinf(md)) return INFINITY;
  float t = md * md;
  for (int step = 0; step < 4 && sqrtf(t) > md; ++step) t = nextafterf(t, 0.0f);
  for (int step = 0; step < 4; ++step) {
    const float up = nextafterf(t, INFINITY);
    if (!(sqrtf(up) <= md)) break;
    t = up;
  }
  return t;
}

// band of an image row coordinate v (finite), scale = kBands / height
__device__ __forceinline__ int band_of(float v, float scale) {
  return (int)fminf(fmaxf(v * scale, 0.0f), (float)(kBands - 1));
}

// an 8-byte copy from global to shared memory that does not hold the thread
__device__ __forceinline__ void copy_async8(void* dst, const void* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to), "l"(src));
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a sequence's scratch, floats: [2*k*n + 8*k + 1] rounded up to 64 (256
// bytes), so that every sequence's projections are float2-aligned
__host__ __device__ __forceinline__ size_t scratch_floats(int k, int n) {
  return ((size_t)2 * k * n + 8 * (size_t)k + 1 + 63) / 64 * 64;
}

// Scratch of the two kernels, floats: the active projections [k*n, 2]
// (+inf off the active set), then the poses newest <- each frame [k, 8] (q,
// t, unused) and the newest slot (an int's bits), written by block 0 of the
// landmark kernel.
__global__ void __launch_bounds__(kThreads)
activation_landmarks_kernel(const float* __restrict__ t_lin_q, const float* __restrict__ t_lin_t,
                            const float* __restrict__ eps,
                            const unsigned char* __restrict__ frame_valid,
                            const float* __restrict__ lm_uv, const float* __restrict__ lm_idepth,
                            const unsigned char* __restrict__ lm_valid,
                            const unsigned char* __restrict__ lm_outlier, int k, int n,
                            Camera cam, float* __restrict__ scratch,
                            const int* __restrict__ seq_list) {
  __shared__ Rigid pose[kMaxFrames], rel[kMaxFrames];
  {
    const int sb = seq::of(seq_list);
    const size_t kn = (size_t)k * n;
    t_lin_q = seq::at(t_lin_q, sb, 4 * (size_t)k);
    t_lin_t = seq::at(t_lin_t, sb, 3 * (size_t)k);
    eps = seq::at(eps, sb, 8 * (size_t)k);
    frame_valid = seq::at(frame_valid, sb, k);
    lm_uv = seq::at(lm_uv, sb, 2 * kn);
    lm_idepth = seq::at(lm_idepth, sb, kn);
    lm_valid = seq::at(lm_valid, sb, kn);
    lm_outlier = seq::at(lm_outlier, sb, kn);
    scratch = seq::at(scratch, blockIdx.z, scratch_floats(k, n));
  }
  const int tid = threadIdx.x;
  const int p = blockIdx.x * kThreads + tid;
  const bool in_range = p < k * n;
  // this thread's landmark, loaded while the poses are composed
  const int pc = in_range ? p : 0, f = pc / n;
  const float u = lm_uv[2 * pc], v = lm_uv[2 * pc + 1], d = lm_idepth[pc];
  const bool active = in_range && lm_valid[pc] != 0 && lm_outlier[pc] == 0 && frame_valid[f] != 0;
  // tracker/activation.py::_to_newest: T_newest^-1 T_f, with the newest slot
  // the count of valid frames less one (ba_body.cuh's relative_pose, its
  // frame poses composed once per frame)
  if (tid < k) pose[tid] = frame_pose(t_lin_q, t_lin_t, eps, tid);
  const int slot = valid_frames(frame_valid, k) - 1;   // every lane of every warp counts
  const int newest = max(slot, 0);
  __syncthreads();
  if (tid < k) {
    const Rigid r = compose(inverse(pose[newest]), pose[tid]);
    rel[tid] = r;
    if (blockIdx.x == 0) {
      float* out = scratch + 2 * (size_t)k * n + 8 * tid;
      out[0] = r.q.w, out[1] = r.q.x, out[2] = r.q.y, out[3] = r.q.z;
      out[4] = r.t.x, out[5] = r.t.y, out[6] = r.t.z, out[7] = 0.0f;
    }
  }
  if (blockIdx.x == 0 && tid == 0) scratch[2 * (size_t)k * n + 8 * k] = __int_as_float(slot);
  __syncthreads();
  if (!in_range) return;
  float2 out = make_float2(INFINITY, INFINITY);
  if (active) {
    const Projection pr = project_into(cam, u, v, d, rel[f]);
    if (pr.valid) out = make_float2(pr.u, pr.v);
  }
  reinterpret_cast<float2*>(scratch)[p] = out;
}

struct WalkShared {
  Rigid rel[kMaxFrames];
  int newest;
  float md, threshold;
  int cursor[kBands];       // entries of a band, then its next free place
  int start[kBands + 1];    // first entry of each band in the staged chunk
  int sums[33];
  float walker_u[kThreads], walker_v[kThreads];
  int walker_c[kThreads];
};

// dynamic shared memory: raw [chunk] (the active projections as they lie),
// staged [chunk] (the same, sorted into bands)
__global__ void __launch_bounds__(kThreads)
activation_walk_kernel(int k, int n, int m, int chunk, Camera cam, const float* __restrict__ uv,
                       const float* __restrict__ idepth_min, const float* __restrict__ idepth_max,
                       const int* __restrict__ status, const unsigned char* __restrict__ traced,
                       const float* __restrict__ uniqueness,
                       const float* __restrict__ search_interval,
                       const unsigned char* __restrict__ valid, float max_interval,
                       float min_uniqueness, const float* __restrict__ min_distance,
                       const float* __restrict__ scratch, unsigned char* __restrict__ activate,
                       unsigned char* __restrict__ drop, long long* __restrict__ n_active,
                       const int* __restrict__ seq_list) {
  __shared__ WalkShared sh;
  {
    const int sb = seq::of(seq_list), z = blockIdx.z;
    const size_t km = (size_t)k * m;
    uv = seq::at(uv, sb, 2 * km);
    idepth_min = seq::at(idepth_min, sb, km);
    idepth_max = seq::at(idepth_max, sb, km);
    status = seq::at(status, sb, km);
    traced = seq::at(traced, sb, km);
    uniqueness = seq::at(uniqueness, sb, km);
    search_interval = seq::at(search_interval, sb, km);
    valid = seq::at(valid, sb, km);
    min_distance = seq::at(min_distance, sb, 1);
    scratch = seq::at(scratch, z, scratch_floats(k, n));
    activate = seq::at(activate, z, km);
    drop = seq::at(drop, z, km);
    n_active = seq::at(n_active, z, 1);
  }
  extern __shared__ float2 dyn[];
  float2* raw = dyn;
  float2* staged = dyn + chunk;
  const int tid = threadIdx.x;
  const int total = k * n;
  const float2* act_uv = reinterpret_cast<const float2*>(scratch);
  // the first chunk of the active projections, copied while the rest loads
  const int len0 = min(chunk, total);
  for (int i = tid; i < len0; i += kThreads) copy_async8(raw + i, act_uv + i);

  // this block's candidates, one a thread
  const int c = blockIdx.x * kThreads + tid;
  const bool in_range = c < k * m;
  const int cc = in_range ? c : 0, bank = cc / m;
  const int st = status[cc];
  const float d = 0.5f * (idepth_min[cc] + idepth_max[cc]);
  const float cu = uv[2 * cc], cv = uv[2 * cc + 1];
  const bool is_valid = in_range && valid[cc] != 0;
  const bool status_ok = st == kGood || st == kSkipped || st == kIllConditioned || st == kOob;
  const bool ready_but_slot = is_valid && traced[cc] != 0 && status_ok &&
                              search_interval[cc] < max_interval &&
                              uniqueness[cc] > min_uniqueness && d > 0.0f;
  if (tid < k) {
    const float* r = scratch + 2 * (size_t)total + 8 * tid;
    sh.rel[tid] = {{r[0], r[1], r[2], r[3]}, {r[4], r[5], r[6]}};
  }
  if (tid == 0) {
    sh.newest = __float_as_int(scratch[2 * (size_t)total + 8 * k]);
    sh.md = min_distance[0];
    sh.threshold = within_threshold(sh.md);
  }
  copy_wait_all();
  __syncthreads();

  bool walks = false;
  Projection pr = {0.0f, 0.0f, false};
  if (in_range) {
    const bool ready = ready_but_slot && bank != sh.newest;
    pr = project_into(cam, cu, cv, d, sh.rel[bank]);
    walks = ready && pr.valid;
    const bool dead = st == kOutlier || (st == kOob && !ready);
    drop[c] = (is_valid && (dead || (ready && !pr.valid))) ? 1 : 0;
    if (!walks) activate[c] = 0;
  }
  // the walkers, compacted: walker w is thread w's
  const int slot = block_exclusive_scan<kThreads>(walks ? 1 : 0, sh.sums);
  const int n_walkers = sh.sums[32];
  if (walks) {
    sh.walker_u[slot] = pr.u;
    sh.walker_v[slot] = pr.v;
    sh.walker_c[slot] = c;
  }
  // only block 0 needs the count of a block without walkers
  if (n_walkers == 0 && blockIdx.x != 0) return;
  __syncthreads();

  const float scale = (float)kBands / cam.height;
  const bool walker = tid < n_walkers;
  const float wu = walker ? sh.walker_u[tid] : 0.0f, wv = walker ? sh.walker_v[tid] : 0.0f;
  const float md = sh.md, threshold = sh.threshold;
  const float reach = md * (1.0f + 1e-5f) + kReachPx;
  const int lo_band = band_of(wv - reach, scale), hi_band = band_of(wv + reach, scale);
  bool found = false;
  long long active = 0;
  for (int base = 0; base < total; base += chunk) {
    const int len = min(chunk, total - base);
    if (base > 0) {
      for (int i = tid; i < len; i += kThreads) copy_async8(raw + i, act_uv + base + i);
      copy_wait_all();
    }
    for (int q = 0; q < kBandsPerThread; ++q) sh.cursor[kBandsPerThread * tid + q] = 0;
    __syncthreads();
    for (int i = tid; i < len; i += kThreads) {
      const float2 a = raw[i];
      if (a.x < INFINITY) atomicAdd(&sh.cursor[band_of(a.y, scale)], 1);
    }
    __syncthreads();
    // thread t owns bands kBandsPerThread * t ..: their starts by one scan
    int own[kBandsPerThread], sum = 0;
    for (int q = 0; q < kBandsPerThread; ++q) {
      own[q] = sh.cursor[kBandsPerThread * tid + q];
      sum += own[q];
    }
    int first = block_exclusive_scan<kThreads>(sum, sh.sums);
    for (int q = 0; q < kBandsPerThread; ++q) {
      sh.start[kBandsPerThread * tid + q] = first;
      sh.cursor[kBandsPerThread * tid + q] = first;
      first += own[q];
    }
    if (tid == kThreads - 1) sh.start[kBands] = first;
    active += sh.sums[32];
    __syncthreads();
    for (int i = tid; i < len; i += kThreads) {
      const float2 a = raw[i];
      if (a.x < INFINITY) staged[atomicAdd(&sh.cursor[band_of(a.y, scale)], 1)] = a;
    }
    __syncthreads();
    if (walker && !found && md == md) {
      int j = sh.start[lo_band];
      const int end = sh.start[hi_band + 1];
      // two independent pair tests a step; d2 as the plain version rounds it
      for (; j + 1 < end && !found; j += 2) {
        const float2 a0 = staged[j], a1 = staged[j + 1];
        const float dx0 = wu - a0.x, dy0 = wv - a0.y;
        const float dx1 = wu - a1.x, dy1 = wv - a1.y;
        const float d0 = dx0 * dx0 + dy0 * dy0, d1 = dx1 * dx1 + dy1 * dy1;
        found = d0 <= threshold || d1 <= threshold;
      }
      if (!found && j < end) {
        const float2 a0 = staged[j];
        const float dx0 = wu - a0.x, dy0 = wv - a0.y;
        found = dx0 * dx0 + dy0 * dy0 <= threshold;
      }
    }
    __syncthreads();
  }
  if (walker) {
    // with no active landmark every walker is spaced
    const bool spaced = active == 0 || (md == md && !found);
    activate[sh.walker_c[tid]] = spaced ? 1 : 0;
  }
  if (blockIdx.x == 0 && tid == 0) *n_active = active;
}

size_t walk_opted[smem::kMaxDevices];

}  // namespace

// Window: t_lin_q [k,4], t_lin_t [k,3], eps [k,8] f32, frame_valid [k] u8,
// lm_uv [k,n,2], lm_idepth [k,n] f32, lm_valid, lm_outlier [k,n] u8.  Banks
// [k,m]: uv [.,2], idepth_min, idepth_max, uniqueness, search_interval f32,
// status int32, traced, valid u8.  min_distance [1] f32 on the device.
// Scratch: [2*k*n + 8*k + 1] f32 a sequence (above), at a stride of that
// rounded up to 64 floats (scratch_floats).  Outputs, every entry written:
// activate, drop [k,m] u8; n_active [] int64.  k <= 64.  Sequence axis
// (seq_axis.cuh): `seqs` sequences, grid z; the window, the banks and
// min_distance are [B, ...] stacks read at seq_list[z] (null: z), the scratch
// and the outputs [seqs, ...] at z.
extern "C" int activation(const float* t_lin_q, const float* t_lin_t, const float* eps,
                          const unsigned char* frame_valid, const float* lm_uv,
                          const float* lm_idepth, const unsigned char* lm_valid,
                          const unsigned char* lm_outlier, int k, int n, int m, float fx,
                          float fy, float cx, float cy, float width, float height,
                          const float* uv, const float* idepth_min, const float* idepth_max,
                          const int* status, const unsigned char* traced,
                          const float* uniqueness, const float* search_interval,
                          const unsigned char* valid, float max_interval, float min_uniqueness,
                          const float* min_distance, float* scratch, unsigned char* activate,
                          unsigned char* drop, long long* n_active, int seqs,
                          const int* seq_list, void* stream) {
  if (k > kMaxFrames || !seq::valid_count(seqs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  const int chunk = k * n < kChunk ? k * n : kChunk;
  const size_t bytes = 2 * sizeof(float2) * (size_t)chunk;
  cudaError_t err = smem::fit(activation_walk_kernel, bytes, walk_opted);
  if (err != cudaSuccess) return (int)err;
  activation_landmarks_kernel<<<dim3((k * n + kThreads - 1) / kThreads, 1, seqs), kThreads, 0,
                                s>>>(t_lin_q, t_lin_t, eps, frame_valid, lm_uv, lm_idepth,
                                     lm_valid, lm_outlier, k, n, cam, scratch, seq_list);
  activation_walk_kernel<<<dim3((k * m + kThreads - 1) / kThreads, 1, seqs), kThreads, bytes,
                           s>>>(k, n, m, chunk, cam, uv, idepth_min, idepth_max, status, traced,
                                uniqueness, search_interval, valid, max_interval, min_uniqueness,
                                min_distance, scratch, activate, drop, n_active, seq_list);
  return (int)cudaGetLastError();
}
