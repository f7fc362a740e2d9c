// K14 refine_idepth and activation_scatter: the idepth refinement of the
// activating immature points, and their move into free landmark slots.
//
// Replaces dsopp_tpu/tracker/activation.py::_refine_idepth_kernel and
// ::_activation_scatter.
//
// refine_idepth.  The activating candidates are compacted in order, banks from
// the highest slot (the newest host) to the lowest and inside a bank by
// index, and the first `cap` are refined: a scalar Levenberg-Marquardt on the
// candidate's idepth against every other valid frame of the window, 1 + 3
// evaluations.  An evaluation reprojects the 8-point pattern (the reciprocal
// form of Pinhole.project_jacobian), samples the target's intensity image
// under the 10x10-window rule (ba_body.cuh, shared with K7), drops the whole
// (candidate, target) pair unless all 8 points are valid, and sums the
// whole-patch Huber energy (capped for valid non-inliers), the inlier count
// and the 1x1 normal equation.  A candidate is kept when the refined idepth is
// positive and has enough inliers.
// Bound: operations (cap x targets x 8 x 4 evaluations of about 150
// operations; the candidates' inputs are a few tens of KB and each sample
// reads 12 scattered pixels).  Design: (1) one block per bank counts the
// activating candidates of the banks after it and scans its own, so the
// order is the stable sort's without a sort.  (2) one block per compacted
// candidate, one thread per (target, pattern point): the 8 points of a target
// are 8 neighbouring lanes, so the validity AND and the per-target sums are
// shuffles in a fixed order; the per-candidate sums run over the targets in
// index order in f64 by one thread, which also takes the accept / reject
// decision.  The sums of the plain version run in another order, so
// `e_new < e` can part at a rounding tie; the kernel can write its decision
// trace for such a comparison.
//
// activation_scatter.  Per frame slot the r-th free landmark slot takes the
// r-th activating candidate of the slot's bank, for r < min(#free,
// #activating); integer work, exact.  Bound: bytes (the copied points).
// Design: one block per frame slot, two ordered compactions by block scan
// into a scratch list, then the copies.  The window tensors it writes are
// clones made by the caller.

#include "ba_body.cuh"

namespace {

using namespace ba;

constexpr int kEvaluations = 4;            // the start and REFINE_ITERATIONS trials
constexpr float kReg0 = 0.1f, kRegDec = 2.0f, kRegInc = 5.0f;
constexpr float kMaxEnergy = kPattern * 12.0f * 12.0f;  // MAX_ENERGY_FOR_INLIERS
constexpr int kMaxTargets = 40;

// order[pos] = flat index of the pos-th activating candidate, newest bank
// first; selected marks those within the cap
__global__ void __launch_bounds__(kThreads)
compact_kernel(const unsigned char* __restrict__ activate, int k, int m, int cap,
               int* __restrict__ order, unsigned char* __restrict__ selected) {
  __shared__ int sums[33];
  const int bank = blockIdx.x;
  int later = 0;   // activating candidates of the banks refined before this one
  for (int i = (bank + 1) * m + threadIdx.x; i < k * m; i += kThreads) later += activate[i];
  block_exclusive_scan<kThreads>(later, sums);
  int base = sums[32];
  for (int start = 0; start < m; start += kThreads) {
    const int i = start + threadIdx.x;
    const int flag = (i < m && activate[bank * m + i] != 0) ? 1 : 0;
    const int pos = base + block_exclusive_scan<kThreads>(flag, sums);
    if (i < m) {
      const bool taken = flag != 0 && pos < cap;
      selected[bank * m + i] = taken ? 1 : 0;
      if (taken) order[pos] = bank * m + i;
    }
    base += sums[32];
  }
}

struct RefineState {
  float idepth, trial, energy, h, b, lam;
  int inliers;
};

__global__ void
refine_kernel(const int* __restrict__ order, const float* __restrict__ uv,
              const float* __restrict__ patch, const float* __restrict__ idepth_min,
              const float* __restrict__ idepth_max, const float* __restrict__ rel_q,
              const float* __restrict__ rel_t, const float* __restrict__ scale,
              const float* __restrict__ affine, const unsigned char* __restrict__ frame_valid,
              const float* __restrict__ images, size_t image_stride, int k, int m, int h, int w,
              Camera cam, float sigma, float* __restrict__ idepth_out,
              unsigned char* __restrict__ keep, float* __restrict__ trace) {
  __shared__ float e_s[kMaxTargets], h_s[kMaxTargets], b_s[kMaxTargets];
  __shared__ int inl_s[kMaxTargets];
  __shared__ RefineState st;
  const int flat = order[blockIdx.x];
  if (flat < 0) return;
  const int host = flat / m;
  const int idx = threadIdx.x;
  const bool in_range = idx < k * kPattern;
  const int j = in_range ? idx / kPattern : k - 1, p = idx % kPattern;
  const int hj = host * k + j;
  const Rigid rel = {{rel_q[4 * hj], rel_q[4 * hj + 1], rel_q[4 * hj + 2], rel_q[4 * hj + 3]},
                     {rel_t[3 * hj], rel_t[3 * hj + 1], rel_t[3 * hj + 2]}};
  const bool pair = frame_valid[j] != 0 && j != host;
  const float u = uv[2 * flat] + kPatternX[p], v = uv[2 * flat + 1] + kPatternY[p];
  const float b_target = affine[2 * j + 1];
  const float corrected = scale[hj] * (patch[(size_t)flat * kPattern + p] - affine[2 * host + 1]);
  const float* img = images + (size_t)j * image_stride;
  const int center_lane = (threadIdx.x & 31 & ~(kPattern - 1)) + kCenter;

  if (idx == 0) {
    st.idepth = 0.5f * (idepth_min[flat] + idepth_max[flat]);
    st.trial = st.idepth;
    st.lam = kReg0;
  }
  __syncthreads();

  for (int ev = 0; ev < kEvaluations; ++ev) {
    const float d = st.trial;
    // core/reproject.py::reproject_jacobian (Pinhole.project_jacobian)
    Vec3 ray;
    const Vec3 q = scaled_target_point(cam, u, v, d, rel, &ray);
    const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
    const float iz = 1.0f / z_safe;
    const float iz2 = iz * iz;
    const float x = cam.fx * q.x * iz + cam.cx;
    const float y = cam.fy * q.y * iz + cam.cy;
    const bool valid = reprojection_valid(cam, q.z, x, y, d);
    const float j0x = cam.fx * iz, j0z = -cam.fx * q.x * iz2;
    const float j1y = cam.fy * iz, j1z = -cam.fy * q.y * iz2;
    const float du = (j0x * rel.t.x + 0.0f * rel.t.y) + j0z * rel.t.z;
    const float dv = (0.0f * rel.t.x + j1y * rel.t.y) + j1z * rel.t.z;

    const float xc = __shfl_sync(kFull, x, center_lane);
    const float yc = __shfl_sync(kFull, y, center_lane);
    const WindowSample smp = sample_window(img, h, w, x, y, window_base(xc, w),
                                           window_base(yc, h));
    const bool ok = all_of_pattern((valid && smp.ok) ? 1 : 0) != 0 && pair;
    const float r = ok ? (smp.val - b_target) - corrected : 0.0f;
    const float dr = ok ? smp.gx * du + smp.gy * dv : 0.0f;
    float r2 = r * r;
    r2 += __shfl_xor_sync(kFull, r2, 1);
    r2 += __shfl_xor_sync(kFull, r2, 2);
    r2 += __shfl_xor_sync(kFull, r2, 4);
    const float rnorm = sqrtf(fmaxf(r2, 1e-30f));
    const float wgt = rnorm > sigma ? sigma / rnorm : 1.0f;
    float hp = wgt * dr * dr, bp = wgt * dr * r;
    hp += __shfl_xor_sync(kFull, hp, 1);
    bp += __shfl_xor_sync(kFull, bp, 1);
    hp += __shfl_xor_sync(kFull, hp, 2);
    bp += __shfl_xor_sync(kFull, bp, 2);
    hp += __shfl_xor_sync(kFull, hp, 4);
    bp += __shfl_xor_sync(kFull, bp, 4);
    if (in_range && p == 0) {
      const bool inlier = ok && r2 < kMaxEnergy;
      e_s[j] = inlier ? wgt * r2 : (ok ? kMaxEnergy : 0.0f);
      inl_s[j] = inlier ? 1 : 0;
      h_s[j] = hp;
      b_s[j] = bp;
    }
    __syncthreads();
    if (idx == 0) {
      double e_sum = 0.0, h_sum = 0.0, b_sum = 0.0;
      int inl = 0;
      for (int t = 0; t < k; ++t) {
        e_sum += (double)e_s[t];
        h_sum += (double)h_s[t];
        b_sum += (double)b_s[t];
        inl += inl_s[t];
      }
      const float e_new = (float)e_sum, h_new = (float)h_sum, b_new = (float)b_sum;
      bool accept = true;
      if (ev > 0) {
        accept = e_new < st.energy && st.h > 0.0f;
        if (trace != nullptr) {
          float* row = trace + ((size_t)blockIdx.x * (kEvaluations - 1) + (ev - 1)) * 4;
          row[0] = st.energy;
          row[1] = e_new;
          row[2] = st.lam;
          row[3] = accept ? 1.0f : 0.0f;
        }
        st.lam = accept ? st.lam / kRegDec : st.lam * kRegInc;
      }
      if (accept) {
        st.idepth = d;
        st.energy = e_new;
        st.inliers = inl;
        st.h = h_new;
        st.b = b_new;
      }
      st.trial = st.idepth - st.b / fmaxf(st.h * (1.0f + st.lam), 1e-20f);
    }
    __syncthreads();
  }

  if (idx == 0) {
    int frames = 0;
    for (int t = 0; t < k; ++t) frames += frame_valid[t] != 0 ? 1 : 0;
    const int min_inliers = min(frames - 1, 1);
    if (st.inliers >= min_inliers && st.idepth > 0.0f) {
      idepth_out[flat] = st.idepth;
      keep[flat] = 1;
    }
  }
}

// free[a, r]: the r-th free landmark slot of frame slot a; act[a, r]: the
// r-th activating candidate of its bank; both lists live in `lists`
__global__ void __launch_bounds__(kThreads)
pair_slots_kernel(const unsigned char* __restrict__ activate,
               const unsigned char* __restrict__ drop, const float* __restrict__ uv,
               const float* __restrict__ patch, const float* __restrict__ idepth_min,
               const float* __restrict__ idepth_max, const unsigned char* __restrict__ imm_valid,
               int k, int n, int m, int* __restrict__ lists, float* __restrict__ lm_uv,
               float* __restrict__ lm_patch, float* __restrict__ lm_idepth,
               unsigned char* __restrict__ lm_valid, int* __restrict__ res_status,
               unsigned char* __restrict__ imm_valid_out,
               unsigned long long* __restrict__ n_activated) {
  __shared__ int sums[33];
  const int a = blockIdx.x;
  int* free_list = lists + (size_t)a * (n + m);
  int* act_list = free_list + n;
  int n_free = 0, n_act = 0;
  for (int start = 0; start < n; start += kThreads) {
    const int i = start + threadIdx.x;
    const int flag = (i < n && lm_valid[a * n + i] == 0) ? 1 : 0;
    const int pos = n_free + block_exclusive_scan<kThreads>(flag, sums);
    if (flag) free_list[pos] = i;
    n_free += sums[32];
  }
  for (int start = 0; start < m; start += kThreads) {
    const int i = start + threadIdx.x;
    const int flag = (i < m && activate[a * m + i] != 0) ? 1 : 0;
    const int pos = n_act + block_exclusive_scan<kThreads>(flag, sums);
    if (flag) act_list[pos] = i;
    n_act += sums[32];
    if (i < m) imm_valid_out[a * m + i] = (imm_valid[a * m + i] != 0 && drop[a * m + i] == 0) ? 1 : 0;
  }
  __syncthreads();
  const int take = min(n_free, n_act);
  for (int r = threadIdx.x; r < take; r += kThreads) {
    const int dst = a * n + free_list[r], src = a * m + act_list[r];
    lm_uv[2 * dst] = uv[2 * src];
    lm_uv[2 * dst + 1] = uv[2 * src + 1];
    for (int p = 0; p < kPattern; ++p) lm_patch[(size_t)dst * kPattern + p] = patch[(size_t)src * kPattern + p];
    lm_idepth[dst] = 0.5f * (idepth_min[src] + idepth_max[src]);
    lm_valid[dst] = 1;
    for (int j = 0; j < k; ++j) res_status[((size_t)a * k + j) * n + free_list[r]] = 0;  // RES_OK
    imm_valid_out[src] = 0;
  }
  if (threadIdx.x == 0 && take > 0) atomicAdd(n_activated, (unsigned long long)take);
}

}  // namespace

// Banks [k,m]: activate u8, uv [.,2], patch [.,8], idepth_min, idepth_max f32.
// Window: rel_q [k,k,4] / rel_t [k,k,3] (target j <- host i at [i,j]), scale
// [k,k] (brightness scale of the pair), affine [k,2], frame_valid [k] u8,
// images + f * image_stride = frame f's [h,w] intensity image.  Scratch: order
// [cap] int32 (set to -1 here).  Outputs: selected [k,m] u8; idepth_out [k,m]
// f32 (holds the banks' idepth on entry) and keep [k,m] u8 (zero on entry),
// written where a candidate is kept; trace [cap,3,4] f32 or nullptr (energy,
// trial energy, lambda, accept per trial).
extern "C" int refine_idepth(const unsigned char* activate, const float* uv,
                             const float* patch, const float* idepth_min,
                             const float* idepth_max, const float* rel_q, const float* rel_t,
                             const float* scale, const float* affine,
                             const unsigned char* frame_valid, const float* images,
                             int image_stride, int k, int m, int h, int w, int cap, float fx,
                             float fy, float cx, float cy, float width, float height,
                             float sigma, int* order, unsigned char* selected,
                             float* idepth_out, unsigned char* keep, float* trace,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  cudaMemsetAsync(order, 0xff, sizeof(int) * cap, s);
  compact_kernel<<<k, kThreads, 0, s>>>(activate, k, m, cap, order, selected);
  const int threads = (k * ba::kPattern + 31) / 32 * 32;
  refine_kernel<<<cap, threads, 0, s>>>(order, uv, patch, idepth_min, idepth_max, rel_q, rel_t,
                                        scale, affine, frame_valid, images,
                                        (size_t)image_stride, k, m, h, w, cam, sigma,
                                        idepth_out, keep, trace);
  return (int)cudaGetLastError();
}

// Banks [k,m] as above plus drop, imm_valid u8.  lm_uv [k,n,2], lm_patch
// [k,n,8], lm_idepth [k,n], lm_valid [k,n] u8 and res_status [k,k,n] int32 are
// the caller's clones, written in place.  Scratch: lists [k, n+m] int32.
// Outputs: imm_valid_out [k,m] u8, n_activated [1] int64 (zeroed here).
extern "C" int activation_scatter(const unsigned char* activate, const unsigned char* drop,
                                  const float* uv, const float* patch,
                                  const float* idepth_min, const float* idepth_max,
                                  const unsigned char* imm_valid, int k, int n, int m,
                                  int* lists, float* lm_uv, float* lm_patch, float* lm_idepth,
                                  unsigned char* lm_valid, int* res_status,
                                  unsigned char* imm_valid_out,
                                  unsigned long long* n_activated, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(n_activated, 0, sizeof(unsigned long long), s);
  pair_slots_kernel<<<k, kThreads, 0, s>>>(activate, drop, uv, patch, idepth_min, idepth_max,
                                        imm_valid, k, n, m, lists, lm_uv, lm_patch, lm_idepth,
                                        lm_valid, res_status, imm_valid_out, n_activated);
  return (int)cudaGetLastError();
}
