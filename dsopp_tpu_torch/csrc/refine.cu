// K14 refine_idepth and activation_scatter: the idepth refinement of the
// activating immature points, and their move into free landmark slots.
//
// Replaces dsopp_tpu/tracker/activation.py::_refine_idepth_kernel and
// ::_activation_scatter, with the glue between them of
// dsopp_tpu/tracker/fused_keyframe.py::fused_keyframe_push.
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
// The kernels take the window's raw tensors and derive the poses target <-
// host (ba_body.cuh's relative_pose, as K7 and K8), the affine (affine0 +
// eps[:, 6:]) and the brightness scale in solvers/pba.py::_brightness_scale's
// order of operations.
// Bound: operations (cap x targets x 8 x 4 evaluations of about 150
// operations; the candidates' inputs are a few tens of KB and each sample
// reads 12 scattered pixels).  Design, two launches and no memset:
// (1) compact_kernel: a block per bank orders its candidates (the later
// banks' activating candidates counted with 16-byte loads, then a span of the
// bank a warp, 32 entries a step, one block scan of the warps' counts, places
// by ballot) and writes the order, -1 past the refined ones, and `selected`;
// ceil(k*k / 256) blocks write the pair table (every (host, target) pose and
// brightness scale, a pair a thread); the other blocks write
// every entry's keep = 0 and idepth_out = the bank's idepth.
// (2) refine_kernel: one block per place of the order, one thread per
// (target, pattern point): the 8 points of a target are 8 neighbouring lanes,
// so the validity AND and the per-target sums are shuffles in a fixed order.
// A block past the refined ones exits after reading its place.  Per
// evaluation the per-target values go to shared memory (two buffers, by the
// evaluation's parity) behind one barrier; then every warp sums them over the
// targets in f64 in one fixed order (a lane two targets, then a butterfly;
// testing/activation_models.py::target_sums, parity.REFINE_SUM_ULPS) and
// every thread takes the accept / reject decision itself, so no second
// barrier broadcasts it.  The sums of the plain version run in another order,
// so `e_new < e` can part at a rounding tie; the kernel can write its
// decision trace for such a comparison.
// testing/activation_models.py mirrors the compaction.
//
// refine_idepth samples channel 0 of the window's channel bank (the
// intensity at C = 1; the first embedder plane of a C > 1 window, as the JAX
// package's refinement reads its patch tables).
//
// activation_scatter (the pairing).  Per frame slot the r-th free landmark
// slot takes the r-th activating candidate of the slot's bank, for r <
// min(#free, #activating); integer work and copies, exact.  After a
// refinement the same call applies its glue: the kept candidates activate,
// their idepth bounds become the refined idepth, the refined ones not kept
// are dropped.  Bound: bytes (the window's five tensors and the banks' masks
// read and written once).  Design: one launch, no memset, no clone: a block
// per (tile of 64 landmark slots, frame slot) recounts its slot's free slots
// and candidates (one block scan) and writes its tile of every output, the
// untouched entries copied from the caller's window, which stays as it was
// (pair_slots_kernel).  In a window of C > 1 embedder channels the reference
// patch a landmark takes is not the immature point's intensity patch but its
// C-channel one (activation.py::embedded_patches): each value samples one of
// the host slot's C channel planes at one of the 8 pattern points under the
// 10x10-window rule (ba_body.cuh::sample_window, shared with K7; the window
// based at floor(uv) - 4, values only).
//
// Sequence axis (seq_axis.cuh), both entries: grid z is a sequence of the
// call, every launch serves all S.  The window (its poses, affine, exposure,
// landmarks and channel bank) and the immature banks are [B, ...] stacks read
// at seq[z] and never copied; the per-candidate flags that an earlier kernel
// of the call wrote (K13's activate and drop, the refinement's outputs), the
// scratch (order, pair table, the pairing's workspace) and the outputs are
// [S, ...] at z, so a sequence's blocks do what a launch of it alone does:
// each sequence has its own cap and its own newest-bank-first order.

#include "ba_body.cuh"
#include "seq_axis.cuh"

namespace {

using namespace ba;

constexpr int kEvaluations = 4;            // the start and REFINE_ITERATIONS trials
constexpr float kReg0 = 0.1f, kRegDec = 2.0f, kRegInc = 5.0f;
constexpr float kMaxEnergy = kPattern * 12.0f * 12.0f;  // MAX_ENERGY_FOR_INLIERS
constexpr int kMaxTargets = 40;

constexpr int kFillPerThread = 4;          // entries a thread of a fill block writes
constexpr int kBatch = 8;                  // flags a lane loads at a time

// a candidate's LM state; every thread of its block holds the same copy
struct RefineState {
  float idepth, trial, energy, h, b, lam;
  int inliers;
};

// activating candidates among the flags [begin, end) (bytes 0 or 1): 16 bytes
// a load where the address is aligned (a sequence's flags need not start on
// 16 bytes), the edges byte by byte; summed over the block
__device__ int block_count(const unsigned char* __restrict__ flags, int begin, int end,
                           int* sums) {
  int count = 0;
  const int lead = (int)((16 - ((size_t)(flags + begin) & 15)) & 15);
  const int body = min(begin + lead, end);
  const int tail = body + ((end - body) & ~15);
  for (int i = begin + (int)threadIdx.x; i < body; i += kThreads) count += flags[i];
  for (int i = tail + (int)threadIdx.x; i < end; i += kThreads) count += flags[i];
  const uint4* words = reinterpret_cast<const uint4*>(flags + body);
#pragma unroll 4
  for (int i = threadIdx.x; i < (tail - body) / 16; i += kThreads) {
    const uint4 w = words[i];
    count += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
  }
  block_exclusive_scan<kThreads>(count, sums);
  return sums[32];
}

// Blocks 0..k-1, one per bank: order[pos] = flat index of the pos-th
// activating candidate, newest bank first and inside a bank by index, for pos
// < cap, -1 past them (bank 0's block, the last in that order); `selected`
// marks them.  A bank's block counts the activating candidates of the banks
// after it (refined before it), then each warp takes a contiguous span of
// the bank, 32 consecutive entries a step: the warps' counts are scanned
// once, the places follow by ballot.  The next ceil(k*k / 256) blocks: the
// pair table, a pair a thread, entry (host i, target j) = T_j^-1 T_i
// (ba_body.cuh's relative_pose, each block composing the frame poses once
// per frame) and the brightness scale (pba.py::_brightness_scale's order),
// then each frame's affine b.  The rest: keep = 0 and idepth_out = the bank's
// idepth, every entry (refine_kernel then writes the kept ones).
__global__ void __launch_bounds__(kThreads)
compact_kernel(const unsigned char* __restrict__ activate,
               const float* __restrict__ idepth_min, const float* __restrict__ idepth_max,
               const float* __restrict__ t_lin_q, const float* __restrict__ t_lin_t,
               const float* __restrict__ eps, const float* __restrict__ affine0,
               const float* __restrict__ exposure, int k, int m, int cap,
               int* __restrict__ order, unsigned char* __restrict__ selected,
               float* __restrict__ table, float* __restrict__ idepth_out,
               unsigned char* __restrict__ keep, const int* __restrict__ seq_list) {
  {
    const int sb = seq::of(seq_list), z = blockIdx.z;
    const size_t km = (size_t)k * m;
    activate = seq::at(activate, z, km);
    idepth_min = seq::at(idepth_min, sb, km);
    idepth_max = seq::at(idepth_max, sb, km);
    t_lin_q = seq::at(t_lin_q, sb, 4 * (size_t)k);
    t_lin_t = seq::at(t_lin_t, sb, 3 * (size_t)k);
    eps = seq::at(eps, sb, 8 * (size_t)k);
    affine0 = seq::at(affine0, sb, 2 * (size_t)k);
    exposure = seq::at(exposure, sb, k);
    order = seq::at(order, z, cap);
    selected = seq::at(selected, z, km);
    table = seq::at(table, z, 8 * (size_t)k * k + k);
    idepth_out = seq::at(idepth_out, z, km);
    keep = seq::at(keep, z, km);
  }
  const int total = k * m;
  const int tid = threadIdx.x;
  const int table_blocks = (k * k + kThreads - 1) / kThreads;
  if ((int)blockIdx.x >= k + table_blocks) {
    const int base = (blockIdx.x - k - table_blocks) * kThreads * kFillPerThread + tid;
#pragma unroll
    for (int q = 0; q < kFillPerThread; ++q) {
      const int i = base + q * kThreads;
      if (i < total) {
        idepth_out[i] = 0.5f * (idepth_min[i] + idepth_max[i]);
        keep[i] = 0;
      }
    }
    return;
  }
  if ((int)blockIdx.x >= k) {
    // a pair a thread; each table block composes every frame pose itself
    __shared__ Rigid pose[kMaxTargets];
    const int t = (blockIdx.x - k) * kThreads + tid;
    const int i = t < k * k ? t / k : 0, j = t < k * k ? t % k : 0;
    // the pair's brightness terms, loaded before the barrier
    const float ratio = exposure[j] / fmaxf(exposure[i], 1e-12f);
    const float da = (affine0[2 * j] + eps[8 * j + 6]) - (affine0[2 * i] + eps[8 * i + 6]);
    if (tid < k) {
      pose[tid] = frame_pose(t_lin_q, t_lin_t, eps, tid);
      if (blockIdx.x == k) table[8 * k * k + tid] = affine0[2 * tid + 1] + eps[8 * tid + 7];
    }
    __syncthreads();
    if (t >= k * k) return;
    const Rigid r = compose(inverse(pose[j]), pose[i]);
    float* out = table + 8 * (size_t)t;
    out[0] = r.q.w, out[1] = r.q.x, out[2] = r.q.y, out[3] = r.q.z;
    out[4] = r.t.x, out[5] = r.t.y, out[6] = r.t.z;
    out[7] = ratio * expf(da);
    return;
  }
  __shared__ int sums[33];
  const int bank = blockIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // this warp's span of the bank, 32 entries a step, the flags loaded before
  // the count of the later banks
  const int steps = (m + kThreads - 1) / kThreads;
  const int first = bank * m + warp * 32 * steps + lane;
  const int end = (bank + 1) * m;
  unsigned flags = 0;
  for (int step0 = 0; step0 < steps; step0 += kBatch) {
    unsigned char flag[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = first + 32 * (step0 + q);
      flag[q] = step0 + q < steps && i < end ? activate[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (flag[q] != 0 && step0 + q < 32) flags |= 1u << (step0 + q);
  }
  const int later = block_count(activate, end, total, sums);
  int count = __popc(flags);
  for (int step = 32; step < steps; ++step) {   // banks of more than 8192 entries
    const int i = first + 32 * step;
    count += i < end && activate[i] != 0 ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
  const int before = block_exclusive_scan<kThreads>(lane == 0 ? count : 0, sums);
  const int bank_count = sums[32];
  int pos = later + __shfl_sync(kFull, before, 0);
  for (int step = 0; step < steps; ++step) {
    const int i = first + 32 * step;
    const bool in_range = i < end;
    const bool flag = step < 32 ? ((flags >> step) & 1u) != 0 : in_range && activate[i] != 0;
    const unsigned bits = __ballot_sync(kFull, flag);
    const int at = pos + __popc(bits & ((1u << lane) - 1u));
    if (in_range) {
      const bool taken = flag && at < cap;
      selected[i] = taken ? 1 : 0;
      if (taken) order[at] = i;
    }
    pos += __popc(bits);
  }
  // bank 0 is ordered last: the places past every activating candidate are empty
  if (bank == 0)
    for (int at = later + bank_count + tid; at < cap; at += kThreads) order[at] = -1;
}

__global__ void
refine_kernel(const int* __restrict__ order, const float* __restrict__ uv,
              const float* __restrict__ patch, const float* __restrict__ idepth_min,
              const float* __restrict__ idepth_max, const float* __restrict__ table,
              const unsigned char* __restrict__ frame_valid, const float* __restrict__ images,
              size_t image_stride, int k, int m, int h, int w, int cap, Camera cam, float sigma,
              float* __restrict__ idepth_out, unsigned char* __restrict__ keep,
              float* __restrict__ trace, const int* __restrict__ seq_list) {
  __shared__ float e_s[2][kMaxTargets], h_s[2][kMaxTargets], b_s[2][kMaxTargets];
  __shared__ int inl_s[2][kMaxTargets];
  {
    const int sb = seq::of(seq_list), z = blockIdx.z;
    const size_t km = (size_t)k * m;
    order = seq::at(order, z, cap);
    uv = seq::at(uv, sb, 2 * km);
    patch = seq::at(patch, sb, km * kPattern);
    idepth_min = seq::at(idepth_min, sb, km);
    idepth_max = seq::at(idepth_max, sb, km);
    table = seq::at(table, z, 8 * (size_t)k * k + k);
    frame_valid = seq::at(frame_valid, sb, k);
    images = seq::at(images, sb, (size_t)k * image_stride);
    idepth_out = seq::at(idepth_out, z, km);
    keep = seq::at(keep, z, km);
    trace = seq::at(trace, z, (size_t)cap * (kEvaluations - 1) * 4);
  }
  const int idx = threadIdx.x;
  const int flat = order[blockIdx.x];
  if (flat < 0) {
    if (trace != nullptr && idx < (kEvaluations - 1) * 4)
      trace[(size_t)blockIdx.x * (kEvaluations - 1) * 4 + idx] = 0.0f;
    return;
  }
  const int host = flat / m;
  // the pair's pose and brightness scale, the affine b of target and host
  const bool in_range = idx < k * kPattern;
  const int j = in_range ? idx / kPattern : k - 1, p = idx % kPattern;
  const float* pair_row = table + 8 * ((size_t)host * k + j);
  const Rigid rel = {{pair_row[0], pair_row[1], pair_row[2], pair_row[3]},
                     {pair_row[4], pair_row[5], pair_row[6]}};
  const float scale = pair_row[7];
  const float b_target = table[8 * k * k + j], b_host = table[8 * k * k + host];
  const int frames = valid_frames(frame_valid, k);
  const bool pair = frame_valid[j] != 0 && j != host;
  const float u = uv[2 * flat] + kPatternX[p], v = uv[2 * flat + 1] + kPatternY[p];
  const float corrected = scale * (patch[(size_t)flat * kPattern + p] - b_host);
  const float* img = images + (size_t)j * image_stride;
  const int center_lane = (threadIdx.x & 31 & ~(kPattern - 1)) + kCenter;
  RefineState st;
  st.idepth = 0.5f * (idepth_min[flat] + idepth_max[flat]);
  st.trial = st.idepth;
  st.lam = kReg0;
  st.energy = st.h = st.b = 0.0f;
  st.inliers = 0;

#pragma unroll
  for (int ev = 0; ev < kEvaluations; ++ev) {
    const int buf = ev & 1;
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
      e_s[buf][j] = inlier ? wgt * r2 : (ok ? kMaxEnergy : 0.0f);
      inl_s[buf][j] = inlier ? 1 : 0;
      h_s[buf][j] = hp;
      b_s[buf][j] = bp;
    }
    // the one barrier of the evaluation: a buffer is written again two
    // evaluations later, after every thread has passed the next barrier
    __syncthreads();
    // every warp sums the targets in f64 in one fixed order (lane l holds
    // targets l and l + 32, then a butterfly), so all threads take the same
    // decision with no second barrier
    const int lane = idx & 31;
    double e_sum = 0.0, h_sum = 0.0, b_sum = 0.0;
    int inl = 0;
    for (int t = lane; t < k; t += 32) {
      e_sum += (double)e_s[buf][t];
      h_sum += (double)h_s[buf][t];
      b_sum += (double)b_s[buf][t];
      inl += inl_s[buf][t];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      e_sum += __shfl_xor_sync(kFull, e_sum, off);
      h_sum += __shfl_xor_sync(kFull, h_sum, off);
      b_sum += __shfl_xor_sync(kFull, b_sum, off);
      inl += __shfl_xor_sync(kFull, inl, off);
    }
    const float e_new = (float)e_sum, h_new = (float)h_sum, b_new = (float)b_sum;
    bool accept = true;
    if (ev > 0) {
      accept = e_new < st.energy && st.h > 0.0f;
      if (trace != nullptr && idx == 0) {
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

  const int min_inliers = min(frames - 1, 1);
  if (idx == 0 && st.inliers >= min_inliers && st.idepth > 0.0f) {
    idepth_out[flat] = st.idepth;
    keep[flat] = 1;
  }
}

// The pairing.  Per frame slot a, the r-th free landmark slot (lm_valid 0, in
// index order) takes the r-th activating candidate of bank a (in index order)
// for r < take = min(#free, #activating).  A block per (landmark tile t, slot
// a): it counts slot a's free slots and activating candidates over contiguous
// runs a thread, one block scan of both counts packed in one int, and keeps
// in shared memory the activating candidates in order (act_list) and each
// free slot's rank (free_rank); then it writes tile t's share of every
// output, each entry once: the landmark slots [t L, (t + 1) L) of slot a (uv,
// the C*8 patch values, idepth, valid and the k residual statuses of each:
// the moved candidate's values where a slot is paired, the window's
// otherwise) and the bank entries [t Lm, (t + 1) Lm) (valid and, after a
// refinement, the idepth bounds).  Where a refinement ran (`refined` and
// `selected` not null) `act` is its keep mask, the bounds of a kept candidate
// become its refined idepth and a refined candidate it did not keep is
// dropped, as fused_keyframe.py's glue did before the pairing.  The blocks of
// tile 0 write each slot's take and take a ticket; the last sums the takes in
// slot order into n_activated and resets the ticket for the next launch.  The
// takes and the ticket live in the caller's workspace (kernels.py::workspace:
// one per stream, zero when made, left zero by every launch).
constexpr int kPairTile = 64;              // landmark slots a block writes at most
constexpr int kMaxPairSlots = 64;

// each slot's take and the ticket; the ticket is zero between launches
struct PairWorkspace {
  int takes[kMaxPairSlots];
  unsigned int ticket;
};

struct PairBank {
  const unsigned char* act;     // [k,m]
  const unsigned char* drop;    // [k,m]
  const unsigned char* selected;  // [k,m] or null
  const float* refined;         // [k,m] or null
  const float* uv;              // [k,m,2]
  const float* patch;           // [k,m,8]
  const float* idepth_min;
  const float* idepth_max;
  const unsigned char* valid;
};

struct PairWindow {
  const float* lm_uv;
  const float* lm_patch;
  const float* lm_idepth;
  const unsigned char* lm_valid;
  const int* res_status;
};

struct PairOut {
  float* lm_uv;
  float* lm_patch;
  float* lm_idepth;
  unsigned char* lm_valid;
  int* res_status;
  unsigned char* valid;
  float* idepth_min;            // null without a refinement
  float* idepth_max;
  long long* n_activated;
};

// a bank entry's idepth bound after the refinement's glue
static __device__ __forceinline__ float pair_bound(const PairBank& in, const float* bound,
                                                   int e) {
  return in.refined != nullptr && in.act[e] != 0 ? in.refined[e] : bound[e];
}

__global__ void __launch_bounds__(kThreads)
pair_slots_kernel(PairBank in, PairWindow win, PairOut out, const float* __restrict__ bank,
                  int channels, int h, int w, int k, int n, int m,
                  PairWorkspace* __restrict__ ws, const int* __restrict__ seq_list) {
  extern __shared__ int pair_lists[];
  __shared__ int sums[33];
  {
    const int sb = seq::of(seq_list), z = blockIdx.z;
    const size_t km = (size_t)k * m, kn = (size_t)k * n;
    const size_t values = (size_t)channels * kPattern;
    in.act = seq::at(in.act, z, km);
    in.drop = seq::at(in.drop, z, km);
    in.selected = seq::at(in.selected, z, km);
    in.refined = seq::at(in.refined, z, km);
    in.uv = seq::at(in.uv, sb, 2 * km);
    in.patch = seq::at(in.patch, sb, km * kPattern);
    in.idepth_min = seq::at(in.idepth_min, sb, km);
    in.idepth_max = seq::at(in.idepth_max, sb, km);
    in.valid = seq::at(in.valid, sb, km);
    bank = seq::at(bank, sb, (size_t)k * 3 * channels * h * w);
    win.lm_uv = seq::at(win.lm_uv, sb, 2 * kn);
    win.lm_patch = seq::at(win.lm_patch, sb, kn * values);
    win.lm_idepth = seq::at(win.lm_idepth, sb, kn);
    win.lm_valid = seq::at(win.lm_valid, sb, kn);
    win.res_status = seq::at(win.res_status, sb, kn * k);
    out.lm_uv = seq::at(out.lm_uv, z, 2 * kn);
    out.lm_patch = seq::at(out.lm_patch, z, kn * values);
    out.lm_idepth = seq::at(out.lm_idepth, z, kn);
    out.lm_valid = seq::at(out.lm_valid, z, kn);
    out.res_status = seq::at(out.res_status, z, kn * k);
    out.valid = seq::at(out.valid, z, km);
    out.idepth_min = seq::at(out.idepth_min, z, km);
    out.idepth_max = seq::at(out.idepth_max, z, km);
    out.n_activated = seq::at(out.n_activated, z, 1);
    ws = seq::at(ws, z, 1);
  }
  int* act_list = pair_lists;       // [m]
  int* free_rank = pair_lists + m;  // [n], -1 where the slot is live
  const int t = blockIdx.x, a = blockIdx.y, tid = threadIdx.x;
  const int run_n = (n + kThreads - 1) / kThreads, run_m = (m + kThreads - 1) / kThreads;
  const int n0 = min(tid * run_n, n), n1 = min(n0 + run_n, n);
  const int m0 = min(tid * run_m, m), m1 = min(m0 + run_m, m);
  const unsigned char* lm_valid = win.lm_valid + (size_t)a * n;
  const unsigned char* act = in.act + (size_t)a * m;
  int n_free = 0, n_act = 0;
  for (int i = n0; i < n1; ++i) n_free += lm_valid[i] == 0;
  for (int s = m0; s < m1; ++s) n_act += act[s] != 0;
  // both counts in one scan: free slots in the high half, candidates in the low
  const int pre = block_exclusive_scan<kThreads>((n_free << 16) | n_act, sums);
  const int total_free = sums[32] >> 16, total_act = sums[32] & 0xffff;
  int rank = pre >> 16;
  for (int i = n0; i < n1; ++i) free_rank[i] = lm_valid[i] == 0 ? rank++ : -1;
  rank = pre & 0xffff;
  for (int s = m0; s < m1; ++s)
    if (act[s] != 0) act_list[rank++] = s;
  const int take = min(total_free, total_act);
  if (t == 0 && tid == 0) {
    ws->takes[a] = take;
    __threadfence();
    if (atomicAdd(&ws->ticket, 1u) == (unsigned)k - 1) {
      __threadfence();
      long long sum = 0;
      for (int b = 0; b < k; ++b) sum += __ldcg(&ws->takes[b]);
      *out.n_activated = sum;
      ws->ticket = 0;
    }
  }
  __syncthreads();

  // tile t of slot a's landmark slots
  const int tiles = gridDim.x;
  const int span = (n + tiles - 1) / tiles, i0 = t * span, len = max(min(span, n - i0), 0);
  // the bank entry that landmark slot i0 + e takes, or -1
  auto source = [&](int e) {
    const int r = free_rank[i0 + e];
    return r >= 0 && r < take ? a * m + act_list[r] : -1;
  };
  for (int e = tid; e < len; e += kThreads) {
    const int dst = a * n + i0 + e, src = source(e);
    out.lm_idepth[dst] = src >= 0 ? 0.5f * (pair_bound(in, in.idepth_min, src) +
                                            pair_bound(in, in.idepth_max, src))
                                  : win.lm_idepth[dst];
    out.lm_valid[dst] = src >= 0 ? 1 : win.lm_valid[dst];
  }
  for (int e = tid; e < 2 * len; e += kThreads) {
    const size_t dst = 2 * ((size_t)a * n + i0) + e;
    const int src = source(e >> 1);
    out.lm_uv[dst] = src >= 0 ? in.uv[2 * src + (e & 1)] : win.lm_uv[dst];
  }
  const int values = channels * kPattern;
  const float* host = bank + (size_t)a * 3 * channels * h * w;
  for (int e = tid; e < values * len; e += kThreads) {
    const size_t dst = ((size_t)a * n + i0) * values + e;
    const int src = source(e / values), q = e % values;
    float v;
    if (src < 0) {
      v = win.lm_patch[dst];
    } else if (channels == 1) {
      v = in.patch[(size_t)src * kPattern + q];
    } else {
      // channel q / 8 of the host slot a's planes at pattern point q % 8
      const float x0 = in.uv[2 * src], y0 = in.uv[2 * src + 1];
      const int c = q / kPattern, p = q % kPattern;
      v = sample_window(host + (size_t)c * h * w, h, w, x0 + kPatternX[p], y0 + kPatternY[p],
                        window_base(x0, w), window_base(y0, h)).val;
    }
    out.lm_patch[dst] = v;
  }
  for (int e = tid; e < k * len; e += kThreads) {
    const int j = e / len, i = e % len;
    const size_t idx = ((size_t)a * k + j) * n + i0 + i;
    out.res_status[idx] = source(i) >= 0 ? 0 : win.res_status[idx];   // RES_OK
  }

  // tile t of bank a
  const int span_m = (m + tiles - 1) / tiles, s0 = t * span_m;
  const int len_m = max(min(span_m, m - s0), 0);
  const int last_taken = take > 0 ? act_list[take - 1] : -1;
  for (int e = tid; e < len_m; e += kThreads) {
    const int s = s0 + e, idx = a * m + s;
    const bool active = act[s] != 0;
    const bool drop = in.drop[idx] != 0 || (in.selected != nullptr && in.selected[idx] != 0 &&
                                            !active);
    const bool taken = active && s <= last_taken;
    out.valid[idx] = in.valid[idx] != 0 && !drop && !taken ? 1 : 0;
    if (out.idepth_min != nullptr) {
      out.idepth_min[idx] = pair_bound(in, in.idepth_min, idx);
      out.idepth_max[idx] = pair_bound(in, in.idepth_max, idx);
    }
  }
}

}  // namespace

// Banks [k,m]: activate u8, uv [.,2], patch [.,8], idepth_min, idepth_max f32.
// Window: t_lin_q [k,4], t_lin_t [k,3], eps [k,8], affine0 [k,2], exposure
// [k] f32, frame_valid [k] u8, images + f * image_stride = frame f's [h,w]
// intensity image (plane 0 of its channel bank, image_stride = 3 C h w).  Scratch: order [cap] int32, table [8*k*k + k] f32 (the
// pairs' poses and scales, the frames' b; compact_kernel).  Outputs, every entry
// written: selected, keep [k,m] u8; idepth_out [k,m] f32 (the refined idepth
// where a candidate is kept, the bank's elsewhere); trace [cap,3,4] f32 or
// nullptr (energy, trial energy, lambda, accept per trial; zero rows past the
// refined count).  k <= kMaxTargets.  Sequence axis (seq_axis.cuh): `seqs`
// sequences, grid z; the window, images and banks are [B, ...] stacks read at
// seq_list[z] (null: z), activate, the scratch and the outputs [seqs, ...] at
// z (order [seqs,cap], table [seqs,8*k*k+k]).
extern "C" int refine_idepth(const unsigned char* activate, const float* uv,
                             const float* patch, const float* idepth_min,
                             const float* idepth_max, const float* t_lin_q,
                             const float* t_lin_t, const float* eps, const float* affine0,
                             const float* exposure, const unsigned char* frame_valid,
                             const float* images, int image_stride, int k, int m, int h, int w,
                             int cap, float fx, float fy, float cx, float cy, float width,
                             float height, float sigma, int* order, float* table,
                             unsigned char* selected, float* idepth_out, unsigned char* keep,
                             float* trace, int seqs, const int* seq_list, void* stream) {
  if (k > kMaxTargets || !seq::valid_count(seqs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  const int fill = kThreads * kFillPerThread;
  const int table_blocks = (k * k + kThreads - 1) / kThreads;
  compact_kernel<<<dim3(k + table_blocks + (k * m + fill - 1) / fill, 1, seqs), kThreads, 0,
                   s>>>(activate, idepth_min, idepth_max, t_lin_q, t_lin_t, eps, affine0,
                        exposure, k, m, cap, order, selected, table, idepth_out, keep,
                        seq_list);
  const int threads = (k * ba::kPattern + 31) / 32 * 32;
  refine_kernel<<<dim3(cap, 1, seqs), threads, 0, s>>>(
      order, uv, patch, idepth_min, idepth_max, table, frame_valid, images,
      (size_t)image_stride, k, m, h, w, cap, cam, sigma, idepth_out, keep, trace, seq_list);
  return (int)cudaGetLastError();
}

// Banks [k,m]: activate (the refinement's keep mask where one ran), drop,
// imm_valid u8; selected u8 and refined f32 (the refinement's, or both null);
// uv [.,2], patch [.,8], idepth_min, idepth_max f32.  The window's channel
// bank (bank + f * 3 C h w + c * h * w is channel c of frame slot f, [h,w];
// read at C > 1 only), lm_uv [k,n,2], lm_patch [k,n,C*8], lm_idepth [k,n],
// lm_valid [k,n] u8 and res_status [k,k,n] int32, read only.  Outputs, every
// entry written once: the window's five tensors after the pairing (*_out),
// imm_valid_out [k,m] u8, idepth_min_out and idepth_max_out [k,m] f32 (null
// without a refinement: the bounds are unchanged), n_activated one int64.
// workspace: workspace_bytes >= seqs * sizeof(PairWorkspace) of device
// memory (a PairWorkspace a sequence, at z), zero before the first launch on
// the stream that owns it; every launch leaves it zero again.  Sequence axis
// (seq_axis.cuh): `seqs` sequences, grid z; the banks, the channel bank and
// the window's five tensors are [B, ...] stacks read at seq_list[z] (null:
// z), the flags (activate, drop, selected, refined) and the outputs [seqs,
// ...] at z.
extern "C" int activation_scatter(const unsigned char* activate, const unsigned char* drop,
                                  const unsigned char* selected, const float* refined,
                                  const float* uv, const float* patch,
                                  const float* idepth_min, const float* idepth_max,
                                  const unsigned char* imm_valid, const float* bank,
                                  int channels, int h, int w, int k, int n, int m,
                                  const float* lm_uv, const float* lm_patch,
                                  const float* lm_idepth, const unsigned char* lm_valid,
                                  const int* res_status, float* lm_uv_out,
                                  float* lm_patch_out, float* lm_idepth_out,
                                  unsigned char* lm_valid_out, int* res_status_out,
                                  unsigned char* imm_valid_out, float* idepth_min_out,
                                  float* idepth_max_out, long long* n_activated,
                                  void* workspace, int workspace_bytes, int seqs,
                                  const int* seq_list, void* stream) {
  const bool refine = refined != nullptr;
  const size_t shared = (size_t)(n + m) * sizeof(int);
  if (channels < 1 || k < 1 || k > kMaxPairSlots || n < 1 || m < 1 || n >= 32768 ||
      m >= 32768 || shared > 48 * 1024 || (selected != nullptr) != refine ||
      (idepth_min_out != nullptr) != refine || (idepth_max_out != nullptr) != refine ||
      !seq::valid_count(seqs) || workspace == nullptr ||
      (long long)workspace_bytes < (long long)seqs * (long long)sizeof(PairWorkspace))
    return (int)cudaErrorInvalidValue;
  const PairBank in = {activate, drop, selected, refined, uv, patch, idepth_min, idepth_max,
                       imm_valid};
  const PairWindow win = {lm_uv, lm_patch, lm_idepth, lm_valid, res_status};
  const PairOut out = {lm_uv_out, lm_patch_out, lm_idepth_out, lm_valid_out, res_status_out,
                       imm_valid_out, idepth_min_out, idepth_max_out, n_activated};
  const dim3 grid((n + kPairTile - 1) / kPairTile, k, seqs);
  pair_slots_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      in, win, out, bank, channels, h, w, k, n, m, (PairWorkspace*)workspace, seq_list);
  return (int)cudaGetLastError();
}
