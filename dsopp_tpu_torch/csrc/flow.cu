// K5 flow_statistic: the RMS ray-space flow of the frontend's flow set under
// the tracked pose T and under T without its rotation (the keyframe
// strategy's two statistics), and, in the same call, the frontend's
// reliability gate and the keyframe decision that read them.
//
// Replaces dsopp_tpu/tracker/depth_map.py::mean_square_flows and the gate and
// decision of dsopp_tpu/tracker/device_loop.py::_frontend_core: for each of
// <= 8192 points (uv, idepth) of the newest keyframe, reproject into the
// current frame, unproject the reprojected pixel and take the squared
// distance to the source ray; mean over the points that are valid at the
// source (inside the image less the border, idepth > 1e-6) and after
// core/reproject.py::reproject; square root.  Both poses share the
// unprojected source ray.  Then, from the tick's rmse and valid count and the
// state's rmse_last0 and kf_rmse:
//   reliable    = rmse < 2.5 rmse_last0 and num_valid > 0
//   rmse_last0' = reliable ? rmse : 2.5 rmse_last0
//   kf_rmse_eff = kf_rmse < 0 ? rmse : kf_rmse
//   need        = (factor (4.5 flow + 9 flow_no_rot) > 1
//                  or rmse / max(kf_rmse_eff, 1e-12) > 4) and reliable
//   kf_rmse'    = force ? kf_rmse : (need ? -1 : kf_rmse_eff)
// in f32 with torch's roundings (a Python scalar times an f32 tensor is an
// f32 product, clamp is a max that keeps a NaN, the division is IEEE, the
// comparisons strict), so the decision has the bits of the torch code it
// replaced.
//
// Bound: bytes (16 bytes of input per point, a few floats out); at 8192
// points the launch itself is the cost.  Design: one launch, no memset, no
// host read.  A thread per point (a block of 256 threads per 256 points, at
// most kMaxBlocks blocks, striding beyond): each thread's f64 partial sums and
// integer counts, a warp butterfly, the warps in index order; each block
// writes its partials to its own place, then takes a ticket (__threadfence,
// atomicAdd).  The block holding the last ticket loads the partials at once,
// sums them in block index order (a thread a pose), resets the ticket for
// the next launch, and writes the flows and the decision.  So the sums have one order whatever the order in which
// the blocks finish (testing/frontend_models.py::flow_block_sums), and the
// statistic that decides a keyframe is the same on every run.  The ticket and
// the partials live in the caller's workspace (kernels.py::workspace: one per
// stream, zero when made, left zero by every launch), so launches in stream
// order share it and launches on two streams never do.  The projection is Pinhole.project's
// division form (fx * x / z + cx), as the plain version rounds.
//
// B sequences (the batched tick) are one launch: grid y runs over them, each
// reads its points, pose and decision inputs at its offset in [B, ...]
// stacks and writes its row of a [B, 23] output.  Each sequence has its own
// partials and ticket (workspace[b]), so its blocks sum in block order and
// its last block finishes it alone: a sequence's statistics are those of its
// own launch to the bit.

#include "ba_body.cuh"

namespace {

using namespace ba;

constexpr int kFlowThreads = 256;
constexpr int kFlowWarps = kFlowThreads / 32;
constexpr int kMaxBlocks = 64;
// the decision's constants (depth_map.py's ENERGY_RATIO_THRESHOLD,
// strategy weights and thresholds)
constexpr float kEnergyRatio = 2.5f;
constexpr float kShiftWeight = 4.5f, kShiftNoRotWeight = 9.0f;
constexpr float kThreshold = 1.0f, kMaxExcessEnergy = 4.0f;
// the packed output (depth_map.py's STAT_* indices)
enum Stat {
  kStatFlow = 0, kStatFlowNoRot = 1, kStatReliable = 2, kStatRmseLast0 = 3, kStatKfRmse = 4,
  kStatNeed = 5, kStatRmse = 6, kStatMatrix = 7,
};

constexpr int kMaxBatch = 256;  // sequences of one launch (the forced flags' bits)

// a sequence's blocks' partials and ticket; the ticket is zero between launches
struct FlowWorkspace {
  double sum[kMaxBlocks][2];
  int count[kMaxBlocks][2];
  unsigned int ticket;
};

struct Decision {
  const float* t_kf_frame_mat;   // [B,4,4]
  const float* rmse;             // [B]
  const int* num_valid;          // [B]
  const float* rmse_last0;       // [B] at rmse_last0_stride floats a sequence
  const float* kf_rmse;          // [B] at kf_rmse_stride
  int rmse_last0_stride, kf_rmse_stride;
  float factor;
  unsigned int force[kMaxBatch / 32];  // sequence b's keyframe is forced: bit b
};

__global__ void __launch_bounds__(kFlowThreads)
flow_kernel(const float* __restrict__ uv, const float* __restrict__ idepth,
            const unsigned char* __restrict__ valid, int n, const float* __restrict__ pose_q,
            const float* __restrict__ pose_t, Camera cam, float border, Decision dec,
            FlowWorkspace* __restrict__ workspace, float* __restrict__ out) {
  __shared__ double sum_s[2][kFlowWarps];
  __shared__ int cnt_s[2][kFlowWarps];
  __shared__ double part_sum[2][kMaxBlocks];
  __shared__ int part_cnt[2][kMaxBlocks];
  __shared__ float flow_s[2];
  __shared__ bool last;
  // this block's sequence: its points, pose, decision inputs, output row and
  // workspace
  const int seq = blockIdx.y;
  const bool decide = dec.rmse != nullptr;
  uv += (size_t)seq * 2 * n;
  idepth += (size_t)seq * n;
  valid += (size_t)seq * n;
  pose_q += 4 * seq;
  pose_t += 3 * seq;
  out += seq * (decide ? kStatMatrix + 16 : 2);
  FlowWorkspace* __restrict__ ws = workspace + seq;
  const Rigid pose[2] = {
      {{pose_q[0], pose_q[1], pose_q[2], pose_q[3]}, {pose_t[0], pose_t[1], pose_t[2]}},
      {{1.0f, 0.0f, 0.0f, 0.0f}, {pose_t[0], pose_t[1], pose_t[2]}}};
  // the decision's inputs, loaded while the points are summed (used by the
  // last block's thread 0 only)
  float rmse = 0.0f, rmse_last0 = 0.0f, kf_rmse = 0.0f;
  int num_valid = 0;
  if (decide && threadIdx.x == 0) {
    rmse = dec.rmse[seq];
    rmse_last0 = dec.rmse_last0[seq * dec.rmse_last0_stride];
    kf_rmse = dec.kf_rmse[seq * dec.kf_rmse_stride];
    num_valid = dec.num_valid[seq];
  }
  double sum[2] = {0.0, 0.0};
  int cnt[2] = {0, 0};

  for (int p = blockIdx.x * kFlowThreads + threadIdx.x; p < n; p += gridDim.x * kFlowThreads) {
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

  // the frame's matrix and rmse go into the packed output unchanged
  if (decide && blockIdx.x == 0) {
    if (threadIdx.x < 16)
      out[kStatMatrix + threadIdx.x] = dec.t_kf_frame_mat[16 * seq + threadIdx.x];
    if (threadIdx.x == 16) out[kStatRmse] = dec.rmse[seq];
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
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      double a = 0.0;
      int c = 0;
      for (int w = 0; w < kFlowWarps; ++w) {
        a += sum_s[s][w];
        c += cnt_s[s][w];
      }
      ws->sum[blockIdx.x][s] = a;
      ws->count[blockIdx.x][s] = c;
    }
    __threadfence();
    last = atomicAdd(&ws->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every partial is visible past the other blocks' fences;
  // its threads load them at once, two threads add them in block index order
  __threadfence();
  if (threadIdx.x == 0) ws->ticket = 0;
  for (int i = threadIdx.x; i < 2 * (int)gridDim.x; i += kFlowThreads) {
    const int b = i >> 1, s = i & 1;
    part_sum[s][b] = __ldcg(&ws->sum[b][s]);
    part_cnt[s][b] = __ldcg(&ws->count[b][s]);
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const int s = threadIdx.x;
    double a = 0.0;
    int c = 0;
    for (int b = 0; b < (int)gridDim.x; ++b) {
      a += part_sum[s][b];
      c += part_cnt[s][b];
    }
    flow_s[s] = sqrtf((float)a / (float)max(c, 1));
    out[s] = flow_s[s];
  }
  if (!decide) return;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const bool reliable = rmse < kEnergyRatio * rmse_last0 && num_valid > 0;
  const float kf_rmse_eff = kf_rmse < 0.0f ? rmse : kf_rmse;
  const float clamped = isnan(kf_rmse_eff) ? kf_rmse_eff : fmaxf(kf_rmse_eff, 1e-12f);
  const float shift = dec.factor * (kShiftWeight * flow_s[0] + kShiftNoRotWeight * flow_s[1]);
  const bool need = (shift > kThreshold || rmse / clamped > kMaxExcessEnergy) && reliable;
  out[kStatReliable] = reliable ? 1.0f : 0.0f;
  out[kStatRmseLast0] = reliable ? rmse : rmse_last0 * kEnergyRatio;
  const bool force = (dec.force[seq >> 5] >> (seq & 31)) & 1u;
  out[kStatKfRmse] = force ? kf_rmse : (need ? -1.0f : kf_rmse_eff);
  out[kStatNeed] = need ? 1.0f : 0.0f;
}

}  // namespace

// Points: uv [n,2], idepth [n], valid [n] u8; pose_q [4], pose_t [3] (target
// <- reference).  The decision's inputs, all null for the flows alone:
// t_kf_frame_mat [4,4] f32, rmse f32, num_valid int32, rmse_last0 f32,
// kf_rmse f32 (each one value), factor = keyframe_factor; force: a host
// array of the batch's force_kf flags (u8), or null for none.  Output: out
// [2] = (flow, flow without rotation), or with the decision out [23] in
// depth_map.py's STAT_* order: flow, flow without rotation, reliable,
// rmse_last0', kf_rmse', need (booleans as 0 / 1), rmse and the 16 entries of
// t_kf_frame_mat.  batch > 1 sequences: every array a [B, ...] stack of the
// above (rmse_last0 and kf_rmse at their strides, in floats), out [B, 23]
// ([B, 2] for the flows alone).  workspace: workspace_bytes >= batch x
// sizeof(FlowWorkspace) of device memory, zero before the first launch on
// the stream that owns it; every launch leaves it zero again.
extern "C" int flow_statistic(const float* uv, const float* idepth,
                              const unsigned char* valid, int n, int batch,
                              const float* pose_q, const float* pose_t, float fx, float fy,
                              float cx, float cy, float width, float height, float border,
                              const float* t_kf_frame_mat, const float* rmse,
                              const int* num_valid, const float* rmse_last0,
                              int rmse_last0_stride, const float* kf_rmse,
                              int kf_rmse_stride, float factor, const unsigned char* force,
                              void* workspace, int workspace_bytes, float* out,
                              void* stream) {
  const bool decide = rmse != nullptr;
  if (n < 1 || batch < 1 || batch > kMaxBatch || workspace == nullptr ||
      workspace_bytes < batch * (int)sizeof(FlowWorkspace) ||
      decide != (t_kf_frame_mat != nullptr && num_valid != nullptr &&
                 rmse_last0 != nullptr && kf_rmse != nullptr))
    return (int)cudaErrorInvalidValue;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  Decision dec = {t_kf_frame_mat, rmse, num_valid, rmse_last0, kf_rmse,
                  rmse_last0_stride, kf_rmse_stride, factor, {}};
  if (force != nullptr)
    for (int b = 0; b < batch; ++b)
      if (force[b]) dec.force[b >> 5] |= 1u << (b & 31);
  const int blocks = min((n + kFlowThreads - 1) / kFlowThreads, kMaxBlocks);
  const dim3 grid(blocks, batch);
  flow_kernel<<<grid, kFlowThreads, 0, (cudaStream_t)stream>>>(uv, idepth, valid, n, pose_q,
                                                                pose_t, cam, border, dec,
                                                                (FlowWorkspace*)workspace, out);
  return (int)cudaGetLastError();
}
