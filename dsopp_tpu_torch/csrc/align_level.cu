// K3 align_level: the Levenberg-Marquardt loop of the frontend pose
// alignment at one pyramid level, for a batch of pose hypotheses, in one
// launch and without a host read.
//
// Replaces dsopp_tpu/solvers/pose_alignment.py::align_level (the while-loop
// over _residual_system, the damped 8x8 solve, the left increment
// t <- exp(step) t, accept/reject with lambda /2 and x10, the function and
// parameter tolerances and the per-hypothesis done flag).
//
// Bound: latency — up to 51 dependent passes, each one pass over <= 2000
// points, a reduction of 46 sums and one 8x8 solve.  Design: a thread-block
// cluster of C blocks per hypothesis, C a function of the number of
// hypotheses alone (8 up to 16 hypotheses, 4 up to 33, else 2), so that one
// hypothesis at level 0 runs on 8 SMs and 105 fill the card.
//  - Each block owns a contiguous slice of the level's points (the partition
//    depends on n and C only) and stages it once per launch into shared
//    memory as (ray x, ray y, idepth, intensity - b_r); the level's map stays
//    in L2.  Against a map of several embedder channels (a [3 Ch, h, w] map,
//    intensities [n, Ch]) the fourth word is the point's index and
//    align::accumulate_channels reads its Ch intensities from global memory.
//  - A pass: 256 threads over the slice (align::accumulate_point, K2's
//    per-point body); one reduce-scatter butterfly per warp (62 shuffles for
//    the 46 sums, padded to 64, against 230 for 46 butterflies); the warps'
//    sums in index order; the block's 46 partial sums into a double-buffered
//    shared array; one cluster barrier; then warp 0 of every block reads all
//    blocks' partials through distributed shared memory in rank order, so
//    every block holds the same bits.
//  - Lane 0 of every block's warp 0 then runs the serial part in registers:
//    priors, accept test and lambda update, the damped solve by LU with
//    partial pivoting in f32 (fully unrolled; the plain version solves with a
//    pivoted f32 LU as well), exp(step) composed onto the pose with the
//    formulas and small-angle branches of core/lie.py.  Every block decides
//    alike, so no broadcast crosses the cluster; one block barrier hands the
//    trial pose to the block's warps, and the double-buffered partials leave
//    one cluster barrier per pass.  Rank 0 alone writes the outputs and the
//    trace.
// Deterministic: fixed partition, fixed reduction order, no atomics (the
// caller takes an argmin over energies).  A refused cluster launch returns
// its error, which the wrapper raises.
//
// B sequences in one launch (the batched tick): each hypothesis carries its
// sequence's index (seq, or sequence 0 when null) and reads that sequence's
// level points, level map and reference brightness (a_r, b_r, the exposure
// ratio) at the sequence's offset in [B, ...] stacks; the camera is shared.
// The cluster size is a function of the hypotheses a sequence has in the
// launch (per_seq), not of the launch's total, so a sequence's partition,
// arithmetic and reduction order are those of its own launch, and its
// results are that launch's to the bit.

#include <cooperative_groups.h>

#include "align_body.cuh"
#include "shared_opt_in.cuh"

namespace {

using namespace align;

struct LmOptions {
  int max_iterations;
  float initial_regularizer, function_tolerance, parameter_tolerance;
  float affine_reg_a, affine_reg_b, reg_decrease, reg_increase;
};

constexpr float kSmall = 1e-6f;  // core/lie.py::_SMALL
// a pass's row of the optional trace: energy before, trial energy, lambda
// before, |step|^2, accept + 2 finished (solvers/pose_alignment.py::TRACE_FIELDS)
constexpr int kTraceFields = 5;

// exp(xi) * ps on (quaternion, translation): core/lie.py::SE3.exp and compose
__device__ __forceinline__ Pose left_increment(const float* xi, const Pose& ps) {
  const Vec3 ups = {xi[0], xi[1], xi[2]};
  const Vec3 om = {xi[3], xi[4], xi[5]};
  const float theta_sq = (om.x * om.x + om.y * om.y) + om.z * om.z;
  const float theta = sqrtf(fmaxf(theta_sq, 1e-30f));
  const float half = 0.5f * theta;
  const bool small = theta_sq < kSmall;
  // so3_exp_quat
  const float k = small ? 0.5f - theta_sq / 48.0f : sinf(half) / theta;
  float ew = small ? 1.0f - theta_sq / 8.0f : cosf(half);
  Vec3 eu = {k * om.x, k * om.y, k * om.z};
  const float en = sqrtf(fmaxf(((ew * ew + eu.x * eu.x) + eu.y * eu.y) + eu.z * eu.z, 1e-30f));
  ew /= en;
  eu = {eu.x / en, eu.y / en, eu.z / en};
  // _apply_V
  const float a = small ? 0.5f - theta_sq / 24.0f
                        : (1.0f - cosf(theta)) / fmaxf(theta_sq, 1e-30f);
  const float b = small ? 1.0f / 6.0f - theta_sq / 120.0f
                        : (theta - sinf(theta)) / fmaxf(theta_sq * theta, 1e-30f);
  const Vec3 c1 = cross(om, ups);
  const Vec3 c2 = cross(om, c1);
  const Vec3 et = {ups.x + a * c1.x + b * c2.x, ups.y + a * c1.y + b * c2.y,
                   ups.z + a * c1.z + b * c2.z};
  // compose: q = normalize(e.q * q), t = R(e.q) t + e.t
  const float bw = ps.qw, bx = ps.qu.x, by = ps.qu.y, bz = ps.qu.z;
  float qw = ew * bw - eu.x * bx - eu.y * by - eu.z * bz;
  float qx = ew * bx + eu.x * bw + eu.y * bz - eu.z * by;
  float qy = ew * by - eu.x * bz + eu.y * bw + eu.z * bx;
  float qz = ew * bz + eu.x * by - eu.y * bx + eu.z * bw;
  const float qn = sqrtf(fmaxf(((qw * qw + qx * qx) + qy * qy) + qz * qz, 1e-30f));
  const Vec3 rt = quat_rotate(ew, eu, ps.t);
  Pose out;
  out.qw = qw / qn;
  out.qu = {qx / qn, qy / qn, qz / qn};
  out.t = {rt.x + et.x, rt.y + et.y, rt.z + et.z};
  out.a = ps.a + xi[6];
  out.b = ps.b + xi[7];
  return out;
}

// x <- A^-1 x by LU with partial pivoting in registers; A is destroyed.  A
// zero pivot gives a non-finite x, which the caller zeroes as the plain
// version does.  Every loop has fixed bounds (predicates where the range
// depends on the column), so it unrolls fully and A stays in registers; the
// pivot row is swapped in by selects.
__device__ __forceinline__ void solve8(float (&a)[8][8], float (&x)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int piv = k;
    float big = fabsf(a[k][k]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = fabsf(a[r][k]);
      if (r > k && v > big) {
        big = v;
        piv = r;
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r > k && r == piv) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float tmp = a[k][c];
          a[k][c] = a[r][c];
          a[r][c] = tmp;
        }
        const float tmp = x[k];
        x[k] = x[r];
        x[r] = tmp;
      }
    }
    const float pivot = a[k][k];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r > k) {
        const float f = a[r][k] / pivot;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c > k) a[r][c] -= f * a[k][c];
        x[r] -= f * x[k];
      }
    }
  }
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    float s = x[k];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c > k) s -= a[k][c] * x[c];
    x[k] = s / a[k][k];
  }
}

// the affine priors on a system at affine (a, b), as residual_system adds them
__device__ __forceinline__ void add_priors(float* sys, float a, float b, const LmOptions& o) {
  sys[kEnergy] = sys[kEnergy] + 0.5f * (o.affine_reg_a * a * a + o.affine_reg_b * b * b);
  sys[33] += o.affine_reg_a;  // H[6][6] in the upper triangle by rows
  sys[35] += o.affine_reg_b;  // H[7][7]
  sys[36 + 6] = sys[36 + 6] + o.affine_reg_a * a;
  sys[36 + 7] = sys[36 + 7] + o.affine_reg_b * b;
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPad = 64;  // the 46 sums padded for the reduce-scatter: 2 per lane

// One step of the reduce-scatter: keep the kHalf values named by lane bit
// kHalf / 2 and add the partner lane's copy of them.
template <int kHalf>
__device__ __forceinline__ void scatter_step(float (&acc)[kPad], int lane) {
  constexpr int kOff = kHalf / 2;
  const bool upper = (lane & kOff) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? acc[i] : acc[i + kHalf];
    const float keep = upper ? acc[i + kHalf] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, kOff);
  }
}

// The warp's sums of acc[0..64), scattered: lane L returns those of values
// 2L and 2L + 1 (62 shuffles).
__device__ __forceinline__ void reduce_scatter(float (&acc)[kPad], int lane, float& v0,
                                               float& v1) {
  scatter_step<32>(acc, lane);
  scatter_step<16>(acc, lane);
  scatter_step<8>(acc, lane);
  scatter_step<4>(acc, lane);
  scatter_step<2>(acc, lane);
  v0 = acc[0];
  v1 = acc[1];
}

// the cluster size of a launch: a function of the number of hypotheses alone
__host__ __device__ __forceinline__ int cluster_blocks(int num_hyp) {
  return num_hyp <= 16 ? 8 : (num_hyp <= 33 ? 4 : 2);
}

template <bool kMulti>
__global__ void __launch_bounds__(kThreads, 2)
align_level_kernel(Problem prob, LmOptions o, const float* __restrict__ pose_q,
                   const float* __restrict__ pose_t, const float* __restrict__ affine,
                   const float* __restrict__ ref, const int* __restrict__ seq,
                   float* __restrict__ out_q,
                   float* __restrict__ out_t, float* __restrict__ out_affine,
                   float* __restrict__ out_e, int* __restrict__ out_n,
                   float* __restrict__ out_rmse, int* __restrict__ out_iters,
                   float* __restrict__ trace) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 pts[];          // this block's slice of the points
  __shared__ float part[kWarps][kPad];     // the warps' sums
  __shared__ float partial[2][kSys];       // the block's sums, read by the cluster
  __shared__ float sys_cur[kSys];
  __shared__ float step[8];
  __shared__ Pose pose_cur, pose_new;
  __shared__ int done;

  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int hyp = blockIdx.x / csize;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this hypothesis's sequence: its points, its map and its reference
  const int sq = seq != nullptr ? seq[hyp] : 0;
  prob.uv += (size_t)sq * 2 * prob.n;
  prob.idepth += (size_t)sq * prob.n;
  prob.intensity += (size_t)sq * prob.n * prob.channels;
  prob.valid += (size_t)sq * prob.n;
  prob.map += (size_t)sq * 3 * prob.channels * prob.h * prob.w;
  prob.a_r = ref[3 * sq + 0];
  prob.b_r = ref[3 * sq + 1];
  prob.ratio = ref[3 * sq + 2];

  // stage the slice; an invalid point's ray x is NaN (a NaN coordinate
  // fails the projection tests, so the pass skips both alike)
  const int per = (prob.n + csize - 1) / csize;
  const int first = min(prob.n, rank * per);
  const int count_pts = min(prob.n, first + per) - first;
  for (int i = threadIdx.x; i < count_pts; i += kThreads) {
    const int p = first + i;
    float4 v;
    v.x = prob.valid[p] ? (prob.uv[2 * p] - prob.cx) / prob.fx : __int_as_float(0x7fc00000);
    v.y = (prob.uv[2 * p + 1] - prob.cy) / prob.fy;
    v.z = prob.idepth[p];
    v.w = kMulti ? __int_as_float(p) : prob.intensity[p] - prob.b_r;
    pts[i] = v;
  }
  if (threadIdx.x == 0) {
    pose_new = {pose_q[4 * hyp + 0],
                {pose_q[4 * hyp + 1], pose_q[4 * hyp + 2], pose_q[4 * hyp + 3]},
                {pose_t[3 * hyp + 0], pose_t[3 * hyp + 1], pose_t[3 * hyp + 2]},
                affine[2 * hyp + 0], affine[2 * hyp + 1]};
    done = 0;
  }
  __syncthreads();

  float reg = o.initial_regularizer;  // lane 0 of warp 0 only
  int iterations = 0;                 // lane 0 of warp 0 only

  // pass 0 evaluates the initial pose; pass it >= 1 evaluates the trial of
  // LM iteration it and decides on it
  for (int it = 0; it <= o.max_iterations; ++it) {
    const Pose trial = pose_new;
    const float scale = prob.ratio * expf(trial.a - prob.a_r);
    float acc[kPad];
#pragma unroll
    for (int i = 0; i < kPad; ++i) acc[i] = 0.0f;
    int valid = 0;
    for (int i = threadIdx.x; i < count_pts; i += kThreads) {
      const float4 v = pts[i];
      if (isnan(v.x)) continue;
      const bool ok = kMulti ? accumulate_channels(prob, trial, scale, v.x, v.y, v.z,
                                                   __float_as_int(v.w), acc)
                             : accumulate_point(prob, trial, scale, v.x, v.y, v.z, v.w, acc);
      if (ok) ++valid;
    }
    acc[kCount] = (float)valid;  // exact: a count below 2^24
    float v0, v1;
    reduce_scatter(acc, lane, v0, v1);
    part[warp][2 * lane] = v0;
    part[warp][2 * lane + 1] = v1;
    __syncthreads();
    const int buf = it & 1;
    if (threadIdx.x < kSys) {
      float v = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += part[wi][threadIdx.x];
      partial[buf][threadIdx.x] = v;
    }
    cluster.sync();

    if (warp == 0) {
      // the cluster's sums in rank order: lane i holds values i and i + 32
      float s0 = 0.0f, s1 = 0.0f;
      for (int r = 0; r < csize; ++r) {
        const float* remote = cluster.map_shared_rank(&partial[buf][0], r);
        s0 += remote[lane];
        if (lane + 32 < kSys) s1 += remote[lane + 32];
      }
      float sys_new[kSys];
#pragma unroll
      for (int i = 0; i < kSys; ++i) sys_new[i] = __shfl_sync(kFull, i < 32 ? s0 : s1, i & 31);

      if (lane == 0) {
        add_priors(sys_new, trial.a, trial.b, o);
        const float e_new = sys_new[kEnergy];
        const int n_new = (int)sys_new[kCount];
        bool finished, accept = false;
        float step_sq = 0.0f;
        const float reg_before = reg;
        const float e = it == 0 ? e_new : sys_cur[kEnergy];
        if (it == 0) {
#pragma unroll
          for (int i = 0; i < kSys; ++i) sys_cur[i] = sys_new[i];
          pose_cur = trial;
          finished = n_new == 0;
        } else {
          const bool finite = isfinite(e_new);
          accept = (e_new < e) && (n_new > 0) && finite;
          const bool ftol = fabsf(e - e_new) / fmaxf(e, 1e-30f) < o.function_tolerance;
          const float state_sq = pose_cur.a * pose_cur.a + pose_cur.b * pose_cur.b;
#pragma unroll
          for (int i = 0; i < 8; ++i) step_sq += step[i] * step[i];
          const bool ptol = step_sq < o.parameter_tolerance * (state_sq + o.parameter_tolerance);
          finished = (ftol && finite) || (accept && ptol);
          if (accept) {
#pragma unroll
            for (int i = 0; i < kSys; ++i) sys_cur[i] = sys_new[i];
            pose_cur = trial;
            reg = reg / o.reg_decrease;
          } else {
            reg = reg * o.reg_increase;
          }
        }
        if (trace != nullptr && rank == 0) {
          float* row = trace + ((size_t)hyp * (o.max_iterations + 1) + it) * kTraceFields;
          row[0] = e;
          row[1] = e_new;
          row[2] = reg_before;
          row[3] = step_sq;
          row[4] = (float)((accept ? 1 : 0) + (finished ? 2 : 0));
        }
        if (!finished && it < o.max_iterations) {
          // damped system from the upper triangle; step = -(H + D)^-1 b
          float lu[8][8], x[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              // H's upper triangle by rows: entry (min, max) at its index
              const int lo = r < c ? r : c, hi = r < c ? c : r;
              lu[r][c] = sys_cur[lo * 8 - lo * (lo - 1) / 2 + (hi - lo)];
            }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            lu[r][r] = lu[r][r] + (reg * lu[r][r] + 1e-24f);
            x[r] = sys_cur[36 + r];
          }
          solve8(lu, x);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            x[r] = isfinite(x[r]) ? -x[r] : 0.0f;
            step[r] = x[r];
          }
          pose_new = left_increment(x, pose_cur);
          ++iterations;
        } else {
          done = 1;
        }
      }
    }
    __syncthreads();
    if (done) break;
  }
  // no block leaves while another may still read its partials
  cluster.sync();

  if (rank == 0 && threadIdx.x == 0) {
    const float e = sys_cur[kEnergy];
    const int n = (int)sys_cur[kCount];
    out_q[4 * hyp + 0] = pose_cur.qw;
    out_q[4 * hyp + 1] = pose_cur.qu.x;
    out_q[4 * hyp + 2] = pose_cur.qu.y;
    out_q[4 * hyp + 3] = pose_cur.qu.z;
    out_t[3 * hyp + 0] = pose_cur.t.x;
    out_t[3 * hyp + 1] = pose_cur.t.y;
    out_t[3 * hyp + 2] = pose_cur.t.z;
    out_affine[2 * hyp + 0] = pose_cur.a;
    out_affine[2 * hyp + 1] = pose_cur.b;
    out_e[hyp] = e;
    out_n[hyp] = n;
    out_rmse[hyp] = sqrtf(e / (float)max(n, 1));
    out_iters[hyp] = iterations;
  }
}

}  // namespace

// Inputs as align_residual_system (the hypotheses are the initial poses and
// affines), for B sequences: the points [B, n, ...], the map [B, 3 channels,
// h, w], ref [B, 3], seq [num_hyp] int32 each hypothesis's sequence (null:
// B = 1), per_seq the hypotheses a sequence has in the launch (the cluster
// size's argument; num_hyp at B = 1).  Outputs per hypothesis: pose q [.,4], t [.,3], affine [.,2],
// energy (with the affine priors), num_valid int32, rmse, LM iterations
// int32.  trace: nullptr, or [num_hyp, max_iterations + 1, 5] for the
// decision of every pass a hypothesis runs (diagnostics; rows of passes that
// do not run stay as the caller filled them).  Returns the launch's error: a
// cluster the card cannot place, or a slice of points above a block's shared
// memory, is refused, never run another way.
extern "C" int align_level(
    const float* uv, const float* idepth, const float* intensity,
    const unsigned char* valid, int n, const float* map, int h, int w, int channels,
    const float* pose_q, const float* pose_t, const float* affine,
    const float* ref, const int* seq, int num_hyp, int per_seq, float fx, float fy,
    float cx, float cy,
    float width, float height, float sigma, int max_iterations,
    float initial_regularizer, float function_tolerance,
    float parameter_tolerance, float affine_reg_a, float affine_reg_b,
    float reg_decrease, float reg_increase, float* out_q, float* out_t,
    float* out_affine, float* out_e, int* out_n, float* out_rmse,
    int* out_iters, float* trace, void* stream) {
  if (num_hyp < 1 || per_seq < 1 || per_seq > num_hyp || n < 0 || channels < 1)
    return (int)cudaErrorInvalidValue;
  const align::Problem prob = {uv, idepth, intensity, valid, n,  map,   h,
                             w,  channels, fx,     fy,        cx,    cy, width, height,
                             0.0f, 0.0f, 0.0f, sigma};
  const LmOptions o = {max_iterations,      initial_regularizer, function_tolerance,
                       parameter_tolerance, affine_reg_a,        affine_reg_b,
                       reg_decrease,        reg_increase};
  const int csize = cluster_blocks(per_seq);
  const size_t bytes = (size_t)((n + csize - 1) / csize) * sizeof(float4);
  // the single-channel instance, or the one for a map of several channels;
  // each opts in to the shared memory once per device
  static size_t opted[2][smem::kMaxDevices] = {};
  const bool multi = channels > 1;
  auto kernel = multi ? align_level_kernel<true> : align_level_kernel<false>;
  cudaError_t err = smem::fit(kernel, bytes, opted[multi]);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(num_hyp * csize), 1, 1);
  config.blockDim = dim3(align::kThreads, 1, 1);
  config.dynamicSmemBytes = bytes;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = (unsigned)csize;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, prob, o, pose_q, pose_t, affine, ref, seq,
                           out_q, out_t, out_affine, out_e, out_n, out_rmse, out_iters, trace);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
