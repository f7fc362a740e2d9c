// K3 align_level: the Levenberg-Marquardt loop of the frontend pose
// alignment at one pyramid level, for a batch of pose hypotheses, in one
// launch and without a host read.
//
// Replaces dsopp_tpu/solvers/pose_alignment.py::align_level (the while-loop
// over _residual_system, the damped 8x8 solve, the left increment
// t <- exp(step) t, accept/reject with lambda /2 and x10, the function and
// parameter tolerances and the per-hypothesis done flag).
//
// Bound: latency — up to 50 dependent iterations, each one pass over <=
// 2000 points and one 8x8 solve.  Design: one block per hypothesis keeps the
// whole loop on the device.  Every iteration the 256 threads build the
// system (align::residual_system_block, K2's body, fixed reduction order),
// then thread 0 does the serial part in shared memory: priors, accept test
// and lambda update, the damped solve by LU with partial pivoting in f32
// (the plain version solves with a pivoted f32 LU as well), exp(step)
// composed onto the pose with the formulas and small-angle branches of
// core/lie.py.  Hypotheses are independent, so a block leaves its loop as
// soon as its hypothesis is done.

#include "align_body.cuh"

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
__device__ Pose left_increment(const float* xi, const Pose& ps) {
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

// x <- A^-1 x by LU with partial pivoting; A is destroyed.  A zero pivot
// gives a non-finite x, which the caller zeroes as the plain version does.
__device__ void solve8(float (*a)[9], float* x) {
  for (int k = 0; k < 8; ++k) {
    int piv = k;
    float big = fabsf(a[k][k]);
    for (int r = k + 1; r < 8; ++r) {
      const float v = fabsf(a[r][k]);
      if (v > big) {
        big = v;
        piv = r;
      }
    }
    if (piv != k) {
      for (int c = 0; c < 8; ++c) {
        const float tmp = a[k][c];
        a[k][c] = a[piv][c];
        a[piv][c] = tmp;
      }
      const float tmp = x[k];
      x[k] = x[piv];
      x[piv] = tmp;
    }
    const float pivot = a[k][k];
    for (int r = k + 1; r < 8; ++r) {
      const float f = a[r][k] / pivot;
      for (int c = k + 1; c < 8; ++c) a[r][c] -= f * a[k][c];
      x[r] -= f * x[k];
    }
  }
  for (int k = 7; k >= 0; --k) {
    float s = x[k];
    for (int c = k + 1; c < 8; ++c) s -= a[k][c] * x[c];
    x[k] = s / a[k][k];
  }
}

// the affine priors on a system at affine (a, b), as residual_system adds them
__device__ void add_priors(float* sys, float a, float b, const LmOptions& o) {
  sys[kEnergy] = sys[kEnergy] + 0.5f * (o.affine_reg_a * a * a + o.affine_reg_b * b * b);
  sys[33] += o.affine_reg_a;  // H[6][6] in the upper triangle by rows
  sys[35] += o.affine_reg_b;  // H[7][7]
  sys[36 + 6] = sys[36 + 6] + o.affine_reg_a * a;
  sys[36 + 7] = sys[36 + 7] + o.affine_reg_b * b;
}

__global__ void __launch_bounds__(kThreads)
align_level_kernel(Problem prob, LmOptions o, const float* __restrict__ pose_q,
                   const float* __restrict__ pose_t, const float* __restrict__ affine,
                   const float* __restrict__ ref, float* __restrict__ out_q,
                   float* __restrict__ out_t, float* __restrict__ out_affine,
                   float* __restrict__ out_e, int* __restrict__ out_n,
                   float* __restrict__ out_rmse, int* __restrict__ out_iters,
                   float* __restrict__ trace) {
  __shared__ float part[kWarps][kSys];
  __shared__ float sys_new[kSys];
  __shared__ float sys_cur[kSys];
  __shared__ float lu[8][9];
  __shared__ float step[8];
  __shared__ Pose pose_cur, pose_new;
  __shared__ int done;

  const int hyp = blockIdx.x;
  prob.a_r = ref[0];
  prob.b_r = ref[1];
  prob.ratio = ref[2];
  if (threadIdx.x == 0) {
    pose_new = {pose_q[4 * hyp + 0],
                {pose_q[4 * hyp + 1], pose_q[4 * hyp + 2], pose_q[4 * hyp + 3]},
                {pose_t[3 * hyp + 0], pose_t[3 * hyp + 1], pose_t[3 * hyp + 2]},
                affine[2 * hyp + 0], affine[2 * hyp + 1]};
    done = 0;
  }
  __syncthreads();

  float reg = o.initial_regularizer;  // thread 0 only
  int iterations = 0;                 // thread 0 only

  // pass 0 evaluates the initial pose; pass it >= 1 evaluates the trial of
  // LM iteration it and decides on it
  for (int it = 0; it <= o.max_iterations; ++it) {
    const Pose trial = pose_new;
    residual_system_block(prob, trial, part, sys_new);

    if (threadIdx.x == 0) {
      add_priors(sys_new, trial.a, trial.b, o);
      const float e_new = sys_new[kEnergy];
      const int n_new = __float_as_int(sys_new[kCount]);
      bool finished, accept = false;
      float step_sq = 0.0f;
      const float reg_before = reg;
      const float e = it == 0 ? e_new : sys_cur[kEnergy];
      if (it == 0) {
        for (int i = 0; i < kSys; ++i) sys_cur[i] = sys_new[i];
        pose_cur = trial;
        finished = n_new == 0;
      } else {
        const bool finite = isfinite(e_new);
        accept = (e_new < e) && (n_new > 0) && finite;
        const bool ftol = fabsf(e - e_new) / fmaxf(e, 1e-30f) < o.function_tolerance;
        const float state_sq = pose_cur.a * pose_cur.a + pose_cur.b * pose_cur.b;
        for (int i = 0; i < 8; ++i) step_sq += step[i] * step[i];
        const bool ptol = step_sq < o.parameter_tolerance * (state_sq + o.parameter_tolerance);
        finished = (ftol && finite) || (accept && ptol);
        if (accept) {
          for (int i = 0; i < kSys; ++i) sys_cur[i] = sys_new[i];
          pose_cur = trial;
          reg = reg / o.reg_decrease;
        } else {
          reg = reg * o.reg_increase;
        }
      }
      if (trace != nullptr) {
        float* row = trace + ((size_t)hyp * (o.max_iterations + 1) + it) * kTraceFields;
        row[0] = e;
        row[1] = e_new;
        row[2] = reg_before;
        row[3] = step_sq;
        row[4] = (float)((accept ? 1 : 0) + (finished ? 2 : 0));
      }
      if (!finished && it < o.max_iterations) {
        // damped system from the upper triangle; step = -(H + D)^-1 b
        int k = 0;
        for (int r = 0; r < 8; ++r)
          for (int c = r; c < 8; ++c) {
            lu[r][c] = sys_cur[k];
            lu[c][r] = sys_cur[k];
            ++k;
          }
        for (int r = 0; r < 8; ++r) {
          lu[r][r] = lu[r][r] + (reg * lu[r][r] + 1e-24f);
          step[r] = sys_cur[36 + r];
        }
        solve8(lu, step);
        for (int r = 0; r < 8; ++r) step[r] = isfinite(step[r]) ? -step[r] : 0.0f;
        pose_new = left_increment(step, pose_cur);
        ++iterations;
      } else {
        done = 1;
      }
    }
    __syncthreads();
    if (done) break;
  }

  if (threadIdx.x == 0) {
    const float e = sys_cur[kEnergy];
    const int n = __float_as_int(sys_cur[kCount]);
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
// affines).  Outputs per hypothesis: pose q [.,4], t [.,3], affine [.,2],
// energy (with the affine priors), num_valid int32, rmse, LM iterations
// int32.  trace: nullptr, or [num_hyp, max_iterations + 1, 5] for the
// decision of every pass a hypothesis runs (diagnostics; rows of passes that
// do not run stay as the caller filled them).
extern "C" int align_level(
    const float* uv, const float* idepth, const float* intensity,
    const unsigned char* valid, int n, const float* map, int h, int w,
    const float* pose_q, const float* pose_t, const float* affine,
    const float* ref, int num_hyp, float fx, float fy, float cx, float cy,
    float width, float height, float sigma, int max_iterations,
    float initial_regularizer, float function_tolerance,
    float parameter_tolerance, float affine_reg_a, float affine_reg_b,
    float reg_decrease, float reg_increase, float* out_q, float* out_t,
    float* out_affine, float* out_e, int* out_n, float* out_rmse,
    int* out_iters, float* trace, void* stream) {
  const align::Problem prob = {uv, idepth, intensity, valid, n,  map,   h,
                             w,  fx,     fy,        cx,    cy, width, height,
                             0.0f, 0.0f, 0.0f, sigma};
  const LmOptions o = {max_iterations,      initial_regularizer, function_tolerance,
                       parameter_tolerance, affine_reg_a,        affine_reg_b,
                       reg_decrease,        reg_increase};
  align_level_kernel<<<num_hyp, align::kThreads, 0, (cudaStream_t)stream>>>(
      prob, o, pose_q, pose_t, affine, ref, out_q, out_t, out_affine, out_e, out_n,
      out_rmse, out_iters, trace);
  return (int)cudaGetLastError();
}
