// K10 ba_lm: the control of the windowed BA's Levenberg-Marquardt loop, kept
// on the device so that the host never reads a flag.
//
// Replaces the loop of dsopp_tpu/solvers/pba.py::_solve_loop_device (a
// lax.while_loop there): the energy of a trial evaluation (_energy_from_ev:
// sum of the patch energies, the count of positive ones, the affine prior
// energy, the ledger quadratic in f64), the accept / done decision with
// forced accepts for the first iterations, the function and parameter
// tolerances, the regularizer update, the select-commit of the trial state
// and its evaluation, the fold of eps into the linearization point while the
// ledger is empty, and after the loop the fold of the newest frame.
//
// The host launches the same sequence opts.max_iterations times: K8
// (linearize, the FEJ formed inside), K9 (solve step), K7 (evaluate the
// trial), then this entry.
// The loop's state is eight words in device memory (ba_lm_state.cuh); the
// other kernels read it and return at once when the loop is done.
//
// Bound: latency (a reduction over K*K*N patch energies, 98 260 at K = 17,
// N = 340, and a copy of the evaluation, 11 MB at C = 1; its residuals and
// gradients carry C channels, K*K*N*C*8 values each).  Design, one entry with
// three phases:
//   phase 0 (init)   decide_kernel on the initial evaluation: e, n, lambda,
//                    done = (n == 0), ledger_empty = (max |h_marg| == 0);
//   phase 1 (step)   decide_kernel on the trial (one block: fixed-order
//                    reductions, then thread 0 decides and the first K
//                    threads fold their frames when the step relinearizes),
//                    then commit_kernel (grid-stride): where accept is set,
//                    the trial eps, idepth, statuses and evaluation are
//                    copied over the carried ones;
//   phase 2 (finish) finish_kernel: the newest frame's eps folded into its
//                    linearization point.
// Every phase writes the state it leaves into row `iter` of a small log, so
// that a run can be compared with the host-driven loop after the fact.

#include "ba_body.cuh"
#include "ba_lm_state.cuh"

namespace {

using namespace ba;

constexpr int kDecideThreads = 1024;
constexpr int kDecideWarps = kDecideThreads / 32;
constexpr int kMaxKb = 40 * 8;  // as ba_linearize.cu's kMaxFrames

struct LmOptions {
  int min_iterations, force_accept;
  float initial_regularizer, function_tolerance, parameter_tolerance;
  float reg_decrease, reg_increase, affine_reg_a, affine_reg_b;
};

struct EvPtrs {
  float* residuals;
  float* energy_patch;
  float* weight;
  int* status_candidate;
  float* gx;
  float* gy;
  unsigned char* ok;
};

// sum over the block in a fixed order: butterfly in a warp, warps in index order
__device__ double block_sum(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  __syncthreads();  // scratch may still be read from an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < kDecideWarps; ++w) total += scratch[w];
  return total;
}

// T_lin[f] <- T_lin[f] exp(eps[f, :6]); affine0[f] += eps[f, 6:]
__device__ void fold_frame(float* t_lin_q, float* t_lin_t, float* affine0, const float* eps,
                           int f) {
  const Rigid t = frame_pose(t_lin_q, t_lin_t, eps, f);
  t_lin_q[4 * f] = t.q.w;
  t_lin_q[4 * f + 1] = t.q.x;
  t_lin_q[4 * f + 2] = t.q.y;
  t_lin_q[4 * f + 3] = t.q.z;
  t_lin_t[3 * f] = t.t.x;
  t_lin_t[3 * f + 1] = t.t.y;
  t_lin_t[3 * f + 2] = t.t.z;
  affine0[2 * f] = affine0[2 * f] + eps[8 * f + 6];
  affine0[2 * f + 1] = affine0[2 * f + 1] + eps[8 * f + 7];
}

__global__ void __launch_bounds__(kDecideThreads)
decide_kernel(int phase, int iter, int k, int n, LmOptions o,
              const unsigned char* __restrict__ frame_valid,
              const double* __restrict__ h_marg, const double* __restrict__ b_marg,
              const double* __restrict__ energy_marg, const float* __restrict__ trial_eps,
              const float* __restrict__ trial_energy, const float* __restrict__ step_sq,
              float* t_lin_q, float* t_lin_t, float* affine0, int* __restrict__ state,
              int* __restrict__ log) {
  __shared__ double scratch[kDecideWarps];
  __shared__ double hs[kMaxKb];
  __shared__ int relin_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kb = k * 8;
  int* log_row = log + iter * kLmFields;

  if (phase == 1 && state[kLmDone]) {
    // the loop has ended: nothing is accepted, nothing relinearized
    if (tid == 0) {
      state[kLmAccept] = 0;
      state[kLmRelin] = 0;
    }
    if (tid < kLmFields) log_row[tid] = (tid == kLmAccept || tid == kLmRelin) ? 0 : state[tid];
    return;
  }

  // landmark energy and the count of positive patch energies
  const int groups = k * k * n;
  double e_part = 0.0, n_part = 0.0;
  for (int g = tid; g < groups; g += kDecideThreads) {
    const float e = trial_energy[g];
    e_part += (double)e;
    n_part += e > 0.0f ? 1.0 : 0.0;
  }
  const float e_land = (float)block_sum(e_part, scratch);
  const int n_new = (int)block_sum(n_part, scratch);

  // ledger quadratic (e_m + b_m s) + 0.5 s (H_m s) in f64, s = eps; and
  // whether the ledger is empty
  double nonzero = 0.0;
  for (int r = warp; r < kb; r += kDecideWarps) {
    double acc = 0.0;
    for (int c = lane; c < kb; c += 32) {
      const double h = h_marg[(size_t)r * kb + c];
      acc += h * (double)trial_eps[c];
      nonzero += h != 0.0 ? 1.0 : 0.0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) hs[r] = acc;
  }
  const bool ledger_empty = block_sum(nonzero, scratch) == 0.0;  // syncs: hs is visible
  double bs = 0.0, shs = 0.0;
  for (int r = tid; r < kb; r += kDecideThreads) {
    bs += b_marg[r] * (double)trial_eps[r];
    shs += (double)trial_eps[r] * hs[r];
  }
  bs = block_sum(bs, scratch);
  shs = block_sum(shs, scratch);

  if (tid == 0) {
    const double e_marg = (energy_marg[0] + bs) + 0.5 * shs;
    // _prior_energy: 0.5 sum over valid frames of reg (a0 + eps)^2
    float prior = 0.0f, state_sq = 0.0f;
    for (int f = 0; f < k; ++f) {
      const float a = affine0[2 * f] + trial_eps[8 * f + 6];
      const float b = affine0[2 * f + 1] + trial_eps[8 * f + 7];
      if (frame_valid[f]) {
        prior += (o.affine_reg_a * a) * a;
        prior += (o.affine_reg_b * b) * b;
      }
      for (int c = 0; c < 8; ++c) state_sq += trial_eps[8 * f + c] * trial_eps[8 * f + c];
    }
    const float e_new = (e_land + 0.5f * prior) + (float)e_marg;

    if (phase == 0) {
      state[kLmEnergy] = __float_as_int(e_new);
      state[kLmLambda] = __float_as_int(o.initial_regularizer);
      state[kLmCount] = n_new;
      state[kLmIter] = 0;
      state[kLmAccept] = 0;
      state[kLmDone] = n_new == 0;
      state[kLmRelin] = 0;
      state[kLmLedgerEmpty] = ledger_empty;
      relin_s = 0;
    } else {
      const float e = __int_as_float(state[kLmEnergy]);
      float lam = __int_as_float(state[kLmLambda]);
      const int it = state[kLmIter];
      const bool ftol = fabsf(e - e_new) / fmaxf(e, 1e-30f) < o.function_tolerance;
      const bool ok = n_new > 0 && isfinite(e_new);
      const bool forced = o.force_accept && it < o.min_iterations;
      const bool accept = (e_new < e || forced) && ok;
      const bool ptol = (step_sq[0] + step_sq[1]) <
                        o.parameter_tolerance * (state_sq + o.parameter_tolerance);
      bool done = ftol || (accept && ptol);
      if (o.force_accept) done = done || !accept;
      if (accept) {
        state[kLmEnergy] = __float_as_int(e_new);
        state[kLmCount] = n_new;
        lam = lam / o.reg_decrease;
      } else {
        lam = lam * o.reg_increase;
      }
      const bool relin = accept && state[kLmLedgerEmpty] && !done;
      state[kLmLambda] = __float_as_int(lam);
      state[kLmIter] = it + 1;
      state[kLmAccept] = accept;
      state[kLmDone] = done;
      state[kLmRelin] = relin;
      relin_s = relin;
    }
  }
  __syncthreads();
  if (tid < kLmFields) log_row[tid] = state[tid];
  // relinearize: fold the accepted eps into every frame's linearization point
  // (commit_kernel then zeroes eps and moves lin_idepth)
  if (relin_s && tid < k) fold_frame(t_lin_q, t_lin_t, affine0, trial_eps, tid);
}

__global__ void commit_kernel(int k, int n, int channels, const int* __restrict__ state,
                              const float* __restrict__ trial_eps,
                              const float* __restrict__ trial_idepth, EvPtrs trial,
                              float* __restrict__ eps, float* __restrict__ idepth,
                              float* __restrict__ lin_idepth, int* __restrict__ res_status,
                              EvPtrs ev) {
  if (!state[kLmAccept]) return;
  const bool relin = state[kLmRelin] != 0;
  const int groups = k * k * n;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < groups * channels * kPattern;
       i += stride) {
    ev.residuals[i] = trial.residuals[i];
    ev.gx[i] = trial.gx[i];
    ev.gy[i] = trial.gy[i];
    if (i < groups) {
      // the committed statuses are the trial's candidates
      res_status[i] = trial.status_candidate[i];
      ev.status_candidate[i] = trial.status_candidate[i];
      ev.energy_patch[i] = trial.energy_patch[i];
      ev.weight[i] = trial.weight[i];
      ev.ok[i] = trial.ok[i];
    }
    if (i < k * n) {
      idepth[i] = trial_idepth[i];
      if (relin) lin_idepth[i] = trial_idepth[i];
    }
    if (i < k * 8) eps[i] = relin ? 0.0f : trial_eps[i];
  }
}

__global__ void finish_kernel(int iter, int k, const unsigned char* __restrict__ frame_valid,
                              float* t_lin_q, float* t_lin_t, float* affine0, float* eps,
                              const int* __restrict__ state, int* __restrict__ log) {
  if (threadIdx.x < kLmFields) log[iter * kLmFields + threadIdx.x] = state[threadIdx.x];
  if (threadIdx.x != 0) return;
  int newest = -1;
  for (int f = 0; f < k; ++f) newest += frame_valid[f] ? 1 : 0;
  if (newest < 0) return;
  fold_frame(t_lin_q, t_lin_t, affine0, eps, newest);
  for (int c = 0; c < 8; ++c) eps[8 * newest + c] = 0.0f;
}

}  // namespace

// phase 0 init (trial = the initial eps and evaluation), 1 step, 2 finish.
// Window: frame_valid [k] u8; ledger h_marg [8k,8k], b_marg [8k], energy_marg
// [1] f64.  Trial: eps [k,8], idepth [k,n], step_sq [2] (ba_solve_step) and
// an evaluation as ba_evaluate writes it.  Carried, updated in place: t_lin_q
// [k,4], t_lin_t [k,3], affine0 [k,2], eps [k,8], idepth and lin_idepth
// [k,n], res_status [k,k,n] int32 and the carried evaluation (C channels).  state: int32
// [8] (ba_lm_state.cuh); log: int32 [rows, 8], row `iter` is written.
// Returns cudaErrorInvalidValue (1) for k above 40.
extern "C" int ba_lm(int phase, int iter, int k, int n, int channels, int min_iterations,
                     int force_accept,
                     float initial_regularizer, float function_tolerance,
                     float parameter_tolerance, float reg_decrease, float reg_increase,
                     float affine_reg_a, float affine_reg_b,
                     const unsigned char* frame_valid, const double* h_marg,
                     const double* b_marg, const double* energy_marg,
                     const float* trial_eps, const float* trial_idepth, const float* step_sq,
                     float* trial_residuals, float* trial_energy, float* trial_weight,
                     int* trial_candidate, float* trial_gx, float* trial_gy,
                     unsigned char* trial_ok, float* t_lin_q, float* t_lin_t, float* affine0,
                     float* eps, float* idepth, float* lin_idepth, int* res_status,
                     float* residuals, float* energy_patch, float* weight,
                     int* status_candidate, float* gx, float* gy, unsigned char* ok,
                     int* state, int* log, void* stream) {
  if (k < 1 || k * 8 > kMaxKb || n < 1 || channels < 1 || phase < 0 || phase > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (phase == 2) {
    finish_kernel<<<1, 32, 0, s>>>(iter, k, frame_valid, t_lin_q, t_lin_t, affine0, eps, state,
                                   log);
    return (int)cudaGetLastError();
  }
  const LmOptions o = {min_iterations,      force_accept,        initial_regularizer,
                       function_tolerance,  parameter_tolerance, reg_decrease,
                       reg_increase,        affine_reg_a,        affine_reg_b};
  decide_kernel<<<1, kDecideThreads, 0, s>>>(phase, iter, k, n, o, frame_valid, h_marg, b_marg,
                                             energy_marg, trial_eps, trial_energy, step_sq,
                                             t_lin_q, t_lin_t, affine0, state, log);
  if (phase == 1) {
    const EvPtrs trial = {trial_residuals, trial_energy, trial_weight, trial_candidate,
                          trial_gx,        trial_gy,     trial_ok};
    const EvPtrs ev = {residuals, energy_patch, weight, status_candidate, gx, gy, ok};
    const int total = k * k * n * channels * ba::kPattern;
    const int blocks = min((total + 255) / 256, 1024);
    commit_kernel<<<blocks, 256, 0, s>>>(k, n, channels, state, trial_eps, trial_idepth, trial, eps,
                                         idepth, lin_idepth, res_status, ev);
  }
  return (int)cudaGetLastError();
}
