// K10 ba_lm: the control of the windowed BA's Levenberg-Marquardt loop, kept
// on the device so that the host never reads a flag; and ba_solve_loop, the
// whole solve issued by one C call.
//
// Replaces the loop of dsopp_tpu/solvers/pba.py::_solve_loop_device (a
// lax.while_loop there): the energy of a trial evaluation (_energy_from_ev:
// sum of the patch energies, the count of positive ones, the affine prior
// energy, the ledger quadratic in f64), the accept / done decision with
// forced accepts for the first iterations, the function and parameter
// tolerances, the regularizer update, the commit of the trial state, the fold
// of eps into the linearization point while the ledger is empty, and after the
// loop the fold of the newest frame.
//
// ba_solve_loop issues on the caller's stream the fixed sequence of the JAX
// function's one program, calling the other kernels' C entries (linked into
// the same library): K7 on the initial state, K10's phase 0, then
// max_iterations times K8 (linearize, the FEJ formed inside), K9 (solve
// step), K7 (evaluate the trial), K10's phase 1; K10's phase 2; K7 at the
// final state and K11 (point status).  It allocates nothing and reads
// nothing back from the device; it counts each entry's successful calls into
// a host array, which the caller adds to the entries' launch counts.  The
// loop's state is nine words in device memory (ba_lm_state.cuh); the other
// kernels read it and return at once when the loop is done.
//
// Two evaluation buffers: the state's kLmCarried word names the one that
// holds the carried evaluation; K7 writes each trial into the other one, K8
// reads the carried one, and an accepted step flips the word, so that no
// evaluation is copied.  Only the small state is committed by copy: eps,
// idepth, lin_idepth and the residual statuses (the accepted trial's
// candidates).
//
// A landmark-sharded solve (parallel/shard_map_ba.py) issues the same
// sequence from Python with all-reduces between the kernels: its ranks hold a
// slice of the landmark slots each, so the trial's landmark energy and count
// are sums over the ranks.  There ba_lm takes them as an f64 pair (`reduced`:
// sum of the patch energies, count of the positive ones), all-reduced across
// the shards, in place of its own sums, and rounds the energy to f32 once as
// it rounds its own sum; every other input of the decision (the ledger, eps,
// the step's norm) is the same on every rank, so every rank decides alike.
// With a null `reduced` the kernel sums the trial itself, as ba_solve_loop
// has it.
//
// Bound: latency (one block reduces K*K*N patch energies, 98 260 at K = 17,
// N = 340, then the commit of the small state, 0.4 MB at that point).  Design,
// one entry (ba_lm) with three phases:
//   phase 0 (init)   carry_kernel copies the window's linearization point,
//                    eps, idepth (twice: the state and lin_idepth) and
//                    statuses into the carried buffers (grid-stride), then
//                    decide_kernel on the initial evaluation (buffer 0): e, n,
//                    lambda, done = (n == 0), ledger_empty = (max |h_marg| ==
//                    0), carried = 0;
//   phase 1 (step)   decide_kernel on the trial buffer (one block: fixed-order
//                    reductions, then thread 0 decides and flips the carried
//                    word on accept, and the first K threads fold their frames
//                    when the step relinearizes), then commit_kernel
//                    (grid-stride): where accept is set, the trial eps, idepth
//                    and the now carried buffer's candidate statuses are
//                    copied over the carried ones;
//   phase 2 (finish) finish_kernel: the newest frame's eps folded into its
//                    linearization point.
// Every phase writes the state it leaves into row `iter` of a small log, so
// that a run can be compared with the host-driven loop after the fact.
//
// Sequence axis (seq_axis.cuh): every kernel has grid z a sequence, and
// ba_solve_loop issues the fixed sequence once for S sequences of one shape,
// each on its own grid index.  The window's fields (frame_valid, the ledger,
// the start of the carried state) are read at `seq[z]` of the stacked
// window; the carried state, the loop state [S, 9], its log [S, rows, 9],
// the evaluations and every buffer of the loop at z.  Each sequence's
// kernels read its own state word and return at once when it says done, so
// a sequence that converges early stops while the others iterate; the
// launches stay those of one sequence's call.

#include "ba_body.cuh"
#include "ba_entries.cuh"
#include "ba_lm_state.cuh"
#include "seq_axis.cuh"

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

// the carried state, which the loop updates in place
struct Carried {
  float* t_lin_q;
  float* t_lin_t;
  float* affine0;
  float* eps;
  float* idepth;
  float* lin_idepth;
  int* res_status;

  // sequence z's carried state
  __device__ Carried at(int z, int k, int n) const {
    const size_t kn = (size_t)k * n;
    return {seq::at(t_lin_q, z, 4 * k), seq::at(t_lin_t, z, 3 * k),
            seq::at(affine0, z, 2 * k), seq::at(eps, z, 8 * k),
            seq::at(idepth, z, kn),     seq::at(lin_idepth, z, kn),
            seq::at(res_status, z, kn * k)};
  }
};

// the window's fields the carried state starts from
struct Start {
  const float* t_lin_q;
  const float* t_lin_t;
  const float* affine0;
  const float* eps;
  const float* idepth;
  const int* res_status;

  // the window of sequence s
  __device__ Start at(int s, int k, int n) const {
    const size_t kn = (size_t)k * n;
    return {seq::at(t_lin_q, s, 4 * k), seq::at(t_lin_t, s, 3 * k), seq::at(affine0, s, 2 * k),
            seq::at(eps, s, 8 * k),     seq::at(idepth, s, kn),     seq::at(res_status, s, kn * k)};
  }
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
              const float* __restrict__ energy0, const float* __restrict__ energy1,
              const double* __restrict__ reduced, const float* __restrict__ step_sq,
              float* t_lin_q, float* t_lin_t,
              float* affine0, int* __restrict__ state, int* __restrict__ log, int log_rows,
              const int* __restrict__ bank_seq) {
  {
    const int z = blockIdx.z, sb = seq::of(bank_seq);
    const size_t kb = 8 * (size_t)k, groups = (size_t)k * k * n;
    frame_valid = seq::at(frame_valid, sb, k);
    h_marg = seq::at(h_marg, sb, kb * kb);
    b_marg = seq::at(b_marg, sb, kb);
    energy_marg = seq::at(energy_marg, sb, 1);
    trial_eps = seq::at(trial_eps, z, kb);
    energy0 = seq::at(energy0, z, groups);
    energy1 = seq::at(energy1, z, groups);
    reduced = seq::at(reduced, z, 2);
    step_sq = seq::at(step_sq, z, 2);
    t_lin_q = seq::at(t_lin_q, z, 4 * k);
    t_lin_t = seq::at(t_lin_t, z, 3 * k);
    affine0 = seq::at(affine0, z, 2 * k);
    state = seq::at(state, z, kLmFields);
    log = seq::at(log, z, (size_t)log_rows * kLmFields);
  }
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

  // the trial: the initial evaluation (buffer 0) in phase 0, else the
  // buffer that does not hold the carried evaluation
  const int carried = phase == 0 ? 1 : state[kLmCarried];
  const float* __restrict__ trial_energy = carried ? energy0 : energy1;

  // landmark energy and the count of positive patch energies: the trial's
  // own, or the pair summed over the landmark shards
  float e_land;
  int n_new;
  if (reduced != nullptr) {
    e_land = (float)reduced[0];
    n_new = (int)reduced[1];
  } else {
    const int groups = k * k * n;
    double e_part = 0.0, n_part = 0.0;
    for (int g = tid; g < groups; g += kDecideThreads) {
      const float e = trial_energy[g];
      e_part += (double)e;
      n_part += e > 0.0f ? 1.0 : 0.0;
    }
    e_land = (float)block_sum(e_part, scratch);
    n_new = (int)block_sum(n_part, scratch);
  }

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
      state[kLmCarried] = 0;
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
      // the accepted trial's buffer now holds the carried evaluation
      if (accept) state[kLmCarried] = 1 - carried;
      relin_s = relin;
    }
  }
  __syncthreads();
  if (tid < kLmFields) log_row[tid] = state[tid];
  // relinearize: fold the accepted eps into every frame's linearization point
  // (commit_kernel then zeroes eps and moves lin_idepth)
  if (relin_s && tid < k) fold_frame(t_lin_q, t_lin_t, affine0, trial_eps, tid);
}

__global__ void carry_kernel(int k, int n, Start src, Carried dst,
                             const int* __restrict__ bank_seq) {
  src = src.at(seq::of(bank_seq), k, n);
  dst = dst.at(blockIdx.z, k, n);
  const int total = max(k * k * n, 8 * k);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    if (i < k * k * n) dst.res_status[i] = src.res_status[i];
    if (i < k * n) dst.idepth[i] = dst.lin_idepth[i] = src.idepth[i];
    if (i < k * 8) dst.eps[i] = src.eps[i];
    if (i < k * 4) dst.t_lin_q[i] = src.t_lin_q[i];
    if (i < k * 3) dst.t_lin_t[i] = src.t_lin_t[i];
    if (i < k * 2) dst.affine0[i] = src.affine0[i];
  }
}

__global__ void commit_kernel(int k, int n, const int* __restrict__ state,
                              const float* __restrict__ trial_eps,
                              const float* __restrict__ trial_idepth,
                              const int* __restrict__ candidate0,
                              const int* __restrict__ candidate1, Carried c) {
  {
    const int z = blockIdx.z;
    const size_t kn = (size_t)k * n;
    state = seq::at(state, z, kLmFields);
    trial_eps = seq::at(trial_eps, z, 8 * k);
    trial_idepth = seq::at(trial_idepth, z, kn);
    candidate0 = seq::at(candidate0, z, kn * k);
    candidate1 = seq::at(candidate1, z, kn * k);
    c = c.at(z, k, n);
  }
  if (!state[kLmAccept]) return;
  const bool relin = state[kLmRelin] != 0;
  // the committed statuses are the accepted trial's candidates, in the buffer
  // that now holds the carried evaluation
  const int* __restrict__ candidate = state[kLmCarried] ? candidate1 : candidate0;
  const int total = max(k * k * n, 8 * k);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    if (i < k * k * n) c.res_status[i] = candidate[i];
    if (i < k * n) {
      c.idepth[i] = trial_idepth[i];
      if (relin) c.lin_idepth[i] = trial_idepth[i];
    }
    if (i < k * 8) c.eps[i] = relin ? 0.0f : trial_eps[i];
  }
}

__global__ void finish_kernel(int iter, int k, const unsigned char* __restrict__ frame_valid,
                              float* t_lin_q, float* t_lin_t, float* affine0, float* eps,
                              const int* __restrict__ state, int* __restrict__ log,
                              float* __restrict__ energy_out, int* __restrict__ count_out,
                              int log_rows, const int* __restrict__ bank_seq) {
  {
    const int z = blockIdx.z;
    frame_valid = seq::at(frame_valid, seq::of(bank_seq), k);
    t_lin_q = seq::at(t_lin_q, z, 4 * k);
    t_lin_t = seq::at(t_lin_t, z, 3 * k);
    affine0 = seq::at(affine0, z, 2 * k);
    eps = seq::at(eps, z, 8 * k);
    state = seq::at(state, z, kLmFields);
    log = seq::at(log, z, (size_t)log_rows * kLmFields);
    energy_out = seq::at(energy_out, z, 1);
    count_out = seq::at(count_out, z, 1);
  }
  if (threadIdx.x < kLmFields) log[iter * kLmFields + threadIdx.x] = state[threadIdx.x];
  if (threadIdx.x != 0) return;
  if (energy_out != nullptr) {
    *energy_out = __int_as_float(state[kLmEnergy]);
    *count_out = state[kLmCount];
  }
  int newest = -1;
  for (int f = 0; f < k; ++f) newest += frame_valid[f] ? 1 : 0;
  if (newest < 0) return;
  fold_frame(t_lin_q, t_lin_t, affine0, eps, newest);
  for (int c = 0; c < 8; ++c) eps[8 * newest + c] = 0.0f;
}

// grid of the grid-stride copies
inline int copy_blocks(int k, int n) { return min((max(k * k * n, 8 * k) + 255) / 256, 1024); }

}  // namespace

// phase 0 init, 1 step, 2 finish.  Window: frame_valid [k] u8; ledger h_marg
// [8k,8k], b_marg [8k], energy_marg [1] f64.  Trial: eps [k,8], idepth [k,n],
// step_sq [2] (ba_solve_step).  The two evaluation buffers' energy_patch
// [k,k,n] and status_candidate [k,k,n] int32 (phase 0 decides on buffer 0).
// reduced: null, or the trial's (sum of patch energies, count of positive
// ones) [2] f64, summed over the landmark shards, taken in place of the
// kernel's own sums (phases 0 and 1).  Start (phase 0 only, else may be null): the window's t_lin_q [k,4], t_lin_t
// [k,3], affine0 [k,2], eps [k,8], lm_idepth [k,n] and res_status [k,k,n]
// int32.  Carried, updated in place (phase 0 writes them from the start):
// t_lin_q, t_lin_t, affine0, eps, idepth and lin_idepth [k,n], res_status.
// state: int32 [9] (ba_lm_state.cuh); log: int32 [rows, 9], row `iter` is
// written.  Phase 2 also writes the loop's energy [1] f32 and count [1]
// int32 where energy_out and count_out are given.  log_rows: the rows of a
// sequence's log.  Sequence axis (seq_axis.cuh): `seqs` sequences, grid z;
// frame_valid, the ledger and the start are [B, ...] stacks read at
// bank_seq[z] (null: z); reduced, the trial, the evaluations, the carried
// state, state, log and the two outputs are [seqs, ...] at z.  Returns
// cudaErrorInvalidValue (1) for k above 40 or a row outside the log.
extern "C" int ba_lm(int phase, int iter, int k, int n, int min_iterations, int force_accept,
                     float initial_regularizer, float function_tolerance,
                     float parameter_tolerance, float reg_decrease, float reg_increase,
                     float affine_reg_a, float affine_reg_b,
                     const unsigned char* frame_valid, const double* h_marg,
                     const double* b_marg, const double* energy_marg,
                     const float* trial_eps, const float* trial_idepth, const float* step_sq,
                     const float* energy0, const int* candidate0, const float* energy1,
                     const int* candidate1, const double* reduced, const float* start_t_lin_q,
                     const float* start_t_lin_t, const float* start_affine0,
                     const float* start_eps, const float* start_idepth,
                     const int* start_res_status, float* t_lin_q, float* t_lin_t,
                     float* affine0, float* eps, float* idepth, float* lin_idepth,
                     int* res_status, int* state, int* log, float* energy_out, int* count_out,
                     int log_rows, int seqs, const int* bank_seq, void* stream) {
  if (k < 1 || k * 8 > kMaxKb || n < 1 || phase < 0 || phase > 2 || iter < 0 ||
      iter >= log_rows || !seq::valid_count(seqs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Carried c = {t_lin_q, t_lin_t, affine0, eps, idepth, lin_idepth, res_status};
  if (phase == 2) {
    finish_kernel<<<dim3(1, 1, seqs), 32, 0, s>>>(iter, k, frame_valid, t_lin_q, t_lin_t,
                                                  affine0, eps, state, log, energy_out,
                                                  count_out, log_rows, bank_seq);
    return (int)cudaGetLastError();
  }
  if (phase == 0) {
    const Start src = {start_t_lin_q, start_t_lin_t, start_affine0,
                       start_eps,     start_idepth,  start_res_status};
    carry_kernel<<<dim3(copy_blocks(k, n), 1, seqs), 256, 0, s>>>(k, n, src, c, bank_seq);
    // the initial decision's state: the carried copy of the window's, which
    // lies at z as every trial does
    trial_eps = eps;
  }
  const LmOptions o = {min_iterations,      force_accept,        initial_regularizer,
                       function_tolerance,  parameter_tolerance, reg_decrease,
                       reg_increase,        affine_reg_a,        affine_reg_b};
  decide_kernel<<<dim3(1, 1, seqs), kDecideThreads, 0, s>>>(
      phase, iter, k, n, o, frame_valid, h_marg, b_marg, energy_marg, trial_eps, energy0,
      energy1, reduced, step_sq, t_lin_q, t_lin_t, affine0, state, log, log_rows, bank_seq);
  if (phase == 1)
    commit_kernel<<<dim3(copy_blocks(k, n), 1, seqs), 256, 0, s>>>(
        k, n, state, trial_eps, trial_idepth, candidate0, candidate1, c);
  return (int)cudaGetLastError();
}

// The steps of ba_solve_loop, as its error code names them (solvers/pba.py
// mirrors them in _SOLVE_LOOP_STEPS): a failure returns (step << 16) | the
// CUDA error, with step 0 the entry's own argument check
enum SolveStep {
  kStepArguments = 0,
  kStepEvaluateInitial = 1,
  kStepLmInit = 2,
  kStepLinearize = 3,
  kStepSolve = 4,
  kStepEvaluateTrial = 5,
  kStepLmStep = 6,
  kStepLmFinish = 7,
  kStepEvaluateFinal = 8,
  kStepPointStatus = 9,
};

// The entries ba_solve_loop calls, in the order of its host array of launch
// counts (solvers/pba.py mirrors them in _SOLVE_LOOP_COUNTED)
enum SolveCount {
  kCountEvaluate = 0,
  kCountLinearize = 1,
  kCountSolve = 2,
  kCountLm = 3,
  kCountStatus = 4,
};
constexpr int kSolveCounts = 5;

// The whole windowed-BA solve (solvers/pba.py::_solve_loop_cuda) in one call.
// Window: t_lin_q [k,4], t_lin_t [k,3], affine0 [k,2], eps [k,8], exposure
// [k], lm_uv [k,n,2], lm_idepth [k,n], lm_patch [k,n,C*8], lm_valid [k,n] u8,
// frame_valid, frame_fixed, frame_marg [k] u8, res_status [k,k,n] int32, the
// ledger h_marg [8k,8k], b_marg [8k], energy_marg [1] f64, the channel
// planes (as ba_evaluate), lm_baseline [k,n], lm_outlier [k,n] u8,
// lm_opt_count [k,n] int32.  sigma: K7's Huber sigma of C channels;
// status_sigma: K11's.  Outputs: the carried state (c_*: the solved
// linearization point, eps and idepth; lin_idepth and res_status are the
// loop's), the two evaluation buffers (ev0_*, ev1_*: K7's outputs), mask
// [k,n] u8 (lm_valid & frame_valid), K8's scratch and outputs, K9's scratch
// and outputs, the loop state [9] and log [max_iterations + 2, 9] int32, the
// loop's energy [1] f32 and count [1] int32 (the state's words), K11's
// workspace and candidates (as ba_point_status takes them), and K11's outputs
// (the solved window's statuses, baselines, inlier counts, outlier flags and
// optimization counts).  Every output is written before it
// is read: the caller passes torch.empty buffers.  launched [5] int32, host
// memory: set to 0, then each entry's successful calls (SolveCount's order),
// also when a later step fails.  Sequence axis (seq_axis.cuh): `seqs`
// sequences of one shape in one call, one launch per kernel for all of them;
// every window argument above is a [B, ...] stack read at seq_list[z] (null:
// z), every output and buffer is [seqs, ...] (K11's workspace a header a
// sequence, its candidates k k n words a sequence), and the log is [seqs, max_iterations + 2, 9].
extern "C" int ba_solve_loop(
    const float* t_lin_q, const float* t_lin_t, const float* affine0, const float* eps,
    const float* exposure, const float* lm_uv, const float* lm_idepth, const float* lm_patch,
    const unsigned char* lm_valid, const unsigned char* frame_valid,
    const unsigned char* frame_fixed, const unsigned char* frame_marg, const int* res_status,
    const double* h_marg, const double* b_marg, const double* energy_marg, const float* images,
    int image_stride, const float* lm_baseline, const unsigned char* lm_outlier,
    const int* lm_opt_count, int k, int n, int h, int w, int channels, float fx, float fy,
    float cx, float cy, float width, float height, int max_iterations, int min_iterations,
    int force_accept, float initial_regularizer, float function_tolerance,
    float parameter_tolerance, float reg_decrease, float reg_increase, float affine_reg_a,
    float affine_reg_b, float fixed_reg, float idepth_threshold, float scale_reg, float sigma,
    float status_sigma, float quantile, int min_valid, float* c_t_lin_q, float* c_t_lin_t,
    float* c_affine0, float* c_eps, float* c_idepth, float* c_lin_idepth, int* c_res_status,
    float* ev0_residuals, float* ev0_energy, float* ev0_weight, int* ev0_candidate,
    float* ev0_gx, float* ev0_gy, unsigned char* ev0_ok, float* ev1_residuals,
    float* ev1_energy, float* ev1_weight, int* ev1_candidate, float* ev1_gx, float* ev1_gy,
    unsigned char* ev1_ok, unsigned char* mask, int tiles, double* pair_part, float* lm_part,
    double* schur_part, float* h_pose, float* b_pose, float* h_schur, float* b_schur,
    float* hpd, float* inv_hdd, float* b_d, int blocks, float* step, float* d_part, double* system,
    float* eps_new, float* idepth_new, float* step_sq, int* state, int* log, float* energy,
    int* count, void* status_workspace, int status_workspace_bytes,
    unsigned int* status_candidates, float* thresh,
    int* new_status, float* baseline, int* inliers, unsigned char* outlier, int* opt_count,
    int seqs, const int* seq_list, int* launched, void* stream) {
  auto failed = [](int step, int err) { return (step << 16) | err; };
  if (launched == nullptr) return failed(kStepArguments, (int)cudaErrorInvalidValue);
  for (int i = 0; i < kSolveCounts; ++i) launched[i] = 0;
  if (k < 1 || k * 8 > kMaxKb || n < 1 || channels < 1 || max_iterations < 0 ||
      !seq::valid_count(seqs))
    return failed(kStepArguments, (int)cudaErrorInvalidValue);
  const int rows = max_iterations + 2;  // a sequence's log
  int err;
  // the state K7 evaluates into both buffers' pointers; K8 reads the carried
#define EV0 ev0_residuals, ev0_energy, ev0_weight, ev0_candidate, ev0_gx, ev0_gy, ev0_ok
#define EV1 ev1_residuals, ev1_energy, ev1_weight, ev1_candidate, ev1_gx, ev1_gy, ev1_ok
#define CAM fx, fy, cx, cy, width, height
#define LM_OPTS                                                                          \
  min_iterations, force_accept, initial_regularizer, function_tolerance, parameter_tolerance, \
      reg_decrease, reg_increase, affine_reg_a, affine_reg_b
#define CARRIED c_t_lin_q, c_t_lin_t, c_affine0, c_eps, c_idepth, c_lin_idepth, c_res_status
  // 1. the initial evaluation, into buffer 0, and the active landmark mask
  err = ba_evaluate(t_lin_q, t_lin_t, eps, affine0, exposure, lm_uv, lm_idepth, lm_patch,
                    lm_valid, frame_valid, res_status, images, image_stride, k, n, h, w,
                    channels, CAM, sigma, nullptr, EV0, EV1, mask, seqs, seq_list, seq_list,
                    stream);
  if (err) return failed(kStepEvaluateInitial, err);
  ++launched[kCountEvaluate];
  // 2. the carried state from the window, and the loop state from buffer 0
  err = ba_lm(0, 0, k, n, LM_OPTS, frame_valid, h_marg, b_marg, energy_marg, eps, lm_idepth,
              nullptr, ev0_energy, ev0_candidate, ev1_energy, ev1_candidate, nullptr, t_lin_q,
              t_lin_t, affine0, eps, lm_idepth, res_status, CARRIED, state, log, nullptr,
              nullptr, rows, seqs, seq_list, stream);
  if (err) return failed(kStepLmInit, err);
  ++launched[kCountLm];
  // 3. the iterations, each returning at once when the loop is done
  for (int it = 1; it <= max_iterations; ++it) {
    err = ba_linearize_schur(c_t_lin_q, c_t_lin_t, c_affine0, exposure, lm_uv, c_lin_idepth,
                             lm_patch, CAM, ev0_residuals, ev0_weight, ev0_gx, ev0_gy, ev0_ok,
                             ev1_residuals, ev1_weight, ev1_gx, ev1_gy, ev1_ok, c_eps,
                             frame_valid, frame_fixed, frame_marg, k, n, channels, 0,
                             idepth_threshold, scale_reg, fixed_reg, affine_reg_a, affine_reg_b,
                             tiles, state, pair_part, lm_part, schur_part, h_pose, b_pose,
                             h_schur, b_schur, hpd, inv_hdd, b_d, seqs, seq_list, nullptr,
                             stream);
    if (err) return failed(kStepLinearize, err);
    ++launched[kCountLinearize];
    err = ba_solve_step(h_pose, b_pose, h_schur, b_schur, h_marg, b_marg, c_eps, c_idepth,
                        frame_valid, hpd, inv_hdd, b_d, k, n, 0.0f, blocks, state, step, d_part,
                        system, eps_new, idepth_new, step_sq, seqs, seq_list, nullptr, stream);
    if (err) return failed(kStepSolve, err);
    ++launched[kCountSolve];
    err = ba_evaluate(c_t_lin_q, c_t_lin_t, eps_new, c_affine0, exposure, lm_uv, idepth_new,
                      lm_patch, lm_valid, frame_valid, c_res_status, images, image_stride, k, n,
                      h, w, channels, CAM, sigma, state, EV0, EV1, nullptr, seqs, seq_list,
                      nullptr, stream);
    if (err) return failed(kStepEvaluateTrial, err);
    ++launched[kCountEvaluate];
    err = ba_lm(1, it, k, n, LM_OPTS, frame_valid, h_marg, b_marg, energy_marg, eps_new,
                idepth_new, step_sq, ev0_energy, ev0_candidate, ev1_energy, ev1_candidate,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, CARRIED, state,
                log, nullptr, nullptr, rows, seqs, seq_list, stream);
    if (err) return failed(kStepLmStep, err);
    ++launched[kCountLm];
  }
  // 4. the newest frame's increment folded into its linearization point
  err = ba_lm(2, max_iterations + 1, k, n, LM_OPTS, frame_valid, h_marg, b_marg, energy_marg,
              c_eps, c_idepth, nullptr, ev0_energy, ev0_candidate, ev1_energy, ev1_candidate,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, CARRIED, state, log,
              energy, count, rows, seqs, seq_list, stream);
  if (err) return failed(kStepLmFinish, err);
  ++launched[kCountLm];
  // 5. the point statuses from an evaluation at the solved state (buffer 0)
  err = ba_evaluate(c_t_lin_q, c_t_lin_t, c_eps, c_affine0, exposure, lm_uv, c_idepth,
                    lm_patch, lm_valid, frame_valid, c_res_status, images, image_stride, k, n,
                    h, w, channels, CAM, sigma, nullptr, EV0, EV1, nullptr, seqs, seq_list,
                    nullptr, stream);
  if (err) return failed(kStepEvaluateFinal, err);
  ++launched[kCountEvaluate];
  err = ba_point_status(ev0_energy, ev0_ok, ev0_candidate, c_t_lin_q, c_t_lin_t, c_eps,
                        c_idepth, mask, lm_baseline, lm_outlier, lm_opt_count, k, n, quantile,
                        status_sigma, min_valid, status_workspace, status_workspace_bytes,
                        status_candidates, thresh,
                        new_status, baseline, inliers, outlier, opt_count, seqs, seq_list,
                        nullptr, stream);
  if (err) return failed(kStepPointStatus, err);
  ++launched[kCountStatus];
#undef EV0
#undef EV1
#undef CAM
#undef LM_OPTS
#undef CARRIED
  return 0;
}
