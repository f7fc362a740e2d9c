// K15 marg_fold: the marginalization fold into the float64 prior ledger.
//
// Replaces dsopp_tpu/solvers/pba.py::_marginalize_device after its
// marginalization pass (K7 and K8): the flagged landmarks' system
// (_marg_system_kernel's priors and subtractions) and the XLA program that
// folds, eliminates and permutes the ledger (the port's plain version is
// solvers/pba.py::_marginalize_plain).  With s = eps, K frame slots, the 8K
// state rows and the m flagged frames' 8m rows:
//  0. the flagged landmarks' system from K8's marginalization pass, in f32 as
//     torch forms it: H_pts = (H_pose − diag(d)) − H_schur, b_pts = (b_pose −
//     b_pr) − b_schur, with the flagged frames' priors (d, b_pr) of
//     _prior_system (affine 1e12 / 1e8 on a free frame, 1e16 on every entry
//     of a fixed one);
//  1. the landmark fold (DSO eq 8.15): h = (H_pts + H_ptsᵀ) / 2,
//     E_m += (E + sᵀhs) − sᵀb_pts, H_m += h, b_m += b_pts − hs;
//  2. the priors folded into H_m and b_m rebased at s;
//  3. the Schur elimination of the flagged rows e from the kept rows k:
//     X0 = pinv(H_ee), X = X0 + X0 (I − H_ee X0), h_kk = H_kk − H_ke X H_keᵀ,
//     b_k = b_k − H_ke X b_e, then (h_kk + h_kkᵀ) / 2;
//  4. the permutation of the kept 8-blocks by perm into the new ledger.
// The reference pseudo-inverts the 8K x 8K matrix H_ee padded with the
// identity, with the cutoff |λ| ≤ rtol · max|λ| (rtol = 10 · 8K · eps); the
// padding adds the eigenvalue 1 (there is always a kept frame), so here the
// compact 8m x 8m block is decomposed and the cutoff is rtol · max(1, max|λ|).
// The sign of λ is kept in 1/λ.
//
// Bound: bytes at one flagged frame (the two 8K x 8K f64 ledgers and the f32
// system: 1.1 MB at K = 17); with many flagged frames the f64 operations of
// the Jacobi sweeps and the products (O(n³), n = 8m) take over.  The time
// went to latency, not to either: at one flagged frame the Jacobi rounds, each
// four threads' rotations behind two barriers of 1024 threads, took 38-55 of
// 53-81 µs (testing/marg_phases.py).  Design, three kernels behind one entry,
// nothing read on the host (m is known on the device only), every sum in a
// fixed order (two runs agree to the bit):
//  1. fold_kernel, a block per frame slot (its 8 rows): the slot's row strip
//     and column strip of H_pose and H_schur staged in shared memory (the
//     transposed read as 32-byte runs), steps 0-2 into scratch; a thread per
//     row sums hs in ascending columns;
//  2. marg_solve_kernel, one block: the flagged rows (slot order, by a
//     ballot), the compact block, a cyclic parallel-order (round-robin) Jacobi
//     eigen-solver in f64 — each 2 x 2 block of a round's disjoint rotations
//     owned by one thread, so the matrix stays exactly symmetric — then X0,
//     the Newton step and the correction H_ke X.  Up to 32 flagged rows (four
//     frames) the rounds run in warp 0 alone, with __syncwarp between them,
//     while warp 1 sums the energy, and the matrices lie in shared memory;
//     above, every thread takes part in each round behind block barriers
//     (the compact block in shared memory, its eigenvectors there when both
//     fit, else in global memory).  Either way a rotation and an update use
//     the same formulas on the same values, so the bits do not depend on
//     which thread computes them;
//  3. fold_out_kernel, one thread per entry of the new ledger: its source
//     entry and the transposed one, each less its correction, their mean,
//     and b.
// Sequence axis (seq_axis.cuh): every kernel has grid z a sequence (one
// solve block each); the window's eps, affine0, frame flags and ledger are
// [B, ...] stacks read at `seq[z]`, the system, the energy, perm, the scratch
// and the outputs [S, ...] at z.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "seq_axis.cuh"

namespace {

constexpr int kBlock = 8;        // state rows per frame: 6 pose + 2 affine
constexpr int kMaxFrames = 40;
constexpr int kMaxRows = kMaxFrames * kBlock;
constexpr int kFoldThreads = 256;
constexpr int kFoldPer = kBlock * kMaxRows / kFoldThreads;  // a thread's strip entries
constexpr int kSolveThreads = 1024;
constexpr int kOutThreads = 256;
constexpr int kMaxSweeps = 40;
constexpr int kWarpRows = 32;    // the most flagged rows the one-warp solver takes
constexpr int kSharedBudget = 200 * 1024;  // with ~15 KB of static shared memory
constexpr unsigned kFull = 0xffffffffu;
// a rotation is made where |a_pq| > kRotTol · sqrt(|a_pp a_qq|)
constexpr double kRotTol = 4.0 * DBL_EPSILON;

// Phase stamps, built only by testing/marg_phases.py (-DMARG_FOLD_STAMPS), never
// on the path: after a block barrier, thread 0 writes clock64() into stamp i
// (and %globaltimer into the first and the last, to convert cycles to ns).
#ifdef MARG_FOLD_STAMPS
constexpr int kStamps = 8;
__device__ long long g_stamps[kStamps + 2];
__device__ __forceinline__ void stamp(int i) {
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[i] = clock64();
    if (i == 0) g_stamps[kStamps] = t;
    g_stamps[kStamps + 1] = t;
  }
}
// ... and, in the Jacobi solver, thread 0's clock64() at four points of each
// of the first kRoundStamps rounds: its start, its rotation made, the vote,
// the update done (left 0 in a round without a rotation)
constexpr int kRoundStamps = 512;
__device__ long long g_rounds[kRoundStamps][4];
__device__ __forceinline__ void round_stamp(int at, int point) {
  if (threadIdx.x == 0 && at < kRoundStamps) g_rounds[at][point] = clock64();
}
#else
__device__ __forceinline__ void stamp(int) {}
__device__ __forceinline__ void round_stamp(int, int) {}
#endif

struct Frames {
  int rows;                         // 8K
  int n;                            // 8m, the flagged rows
  int marg_row[kMaxRows];           // compact index -> state row, slot order
  unsigned char keep[kMaxFrames];   // valid and not flagged
};

// warp 0 fills ``fr`` from the frame flags (a ballot of the flagged slots);
// the caller synchronises
__device__ void frames_of(const unsigned char* valid, const unsigned char* marg, int k,
                          Frames& fr) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int before = 0;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    const bool v = i < k && valid[i], m = i < k && marg[i];
    const unsigned flagged = __ballot_sync(kFull, v && m);
    if (i < k) {
      fr.keep[i] = (v && !m) ? 1 : 0;
      if (v && m) {
        const int at = (before + __popc(flagged & ((1u << lane) - 1u))) * kBlock;
        for (int c = 0; c < kBlock; ++c) fr.marg_row[at + c] = i * kBlock + c;
      }
    }
    before += __popc(flagged);
  }
  if (lane == 0) {
    fr.rows = k * kBlock;
    fr.n = before * kBlock;
  }
}

// the prior of state row r = (slot, c) as _prior_system computes it in f32
__device__ void prior_row(int r, const float* eps, const float* affine0,
                          const unsigned char* valid, const unsigned char* fixed,
                          const unsigned char* marg, float fixed_reg, float reg_a, float reg_b,
                          float& d, float& b) {
  const int slot = r / kBlock, c = r % kBlock;
  const bool sel = valid[slot] && marg[slot];
  const bool is_fixed = sel && fixed[slot];
  const bool is_free = sel && !fixed[slot];
  const float e = eps[r];
  float dv = is_fixed ? fixed_reg : 0.0f;
  float bv = is_fixed ? fixed_reg * e : 0.0f;
  float add_d = 0.0f, add_b = 0.0f;
  if (c >= 6 && is_free) {
    const float reg = c == 6 ? reg_a : reg_b;
    add_d = reg;
    add_b = reg * (affine0[slot * 2 + (c - 6)] + e);
  }
  d = dv + add_d;
  b = bv + add_b;
}

// round r of the circle schedule over n indices: pair t → (p, q), for
// 0 <= r, t < n - 1: (r + t) mod (n - 1) and (r − t) mod (n − 1)
__device__ __forceinline__ void round_pair(int n, int r, int t, int& p, int& q) {
  if (t == 0) {
    p = n - 1;
    q = r;
  } else {
    p = r + t;
    q = r - t + (n - 1);
    if (p >= n - 1) p -= n - 1;
    if (q >= n - 1) q -= n - 1;
  }
}

// the scratch (f64 words): H_m [rows, rows], b_m, hs, b_pts [rows], five
// [nmax, nmax] matrices (the compact block, its eigenvectors, X0, I − H_ee X0,
// X) and the correction [rows, nmax]
struct Scratch {
  double *hm, *bm, *hs, *bpts, *a, *v, *x0, *res, *x, *corr;
  __device__ Scratch(double* base, int rows, int nmax) {
    hm = base;
    bm = hm + (size_t)rows * rows;
    hs = bm + rows;
    bpts = hs + rows;
    a = bpts + rows;
    v = a + (size_t)nmax * nmax;
    x0 = v + (size_t)nmax * nmax;
    res = x0 + (size_t)nmax * nmax;
    x = res + (size_t)nmax * nmax;
    corr = x + (size_t)nmax * nmax;
  }
};

// a sequence's scratch words: solvers/pba.py::_marg_scratch_words
__device__ __forceinline__ size_t scratch_words(int k) {
  const size_t kb = (size_t)k * kBlock, n = (size_t)(k - 1) * kBlock;
  return kb * kb + 3 * kb + 5 * n * n + kb * n;
}

// steps 0-2 for the 8 rows of one frame slot
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const float* __restrict__ h_pose, const float* __restrict__ b_pose,
            const float* __restrict__ h_schur, const float* __restrict__ b_schur,
            const float* __restrict__ eps, const float* __restrict__ affine0,
            const unsigned char* __restrict__ valid, const unsigned char* __restrict__ fixed,
            const unsigned char* __restrict__ marg, const double* __restrict__ h_marg,
            const double* __restrict__ b_marg, int k, float fixed_reg, float reg_a,
            float reg_b, double* __restrict__ scratch, const int* __restrict__ bank_seq) {
  {
    const int z = blockIdx.z, sb = seq::of(bank_seq);
    const size_t kb = (size_t)k * kBlock;
    h_pose = seq::at(h_pose, z, kb * kb);
    b_pose = seq::at(b_pose, z, kb);
    h_schur = seq::at(h_schur, z, kb * kb);
    b_schur = seq::at(b_schur, z, kb);
    eps = seq::at(eps, sb, kb);
    affine0 = seq::at(affine0, sb, 2 * (size_t)k);
    valid = seq::at(valid, sb, k);
    fixed = seq::at(fixed, sb, k);
    marg = seq::at(marg, sb, k);
    h_marg = seq::at(h_marg, sb, kb * kb);
    b_marg = seq::at(b_marg, sb, kb);
    scratch = seq::at(scratch, z, scratch_words(k));
  }
  __shared__ float row_pts[kBlock][kMaxRows];   // H_pts[i, j], i of the slot
  __shared__ float col_pts[kBlock][kMaxRows];   // H_pts[j, i]
  __shared__ float s[kMaxRows];
  __shared__ float prior_d[kBlock], prior_b[kBlock];
  const int tid = threadIdx.x;
  const int rows = k * kBlock, nmax = (k - 1) * kBlock;
  const int i0 = blockIdx.x * kBlock;
  const int strip = kBlock * rows;
  Scratch sc(scratch, rows, nmax);
  // every load first: the thread's entries of the row strip (r, j) = (e /
  // rows, e % rows) and of the column strip (j, r) = (e / 8, e % 8), 32-byte
  // runs of the transposed read
  float pose_row[kFoldPer], schur_row[kFoldPer], pose_col[kFoldPer], schur_col[kFoldPer];
  double ledger_row[kFoldPer];
#pragma unroll
  for (int u = 0; u < kFoldPer; ++u) {
    const int e = tid + u * kFoldThreads;
    if (e < strip) {
      const size_t at = (size_t)(i0 + e / rows) * rows + e % rows;
      const size_t at_t = (size_t)(e / kBlock) * rows + i0 + e % kBlock;
      pose_row[u] = h_pose[at];
      schur_row[u] = h_schur[at];
      ledger_row[u] = h_marg[at];
      pose_col[u] = h_pose[at_t];
      schur_col[u] = h_schur[at_t];
    }
  }
  if (tid < kBlock)
    prior_row(i0 + tid, eps, affine0, valid, fixed, marg, fixed_reg, reg_a, reg_b,
              prior_d[tid], prior_b[tid]);
  for (int j = tid; j < rows; j += kFoldThreads) s[j] = eps[j];
  __syncthreads();
  // H_pts = (H_pose − diag(d)) − H_schur, entry by entry as torch subtracts
#pragma unroll
  for (int u = 0; u < kFoldPer; ++u) {
    const int e = tid + u * kFoldThreads;
    if (e < strip) {
      const int r = e / rows, j = e % rows;
      row_pts[r][j] = (pose_row[u] - (j == i0 + r ? prior_d[r] : 0.0f)) - schur_row[u];
      const int jc = e / kBlock, rc = e % kBlock;
      col_pts[rc][jc] = (pose_col[u] - (jc == i0 + rc ? prior_d[rc] : 0.0f)) - schur_col[u];
    }
  }
  __syncthreads();
  // 1-2. the landmark fold and the flagged frames' priors
#pragma unroll
  for (int u = 0; u < kFoldPer; ++u) {
    const int e = tid + u * kFoldThreads;
    if (e < strip) {
      const int r = e / rows, j = e % rows, i = i0 + r;
      const double v = ledger_row[u] + 0.5 * ((double)row_pts[r][j] + (double)col_pts[r][j]);
      const double d = j == i ? (double)prior_d[r] : 0.0;
      sc.hm[(size_t)i * rows + j] = v + d;
    }
  }
  if (tid < kBlock) {
    const int r = tid, i = i0 + r;
    double acc = 0.0;
    for (int j = 0; j < rows; ++j)
      acc += 0.5 * ((double)row_pts[r][j] + (double)col_pts[r][j]) * (double)s[j];
    const float b_pts = (b_pose[i] - prior_b[r]) - b_schur[i];
    sc.hs[i] = acc;
    sc.bpts[i] = (double)b_pts;
    const double si = (double)s[i];
    const double b1 = b_marg[i] + ((double)b_pts - acc);
    sc.bm[i] = b1 + ((double)prior_b[r] - (double)prior_d[r] * si);
  }
}

// one round of the Jacobi eigen-solver on the n x n matrix A (and its
// eigenvectors V) by the threads lane < lanes; ``sync`` orders the round's
// steps among them → whether a rotation was made.  In the update, index idx
// names A's 2 x 2 block (idx / pairs, idx % pairs) and V's entry (row idx /
// pairs, pair idx % pairs): a thread loads both before it writes either.
template <typename Sync>
__device__ __forceinline__ bool jacobi_round(double* __restrict__ A, double* __restrict__ V,
                                            int n, int r, int lane, int lanes, double* cs,
                                            double* sn, double* tn, unsigned char* act,
                                            int2* pq, Sync sync, int at) {
  const int pairs = n / 2;
  int go = 0;
  round_stamp(at, 0);
  if (lane < pairs) {
    int p, q;
    round_pair(n, r, lane, p, q);
    pq[lane] = make_int2(p, q);
    const double app = A[p * n + p], aqq = A[q * n + q], apq = A[p * n + q];
    go = apq != 0.0 && fabs(apq) > kRotTol * sqrt(fabs(app) * fabs(aqq));
    double c = 1.0, s = 0.0, t = 0.0;
    if (go) {
      const double theta = (aqq - app) / (2.0 * apq);
      const double den = fabs(theta) + hypot(1.0, theta);
      // ±1 / den as the reciprocal and its sign (the same bits; a NaN θ takes
      // the division as written)
      const double inv = 1.0 / den;
      t = theta >= 0.0 ? inv : (theta < 0.0 ? -inv : -1.0 / den);
      c = 1.0 / sqrt(1.0 + t * t);
      s = t * c;
    }
    cs[lane] = c;
    sn[lane] = s;
    tn[lane] = t;
    act[lane] = go ? 1 : 0;
  }
  round_stamp(at, 1);
  const bool some = sync.any(go);
  round_stamp(at, 2);
  if (!some) return false;
  const int blocks = pairs * pairs, entries = n * pairs;
  for (int idx = lane; idx < entries; idx += lanes) {
    const int hi = idx / pairs, lo = idx % pairs;
    // V ← V J: row hi, pair lo
    const bool do_v = act[lo] != 0;
    // A ← Jᵀ A J: the block (hi, lo), hi ≤ lo, and its transpose
    const bool do_a = idx < blocks && hi <= lo && (act[hi] || act[lo]);
    const int2 b = pq[lo];
    int2 a = b;
    double vp = 0.0, vq = 0.0, b00 = 0.0, b01 = 0.0, b10 = 0.0, b11 = 0.0;
    if (do_v) {
      vp = V[hi * n + b.x];
      vq = V[hi * n + b.y];
    }
    if (do_a) {
      a = pq[hi];
      b00 = A[a.x * n + b.x];
      b01 = A[a.x * n + b.y];
      b10 = A[a.y * n + b.x];
      b11 = A[a.y * n + b.y];
    }
    const double cb = cs[lo], sb = sn[lo];
    if (do_v) {
      V[hi * n + b.x] = cb * vp - sb * vq;
      V[hi * n + b.y] = sb * vp + cb * vq;
    }
    if (do_a) {
      const double ca = cs[hi], sa = sn[hi];
      // columns by J_b, then rows by J_aᵀ; on the diagonal (hi == lo) the
      // block's own rotation: a_pp − t a_pq, a_qq + t a_pq and zeros
      const double c00 = cb * b00 - sb * b01, c01 = sb * b00 + cb * b01;
      const double c10 = cb * b10 - sb * b11, c11 = sb * b10 + cb * b11;
      const double d00 = ca * c00 - sa * c10, d10 = sa * c00 + ca * c10;
      const double d01 = ca * c01 - sa * c11, d11 = sa * c01 + ca * c11;
      const bool diag = hi == lo;
      const double th = tn[hi];
      const double w00 = diag ? b00 - th * b01 : d00, w01 = diag ? 0.0 : d01;
      const double w10 = diag ? 0.0 : d10, w11 = diag ? b11 + th * b01 : d11;
      A[a.x * n + b.x] = w00;
      A[a.x * n + b.y] = w01;
      A[a.y * n + b.x] = w10;
      A[a.y * n + b.y] = w11;
      A[b.x * n + a.x] = w00;
      A[b.y * n + a.x] = w01;
      A[b.x * n + a.y] = w10;
      A[b.y * n + a.y] = w11;
    }
  }
  sync.all();
  round_stamp(at, 3);
  return true;
}

// the round's steps ordered within warp 0 ...
struct WarpSync {
  __device__ bool any(int go) const {
    const bool some = __ballot_sync(kFull, go) != 0;
    __syncwarp();
    return some;
  }
  __device__ void all() const { __syncwarp(); }
};

// ... or within the block
struct BlockSync {
  __device__ bool any(int go) const { return __syncthreads_or(go) != 0; }
  __device__ void all() const { __syncthreads(); }
};

// the cyclic Jacobi sweeps → the sweeps that rotated (kMaxSweeps when the
// decomposition did not converge)
template <typename Sync>
__device__ int jacobi(double* A, double* V, int n, int lane, int lanes, double* cs, double* sn,
                      double* tn, unsigned char* act, int2* pq, Sync sync) {
  int rotating = 0;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int r = 0; r < n - 1; ++r)
      rotated |= jacobi_round(A, V, n, r, lane, lanes, cs, sn, tn, act, pq, sync,
                              sweep * (n - 1) + r);
    if (!rotated) break;
    rotating = sweep + 1;
  }
  return rotating;
}

// step 3 from the folded ledger in scratch, and the energy
__global__ void __launch_bounds__(kSolveThreads)
marg_solve_kernel(const float* __restrict__ e_land, const float* __restrict__ eps,
                  const unsigned char* __restrict__ valid, const unsigned char* __restrict__ marg,
                  const double* __restrict__ e_marg, int k, double rtol, int a_shared,
                  int v_shared, double* __restrict__ scratch, double* __restrict__ e_out,
                  int* __restrict__ sweeps_out, const int* __restrict__ bank_seq) {
  {
    const int z = blockIdx.z, sb = seq::of(bank_seq);
    e_land = seq::at(e_land, z, 1);
    eps = seq::at(eps, sb, (size_t)k * kBlock);
    valid = seq::at(valid, sb, k);
    marg = seq::at(marg, sb, k);
    e_marg = seq::at(e_marg, sb, 1);
    scratch = seq::at(scratch, z, scratch_words(k));
    e_out = seq::at(e_out, z, 1);
    sweeps_out = seq::at(sweeps_out, z, 1);
  }
  extern __shared__ double smem[];
  __shared__ Frames fr;
  __shared__ double cs[kMaxRows / 2], sn[kMaxRows / 2], tn[kMaxRows / 2];
  __shared__ double inv[kMaxRows];
  __shared__ unsigned char act[kMaxRows / 2];
  __shared__ int2 pq[kMaxRows / 2];
  __shared__ double hs[kMaxRows], bpts[kMaxRows];
  __shared__ float s[kMaxRows];
  __shared__ double cutoff;
  __shared__ int rotating;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = k * kBlock, nmax = (k - 1) * kBlock;
  Scratch sc(scratch, rows, nmax);
  stamp(0);
  frames_of(valid, marg, k, fr);
  if (warp == 1) {
    for (int i = lane; i < rows; i += 32) {
      s[i] = eps[i];
      hs[i] = sc.hs[i];
      bpts[i] = sc.bpts[i];
    }
  }
  __syncthreads();
  const int n = fr.n;
  const bool in_warp = n <= kWarpRows;
  // the energy: warp 1, beside warp 0's rounds when they run alone
  auto energy = [&]() {
    if (warp != 1) return;
    double part = 0.0;
    if (lane < 2) {
      for (int i = 0; i < rows; ++i)
        part += (double)s[i] * (lane == 0 ? hs[i] : bpts[i]);
    }
    const double sb = __shfl_sync(kFull, part, 1);
    if (lane == 0) e_out[0] = e_marg[0] + (((double)e_land[0] + part) - sb);
  };
  if (n == 0 || n > nmax) {
    energy();
    __syncthreads();
    // all k slots flagged (the policy flags at most k - 2): no ledger
    if (tid == 0 && n > nmax) e_out[0] = NAN;
    if (tid == 0 && sweeps_out) sweeps_out[0] = 0;
    return;
  }
  // the compact block (A) and the identity (V); up to kWarpRows rows every
  // matrix of the step lies in shared memory
  double *A, *V, *x0, *res, *x;
  if (in_warp) {
    A = smem;
    V = A + n * n;
    x0 = V + n * n;
    res = x0 + n * n;
    x = res + n * n;
  } else {
    A = a_shared ? smem : sc.a;
    V = v_shared ? smem + (size_t)nmax * nmax : sc.v;
    x0 = sc.x0;
    res = sc.res;
    x = sc.x;
  }
  for (int e = tid; e < n * n; e += kSolveThreads) {
    const int a = e / n, b = e % n;
    A[e] = sc.hm[(size_t)fr.marg_row[a] * rows + fr.marg_row[b]];
    V[e] = a == b ? 1.0 : 0.0;
  }
  __syncthreads();
  stamp(3);
  if (in_warp) {
    if (warp == 0) {
      const int sweeps = jacobi(A, V, n, lane, 32, cs, sn, tn, act, pq, WarpSync());
      if (lane == 0) rotating = sweeps;
    }
    energy();
  } else {
    energy();
    __syncthreads();
    const int sweeps = jacobi(A, V, n, tid, kSolveThreads, cs, sn, tn, act, pq, BlockSync());
    if (tid == 0) rotating = sweeps;
  }
  __syncthreads();
  stamp(4);
  if (tid == 0) {
    if (sweeps_out) sweeps_out[0] = rotating;
    // the cutoff of the padded matrix: rtol · max(1, max|λ|)
    double top = 1.0;
    for (int a = 0; a < n; ++a) top = fmax(top, fabs(A[a * n + a]));
    cutoff = rtol * top;
  }
  __syncthreads();
  for (int a = tid; a < n; a += kSolveThreads) {
    const double lam = A[a * n + a];
    inv[a] = fabs(lam) > cutoff ? 1.0 / lam : 0.0;
  }
  __syncthreads();
  // X0 = V diag(1/λ) Vᵀ
  for (int e = tid; e < n * n; e += kSolveThreads) {
    const int a = e / n, b = e % n;
    double acc = 0.0;
#pragma unroll 8
    for (int c = 0; c < n; ++c) acc += (V[a * n + c] * inv[c]) * V[b * n + c];
    x0[e] = acc;
  }
  __syncthreads();
  // the Newton step: R = I − H_ee X0, X = X0 + X0 R
  for (int e = tid; e < n * n; e += kSolveThreads) {
    const int a = e / n, b = e % n;
    const double* row = sc.hm + (size_t)fr.marg_row[a] * rows;
    double acc = 0.0;
#pragma unroll 8
    for (int c = 0; c < n; ++c) acc += row[fr.marg_row[c]] * x0[c * n + b];
    res[e] = (a == b ? 1.0 : 0.0) - acc;
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += kSolveThreads) {
    const int a = e / n, b = e % n;
    double acc = 0.0;
#pragma unroll 8
    for (int c = 0; c < n; ++c) acc += x0[a * n + c] * res[c * n + b];
    x[e] = x0[e] + acc;
  }
  __syncthreads();
  stamp(5);
  // the correction H_ke X, [8K, n]; zero on rows that are not kept
  for (int e = tid; e < rows * n; e += kSolveThreads) {
    const int i = e / n, a = e % n;
    double acc = 0.0;
    if (fr.keep[i / kBlock]) {
      const double* row = sc.hm + (size_t)i * rows;
#pragma unroll 8
      for (int c = 0; c < n; ++c) acc += row[fr.marg_row[c]] * x[c * n + a];
    }
    sc.corr[e] = acc;
  }
  stamp(6);
}

__global__ void __launch_bounds__(kOutThreads)
fold_out_kernel(const unsigned char* __restrict__ valid, const unsigned char* __restrict__ marg,
                const long long* __restrict__ perm, int k, const double* __restrict__ scratch,
                double* __restrict__ h_out, double* __restrict__ b_out,
                const int* __restrict__ bank_seq) {
  {
    const int z = blockIdx.z, sb = seq::of(bank_seq);
    const size_t kb = (size_t)k * kBlock;
    valid = seq::at(valid, sb, k);
    marg = seq::at(marg, sb, k);
    perm = seq::at(perm, z, k);
    scratch = seq::at(scratch, z, scratch_words(k));
    h_out = seq::at(h_out, z, kb * kb);
    b_out = seq::at(b_out, z, kb);
  }
  __shared__ Frames fr;
  const int rows = k * kBlock, nmax = (k - 1) * kBlock;
  const double* hm = scratch;
  const double* bm = hm + (size_t)rows * rows;
  const double* corr = bm + 3 * rows + 5 * (size_t)nmax * nmax;
  const int e = blockIdx.x * kOutThreads + threadIdx.x;
  const bool in = e < rows * rows;
  const int ao = in ? e / rows : 0, bo = in ? e % rows : 0;
  // the loads that need no frame flags, before the flags' barrier
  const int i = (int)perm[ao / kBlock] * kBlock + ao % kBlock;
  const int j = (int)perm[bo / kBlock] * kBlock + bo % kBlock;
  const double hij = hm[(size_t)i * rows + j], hji = hm[(size_t)j * rows + i];
  const double bi = bm[i];
  frames_of(valid, marg, k, fr);
  __syncthreads();
  const int n = fr.n;
  if (!in) return;
  if (n > nmax) {  // as marg_solve_kernel: all k slots flagged, no ledger
    h_out[e] = NAN;
    if (bo == 0) b_out[ao] = NAN;
    return;
  }
  const bool ki = fr.keep[i / kBlock], kj = fr.keep[j / kBlock];
  // H_ke X H_keᵀ at (i, j) and at (j, i); H_ke is zero on rows not kept
  double pij = 0.0, pji = 0.0;
#pragma unroll 8
  for (int c = 0; c < n; ++c) {
    const int col = fr.marg_row[c];
    const double hjc = kj ? hm[(size_t)j * rows + col] : 0.0;
    const double hic = ki ? hm[(size_t)i * rows + col] : 0.0;
    pij += corr[(size_t)i * n + c] * hjc;
    pji += corr[(size_t)j * n + c] * hic;
  }
  const double vij = (ki && kj ? hij : 0.0) - pij;
  const double vji = (ki && kj ? hji : 0.0) - pji;
  h_out[e] = 0.5 * (vij + vji);
  if (bo == 0) {
    double pb = 0.0;
#pragma unroll 8
    for (int c = 0; c < n; ++c) pb += corr[(size_t)i * n + c] * bm[fr.marg_row[c]];
    b_out[ao] = (ki ? bi : 0.0) - pb;
  }
}

}  // namespace

#ifdef MARG_FOLD_STAMPS
// the stamps since the last read (host memory, kStamps + 2 values): the clock64
// of each stamp (0 where none was set), then the first and the last stamp's
// %globaltimer in ns; they are zero again after the read
extern "C" int marg_fold_stamps(long long* out) {
  static const long long zero[kStamps + 2] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
  return (int)err;
}

// the round stamps since the last read (host memory, kRoundStamps x 4 values);
// zero again after the read
extern "C" int marg_fold_round_stamps(long long* out) {
  static const long long zero[kRoundStamps][4] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_rounds, sizeof(g_rounds));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_rounds, zero, sizeof(g_rounds));
  return (int)err;
}

// one thread's latency of a dependent chain of each f64 operation a rotation
// makes (the chain's cycles per operation, the loop's additions included):
// [division, square root, hypot(1, x), reciprocal 1 / x, addition]
__global__ void op_latency_kernel(double seed, long long* cycles, double* sink) {
  constexpr int kChain = 256;
  double x = seed;
  long long t = clock64();
  for (int i = 0; i < kChain; ++i) x = (x + 1.0) / (x + 3.0);
  cycles[0] = clock64() - t;
  t = clock64();
  for (int i = 0; i < kChain; ++i) x = sqrt(x + 2.0);
  cycles[1] = clock64() - t;
  t = clock64();
  for (int i = 0; i < kChain; ++i) x = hypot(1.0, x) - 0.5;
  cycles[2] = clock64() - t;
  t = clock64();
  for (int i = 0; i < kChain; ++i) x = 1.0 / (x + 2.0);
  cycles[3] = clock64() - t;
  t = clock64();
  for (int i = 0; i < kChain; ++i) x = x * 0.75 + 0.5;
  cycles[4] = clock64() - t;
  for (int c = 0; c < 5; ++c) cycles[c] /= kChain;
  sink[0] = x;
}

extern "C" int marg_fold_op_latency(long long* out) {
  long long* cycles;
  double* sink;
  cudaError_t err = cudaMalloc(&cycles, 5 * sizeof(long long));
  if (err != cudaSuccess) return (int)err;
  err = cudaMalloc(&sink, sizeof(double));
  if (err == cudaSuccess) {
    op_latency_kernel<<<1, 1>>>(0.3, cycles, sink);
    err = cudaDeviceSynchronize();
    if (err == cudaSuccess)
      err = cudaMemcpy(out, cycles, 5 * sizeof(long long), cudaMemcpyDeviceToHost);
    cudaFree(sink);
  }
  cudaFree(cycles);
  return (int)err;
}
#endif

// K8's marginalization-pass system h_pose [8k,8k], b_pose [8k], h_schur
// [8k,8k], b_schur [8k] and the flagged landmarks' energy e_land [1] (f32);
// the window's eps [k,8], affine0 [k,2], frame_valid, frame_fixed,
// frame_marg [k] u8, perm [k] int64 (kept frames first) and its ledger
// h_marg [8k,8k], b_marg [8k], energy_marg [1] (f64); rtol = 10 · 8k · eps;
// the priors fixed_reg, reg_a, reg_b.  scratch: f64 words, 8k·8k + 3·8k +
// 5·n² + 8k·n with n = 8(k − 1).  Outputs: the new ledger h_out [8k,8k],
// b_out [8k], e_out [1] (f64), all NaN when all k slots are flagged; and,
// unless sweeps is null, sweeps [1] int32: the Jacobi sweeps that rotated
// (40, the limit, when the decomposition did not converge).  Sequence axis
// (seq_axis.cuh): `seqs` sequences, grid z; eps, affine0, the frame flags
// and the ledger are [B, ...] stacks read at seq_list[z] (null: z); the
// system, e_land, perm, the scratch (seqs times its words) and the outputs
// are [seqs, ...] at z.  Returns cudaErrorInvalidValue (1) for k outside
// 2..40.
extern "C" int marg_fold(const float* h_pose, const float* b_pose, const float* h_schur,
                         const float* b_schur, const float* e_land, const float* eps,
                         const float* affine0, const unsigned char* frame_valid,
                         const unsigned char* frame_fixed, const unsigned char* frame_marg,
                         const long long* perm, const double* h_marg, const double* b_marg,
                         const double* e_marg, int k, double rtol, float fixed_reg,
                         float reg_a, float reg_b, double* scratch, double* h_out,
                         double* b_out, double* e_out, int* sweeps, int seqs,
                         const int* seq_list, void* stream) {
  if (k < 2 || k > kMaxFrames || !seq::valid_count(seqs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = k * kBlock, nmax = (k - 1) * kBlock;
  const size_t mat = (size_t)nmax * nmax * sizeof(double);
  const int a_shared = mat <= (size_t)kSharedBudget ? 1 : 0;
  const int v_shared = 2 * mat <= (size_t)kSharedBudget ? 1 : 0;
  const size_t warp_bytes = 5 * (size_t)kWarpRows * kWarpRows * sizeof(double);
  const size_t block_bytes = (size_t)(a_shared + v_shared) * mat;
  const size_t bytes = block_bytes > warp_bytes ? block_bytes : warp_bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      marg_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fold_kernel<<<dim3(k, 1, seqs), kFoldThreads, 0, s>>>(
      h_pose, b_pose, h_schur, b_schur, eps, affine0, frame_valid, frame_fixed, frame_marg,
      h_marg, b_marg, k, fixed_reg, reg_a, reg_b, scratch, seq_list);
  cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  marg_solve_kernel<<<dim3(1, 1, seqs), kSolveThreads, bytes, s>>>(
      e_land, eps, frame_valid, frame_marg, e_marg, k, rtol, a_shared, v_shared, scratch, e_out,
      sweeps, seq_list);
  launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  fold_out_kernel<<<dim3((rows * rows + kOutThreads - 1) / kOutThreads, 1, seqs), kOutThreads,
                    0, s>>>(frame_valid, frame_marg, perm, k, scratch, h_out, b_out, seq_list);
  return (int)cudaGetLastError();
}
