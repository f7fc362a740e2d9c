// K15 marg_fold: the marginalization fold into the float64 prior ledger.
//
// Replaces dsopp_tpu/solvers/pba.py::_marginalize_device after its landmark
// system (_marg_system_kernel, which runs on K7 and K8): the XLA program that
// folds, eliminates and permutes the ledger (the port's plain version is
// solvers/pba.py::_marginalize_plain).  With s = eps, K frame slots, the 8K
// state rows and the m flagged frames' 8m rows:
//  1. the landmark fold (DSO eq 8.15): h = (H_pts + H_ptsᵀ) / 2,
//     E_m += (E + sᵀhs) − sᵀb_pts, H_m += h, b_m += b_pts − hs;
//  2. the flagged frames' priors (affine 1e12 / 1e8 on a free frame, 1e16 on
//     every entry of a fixed one), computed in f32 as _prior_system does,
//     folded into H_m and b_m rebased at s;
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
// the Jacobi sweeps and the products (O(n³), n = 8m) take over.  Design, two
// kernels behind one entry, nothing read on the host (m is known on the
// device only), every sum in a fixed order (two runs agree to the bit):
//  1. fold_kernel, one block: steps 1-2 into scratch, the compaction of the
//     flagged rows (slot order), a cyclic parallel-order (round-robin)
//     Jacobi eigen-solver on the compact block in f64 — the matrix in shared
//     memory, each 2 x 2 block of a round's disjoint rotations owned by one
//     thread, so the matrix stays exactly symmetric; the eigenvectors in
//     shared memory when both fit, else in global memory (L2) — then X0, the
//     Newton step and the correction H_ke X into scratch;
//  2. fold_out_kernel, one thread per entry of the new ledger: its source entry
//     and the transposed one, each less its correction, their mean, and b.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kBlock = 8;        // state rows per frame: 6 pose + 2 affine
constexpr int kMaxFrames = 40;
constexpr int kFoldThreads = 1024;
constexpr int kOutThreads = 256;
constexpr int kMaxSweeps = 40;
constexpr int kSharedBudget = 200 * 1024;  // with ~10 KB of static shared memory
// a rotation is made where |a_pq| > kRotTol · sqrt(|a_pp a_qq|)
constexpr double kRotTol = 4.0 * DBL_EPSILON;

struct Frames {
  int rows;                         // 8K
  int n;                            // 8m, the flagged rows
  int marg_row[kMaxFrames * kBlock];  // compact index -> state row, slot order
  unsigned char keep[kMaxFrames];   // valid and not flagged
};

// thread 0 fills ``fr`` from the frame flags; the caller synchronises
__device__ void frames_of(const unsigned char* valid, const unsigned char* marg, int k,
                          Frames& fr) {
  fr.rows = k * kBlock;
  int n = 0;
  for (int i = 0; i < k; ++i) {
    const bool flagged = valid[i] && marg[i];
    fr.keep[i] = (valid[i] && !marg[i]) ? 1 : 0;
    if (flagged)
      for (int c = 0; c < kBlock; ++c) fr.marg_row[n++] = i * kBlock + c;
  }
  fr.n = n;
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

// the symmetric landmark system in f64, as (H_pts + H_ptsᵀ) / 2
__device__ __forceinline__ double h_sym(const float* h_pts, int rows, int i, int j) {
  return 0.5 * ((double)h_pts[(size_t)i * rows + j] + (double)h_pts[(size_t)j * rows + i]);
}

// round r of the circle schedule over n indices: pair t → (p, q)
__device__ __forceinline__ void round_pair(int n, int r, int t, int& p, int& q) {
  if (t == 0) {
    p = n - 1;
    q = r;
  } else {
    p = (r + t) % (n - 1);
    q = (r - t + (n - 1)) % (n - 1);
  }
}

__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const float* __restrict__ h_pts, const float* __restrict__ b_pts,
            const float* __restrict__ e_land, const float* __restrict__ eps,
            const float* __restrict__ affine0, const unsigned char* __restrict__ valid,
            const unsigned char* __restrict__ fixed, const unsigned char* __restrict__ marg,
            const double* __restrict__ h_marg, const double* __restrict__ b_marg,
            const double* __restrict__ e_marg, int k, double rtol, float fixed_reg,
            float reg_a, float reg_b, int a_shared, int v_shared, double* __restrict__ scratch,
            double* __restrict__ e_out, int* __restrict__ sweeps_out) {
  extern __shared__ double smem[];
  __shared__ Frames fr;
  __shared__ double hs[kMaxFrames * kBlock];
  __shared__ double cs[kMaxFrames * kBlock / 2], sn[kMaxFrames * kBlock / 2],
      tn[kMaxFrames * kBlock / 2];
  __shared__ double inv[kMaxFrames * kBlock];
  __shared__ unsigned char act[kMaxFrames * kBlock / 2];
  __shared__ double cutoff;
  const int tid = threadIdx.x;
  const int rows = k * kBlock, nmax = (k - 1) * kBlock;
  double* hm = scratch;
  double* bm = hm + (size_t)rows * rows;
  double* a_glob = bm + rows;
  double* v_glob = a_glob + (size_t)nmax * nmax;
  double* x0 = v_glob + (size_t)nmax * nmax;
  double* res = x0 + (size_t)nmax * nmax;
  double* x = res + (size_t)nmax * nmax;
  double* corr = x + (size_t)nmax * nmax;
  double* A = a_shared ? smem : a_glob;
  double* V = v_shared ? smem + (size_t)nmax * nmax : v_glob;

  if (tid == 0) frames_of(valid, marg, k, fr);
  // 1-2. the landmark fold and the flagged frames' priors
  for (int e = tid; e < rows * rows; e += kFoldThreads) {
    const int i = e / rows, j = e % rows;
    double v = h_marg[e] + h_sym(h_pts, rows, i, j);
    double d = 0.0;
    if (i == j) {
      float df, bf;
      prior_row(i, eps, affine0, valid, fixed, marg, fixed_reg, reg_a, reg_b, df, bf);
      d = (double)df;
    }
    hm[e] = v + d;
  }
  for (int i = tid; i < rows; i += kFoldThreads) {
    double acc = 0.0;
    for (int j = 0; j < rows; ++j) acc += h_sym(h_pts, rows, i, j) * (double)eps[j];
    hs[i] = acc;
    float df, bf;
    prior_row(i, eps, affine0, valid, fixed, marg, fixed_reg, reg_a, reg_b, df, bf);
    const double s = (double)eps[i];
    const double b1 = b_marg[i] + ((double)b_pts[i] - acc);
    bm[i] = b1 + ((double)bf - (double)df * s);
  }
  __syncthreads();
  if (tid == 0) {
    double shs = 0.0, sb = 0.0;
    for (int i = 0; i < rows; ++i) shs += (double)eps[i] * hs[i];
    for (int i = 0; i < rows; ++i) sb += (double)eps[i] * (double)b_pts[i];
    e_out[0] = e_marg[0] + (((double)e_land[0] + shs) - sb);
  }
  const int n = fr.n;
  if ((n == 0 || n > nmax) && tid == 0 && sweeps_out) sweeps_out[0] = 0;
  if (n == 0) return;
  if (n > nmax) {  // all k slots flagged (the policy flags at most k - 2): no ledger
    if (tid == 0) e_out[0] = NAN;
    return;
  }

  // 3. the compact block and its Jacobi eigen-decomposition
  for (int e = tid; e < n * n; e += kFoldThreads) {
    const int a = e / n, b = e % n;
    A[e] = hm[(size_t)fr.marg_row[a] * rows + fr.marg_row[b]];
    V[e] = a == b ? 1.0 : 0.0;
  }
  __syncthreads();
  const int pairs = n / 2;
  int rotating = 0;  // sweeps that made a rotation: kMaxSweeps when not converged
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    int rotated = 0;
    for (int r = 0; r < n - 1; ++r) {
      int any = 0;
      if (tid < pairs) {
        int p, q;
        round_pair(n, r, tid, p, q);
        const double app = A[p * n + p], aqq = A[q * n + q], apq = A[p * n + q];
        const bool go = apq != 0.0 && fabs(apq) > kRotTol * sqrt(fabs(app) * fabs(aqq));
        double c = 1.0, s = 0.0, t = 0.0;
        if (go) {
          const double theta = (aqq - app) / (2.0 * apq);
          t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + hypot(1.0, theta));
          c = 1.0 / sqrt(1.0 + t * t);
          s = t * c;
        }
        cs[tid] = c;
        sn[tid] = s;
        tn[tid] = t;
        act[tid] = go ? 1 : 0;
        any = go ? 1 : 0;
      }
      any = __syncthreads_or(any);
      if (!any) continue;
      rotated = 1;
      // A ← Jᵀ A J, one thread per 2 x 2 block (ta ≤ tb) and its transpose
      for (int blk = tid; blk < pairs * pairs; blk += kFoldThreads) {
        const int ta = blk / pairs, tb = blk % pairs;
        if (ta > tb || !(act[ta] || act[tb])) continue;
        int pa, qa, pb, qb;
        round_pair(n, r, ta, pa, qa);
        round_pair(n, r, tb, pb, qb);
        const double ca = cs[ta], sa = sn[ta], cb = cs[tb], sb = sn[tb];
        if (ta == tb) {
          const double app = A[pa * n + pa], aqq = A[qa * n + qa], apq = A[pa * n + qa];
          const double t = tn[ta];
          A[pa * n + pa] = app - t * apq;
          A[qa * n + qa] = aqq + t * apq;
          A[pa * n + qa] = 0.0;
          A[qa * n + pa] = 0.0;
          continue;
        }
        const double b00 = A[pa * n + pb], b01 = A[pa * n + qb];
        const double b10 = A[qa * n + pb], b11 = A[qa * n + qb];
        // columns by J_b, then rows by J_aᵀ
        const double c00 = cb * b00 - sb * b01, c01 = sb * b00 + cb * b01;
        const double c10 = cb * b10 - sb * b11, c11 = sb * b10 + cb * b11;
        const double d00 = ca * c00 - sa * c10, d10 = sa * c00 + ca * c10;
        const double d01 = ca * c01 - sa * c11, d11 = sa * c01 + ca * c11;
        A[pa * n + pb] = d00;
        A[pa * n + qb] = d01;
        A[qa * n + pb] = d10;
        A[qa * n + qb] = d11;
        A[pb * n + pa] = d00;
        A[qb * n + pa] = d01;
        A[pb * n + qa] = d10;
        A[qb * n + qa] = d11;
      }
      // V ← V J
      for (int e = tid; e < n * pairs; e += kFoldThreads) {
        const int row = e / pairs, t = e % pairs;
        if (!act[t]) continue;
        int p, q;
        round_pair(n, r, t, p, q);
        const double vp = V[row * n + p], vq = V[row * n + q];
        V[row * n + p] = cs[t] * vp - sn[t] * vq;
        V[row * n + q] = sn[t] * vp + cs[t] * vq;
      }
      __syncthreads();
    }
    if (!rotated) break;
    rotating = sweep + 1;
  }
  if (tid == 0 && sweeps_out) sweeps_out[0] = rotating;

  // the cutoff of the padded matrix: rtol · max(1, max|λ|)
  if (tid == 0) {
    double top = 1.0;
    for (int a = 0; a < n; ++a) top = fmax(top, fabs(A[a * n + a]));
    cutoff = rtol * top;
  }
  __syncthreads();
  for (int a = tid; a < n; a += kFoldThreads) {
    const double lam = A[a * n + a];
    inv[a] = fabs(lam) > cutoff ? 1.0 / lam : 0.0;
  }
  __syncthreads();
  // X0 = V diag(1/λ) Vᵀ
  for (int e = tid; e < n * n; e += kFoldThreads) {
    const int a = e / n, b = e % n;
    double acc = 0.0;
    for (int c = 0; c < n; ++c) acc += (V[a * n + c] * inv[c]) * V[b * n + c];
    x0[e] = acc;
  }
  __syncthreads();
  // the Newton step: R = I − H_ee X0, X = X0 + X0 R
  for (int e = tid; e < n * n; e += kFoldThreads) {
    const int a = e / n, b = e % n;
    const double* row = hm + (size_t)fr.marg_row[a] * rows;
    double acc = 0.0;
    for (int c = 0; c < n; ++c) acc += row[fr.marg_row[c]] * x0[c * n + b];
    res[e] = (a == b ? 1.0 : 0.0) - acc;
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += kFoldThreads) {
    const int a = e / n, b = e % n;
    double acc = 0.0;
    for (int c = 0; c < n; ++c) acc += x0[a * n + c] * res[c * n + b];
    x[e] = x0[e] + acc;
  }
  __syncthreads();
  // the correction H_ke X, [8K, n]; zero on rows that are not kept
  for (int e = tid; e < rows * n; e += kFoldThreads) {
    const int i = e / n, a = e % n;
    double acc = 0.0;
    if (fr.keep[i / kBlock]) {
      const double* row = hm + (size_t)i * rows;
      for (int c = 0; c < n; ++c) acc += row[fr.marg_row[c]] * x[c * n + a];
    }
    corr[e] = acc;
  }
}

__global__ void __launch_bounds__(kOutThreads)
fold_out_kernel(const unsigned char* __restrict__ valid, const unsigned char* __restrict__ marg,
           const long long* __restrict__ perm, int k, const double* __restrict__ scratch,
           double* __restrict__ h_out, double* __restrict__ b_out) {
  __shared__ Frames fr;
  if (threadIdx.x == 0) frames_of(valid, marg, k, fr);
  __syncthreads();
  const int rows = fr.rows, n = fr.n, nmax = (k - 1) * kBlock;
  const double* hm = scratch;
  const double* bm = hm + (size_t)rows * rows;
  const double* corr = bm + rows + 5 * (size_t)nmax * nmax;
  const int e = blockIdx.x * kOutThreads + threadIdx.x;
  if (e >= rows * rows) return;
  const int ao = e / rows, bo = e % rows;
  if (n > nmax) {  // as fold_kernel: all k slots flagged, no ledger
    h_out[e] = NAN;
    if (bo == 0) b_out[ao] = NAN;
    return;
  }
  const int i = (int)perm[ao / kBlock] * kBlock + ao % kBlock;
  const int j = (int)perm[bo / kBlock] * kBlock + bo % kBlock;
  const bool ki = fr.keep[i / kBlock], kj = fr.keep[j / kBlock];
  // H_ke X H_keᵀ at (i, j) and at (j, i); H_ke is zero on rows not kept
  double pij = 0.0, pji = 0.0;
  for (int c = 0; c < n; ++c) {
    const int col = fr.marg_row[c];
    const double hjc = kj ? hm[(size_t)j * rows + col] : 0.0;
    const double hic = ki ? hm[(size_t)i * rows + col] : 0.0;
    pij += corr[(size_t)i * n + c] * hjc;
    pji += corr[(size_t)j * n + c] * hic;
  }
  const double vij = (ki && kj ? hm[(size_t)i * rows + j] : 0.0) - pij;
  const double vji = (ki && kj ? hm[(size_t)j * rows + i] : 0.0) - pji;
  h_out[e] = 0.5 * (vij + vji);
  if (bo == 0) {
    double pb = 0.0;
    for (int c = 0; c < n; ++c) pb += corr[(size_t)i * n + c] * bm[fr.marg_row[c]];
    b_out[ao] = (ki ? bm[i] : 0.0) - pb;
  }
}

}  // namespace

// The flagged landmarks' system h_pts [8k,8k], b_pts [8k], e_land [1] (f32);
// the window's eps [k,8], affine0 [k,2], frame_valid, frame_fixed,
// frame_marg [k] u8, perm [k] int64 (kept frames first) and its ledger
// h_marg [8k,8k], b_marg [8k], energy_marg [1] (f64); rtol = 10 · 8k · eps;
// the priors fixed_reg, reg_a, reg_b.  scratch: f64 words, 8k·8k + 8k +
// 5·n² + 8k·n with n = 8(k − 1).  Outputs: the new ledger h_out [8k,8k],
// b_out [8k], e_out [1] (f64), all NaN when all k slots are flagged; and,
// unless sweeps is null, sweeps [1] int32: the Jacobi sweeps that rotated
// (40, the limit, when the decomposition did not converge).
// Returns cudaErrorInvalidValue (1) for k outside 2..40.
extern "C" int marg_fold(const float* h_pts, const float* b_pts, const float* e_land,
                         const float* eps, const float* affine0,
                         const unsigned char* frame_valid, const unsigned char* frame_fixed,
                         const unsigned char* frame_marg, const long long* perm,
                         const double* h_marg, const double* b_marg, const double* e_marg,
                         int k, double rtol, float fixed_reg, float reg_a, float reg_b,
                         double* scratch, double* h_out, double* b_out, double* e_out,
                         int* sweeps, void* stream) {
  if (k < 2 || k > kMaxFrames) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = k * kBlock, nmax = (k - 1) * kBlock;
  const size_t mat = (size_t)nmax * nmax * sizeof(double);
  const int a_shared = mat <= (size_t)kSharedBudget ? 1 : 0;
  const int v_shared = 2 * mat <= (size_t)kSharedBudget ? 1 : 0;
  const size_t bytes = (size_t)(a_shared + v_shared) * mat;
  const cudaError_t err = cudaFuncSetAttribute(
      fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fold_kernel<<<1, kFoldThreads, bytes, s>>>(
      h_pts, b_pts, e_land, eps, affine0, frame_valid, frame_fixed, frame_marg, h_marg, b_marg,
      e_marg, k, rtol, fixed_reg, reg_a, reg_b, a_shared, v_shared, scratch, e_out, sweeps);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  fold_out_kernel<<<(rows * rows + kOutThreads - 1) / kOutThreads, kOutThreads, 0, s>>>(
      frame_valid, frame_marg, perm, k, scratch, h_out, b_out);
  return (int)cudaGetLastError();
}
