// K8 ba_linearize_schur: the Gauss-Newton system of the windowed BA from an
// evaluation, with the landmark Schur complement.
//
// Replaces dsopp_tpu/solvers/pba.py::_linearize_from_ev: the Jacobian chain (FEJ geometry x current gradients, frozen
// affine columns), H_pp [8k, 8k] and b [8k], the per-landmark pose-idepth
// blocks hpd [k, n, k, 8], h_dd and b_d [k, n], inv_hdd with the nullspace
// threshold and the marginalization pass's scale regularizer, and
// H_schur = sum hpd inv_hdd hpd^T, b_schur = sum hpd inv_hdd b_d.
//
// Bound: bytes (the FEJ cache and the evaluation, ~24 MB at K = 10,
// N = 250, are read once; the sums are ~0.2 GFLOP).  Design, three kernels
// behind one entry point, no float atomics (the LM accept test and the
// status machine see the same sums on every run):
//  1. pair_kernel, one block per (pair (i, j), tile of 64 landmarks): in
//     chunks of 32 landmarks each thread forms one residual's 16 Jacobian
//     columns [j_anchor | j_target] in shared memory; then thread (a, b)
//     owns entry (a, b) of the pair's 16x16 block sum w J^T J (h_rr, h_rt,
//     h_tt) and thread (0, b) of sum w J^T r, walking the chunk's residuals
//     in order; per landmark the 8-point sums that feed hpd, h_dd and b_d
//     go to scratch.
//  2. landmark_kernel, one block per 32 landmarks: sums those over the
//     targets (the anchor term lands on the diagonal block of hpd), applies
//     the threshold and the regularizer, writes hpd, inv_hdd, b_d, and
//     accumulates the block's share of H_schur and b_schur.
//  3. reduce_kernel: sums the per-block partials in index order, places the
//     8x8 blocks as the plain version does and adds _prior_system's diagonal
//     priors (the fixed frames' gauge prior, the free frames' affine prior)
//     to the rounded f32 sums, as the plain version adds them.
// Products are f32 (rounded as the plain version's); the long sums are kept
// in f64, because H's entries span 1e3..5e10 and b cancels.
//
// Frames: landmark_kernel stages 32 rows of 8k + 1 floats in dynamic shared
// memory, which the 48 KB a block gets without opting in holds up to k = 40
// (kMaxFrames; the dense operating point runs k = 17).  Inside the LM loop
// the entry takes the loop's state and all three kernels return at once when
// the loop is done (ba_lm_state.cuh).

#include <cuda_runtime.h>

#include "ba_lm_state.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPattern = 8;
constexpr int kChunkLm = 32;                  // landmarks per pass = 256 residuals
constexpr int kTileLm = 64;                   // landmarks per pair_kernel block
constexpr int kCols = 16;                     // [j_anchor (8) | j_target (8)]
constexpr int kPairOut = kCols * kCols + kCols;  // block sums of H and b
constexpr int kLmOut = 18;                    // hpd_anchor 8, hpd_target 8, h_dd, b_d
constexpr int kMaxFrames = 40;                // solvers/pba.py::_LINEARIZE_MAX_FRAMES

__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ d_uv_ref, const float* __restrict__ d_uv_tgt,
            const float* __restrict__ d_uv_idepth, const float* __restrict__ corrected_ref,
            const float* __restrict__ scale0, const unsigned char* __restrict__ geom_valid,
            const float* __restrict__ residuals, const float* __restrict__ weight,
            const float* __restrict__ gx, const float* __restrict__ gy,
            const unsigned char* __restrict__ ok, int n, int tiles,
            const int* __restrict__ lm_state, double* __restrict__ pair_part,
            float* __restrict__ lm_part) {
  if (ba::lm_done(lm_state)) return;
  __shared__ float jac[kThreads][kCols + 1];
  __shared__ float res_s[kThreads];
  __shared__ float jd_s[kThreads];
  __shared__ float w_s[kChunkLm];

  const int pair = blockIdx.y, tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int ln = tid / kPattern, p = tid % kPattern;
  const int a = tid / kCols, b = tid % kCols;
  const float s0 = scale0[pair];
  double acc_h = 0.0, acc_b = 0.0;

  for (int chunk = 0; chunk < kTileLm / kChunkLm; ++chunk) {
    const int lm = tile * kTileLm + chunk * kChunkLm + ln;
    float row[kCols];
    float r = 0.0f, jd = 0.0f, wgt = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[c] = 0.0f;
    if (lm < n) {
      const size_t group = (size_t)pair * n + lm;
      const size_t res = group * kPattern + p;
      wgt = (ok[group] && geom_valid[group]) ? weight[group] : 0.0f;
      const float g_x = gx[res], g_y = gy[res];
      const float* dr = d_uv_ref + res * 12;
      const float* dt = d_uv_tgt + res * 12;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        row[c] = g_x * __ldg(dr + c) + g_y * __ldg(dr + 6 + c);
        row[8 + c] = g_x * __ldg(dt + c) + g_y * __ldg(dt + 6 + c);
      }
      const float corr = corrected_ref[res];
      row[6] = corr;
      row[7] = s0;
      row[14] = -corr;
      row[15] = -1.0f;
      jd = g_x * d_uv_idepth[2 * res] + g_y * d_uv_idepth[2 * res + 1];
      r = residuals[res];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) jac[tid][c] = row[c];
    res_s[tid] = r;
    jd_s[tid] = jd;
    if (p == 0) w_s[ln] = wgt;
    __syncthreads();

    // entry (a, b) of sum (w J)^T J, and for a == 0 entry b of sum (w J)^T r
    for (int t = 0; t < kThreads; ++t) {
      const float wv = w_s[t / kPattern];
      acc_h += (double)((wv * jac[t][a]) * jac[t][b]);
      if (a == 0) acc_b += (double)((wv * jac[t][b]) * res_s[t]);
    }

    // per landmark: sum over its 8 points of (w J)[col] j_d, j_d^2 w, j_d r w
    if (lm < n) {
      const size_t group = (size_t)pair * n + lm;
      const float wv = w_s[ln];
      float h_ref = 0.0f, h_tgt = 0.0f, extra = 0.0f;
      for (int pp = 0; pp < kPattern; ++pp) {
        const int t = ln * kPattern + pp;
        h_ref += (wv * jac[t][p]) * jd_s[t];
        h_tgt += (wv * jac[t][8 + p]) * jd_s[t];
        if (p == 0) extra += (jd_s[t] * jd_s[t]) * wv;
        if (p == 1) extra += (jd_s[t] * res_s[t]) * wv;
      }
      lm_part[group * kLmOut + p] = h_ref;
      lm_part[group * kLmOut + 8 + p] = h_tgt;
      if (p < 2) lm_part[group * kLmOut + 16 + p] = extra;
    }
    __syncthreads();
  }

  double* out = pair_part + ((size_t)pair * tiles + tile) * kPairOut;
  out[tid] = acc_h;
  if (a == 0) out[kCols * kCols + b] = acc_b;
}

__global__ void __launch_bounds__(kThreads)
landmark_kernel(const float* __restrict__ lm_part, const unsigned char* __restrict__ frame_fixed,
                int k, int n, int marg_pass, float threshold, float scale_reg,
                const int* __restrict__ lm_state, float* __restrict__ hpd,
                float* __restrict__ inv_hdd, float* __restrict__ b_d,
                double* __restrict__ schur_part) {
  if (ba::lm_done(lm_state)) return;
  // hs [kChunkLm][kb + 1], inv_s [kChunkLm], bd_s [kChunkLm]
  extern __shared__ float lm_shared[];
  const int kb = k * 8;
  const int hs_stride = kb + 1;
  float* hs = lm_shared;
  float* inv_s = hs + kChunkLm * hs_stride;
  float* bd_s = inv_s + kChunkLm;
  const int total = k * n;
  const int first = blockIdx.x * kChunkLm;
  const int tid = threadIdx.x;

  // hpd[i, n, j, a] = target term of pair (i, j), plus on j == i the anchor
  // terms summed over all targets
  for (int e = tid; e < kChunkLm * kb; e += kThreads) {
    const int l = e / kb, c = e % kb;
    const int g = first + l;
    float v = 0.0f;
    if (g < total) {
      const int i = g / n, ln = g % n, j = c / 8, a = c % 8;
      v = lm_part[(((size_t)i * k + j) * n + ln) * kLmOut + 8 + a];
      if (j == i) {
        double anchor = 0.0;
        for (int jj = 0; jj < k; ++jj)
          anchor += (double)lm_part[(((size_t)i * k + jj) * n + ln) * kLmOut + a];
        v = v + (float)anchor;
      }
      hpd[(size_t)g * kb + c] = v;
    }
    hs[l * hs_stride + c] = v;
  }
  if (tid < kChunkLm) {
    const int g = first + tid;
    float inv = 0.0f, bd = 0.0f;
    if (g < total) {
      const int i = g / n, ln = g % n;
      double hdd_sum = 0.0, bd_sum = 0.0;
      for (int j = 0; j < k; ++j) {
        const float* part = lm_part + (((size_t)i * k + j) * n + ln) * kLmOut;
        hdd_sum += (double)part[16];
        bd_sum += (double)part[17];
      }
      float hdd = (float)hdd_sum;
      bd = (float)bd_sum;
      if (marg_pass && frame_fixed[i] && hdd > threshold) hdd = hdd + scale_reg;
      inv = hdd > threshold ? 1.0f / hdd : 0.0f;
      inv_hdd[g] = inv;
      b_d[g] = bd;
    }
    inv_s[tid] = inv;
    bd_s[tid] = bd;
  }
  __syncthreads();

  double* out = schur_part + (size_t)blockIdx.x * (kb * kb + kb);
  for (int e = tid; e < kb * kb; e += kThreads) {
    const int row = e / kb, col = e % kb;
    double acc = 0.0;
    for (int l = 0; l < kChunkLm; ++l) {
      const float* h_l = hs + l * hs_stride;
      acc += (double)((h_l[row] * inv_s[l]) * h_l[col]);
    }
    out[e] = acc;
  }
  for (int c = tid; c < kb; c += kThreads) {
    double acc = 0.0;
    for (int l = 0; l < kChunkLm; ++l)
      acc += (double)((hs[l * hs_stride + c] * inv_s[l]) * bd_s[l]);
    out[kb * kb + c] = acc;
  }
}

// the frames' state and the weights of pba.py::_prior_system
struct Priors {
  const float* eps;                  // [k, 8]
  const float* affine0;              // [k, 2]
  const unsigned char* frame_valid;  // [k]
  const unsigned char* frame_fixed;  // [k]
  const unsigned char* frame_marg;   // [k]
  int marg_pass;
  float fixed_reg, affine_reg_a, affine_reg_b;
};

// entry a of frame f's diagonal prior -> its weight and its gradient
__device__ void prior_entry(const Priors& pr, int f, int a, float* weight, float* gradient) {
  *weight = 0.0f;
  *gradient = 0.0f;
  const bool marg = pr.frame_marg[f] != 0;
  if (!pr.frame_valid[f] || marg != (pr.marg_pass != 0)) return;
  const float e = pr.eps[f * 8 + a];
  if (pr.frame_fixed[f]) {
    *weight = pr.fixed_reg;
    *gradient = pr.fixed_reg * e;
  } else if (a >= 6) {
    const float reg = a == 6 ? pr.affine_reg_a : pr.affine_reg_b;
    *weight = reg;
    *gradient = reg * (pr.affine0[f * 2 + a - 6] + e);
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const double* __restrict__ pair_part, const double* __restrict__ schur_part,
              int k, int tiles, int lm_blocks, Priors pr, const int* __restrict__ lm_state,
              float* __restrict__ h_out, float* __restrict__ b_out,
              float* __restrict__ h_schur, float* __restrict__ b_schur) {
  if (ba::lm_done(lm_state)) return;
  const int kb = k * 8;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= kb * kb + kb) return;
  const size_t schur_stride = (size_t)kb * kb + kb;
  double schur = 0.0;
  for (int blk = 0; blk < lm_blocks; ++blk) schur += schur_part[blk * schur_stride + e];

  double sum = 0.0;
  if (e < kb * kb) {
    // H[(bi, a), (bj, b)] = [bi == bj] (h_rr[bi] + h_tt[bi])[a, b]
    //                       + h_rt[bi, bj][a, b] + h_rt[bj, bi][b, a]
    const int row = e / kb, col = e % kb;
    const int bi = row / 8, a = row % 8, bj = col / 8, b = col % 8;
    if (bi == bj) {
      for (int f = 0; f < k; ++f)
        for (int t = 0; t < tiles; ++t) {
          sum += pair_part[((size_t)(bi * k + f) * tiles + t) * kPairOut + a * kCols + b];
          sum += pair_part[((size_t)(f * k + bi) * tiles + t) * kPairOut +
                           (8 + a) * kCols + 8 + b];
        }
    }
    for (int t = 0; t < tiles; ++t) {
      sum += pair_part[((size_t)(bi * k + bj) * tiles + t) * kPairOut + a * kCols + 8 + b];
      sum += pair_part[((size_t)(bj * k + bi) * tiles + t) * kPairOut + b * kCols + 8 + a];
    }
    float weight = 0.0f, gradient;
    if (row == col) prior_entry(pr, bi, a, &weight, &gradient);
    h_out[e] = (float)sum + weight;
    h_schur[e] = (float)schur;
  } else {
    // b[(bi, a)] = b_r[bi][a] + b_t[bi][a]
    const int row = e - kb * kb;
    const int bi = row / 8, a = row % 8;
    for (int f = 0; f < k; ++f)
      for (int t = 0; t < tiles; ++t) {
        sum += pair_part[((size_t)(bi * k + f) * tiles + t) * kPairOut + kCols * kCols + a];
        sum += pair_part[((size_t)(f * k + bi) * tiles + t) * kPairOut + kCols * kCols + 8 + a];
      }
    float weight, gradient;
    prior_entry(pr, bi, a, &weight, &gradient);
    b_out[row] = (float)sum + gradient;
    b_schur[row] = (float)schur;
  }
}

}  // namespace

// FEJ cache and evaluation as ba_fej / ba_evaluate write them; eps [k,8],
// affine0 [k,2]; frame_valid, frame_fixed, frame_marg [k] u8; the priors'
// weights.  Scratch from the caller: pair_part [k*k*tiles*272] f64, lm_part
// [k*k*n*18] f32, schur_part [lm_blocks*(64k^2 + 8k)] f64, with tiles =
// ceil(n / 64) and lm_blocks = ceil(k*n / 32).  Outputs: h, h_schur
// [8k,8k]; b, b_schur [8k] (h and b with the diagonal priors); hpd [k,n,k,8];
// inv_hdd, b_d [k,n].  lm_state: the LM loop's state or nullptr.  Returns
// cudaErrorInvalidValue (1) for k above kMaxFrames (40) or a scratch layout
// that is not the kernels'.
extern "C" int ba_linearize_schur(
    const float* d_uv_ref, const float* d_uv_tgt, const float* d_uv_idepth,
    const float* corrected_ref, const float* scale0, const unsigned char* geom_valid,
    const float* residuals, const float* weight, const float* gx, const float* gy,
    const unsigned char* ok, const float* eps, const float* affine0,
    const unsigned char* frame_valid, const unsigned char* frame_fixed,
    const unsigned char* frame_marg, int k, int n, int marg_pass, float threshold,
    float scale_reg, float fixed_reg, float affine_reg_a, float affine_reg_b, int tiles,
    int lm_blocks, const int* lm_state, double* pair_part, float* lm_part, double* schur_part,
    float* h_out, float* b_out, float* h_schur, float* b_schur, float* hpd,
    float* inv_hdd, float* b_d, void* stream) {
  if (k < 1 || k > kMaxFrames || n < 1 || tiles != (n + kTileLm - 1) / kTileLm ||
      lm_blocks != (k * n + kChunkLm - 1) / kChunkLm)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int kb = k * 8;
  pair_kernel<<<dim3(tiles, k * k), kThreads, 0, s>>>(
      d_uv_ref, d_uv_tgt, d_uv_idepth, corrected_ref, scale0, geom_valid, residuals,
      weight, gx, gy, ok, n, tiles, lm_state, pair_part, lm_part);
  const size_t lm_shared_bytes = (size_t)(kChunkLm * (kb + 1) + 2 * kChunkLm) * sizeof(float);
  landmark_kernel<<<lm_blocks, kThreads, lm_shared_bytes, s>>>(
      lm_part, frame_fixed, k, n, marg_pass, threshold, scale_reg, lm_state, hpd, inv_hdd,
      b_d, schur_part);
  const Priors pr = {eps,       affine0,   frame_valid,  frame_fixed, frame_marg,
                     marg_pass, fixed_reg, affine_reg_a, affine_reg_b};
  reduce_kernel<<<(kb * kb + kb + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      pair_part, schur_part, k, tiles, lm_blocks, pr, lm_state, h_out, b_out, h_schur, b_schur);
  return (int)cudaGetLastError();
}
