// K8 ba_linearize_schur: the Gauss-Newton system of the windowed BA from an
// evaluation, with the landmark Schur complement.
//
// Replaces dsopp_tpu/solvers/pba.py::_linearize_from_ev and, inside it, the
// first-estimate Jacobians (FEJ) of pba.py::_fej_cache (once kernel K6, a
// cache of 27 floats a residual written once and read back every
// iteration): the Jacobian chain (FEJ geometry x current gradients, frozen
// affine columns), H_pp [8k, 8k] and b [8k], the per-landmark pose-idepth
// blocks hpd [k, n, k, 8], h_dd and b_d [k, n], inv_hdd with the nullspace
// threshold and the marginalization pass's scale regularizer, and
// H_schur = sum hpd inv_hdd hpd^T, b_schur = sum hpd inv_hdd b_d.
//
// Bound: bytes (the evaluation, ~14 B a residual, ~11 MB at the dense point
// K = 17, N = 340, and the window's landmark fields, read once).  The FEJ
// depend on the linearization point only, and forming a residual's 27 values
// takes ~150 f32 operations against the 108 B that a cache of them moves out
// and back, so the pair kernel forms them where it reads them
// (ba_body.cuh::fej_point, the arithmetic of the cache it replaces, so the
// values are the same bits).  The long sums are f64 (H's entries span
// 1e3..5e10 and b cancels), and they run on Hopper's f64 tensor cores
// (mma.m16n8k16 .f64, the shape that reaches the card's f64 rate): each f32
// operand is converted as a lane loads its fragment, and the product of two
// f32 values is exact in f64.  No float atomics, and every sum has one fixed
// order, so two runs give the same bits (the LM accept test and the status
// machine read these sums).  Four kernels behind one entry point:
//  1. pair_kernel, one block per (pair (i, j), tile of 128 landmarks): thread
//     0 forms the pair's relative pose at the linearization point and its
//     brightness scale once (the block's first loads already in flight); in
//     chunks of 32 landmarks each thread forms one residual's FEJ and from
//     them its 16 Jacobian columns [j_anchor | j_target] and r, staged in
//     shared memory as f32 columns; warp w takes residuals 32w..32w+31 of
//     each chunk, 16 a product (A = (w J)^T with w J rounded in f32, as the
//     plain version's, B = [J | r]), and sums the pair's [16 x 16] block
//     w J^T J and the 16 entries of w J^T r in its registers; at the end the
//     8 warps' partials are added in warp order.  Per landmark the 8-point
//     f32 sums that feed hpd go out: the target term straight into
//     hpd[i, l, j], the anchor term, h_dd and b_d to scratch.
//  2. landmark_kernel, a thread per (landmark, value): sums the anchor terms,
//     h_dd and b_d over the targets in frame order (f64), adds the anchor
//     term to the diagonal block of hpd, applies the threshold and the
//     regularizer, writes inv_hdd and b_d.
//  3. schur_kernel, one block per (anchor frame i, 1 or 2 bands of 8 rows of
//     H_schur), a warp per 16 columns: walks the anchor's landmarks in order,
//     32 a stage read by consecutive threads into shared memory, 16 a
//     product, summing its part of the bands of
//     sum_l (hpd_l inv_l) [hpd_l | b_d_l]; a partial per anchor frame.
//  4. reduce_kernel, 8 slices per output entry: each slice sums every 8th
//     anchor frame's Schur partial and every 8th pair partial, then a fixed
//     tree over the slices; the 8x8 blocks placed as the plain version places them and
//     _prior_system's diagonal priors (the fixed frames' gauge prior, the
//     free frames' affine prior) added to the rounded f32 sums, as the plain
//     version adds them.
// dsopp_tpu_torch/testing/linearize_order.py mirrors this order of summation
// and the FEJ arithmetic on the CPU.
//
// C channels (a frame embedder's; pba.py:444-471): a pattern point has C
// residual rows, one a channel, which share its FEJ geometry and differ in
// their gradients, residual and frozen affine column scale (patch_c -
// b_anchor).  pair_kernel forms a point's geometry once and then stages its
// chunk C times, channel by channel, each stage the same 256 rows of 32
// landmarks as at C = 1 (shared memory and the MMA shape unchanged); the
// per-landmark sums run over the C * 8 rows channel-major, as the plain
// version's rows.  C = 1 is its own instance of the kernel (pair_kernel<false>,
// the single-channel code); C > 1 runs pair_kernel<true> with C at run time.
//
// Frames: k up to 40 (kMaxFrames: schur_kernel's 21 warps; the dense
// operating point runs k = 17).  Inside the LM loop the entry takes the
// loop's state and every kernel returns at once when the loop is done
// (ba_lm_state.cuh); the linearization point it reads is the loop's carried
// one, which K10 moves when a step relinearizes, and the evaluation it reads
// is the one of the loop's two evaluation buffers that the state names
// carried (pair_kernel picks the pointers at its top; buffer 0 outside the
// loop).
//
// Sequence axis (seq_axis.cuh): every kernel has grid z a sequence; the
// window's fields (exposure, lm_uv, lm_patch, the frame flags) are read at
// `bank_seq[z]`, the linearization point and eps at `state_seq[z]` (the
// window's sequence, or null inside the LM loop, whose carried state is the
// launch's own), the evaluation, the loop state, the scratch and the outputs
// at z.  The band grouping of schur_kernel depends on k alone.

#include <cuda_runtime.h>

#include "ba_body.cuh"
#include "ba_entries.cuh"
#include "ba_lm_state.cuh"
#include "seq_axis.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPattern = 8;
constexpr int kChunkLm = 32;                  // landmarks per stage = 256 residuals
constexpr int kTileLm = 128;                  // landmarks per pair_kernel block
constexpr int kCols = 16;                     // [j_anchor (8) | j_target (8)]
constexpr int kPairOut = kCols * kCols + kCols;  // block sums of H and b
constexpr int kLmOut = 10;                    // anchor term 8, h_dd, b_d
constexpr int kMaxFrames = 40;                // solvers/pba.py::_LINEARIZE_MAX_FRAMES
// a stage column (J's or r's value of the 256 residuals): 260 floats put an
// mma operand's 8 columns x 4 residuals on 32 distinct banks
constexpr int kColStride = kThreads + 4;
constexpr int kRedStride = 24;                // a warp's partial [16][24]: H | b | pad
constexpr int kReduceLanes = 8;               // slices per output entry in reduce_kernel
// schur_kernel's warps: 16 of the 8(k + 1) columns [hpd | b_d] each
constexpr int kSchurMaxWarps = (kMaxFrames + 2) / 2;
inline int schur_warps(int k) { return (k + 2) / 2; }

// d (16x8) += a (16x16, row) b (16x8, col) in f64 on the tensor cores (the
// shape that runs at the card's full f64 rate; m8n8k4 runs at half).  With
// g = lane / 4, t = lane % 4: a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)],
// b[i] = B[t + 4 i][g], d[i] = D[g + 8 (i / 2)][2 t + i % 2].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// one of the loop's two evaluation buffers, as K8 reads it
struct EvalIn {
  const float* residuals;
  const float* weight;
  const float* gx;
  const float* gy;
  const unsigned char* ok;

  // sequence z's buffer, of `groups` (anchor, target, landmark) groups
  __device__ EvalIn at(int z, size_t groups, int channels) const {
    const size_t res = groups * channels * kPattern;
    return {seq::at(residuals, z, res), seq::at(weight, z, groups), seq::at(gx, z, res),
            seq::at(gy, z, res), seq::at(ok, z, groups)};
  }
};

// a landmark's sums over its rows: the target term straight into hpd[i, l, j],
// the anchor term, h_dd and b_d to scratch (at C = 1 before the chunk's
// products, as the single-channel kernel wrote them; at C > 1 after the last
// channel's stage)
__device__ __forceinline__ void write_landmark_sums(float* __restrict__ hpd,
                                                    float* __restrict__ lm_part, int anchor,
                                                    int target, int k, int n, int lm,
                                                    size_t group, int p, float h_ref,
                                                    float h_tgt, float extra) {
  hpd[(((size_t)anchor * n + lm) * k + target) * 8 + p] = h_tgt;
  lm_part[group * kLmOut + p] = h_ref;
  if (p < 2) lm_part[group * kLmOut + 8 + p] = extra;
}

// kMulti: the instance for C > 1 channels, with two blocks an SM (128
// registers a thread: the C loop holds the point's FEJ geometry and the
// landmark sums across the stages); the C = 1 instance keeps three
template <bool kMulti>
__global__ void __launch_bounds__(kThreads, kMulti ? 2 : 3)
pair_kernel(const float* __restrict__ t_lin_q, const float* __restrict__ t_lin_t,
            const float* __restrict__ affine0, const float* __restrict__ exposure,
            const float* __restrict__ lm_uv, const float* __restrict__ lin_idepth,
            const float* __restrict__ lm_patch, ba::Camera cam,
            EvalIn ev0, EvalIn ev1, int k, int n, int channels_in, int tiles,
            const int* __restrict__ lm_state, double* __restrict__ pair_part,
            float* __restrict__ lm_part, float* __restrict__ hpd,
            const int* __restrict__ bank_seq, const int* __restrict__ state_seq) {
  const int z = blockIdx.z;
  lm_state = seq::at(lm_state, z, ba::kLmFields);
  if (ba::lm_done(lm_state)) return;
  {
    const int sb = seq::of(bank_seq), ss = seq::of(state_seq);
    const size_t kn = (size_t)k * n;
    t_lin_q = seq::at(t_lin_q, ss, 4 * k);
    t_lin_t = seq::at(t_lin_t, ss, 3 * k);
    affine0 = seq::at(affine0, ss, 2 * k);
    lin_idepth = seq::at(lin_idepth, ss, kn);
    exposure = seq::at(exposure, sb, k);
    lm_uv = seq::at(lm_uv, sb, 2 * kn);
    lm_patch = seq::at(lm_patch, sb, kn * channels_in * kPattern);
    ev0 = ev0.at(z, kn * k, channels_in);
    ev1 = ev1.at(z, kn * k, channels_in);
    pair_part = seq::at(pair_part, z, (size_t)k * k * tiles * kPairOut);
    lm_part = seq::at(lm_part, z, kn * k * kLmOut);
    hpd = seq::at(hpd, z, kn * k * 8);
  }
  // the carried evaluation of the loop (buffer 0 outside it)
  const EvalIn ev = ba::carried_buffer(lm_state) ? ev1 : ev0;
  const float* __restrict__ residuals = ev.residuals;
  const float* __restrict__ weight = ev.weight;
  const float* __restrict__ gx = ev.gx;
  const float* __restrict__ gy = ev.gy;
  const unsigned char* __restrict__ ok = ev.ok;
  // the warps' [16][24] f64 partials at the end; the stage's columns J | r, a
  // residual each (f32); the pair's pose and brightness scale
  __shared__ double red[kWarps * kCols * kRedStride];
  __shared__ float cols[kCols + 1][kColStride];
  __shared__ float jd_s[kThreads];
  __shared__ float w_s[kChunkLm];
  __shared__ ba::Rigid rel_s;
  __shared__ float scale_s;

  const int channels = kMulti ? channels_in : 1;
  const int pair = blockIdx.y, tile = blockIdx.x;
  const int anchor = pair / k, target = pair % k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ln = tid / kPattern, p = tid % kPattern;
  const int g = lane >> 2, t4 = lane & 3;
  const float b_anchor = affine0[2 * anchor + 1];
  double acc[3][4];                           // n-tiles J 0..7, J 8..15, [r | 0]
#pragma unroll
  for (int t = 0; t < 3; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0;

  for (int chunk = 0; chunk < kTileLm / kChunkLm; ++chunk) {
    const int lm0 = tile * kTileLm + chunk * kChunkLm;
    if (lm0 >= n) break;
    const int lm = lm0 + ln;
    // this residual's inputs (channel 0's), all loads issued before the first
    // chunk's barrier; lanes past the last landmark read the last one's
    // geometry, so that every lane takes part in the pattern's shuffle
    const bool live = lm < n;
    const size_t at = (size_t)anchor * n + (live ? lm : n - 1);   // the anchor's landmark
    const size_t group = (size_t)pair * n + lm;
    const size_t res = group * channels * kPattern + p;
    float wgt = 0.0f, g_x = 0.0f, g_y = 0.0f, r = 0.0f;
    bool ok_g = false;
    if (live) {
      ok_g = ok[group] != 0;
      wgt = weight[group];
      g_x = gx[res];
      g_y = gy[res];
      r = residuals[res];
    }
    const float u = lm_uv[2 * at] + ba::kPatternX[p];
    const float v = lm_uv[2 * at + 1] + ba::kPatternY[p];
    const float d = lin_idepth[at];
    float patch = lm_patch[at * channels * kPattern + p];
    if (chunk == 0) {
      if (tid == 0) {
        rel_s = ba::relative_pose(t_lin_q, t_lin_t, nullptr, anchor, target);
        const float ratio = exposure[target] / fmaxf(exposure[anchor], 1e-12f);
        scale_s = ratio * expf(affine0[2 * target] - affine0[2 * anchor]);
      }
      __syncthreads();
    }
    const float s0 = scale_s;
    // the point's geometry, once; its C residual rows (one a channel) follow
    const ba::Fej f = ba::fej_point(cam, rel_s, u, v, d);
    float corrected = ba::fej_corrected(s0, patch, b_anchor);
    const bool geom_valid = ba::all_of_pattern(f.valid ? 1 : 0) != 0;
    // the per-landmark sums over its C * 8 rows, channel by channel (C > 1)
    float h_ref = 0.0f, h_tgt = 0.0f, extra = 0.0f;
    for (int c = 0; c < channels; ++c) {
      if (c > 0) {
        if (live) {
          const size_t res_c = res + (size_t)c * kPattern;
          g_x = gx[res_c];
          g_y = gy[res_c];
          r = residuals[res_c];
        }
        patch = lm_patch[(at * channels + c) * kPattern + p];
        corrected = ba::fej_corrected(s0, patch, b_anchor);
      }
      float row[kCols];
      float jd = 0.0f;
#pragma unroll
      for (int col = 0; col < kCols; ++col) row[col] = 0.0f;
      if (live) {
        if (!(ok_g && geom_valid)) wgt = 0.0f;
#pragma unroll
        for (int col = 0; col < 6; ++col) {
          row[col] = g_x * f.ref[col] + g_y * f.ref[6 + col];
          row[8 + col] = g_x * f.tgt[col] + g_y * f.tgt[6 + col];
        }
        row[6] = corrected;
        row[7] = s0;
        row[14] = -corrected;
        row[15] = -1.0f;
        jd = g_x * f.idepth[0] + g_y * f.idepth[1];
      }
#pragma unroll
      for (int col = 0; col < kCols; ++col) cols[col][tid] = row[col];
      cols[kCols][tid] = r;
      jd_s[tid] = jd;
      if (p == 0) w_s[ln] = wgt;
      __syncthreads();

      // per landmark: sum over its 8 points of (w J)[col] j_d, j_d^2 w, j_d r w
      if (lm < n) {
        const float wv = w_s[ln];
        float s_ref = kMulti ? h_ref : 0.0f, s_tgt = kMulti ? h_tgt : 0.0f;
        float s_extra = kMulti ? extra : 0.0f;
        for (int pp = 0; pp < kPattern; ++pp) {
          const int t = ln * kPattern + pp;
          s_ref += (wv * cols[p][t]) * jd_s[t];
          s_tgt += (wv * cols[8 + p][t]) * jd_s[t];
          if (p == 0) s_extra += (jd_s[t] * jd_s[t]) * wv;
          if (p == 1) s_extra += (jd_s[t] * cols[kCols][t]) * wv;
        }
        if (kMulti) {
          h_ref = s_ref;
          h_tgt = s_tgt;
          extra = s_extra;
        } else {
          write_landmark_sums(hpd, lm_part, anchor, target, k, n, lm, group, p, s_ref, s_tgt,
                              s_extra);
        }
      }

      // warp w: residuals 32w..32w+31, sixteen a product, in order.  A = (w J)^T
      // (16 x 16 residuals; w J rounded in f32), B = [J | r] (16 residuals x
      // 24): lane (g, t) takes columns g and 8 + g of residuals t + 4j
#pragma unroll
      for (int step = 0; step < 2; ++step) {
        double a[8], b[3][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = warp * 32 + step * 16 + t4 + 4 * j;
          const float x = cols[g][t], y = cols[8 + g][t], wv = w_s[t / kPattern];
          a[2 * j] = (double)(wv * x);
          a[2 * j + 1] = (double)(wv * y);
          b[0][j] = (double)x;
          b[1][j] = (double)y;
          b[2][j] = g == 0 ? (double)cols[kCols][t] : 0.0;
        }
        dmma(acc[0], a, b[0]);
        dmma(acc[1], a, b[1]);
        dmma(acc[2], a, b[2]);
      }
      __syncthreads();
    }
    if (kMulti && lm < n)
      write_landmark_sums(hpd, lm_part, anchor, target, k, n, lm, group, p, h_ref, h_tgt, extra);
  }

  // the warps' [16][24] partials, summed in warp order: entry (a, b) of
  // sum (w J)^T J and entry c of sum (w J)^T r
  double* mine = red + warp * kCols * kRedStride;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mine[(g + 8 * (i / 2)) * kRedStride + t * 8 + 2 * t4 + i % 2] = acc[t][i];
  __syncthreads();
  double* out = pair_part + ((size_t)pair * tiles + tile) * kPairOut;
  for (int e = tid; e < kPairOut; e += kThreads) {
    const int at = e < kCols * kCols ? (e / kCols) * kRedStride + e % kCols
                                     : (e - kCols * kCols) * kRedStride + kCols;
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += red[w * kCols * kRedStride + at];
    out[e] = sum;
  }
}

// thread (landmark g = (i, l), value q): q < 8 the anchor term of hpd's
// diagonal block, q = 8 h_dd -> inv_hdd, q = 9 b_d; sums over the targets in
// frame order
__global__ void __launch_bounds__(kThreads)
landmark_kernel(const float* __restrict__ lm_part, const unsigned char* __restrict__ frame_fixed,
                int k, int n, int marg_pass, float threshold, float scale_reg,
                const int* __restrict__ lm_state, float* __restrict__ hpd,
                float* __restrict__ inv_hdd, float* __restrict__ b_d,
                const int* __restrict__ bank_seq) {
  const int z = blockIdx.z;
  lm_state = seq::at(lm_state, z, ba::kLmFields);
  if (ba::lm_done(lm_state)) return;
  {
    const size_t kn = (size_t)k * n;
    frame_fixed = seq::at(frame_fixed, seq::of(bank_seq), k);
    lm_part = seq::at(lm_part, z, kn * k * kLmOut);
    hpd = seq::at(hpd, z, kn * k * 8);
    inv_hdd = seq::at(inv_hdd, z, kn);
    b_d = seq::at(b_d, z, kn);
  }
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= k * n * kLmOut) return;
  const int g = e / kLmOut, q = e % kLmOut;
  const int i = g / n, l = g % n;
  double sum = 0.0;
  for (int j = 0; j < k; ++j) sum += (double)lm_part[(((size_t)i * k + j) * n + l) * kLmOut + q];
  if (q < 8) {
    const size_t at = ((size_t)g * k + i) * 8 + q;
    hpd[at] = hpd[at] + (float)sum;
  } else if (q == 8) {
    float hdd = (float)sum;
    if (marg_pass && frame_fixed[i] && hdd > threshold) hdd = hdd + scale_reg;
    inv_hdd[g] = hdd > threshold ? 1.0f / hdd : 0.0f;
  } else {
    b_d[g] = (float)sum;
  }
}

// block (group of kBands bands, anchor i), a warp per 16 columns of
// [hpd_l (8k) | b_d_l | 0]: rows 8 band .. 8 band + 7 of each of its bands of
// sum_l [hpd_l | b_d_l]^T (hpd_l inv_l) over the landmarks l of frame i, 16
// a product, in order.  The anchor's rows are contiguous in hpd: a stage of
// kChunkLm rows is read in float4s by consecutive threads (the next stage's
// while this one's products run) into shared memory as f32, and the
// fragments are converted as the lanes read them.  Row m of the warp's A' is
// column 16 w + 2 (m % 8) + m / 8, so a lane's two columns are one float2.
constexpr int kSchurVecs = 4;                 // float4s of a stage a thread loads, at most

// floats of a staged row: 16 (k + 2) / 2 columns at least (the warps'
// columns), 8 mod 32, so a fragment's 4 rows x 8 floats fall on 32 banks
__host__ __device__ inline int schur_stride(int k) {
  const int cols = 16 * ((k + 2) / 2);
  return cols + ((8 - cols % 32) + 32) % 32;
}

template <int kBands>
__global__ void __launch_bounds__(kSchurMaxWarps * 32)
schur_kernel(const float* __restrict__ hpd, const float* __restrict__ inv_hdd,
             const float* __restrict__ b_d, int k, int n, const int* __restrict__ lm_state,
             double* __restrict__ schur_part) {
  {
    const int z = blockIdx.z;
    const size_t kn = (size_t)k * n, kb = 8 * (size_t)k;
    lm_state = seq::at(lm_state, z, ba::kLmFields);
    hpd = seq::at(hpd, z, kn * kb);
    inv_hdd = seq::at(inv_hdd, z, kn);
    b_d = seq::at(b_d, z, kn);
    schur_part = seq::at(schur_part, z, k * (kb * kb + kb));
  }
  if (ba::lm_done(lm_state)) return;
  extern __shared__ float stage_s[];          // [kChunkLm][stride], then inv [kChunkLm]
  const int kb = 8 * k, first_band = blockIdx.x * kBands, i = blockIdx.y;
  const int stride = schur_stride(k), threads = blockDim.x;
  float* inv_s = stage_s + kChunkLm * stride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t g0 = (size_t)i * n;
  const int col = warp * 16 + 2 * g;          // this lane's columns col, col + 1
  const int row_vecs = kb / 4;
  for (int e = tid; e < kChunkLm * stride; e += threads) stage_s[e] = 0.0f;
  float4 v[kSchurVecs];
  float bd = 0.0f, inv = 0.0f;
  auto load = [&](int l0) {
    const int rows = min(kChunkLm, n - l0);
    const float4* src = reinterpret_cast<const float4*>(hpd + (g0 + l0) * kb);
#pragma unroll
    for (int u = 0; u < kSchurVecs; ++u) {
      const int e = tid + u * threads;
      v[u] = e < rows * row_vecs ? __ldg(src + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    bd = tid < rows ? __ldg(b_d + g0 + l0 + tid) : 0.0f;
    inv = tid < rows ? __ldg(inv_hdd + g0 + l0 + tid) : 0.0f;
  };
  double acc[kBands][4] = {};
  load(0);
  for (int l0 = 0; l0 < n; l0 += kChunkLm) {
    const int rows = min(kChunkLm, n - l0);
    __syncthreads();                          // the previous stage's products are done
#pragma unroll
    for (int u = 0; u < kSchurVecs; ++u) {
      const int e = tid + u * threads;
      if (e < rows * row_vecs) {
        const int r = e / row_vecs, c = 4 * (e - r * row_vecs);
        *reinterpret_cast<float4*>(stage_s + r * stride + c) = v[u];
      }
    }
    if (tid < kChunkLm) {
      stage_s[tid * stride + kb] = bd;        // rows past the last landmark: inv 0
      inv_s[tid] = inv;
    }
    __syncthreads();
    if (l0 + kChunkLm < n) load(l0 + kChunkLm);
#pragma unroll
    for (int step = 0; step < kChunkLm / 16; ++step) {
      double a[8];
      float inv_l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = step * 16 + t4 + 4 * j;
        const float2 pr = *reinterpret_cast<const float2*>(stage_s + l * stride + col);
        a[2 * j] = (double)pr.x;
        a[2 * j + 1] = (double)pr.y;
        inv_l[j] = inv_s[l];
      }
#pragma unroll
      for (int bb = 0; bb < kBands; ++bb) {
        const int at = min(first_band + bb, k - 1) * 8 + g;
        double b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = (double)(stage_s[(step * 16 + t4 + 4 * j) * stride + at] * inv_l[j]);
        dmma(acc[bb], a, b);
      }
    }
  }
  // acc[bb][q] = D'[row m = g + 8 (q / 2) of A'][row 8 band + 2 t + q % 2 of H]
  double* out = schur_part + (size_t)i * (kb * kb + kb);
#pragma unroll
  for (int bb = 0; bb < kBands; ++bb) {
    if (first_band + bb >= k) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = col + q / 2, row = (first_band + bb) * 8 + 2 * t4 + q % 2;
      if (c < kb) out[(size_t)row * kb + c] = acc[bb][q];
      else if (c == kb) out[(size_t)kb * kb + row] = acc[bb][q];
    }
  }
}

size_t schur_shared_bytes(int k) {
  return sizeof(float) * (kChunkLm * schur_stride(k) + kChunkLm);
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

  // the priors of the sequences the bank and the state lists name (sb, ss)
  __device__ Priors at(int sb, int ss, int k) const {
    Priors p = *this;
    p.eps = seq::at(eps, ss, 8 * k);
    p.affine0 = seq::at(affine0, ss, 2 * k);
    p.frame_valid = seq::at(frame_valid, sb, k);
    p.frame_fixed = seq::at(frame_fixed, sb, k);
    p.frame_marg = seq::at(frame_marg, sb, k);
    return p;
  }
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

// the 8 slices' sums of an entry -> ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7))
__device__ __forceinline__ double slice_tree(const double (&s)[kReduceLanes]) {
  return ((s[0] + s[4]) + (s[2] + s[6])) + ((s[1] + s[5]) + (s[3] + s[7]));
}

// 32 entries of H | b a block, 8 slices an entry (thread q * 32 + x: entry x,
// slice q, so neighbouring threads read neighbouring entries): slice q sums
// the anchor frames q, q + 8, ... of the Schur partials and, of the pair
// partials, the frames f = q, q + 8, ... of a diagonal block's (bi, f) and
// (f, bi) pairs, then the tiles q, q + 8, ... of the (bi, bj) and (bj, bi)
// pairs; slice_tree adds the slices
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const double* __restrict__ pair_part, const double* __restrict__ schur_part,
              int k, int tiles, Priors pr, const int* __restrict__ lm_state,
              float* __restrict__ h_out, float* __restrict__ b_out,
              float* __restrict__ h_schur, float* __restrict__ b_schur,
              const int* __restrict__ bank_seq, const int* __restrict__ state_seq) {
  {
    const int z = blockIdx.z;
    const size_t kb = 8 * (size_t)k;
    lm_state = seq::at(lm_state, z, ba::kLmFields);
    pair_part = seq::at(pair_part, z, (size_t)k * k * tiles * kPairOut);
    schur_part = seq::at(schur_part, z, k * (kb * kb + kb));
    pr = pr.at(seq::of(bank_seq), seq::of(state_seq), k);
    h_out = seq::at(h_out, z, kb * kb);
    b_out = seq::at(b_out, z, kb);
    h_schur = seq::at(h_schur, z, kb * kb);
    b_schur = seq::at(b_schur, z, kb);
  }
  if (ba::lm_done(lm_state)) return;
  __shared__ double slices[2][kReduceLanes][kThreads / kReduceLanes];
  const int kb = k * 8;
  const int x = threadIdx.x % (kThreads / kReduceLanes), q = threadIdx.x / (kThreads / kReduceLanes);
  const int e = blockIdx.x * (kThreads / kReduceLanes) + x;
  const bool live = e < kb * kb + kb;
  const size_t schur_stride = (size_t)kb * kb + kb;
  double schur = 0.0, sum = 0.0;
  if (live) {
    for (int f = q; f < k; f += kReduceLanes) schur += schur_part[f * schur_stride + e];
    if (e < kb * kb) {
      // H[(bi, a), (bj, b)] = [bi == bj] (h_rr[bi] + h_tt[bi])[a, b]
      //                       + h_rt[bi, bj][a, b] + h_rt[bj, bi][b, a]
      const int row = e / kb, col = e % kb;
      const int bi = row / 8, a = row % 8, bj = col / 8, b = col % 8;
      if (bi == bj) {
        for (int f = q; f < k; f += kReduceLanes)
          for (int t = 0; t < tiles; ++t) {
            sum += pair_part[((size_t)(bi * k + f) * tiles + t) * kPairOut + a * kCols + b];
            sum += pair_part[((size_t)(f * k + bi) * tiles + t) * kPairOut +
                             (8 + a) * kCols + 8 + b];
          }
      }
      for (int t = q; t < tiles; t += kReduceLanes) {
        sum += pair_part[((size_t)(bi * k + bj) * tiles + t) * kPairOut + a * kCols + 8 + b];
        sum += pair_part[((size_t)(bj * k + bi) * tiles + t) * kPairOut + b * kCols + 8 + a];
      }
    } else {
      // b[(bi, a)] = b_r[bi][a] + b_t[bi][a]
      const int row = e - kb * kb;
      const int bi = row / 8, a = row % 8;
      for (int f = q; f < k; f += kReduceLanes)
        for (int t = 0; t < tiles; ++t) {
          sum += pair_part[((size_t)(bi * k + f) * tiles + t) * kPairOut + kCols * kCols + a];
          sum += pair_part[((size_t)(f * k + bi) * tiles + t) * kPairOut + kCols * kCols + 8 + a];
        }
    }
  }
  slices[0][q][x] = schur;
  slices[1][q][x] = sum;
  __syncthreads();
  if (!live || q != 0) return;
  double s_schur[kReduceLanes], s_sum[kReduceLanes];
#pragma unroll
  for (int r = 0; r < kReduceLanes; ++r) {
    s_schur[r] = slices[0][r][x];
    s_sum[r] = slices[1][r][x];
  }
  schur = slice_tree(s_schur);
  sum = slice_tree(s_sum);
  if (e < kb * kb) {
    const int row = e / kb, col = e % kb;
    float weight = 0.0f, gradient;
    if (row == col) prior_entry(pr, row / 8, row % 8, &weight, &gradient);
    h_out[e] = (float)sum + weight;
    h_schur[e] = (float)schur;
  } else {
    const int row = e - kb * kb;
    float weight, gradient;
    prior_entry(pr, row / 8, row % 8, &weight, &gradient);
    b_out[row] = (float)sum + gradient;
    b_schur[row] = (float)schur;
  }
}


}  // namespace

// The window at the linearization point: t_lin_q [k,4], t_lin_t [k,3],
// affine0 [k,2], exposure [k], lm_uv [k,n,2], lin_idepth [k,n] (the
// landmarks' idepth there), lm_patch [k,n,C*8]; the camera; the evaluation
// of C channels as ba_evaluate writes it; eps [k,8]; frame_valid, frame_fixed, frame_marg [k]
// u8; the priors' weights.  Scratch from the caller: pair_part
// [k*k*tiles*272] f64, lm_part [k*k*n*10] f32, schur_part [k*(64k^2 + 8k)]
// f64, with tiles = ceil(n / 128).  Outputs: h, h_schur [8k,8k]; b, b_schur
// [8k] (h and b with the diagonal priors); hpd [k,n,k,8]; inv_hdd, b_d
// [k,n].  lm_state: the LM loop's state or nullptr; the evaluation is read
// from the second buffer (residuals1 ... ok1) when the state names it
// carried, else from the first (the second may then be null).  Returns
// cudaErrorInvalidValue (1) for k above kMaxFrames (40) or a tile count that
// is not the kernels'.  Sequence axis (seq_axis.cuh): `seqs` sequences, grid
// z; the window's fields above are [B, ...] stacks read at bank_seq[z], the
// linearization point (t_lin_q, t_lin_t, affine0, lin_idepth) and eps at
// state_seq[z] (null lists: z); the evaluation, lm_state, the scratch and the
// outputs are [seqs, ...] at z.
extern "C" int ba_linearize_schur(
    const float* t_lin_q, const float* t_lin_t, const float* affine0, const float* exposure,
    const float* lm_uv, const float* lin_idepth, const float* lm_patch, float fx, float fy,
    float cx, float cy, float width, float height, const float* residuals,
    const float* weight, const float* gx, const float* gy, const unsigned char* ok,
    const float* residuals1, const float* weight1, const float* gx1, const float* gy1,
    const unsigned char* ok1,
    const float* eps, const unsigned char* frame_valid, const unsigned char* frame_fixed,
    const unsigned char* frame_marg, int k, int n, int channels, int marg_pass, float threshold,
    float scale_reg, float fixed_reg, float affine_reg_a, float affine_reg_b, int tiles,
    const int* lm_state, double* pair_part, float* lm_part, double* schur_part,
    float* h_out, float* b_out, float* h_schur, float* b_schur, float* hpd,
    float* inv_hdd, float* b_d, int seqs, const int* bank_seq, const int* state_seq,
    void* stream) {
  if (k < 1 || k > kMaxFrames || n < 1 || channels < 1 ||
      tiles != (n + kTileLm - 1) / kTileLm || !seq::valid_count(seqs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int kb = k * 8;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  const EvalIn ev0 = {residuals, weight, gx, gy, ok};
  const EvalIn ev1 = {residuals1, weight1, gx1, gy1, ok1};
  auto pair = channels == 1 ? pair_kernel<false> : pair_kernel<true>;
  pair<<<dim3(tiles, k * k, seqs), kThreads, 0, s>>>(
      t_lin_q, t_lin_t, affine0, exposure, lm_uv, lin_idepth, lm_patch, cam, ev0, ev1, k, n,
      channels, tiles, lm_state, pair_part, lm_part, hpd, bank_seq, state_seq);
  landmark_kernel<<<dim3((k * n * kLmOut + kThreads - 1) / kThreads, 1, seqs), kThreads, 0,
                    s>>>(lm_part, frame_fixed, k, n, marg_pass, threshold, scale_reg, lm_state,
                         hpd, inv_hdd, b_d, bank_seq);
  // bands a Schur block takes: two where that still gives k ceil(k / 2) >= 132
  // blocks (the card's SMs; dense, K = 17), else one (standart, K = 10); each
  // band's sum has the same order whatever the grouping
  const int bands = k * ((k + 1) / 2) >= 132 ? 2 : 1;
  auto schur = bands == 2 ? schur_kernel<2> : schur_kernel<1>;
  schur<<<dim3((k + bands - 1) / bands, k, seqs), 32 * schur_warps(k), schur_shared_bytes(k),
          s>>>(
      hpd, inv_hdd, b_d, k, n, lm_state, schur_part);
  const Priors pr = {eps,       affine0,   frame_valid,  frame_fixed, frame_marg,
                     marg_pass, fixed_reg, affine_reg_a, affine_reg_b};
  const int entries_per_block = kThreads / kReduceLanes;
  reduce_kernel<<<dim3((kb * kb + kb + entries_per_block - 1) / entries_per_block, 1, seqs),
                  kThreads, 0, s>>>(pair_part, schur_part, k, tiles, pr, lm_state, h_out, b_out,
                                    h_schur, b_schur, bank_seq, state_seq);
  return (int)cudaGetLastError();
}
