// K2 align_residual_system: residuals and the 8x8 Gauss-Newton system of
// the frontend pose alignment, for a batch of pose hypotheses.
//
// Replaces the with_jacobian=True body of
// dsopp_tpu/solvers/pose_alignment.py::_residual_system (C = 1) together
// with core/reproject.py::reproject_jacobian and the bilinear sampling of
// ops/sample.py (sampled directly from the [3, H, W] map, no corner
// packing).  The affine priors are added by the caller.
//
// Bound: latency.  One call touches <= 2000 points (~50 KB of scattered
// map reads), so what costs is the launch-to-result time, not bytes or
// flops.  Design: one block per hypothesis; the block's work is
// align::residual_system_block of align_body.cuh, which the LM loop K3
// (align_level.cu) runs once per iteration without leaving the device.

#include "align_body.cuh"

namespace {

using namespace align;

template <bool kMulti>
__global__ void __launch_bounds__(kThreads)
align_residual_kernel(Problem prob, const float* __restrict__ pose_q,
                      const float* __restrict__ pose_t,
                      const float* __restrict__ affine,
                      const float* __restrict__ ref,  // a_r, b_r, ratio
                      float* __restrict__ out_h, float* __restrict__ out_b,
                      float* __restrict__ out_e, int* __restrict__ out_n) {
  __shared__ float part[kWarps][kSys];
  __shared__ float sys[kSys];
  const int hyp = blockIdx.x;
  prob.a_r = ref[0];
  prob.b_r = ref[1];
  prob.ratio = ref[2];
  const Pose ps = {pose_q[4 * hyp + 0],
                   {pose_q[4 * hyp + 1], pose_q[4 * hyp + 2], pose_q[4 * hyp + 3]},
                   {pose_t[3 * hyp + 0], pose_t[3 * hyp + 1], pose_t[3 * hyp + 2]},
                   affine[2 * hyp + 0], affine[2 * hyp + 1]};
  residual_system_block<kMulti>(prob, ps, part, sys);

  const int i = threadIdx.x;
  if (i < 36) {
    // upper-triangle index -> (row, col); write both halves
    int row = 0, rem = i;
    while (rem >= 8 - row) {
      rem -= 8 - row;
      ++row;
    }
    const int col = row + rem;
    out_h[64 * hyp + 8 * row + col] = sys[i];
    out_h[64 * hyp + 8 * col + row] = sys[i];
  } else if (i < 44) {
    out_b[8 * hyp + (i - 36)] = sys[i];
  } else if (i == kEnergy) {
    out_e[hyp] = sys[i];
  } else if (i == kCount) {
    out_n[hyp] = __float_as_int(sys[i]);
  }
}

}  // namespace

// Points [n] (uv [n,2], idepth f32, intensity [n] or [n,C] f32; valid u8),
// map [3C,h,w] f32 of C channels,
// hypotheses [num_hyp] (pose_q [.,4], pose_t [.,3], affine [.,2]), ref [3] =
// (a_ref, b_ref, exposure ratio).  Outputs: H [num_hyp,8,8], b [num_hyp,8],
// energy [num_hyp] (no priors), num_valid [num_hyp] int32.
extern "C" int align_residual_system(
    const float* uv, const float* idepth, const float* intensity,
    const unsigned char* valid, int n, const float* map, int h, int w, int channels,
    const float* pose_q, const float* pose_t, const float* affine,
    const float* ref, int num_hyp, float fx, float fy, float cx, float cy,
    float width, float height, float sigma, float* out_h, float* out_b,
    float* out_e, int* out_n, void* stream) {
  if (channels < 1) return (int)cudaErrorInvalidValue;
  const align::Problem prob = {uv, idepth, intensity, valid, n,  map,   h,
                             w,  channels, fx,     fy,        cx,    cy, width, height,
                             0.0f, 0.0f, 0.0f, sigma};
  auto kernel = channels == 1 ? align_residual_kernel<false> : align_residual_kernel<true>;
  kernel<<<num_hyp, align::kThreads, 0, (cudaStream_t)stream>>>(
      prob, pose_q, pose_t, affine, ref, out_h, out_b, out_e, out_n);
  return (int)cudaGetLastError();
}
