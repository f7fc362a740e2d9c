// K1 pyramid_maps: one pyramid level's (intensity, dx, dy) map.
//
// Replaces dsopp_tpu/features/pyramid.py::build_pyramid_maps (with
// downscale and core/interpolate.py::image_gradients / build_pixel_map).
//
// Bound: device-memory bytes.  Level 0 of a VGA frame reads 1.2 MB and
// writes 3.7 MB; every other level is a quarter of the one before, so the
// whole pyramid moves ~6.5 MB and has no arithmetic to speak of.
// Design: one thread per output pixel, a 32-wide block row so that a warp
// reads and writes neighbouring addresses; the next level's intensity is
// never stored twice: each thread recomputes the 2x2 means of its four
// neighbours from the source level (L1/L2 hits) instead of a second pass.
// One launch per level; level l+1 reads level l's intensity plane.
//
// The same launch at downsample = 0 builds a frame embedder's [3C, h, w] map
// from its [C, h, w] channels (core/interpolate.py::build_pixel_map at C,
// the group layout [values C | dx C | dy C]): grid z runs over the channels,
// channel c's value, dx and dy go to planes c, C + c and 2C + c.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float level_value(const float* __restrict__ src,
                                             int src_w, int y, int x,
                                             int downsample) {
  if (!downsample) return __ldg(src + (size_t)y * src_w + x);
  const float* p = src + (size_t)(2 * y) * src_w + 2 * x;
  // 2x2 mean, summed row-major as the plain version does
  return 0.25f * (((__ldg(p) + __ldg(p + 1)) + __ldg(p + src_w)) +
                  __ldg(p + src_w + 1));
}

__global__ void pyramid_level_kernel(const float* __restrict__ src, int src_h, int src_w,
                                     float* __restrict__ out, int h, int w,
                                     int downsample, int channels) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int c = blockIdx.z;
  src += (size_t)c * src_h * src_w;
  const float v = level_value(src, src_w, y, x, downsample);
  float dx, dy;
  // 1/2 central differences inside, one-sided undivided at the border
  if (x == 0) {
    dx = level_value(src, src_w, y, 1, downsample) - v;
  } else if (x == w - 1) {
    dx = v - level_value(src, src_w, y, w - 2, downsample);
  } else {
    dx = 0.5f * (level_value(src, src_w, y, x + 1, downsample) -
                 level_value(src, src_w, y, x - 1, downsample));
  }
  if (y == 0) {
    dy = level_value(src, src_w, 1, x, downsample) - v;
  } else if (y == h - 1) {
    dy = v - level_value(src, src_w, h - 2, x, downsample);
  } else {
    dy = 0.5f * (level_value(src, src_w, y + 1, x, downsample) -
                 level_value(src, src_w, y - 1, x, downsample));
  }
  const size_t plane = (size_t)h * w;
  const size_t i = (size_t)y * w + x;
  out[c * plane + i] = v;
  out[(channels + c) * plane + i] = dx;
  out[(2 * channels + c) * plane + i] = dy;
}

}  // namespace

// src: [channels, src_h, src_w] f32; out: [3 channels, h, w] f32 with
// h = src_h / 2, w = src_w / 2 when downsample, else h = src_h, w = src_w.
// A level of the pyramid has one channel; a channel map downsample = 0.
extern "C" int pyramid_level(const float* src, int src_h, int src_w,
                             float* out, int h, int w, int downsample,
                             int channels, void* stream) {
  if (channels < 1 || (downsample && channels != 1)) return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, channels);
  pyramid_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      src, src_h, src_w, out, h, w, downsample, channels);
  return (int)cudaGetLastError();
}
