// K1 pyramid_maps: every level's (intensity, dx, dy) map of a frame in one
// launch, or a frame embedder's [3C, h, w] channel map.
//
// Replaces dsopp_tpu/features/pyramid.py::build_pyramid_maps (with
// downscale and core/interpolate.py::image_gradients / build_pixel_map).
//
// Bound: device-memory bytes.  Level 0 of a VGA frame reads 1.2 MB and
// writes 3.7 MB; every other level is a quarter of the one before, so the
// whole pyramid moves ~6.5 MB and has no arithmetic to speak of.
// Design: a block per 32x32 tile of level 0, which it reads once with the
// halo its coarsest level needs (2^(L-1) pixels, so that level's tile has a
// one-pixel ring for its gradients) into shared memory, then builds each
// coarser level's tile with its halo from the finer one in shared memory
// (the 2x2 means summed row-major as the plain version does; a level's
// buffer element (r, c) is the mean of the finer buffer's (2r..2r+1,
// 2c..2c+1), since tiles and halos halve together), and writes each
// level's values and 1/2 central differences.  Halo pixels outside the
// image read 0 and only ever feed halo entries outside the level, which no
// output reads.  Level l's map lies after level l-1's in one flat buffer.
// At 5 levels a block reads a 64x64 tile of level 0 (4x its own pixels, from
// L2) and keeps 21.8 KB in shared memory.
//
// The same launch at one level builds a frame embedder's [3C, h, w] map
// from its [C, h, w] channels (core/interpolate.py::build_pixel_map at C,
// the group layout [values C | dx C | dy C]): grid z runs over the channels,
// channel c's value, dx and dy go to planes c, C + c and 2C + c.
//
// B frames of B sequences (the batched tick) are B pyramids in one launch:
// grid z runs over the frames, which a [B, h, w] source holds one after
// another.  Level l's maps are [B, 3, h_l, w_l], the levels one after
// another in the flat buffer, so a frame's map at a level is a contiguous
// [3, h_l, w_l] block.  A frame's blocks run the code and the order of a
// single frame's launch, so its maps are those of the single launch to the
// bit.  B frames' channel maps (the keyframes of the sequences that keyframe
// on a tick) are one launch too: grid z runs over frame x C + channel, and
// frame f's [3C, h, w] map is the f-th of the output's; a channel map has one
// level.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;   // level-0 pixels of a block's tile, per side
constexpr int kThreads = 512;
constexpr int kMaxLevels = 6;  // the coarsest tile is one pixel

// floats of shared memory for kLevels levels: buffer sides (32 + 2^L) >> l
__host__ __device__ constexpr int shared_floats(int levels) {
  int total = 0;
  for (int l = 0; l < levels; ++l)
    total += ((kTile + (2 << (levels - 1))) >> l) * ((kTile + (2 << (levels - 1))) >> l);
  return total;
}

// the level count is a template argument, so that every loop has a fixed
// trip count: the level-0 loads of a thread are all issued before any lands
template <int kLevels>
__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const float* __restrict__ src, int h, int w, int channels, int batch,
               float* __restrict__ out) {
  constexpr int levels = kLevels;
  constexpr int halo0 = 1 << (levels - 1);
  constexpr int side0 = kTile + 2 * halo0;
  __shared__ float buf[shared_floats(kLevels)];
  // grid z: frame x channels + channel (one channel: the frame)
  const int c = (int)blockIdx.z % channels;
  const int frame = (int)blockIdx.z / channels;
  src += (size_t)blockIdx.z * h * w;
  const int oy = blockIdx.y * kTile - halo0, ox = blockIdx.x * kTile - halo0;
#pragma unroll
  for (int j = 0; j < (side0 * side0 + kThreads - 1) / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / side0, col = e - r * side0;
    const int y = oy + r, x = ox + col;
    if (e < side0 * side0)
      buf[e] = (y >= 0 && x >= 0 && y < h && x < w) ? __ldg(src + (size_t)y * w + x) : 0.0f;
  }
  __syncthreads();
  float* lvl = buf;
  int side = side0, hl = h, wl = w;
  size_t offset = 0;
#pragma unroll
  for (int l = 0; l < levels; ++l) {
    if (l > 0) {
      float* next = lvl + side * side;
      const int ns = side >> 1;
      for (int e = threadIdx.x; e < ns * ns; e += kThreads) {
        const int r = e / ns, col = e - r * ns;
        const float* p = lvl + (2 * r) * side + 2 * col;
        next[e] = 0.25f * (((p[0] + p[1]) + p[side]) + p[side + 1]);
      }
      __syncthreads();
      lvl = next;
      side = ns;
      hl /= 2;
      wl /= 2;
    }
    const int tile = kTile >> l, halo = halo0 >> l;
    const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
    const size_t plane = (size_t)hl * wl;
    float* o = out + (size_t)batch * offset + (size_t)frame * 3 * channels * plane;
    for (int e = threadIdx.x; e < tile * tile; e += kThreads) {
      const int ty = e / tile, tx = e - ty * tile;
      const int y = y0 + ty, x = x0 + tx;
      if (y >= hl || x >= wl) continue;
      const float* p = lvl + (ty + halo) * side + tx + halo;
      const float v = p[0];
      // 1/2 central differences inside, one-sided undivided at the border
      const float dx = x == 0        ? p[1] - v
                       : x == wl - 1 ? v - p[-1]
                                     : 0.5f * (p[1] - p[-1]);
      const float dy = y == 0        ? p[side] - v
                       : y == hl - 1 ? v - p[-side]
                                     : 0.5f * (p[side] - p[-side]);
      const size_t i = (size_t)y * wl + x;
      o[c * plane + i] = v;
      o[(channels + c) * plane + i] = dx;
      o[(2 * channels + c) * plane + i] = dy;
    }
    offset += 3 * plane;
  }
}

}  // namespace

// src: [batch, channels, h, w] f32; out: the levels' [batch, 3 channels, h_l,
// w_l] maps one after another, h_0 = h, h_l = h_{l-1} / 2 (likewise w), each
// at least 2.  A pyramid has one channel; a channel map has one level.
extern "C" int pyramid_maps(const float* src, int h, int w, int channels, int levels,
                            int batch, float* out, void* stream) {
  if (channels < 1 || levels < 1 || levels > kMaxLevels || batch < 1 ||
      (channels > 1 && levels > 1) || (long long)batch * channels > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, channels * batch);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (levels) {  // shared memory <= 48 KB at 6 levels
    case 1: pyramid_kernel<1><<<grid, kThreads, 0, s>>>(src, h, w, channels, batch, out); break;
    case 2: pyramid_kernel<2><<<grid, kThreads, 0, s>>>(src, h, w, channels, batch, out); break;
    case 3: pyramid_kernel<3><<<grid, kThreads, 0, s>>>(src, h, w, channels, batch, out); break;
    case 4: pyramid_kernel<4><<<grid, kThreads, 0, s>>>(src, h, w, channels, batch, out); break;
    case 5: pyramid_kernel<5><<<grid, kThreads, 0, s>>>(src, h, w, channels, batch, out); break;
    default: pyramid_kernel<6><<<grid, kThreads, 0, s>>>(src, h, w, channels, batch, out); break;
  }
  return (int)cudaGetLastError();
}
