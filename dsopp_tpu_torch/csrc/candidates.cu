// K12 select_candidates: the well-spread high-gradient pixels of a keyframe.
//
// Replaces dsopp_tpu/features/extractor.py::select_candidates (with
// _region_threshold): g2 = dx^2 + dy^2 per pixel; per 32x32 region the median
// bin of floor(min(sqrt(g2), 49)) over 50 unit bins, squared, times the
// factor; per tile (block x block pixels) the first argmax of g2 among the
// allowed pixels above their region's threshold; then the num_points best
// tiles, the lower tile index first among equal scores.
//
// Bound: bytes (the two gradient channels and the mask are read once, about
// 2.8 MB at VGA; the outputs are a few KB).  Design: three small launches.
// (1) one block per region, a 50-bin histogram in shared memory filled with
// integer atomics, the median read by one thread (the one-hot compare of the
// TPU version is not needed).  (2) one warp per tile: the lanes stride over
// the tile's pixels in row-major order and keep their first maximum, then a
// shuffle reduction that prefers the larger score and, among equal scores,
// the lower position.  (3) the output slot of a tile is its rank: the number
// of tiles with a larger score or an equal score and a lower index.  A warp
// ranks one tile, 8 tiles a block (221 blocks at VGA and 800 points, 312 at
// 1200): the block stages the tile scores in shared memory (up to 4096 at a
// time), the lanes stride over them counting, and a warp sum gives the rank.
// The rank is exact and unique, so the slot order is that of a stable
// descending sort, with no sort and no limit on the number of tiles.  sqrtf
// is the IEEE square root (no fast-math), as torch.sqrt: a value on an
// integer decides a median.
// Sequence axis (seq_axis.cuh): grid z is a sequence of the call, and each
// of the three launches serves all S of them.  The maps are the tick's [B, 3,
// h, w] stack, read at seq[z] and never copied; the mask is the batch's one;
// the scratch (thresholds, tile scores and positions) and the outputs are
// [S, ...] at z, so a sequence's blocks do what a launch of it alone does.

#include <cuda_runtime.h>
#include <math.h>

#include "seq_axis.cuh"

namespace {

constexpr int kRegion = 32;         // features/extractor.py::REGION
constexpr int kBins = 50;           // MAX_GRADIENT_BIN
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 4096;        // tile scores staged at a time by rank_tiles_kernel: 16 KB
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float grad2(const float* __restrict__ map, int hw, int pix) {
  const float dx = map[hw + pix], dy = map[2 * hw + pix];
  return dx * dx + dy * dy;
}

__global__ void __launch_bounds__(kThreads)
region_threshold_kernel(const float* __restrict__ map, int h, int w, int rw, float factor,
                        float* __restrict__ thr, const int* __restrict__ seq_list) {
  __shared__ int hist[kBins];
  map = seq::at(map, seq::of(seq_list), (size_t)3 * h * w);
  thr = seq::at(thr, blockIdx.z, (size_t)(h / kRegion) * rw);
  const int region = blockIdx.x;
  const int ry = region / rw, rx = region % rw;
  if (threadIdx.x < kBins) hist[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kRegion * kRegion; i += kThreads) {
    const int y = ry * kRegion + i / kRegion, x = rx * kRegion + i % kRegion;
    const float g = fminf(sqrtf(grad2(map, h * w, y * w + x)), (float)(kBins - 1));
    atomicAdd(&hist[(int)g], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int half = (kRegion * kRegion) / 2;
    int run = 0, med = 0;
    for (int b = 0; b < kBins; ++b) {
      run += hist[b];
      if (run > half) {
        med = b;
        break;
      }
    }
    const float m = (float)med;
    thr[region] = m * m * factor;
  }
}

// one warp per tile -> its best score (-1: no allowed pixel above threshold)
// and the position of the first pixel that has it
__global__ void __launch_bounds__(kThreads)
tile_argmax_kernel(const float* __restrict__ map, const unsigned char* __restrict__ mask,
                   const float* __restrict__ thr, int h, int w, int rh, int rw, int block,
                   int bw, int tiles, int border, float* __restrict__ tile_score,
                   int* __restrict__ tile_pos, const int* __restrict__ seq_list) {
  map = seq::at(map, seq::of(seq_list), (size_t)3 * h * w);
  thr = seq::at(thr, blockIdx.z, (size_t)rh * rw);
  tile_score = seq::at(tile_score, blockIdx.z, tiles);
  tile_pos = seq::at(tile_pos, blockIdx.z, 2 * (size_t)tiles);
  const int tile = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (tile >= tiles) return;
  const int lane = threadIdx.x & 31;
  const int ty = tile / bw, tx = tile % bw;
  float best = -2.0f;      // below every score, so the first pixel is taken
  int best_i = 0;
  for (int i = lane; i < block * block; i += 32) {
    const int y = ty * block + i / block, x = tx * block + i % block;
    const int pix = y * w + x;
    bool allowed = y >= border && y < h - border && x >= border && x < w - border;
    if (mask != nullptr) allowed = allowed && mask[pix] != 0;
    const float g2 = grad2(map, h * w, pix);
    const float limit = thr[min(y / kRegion, rh - 1) * rw + min(x / kRegion, rw - 1)];
    const float score = (allowed && g2 > limit) ? g2 : -1.0f;
    if (score > best) {
      best = score;
      best_i = i;
    }
  }
  // a lane past the tile's end keeps -2 and loses to every real pixel
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float other = __shfl_xor_sync(kFull, best, off);
    const int other_i = __shfl_xor_sync(kFull, best_i, off);
    if (other > best || (other == best && other_i < best_i)) {
      best = other;
      best_i = other_i;
    }
  }
  if (lane == 0) {
    tile_score[tile] = best;
    tile_pos[2 * tile] = tx * block + best_i % block;
    tile_pos[2 * tile + 1] = ty * block + best_i / block;
  }
}

// warp t of the grid: the slot of tile t = its rank in (score descending,
// tile index ascending); warps past the tiles pad the slots that no tile fills
__global__ void __launch_bounds__(kThreads)
rank_tiles_kernel(const float* __restrict__ tile_score, const int* __restrict__ tile_pos,
                  int tiles, int num_points, float* __restrict__ uv,
                  float* __restrict__ grad2_out, unsigned char* __restrict__ valid) {
  __shared__ float stage[kStage];
  const int z = blockIdx.z;
  tile_score = seq::at(tile_score, z, tiles);
  tile_pos = seq::at(tile_pos, z, 2 * (size_t)tiles);
  uv = seq::at(uv, z, 2 * (size_t)num_points);
  grad2_out = seq::at(grad2_out, z, num_points);
  valid = seq::at(valid, z, num_points);
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const float mine = t < tiles ? tile_score[t] : 0.0f;
  int count = 0;
  for (int base = 0; base < tiles; base += kStage) {
    const int len = min(kStage, tiles - base);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += kThreads) stage[j] = tile_score[base + j];
    __syncthreads();
    if (t < tiles) {
      for (int j = lane; j < len; j += 32) {
        const float s = stage[j];
        count += (s > mine || (s == mine && base + j < t)) ? 1 : 0;
      }
    }
  }
  const int rank = __reduce_add_sync(kFull, count);
  if (lane != 0) return;
  if (t < tiles) {
    if (rank < num_points) {
      uv[2 * rank] = (float)tile_pos[2 * t];
      uv[2 * rank + 1] = (float)tile_pos[2 * t + 1];
      grad2_out[rank] = fmaxf(mine, 0.0f);
      valid[rank] = mine > 0.0f ? 1 : 0;
    }
  } else if (t < num_points) {
    uv[2 * t] = 0.0f;
    uv[2 * t + 1] = 0.0f;
    grad2_out[t] = 0.0f;
    valid[t] = 0;
  }
}

}  // namespace

// map [B,3,h,w] f32 (intensity, dx, dy; sequence seq[z] read); mask [h,w] u8
// or nullptr (all valid), the same for every sequence.  Scratch, no contents
// expected and none left: thr [S,(h/32)*(w/32)] f32, tile_score [S,tiles] f32,
// tile_pos [S,tiles,2] int32 with tiles = (h/block)*(w/block).  Outputs: uv
// [S,num_points,2] f32, grad2 [S,num_points] f32, valid [S,num_points] u8.
// Sequence axis (seq_axis.cuh): `seqs` sequences S, grid z; seq_list null:
// sequence z.
extern "C" int select_candidates(const float* map, const unsigned char* mask, int h, int w,
                                 int num_points, int block, int border, float factor,
                                 float* thr, float* tile_score, int* tile_pos, float* uv,
                                 float* grad2_out, unsigned char* valid, int seqs,
                                 const int* seq_list, void* stream) {
  if (!seq::valid_count(seqs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rh = h / kRegion, rw = w / kRegion;
  const int bh = h / block, bw = w / block, tiles = bh * bw;
  region_threshold_kernel<<<dim3(rh * rw, 1, seqs), kThreads, 0, s>>>(map, h, w, rw, factor,
                                                                      thr, seq_list);
  tile_argmax_kernel<<<dim3((tiles + kWarps - 1) / kWarps, 1, seqs), kThreads, 0, s>>>(
      map, mask, thr, h, w, rh, rw, block, bw, tiles, border, tile_score, tile_pos, seq_list);
  const int slots = tiles > num_points ? tiles : num_points;
  rank_tiles_kernel<<<dim3((slots + kWarps - 1) / kWarps, 1, seqs), kThreads, 0, s>>>(
      tile_score, tile_pos, tiles, num_points, uv, grad2_out, valid);
  return (int)cudaGetLastError();
}
