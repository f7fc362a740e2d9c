// K16 depth_maps: the semi-dense reference depth maps of the newest keyframe
// and the frontend point sets selected from them.
//
// Replaces dsopp_tpu/tracker/depth_map.py::build_depth_maps and
// depth_map_level_points (through build_frontend_state): every live landmark
// of the older keyframes is reprojected into the newest keyframe and adds
// (idepth, 1) at its rounded pixel (round half to even); the two grids are
// 2x2 sum-pooled ((a + b) + c) + d into the pyramid; an empty pixel of a
// level takes the sum of its 3x3 neighbourhood of that (undilated) level; per
// level the max_points heaviest pixels, the lower flat index first among
// equal weights, give (uv, idepth / weight, intensity, validity), and level
// 0 once more with the flow set's slot count.
//
// Bound: bytes (the grids of all levels are written once, about 6.5 MB at
// VGA; the points are a few tens of KB), and at these sizes the launches.
// Design, 10 launches and no memset a call, every sum in one fixed order so
// two runs give the same bits; the entry takes the window's raw tensors:
// 1. prepare_kernel: each point block counts the valid frames (the newest
//    slot is the count less one, as pba.newest_slot), composes T_newest^-1 *
//    T_f of every frame into shared memory (T_f = T_lin,f * exp(eps_f) as
//    Window.poses gives it, in torch's order of operations, torch_lie.cuh)
//    and masks the live landmarks of the older keyframes (lm_valid &
//    frame_valid & ~lm_outlier, not the newest frame); then it projects the
//    points; the other blocks zero level 0's grids and the histograms;
// 2. twins_kernel, a block per (tile, tile) of 256 points: for each point the
//    least later point on its pixel (an integer atomicMin, whose result does
//    not depend on the order) and whether an earlier one exists;
// 3. chain_kernel: the first point of each pixel walks that chain and sums
//    ((0 + d_first) + d_2) + ... in point order;
// 4. pool_kernel, a block per 16x16 tile of level 0: the tile's pixels of
//    levels 1..4, pooled in shared memory;
// 5. dilate_hist_kernel, all levels in one grid: the 3x3 fill of the empty
//    pixels, and per level a histogram of the positive weights (exact integer
//    counts of at most K * N, so the selection needs no sort of the pixels);
// 6. class_threshold_kernel, a block per selection round (levels, then level
//    0 for the flow set): the weight class c* at which the running count from
//    the top crosses the slot count, and the pixels heavier than it;
// 7. tile_count_kernel and 8. select_write_kernel, all rounds in one grid
//    each: an ordered compaction per 1024-pixel tile (a block scan plus the
//    counts of the tiles before it): pixels of class c* take the slots after
//    the heavier ones in index order, and the heavier ones (fewer than the
//    slot count) go to a list in index order;
// 9. class_rank_kernel and 10. heavy_write_kernel: a stable counting sort of
//    that list by class, from the top: the histogram gives each class its
//    first slot, and the entries of its class before it in the list (counted
//    tile against tile, integer atomics) the rank inside the class.
// When fewer pixels are positive than there are slots, c* is 0 and the same
// compaction fills the rest with the lowest-index empty pixels, invalid, as
// the stable sort of the plain version leaves them.
// Sequence axis (seq_axis.cuh): each of the 10 launches serves the S
// sequences of the call, a sequence's blocks doing what a launch of it alone
// does.  Grid z is the sequence, but class_rank_kernel's z is sequence x
// rounds + round (so S <= 65535 / 6).  The window and the tick's [B, 3,
// h_l, w_l] pyramid levels are stacks read at seq[z]; every scratch array
// is [S, its one-sequence size] at z; the outputs of a level (each grid) and
// of a round (each selection) are [S, ...] blocks one after another, so that
// each is a dense [S, h_l, w_l] or [S, slots] tensor.

#include "ba_body.cuh"
#include "seq_axis.cuh"
#include "shared_opt_in.cuh"
#include "torch_lie.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;            // pixels per compaction tile
constexpr int kPerThread = kTile / kThreads;
constexpr int kLowBins = 64;           // weight classes counted in shared memory
constexpr int kBlockThreads = 1024;    // the one-block-a-round kernels (threshold, rank)
constexpr int kMaxLevels = 5;          // a 16x16 level-0 tile holds one level-4 pixel
constexpr int kPoolTile = 1 << (kMaxLevels - 1);
constexpr int kMaxRounds = kMaxLevels + 1;
constexpr int kMaxPoints = 16384;      // heavy_write_kernel's first slots: 64 KB of shared memory
constexpr int kMaxFrames = 64;         // window slots: prepare_kernel's poses in shared memory
constexpr int kNone = 0x7fffffff;      // no later point on the pixel

// what every kernel reads of the call: the levels, the selection rounds and
// where each one's cells, tiles and slots lie
struct Plan {
  int levels, rounds, classes, heavy_stride;
  int seqs, cells, tiles;              // sequences, one sequence's cells and tiles
  const int* seq_list;                 // the stacked inputs' sequences (null: z)
  int h[kMaxLevels], w[kMaxLevels], cell_off[kMaxLevels];
  int block_off[kMaxLevels + 1];       // dilate_hist_kernel's blocks per level, summed
  int level[kMaxRounds], slots[kMaxRounds], sel_off[kMaxRounds];
  int tile_off[kMaxRounds + 1];        // compaction tiles per round, summed
  const float* intensity[kMaxLevels];  // [B, 3, h_l, w_l] maps of level l (channel 0 read)
};

// sequence z's first cell of level l in the outputs out_i / out_w
__device__ __forceinline__ size_t out_cells(const Plan& plan, int l, int z) {
  return (size_t)plan.cell_off[l] * plan.seqs + (size_t)z * plan.h[l] * plan.w[l];
}

// sequence z's first slot of round r in the selections
__device__ __forceinline__ size_t sel_at(const Plan& plan, int r, int z) {
  return (size_t)plan.sel_off[r] * plan.seqs + (size_t)z * plan.slots[r];
}

__host__ __device__ inline int blocks_for(int items, int per_block) {
  return (items + per_block - 1) / per_block;
}

// the (first) entry of a prefix table `off` that is at most v
__device__ __forceinline__ int segment_of(const int* off, int count, int v) {
  int s = 0;
  while (s + 1 < count && off[s + 1] <= v) ++s;
  return s;
}

// block ranges of prepare_kernel: the points, then level 0's cells, then the
// histograms.  A point block first composes the frames' poses relative to the
// newest (the first block also writes them to rel_out unless it is null).
__global__ void __launch_bounds__(kThreads)
prepare_kernel(const float* __restrict__ lm_uv, const float* __restrict__ lm_idepth,
               const unsigned char* __restrict__ lm_valid,
               const unsigned char* __restrict__ lm_outlier,
               const unsigned char* __restrict__ frame_valid, const float* __restrict__ t_lin_q,
               const float* __restrict__ t_lin_t, const float* __restrict__ eps, int k,
               int total, int n, ba::Camera cam, Plan plan, int* __restrict__ pix,
               float* __restrict__ pidep, int* __restrict__ next, int* __restrict__ has_prev,
               float* __restrict__ raw_i, float* __restrict__ raw_w, int* __restrict__ hist,
               float* __restrict__ rel_out) {
  __shared__ torch_lie::Pose abs_s[kMaxFrames], rel_s[kMaxFrames];
  {
    const int sb = seq::of(plan.seq_list), z = blockIdx.z;
    lm_uv = seq::at(lm_uv, sb, 2 * (size_t)total);
    lm_idepth = seq::at(lm_idepth, sb, total);
    lm_valid = seq::at(lm_valid, sb, total);
    lm_outlier = seq::at(lm_outlier, sb, total);
    frame_valid = seq::at(frame_valid, sb, k);
    t_lin_q = seq::at(t_lin_q, sb, 4 * (size_t)k);
    t_lin_t = seq::at(t_lin_t, sb, 3 * (size_t)k);
    eps = seq::at(eps, sb, 8 * (size_t)k);
    pix = seq::at(pix, z, total);
    pidep = seq::at(pidep, z, total);
    next = seq::at(next, z, total);
    has_prev = seq::at(has_prev, z, total);
    raw_i = seq::at(raw_i, z, plan.cells);
    raw_w = seq::at(raw_w, z, plan.cells);
    hist = seq::at(hist, z, (size_t)plan.levels * plan.classes);
    rel_out = seq::at(rel_out, z, 7 * (size_t)k);
  }
  const int point_blocks = blocks_for(total, kThreads);
  const int cells = plan.h[0] * plan.w[0], cell_blocks = blocks_for(cells, kThreads);
  const int b = blockIdx.x;
  if (b < point_blocks) {
    const int p = b * kThreads + threadIdx.x;
    const bool in = p < total;
    const int i = in ? p / n : 0;
    // the point's loads go out before the poses' arithmetic
    const float u = in ? lm_uv[2 * p] : 0.0f, v = in ? lm_uv[2 * p + 1] : 0.0f;
    const float d = in ? lm_idepth[p] : 0.0f;
    const bool live = in && lm_valid[p] != 0 && lm_outlier[p] == 0 && frame_valid[i] != 0;
    const int newest = ba::valid_frames(frame_valid, k) - 1;
    const int f = threadIdx.x;
    if (f < k) abs_s[f] = torch_lie::window_pose(t_lin_q, t_lin_t, eps, f);
    __syncthreads();
    if (f < k) {
      const torch_lie::Pose rel =
          torch_lie::compose(torch_lie::inverse(abs_s[max(newest, 0)]), abs_s[f]);
      rel_s[f] = rel;
      if (b == 0 && rel_out != nullptr) {
        const float out[7] = {rel.q.w, rel.q.x, rel.q.y, rel.q.z, rel.t.x, rel.t.y, rel.t.z};
        for (int c = 0; c < 7; ++c) rel_out[7 * f + c] = out[c];
      }
    }
    __syncthreads();
    if (!in) return;
    const int h = plan.h[0], w = plan.w[0];
    const torch_lie::Pose r = rel_s[i];
    const ba::Rigid rel = {{r.q.w, r.q.x, r.q.y, r.q.z}, {r.t.x, r.t.y, r.t.z}};
    ba::Vec3 ray;
    const ba::Vec3 q = ba::scaled_target_point(cam, u, v, d, rel, &ray);
    const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
    const float u_t = cam.fx * q.x / z_safe + cam.cx;
    const float v_t = cam.fy * q.y / z_safe + cam.cy;
    const bool ok = live && i != newest && ba::reprojection_valid(cam, q.z, u_t, v_t, d);
    const int xs = min(max((int)rintf(u_t), 0), w - 1);
    const int ys = min(max((int)rintf(v_t), 0), h - 1);
    pix[p] = ok ? ys * w + xs : -1;
    pidep[p] = d / z_safe;
    next[p] = kNone;
    has_prev[p] = 0;
  } else if (b < point_blocks + cell_blocks) {
    const int idx = (b - point_blocks) * kThreads + threadIdx.x;
    if (idx < cells) {
      raw_i[idx] = 0.0f;
      raw_w[idx] = 0.0f;
    }
  } else {
    const int e = (b - point_blocks - cell_blocks) * kThreads + threadIdx.x;
    if (e < plan.levels * plan.classes) hist[e] = 0;
  }
}

// block (x, y): the points of tile x against those of tile y (256 each):
// next[p] = the least later point on p's pixel (an integer minimum, so the
// order of the atomics does not matter), has_prev[p] = an earlier one exists
__global__ void __launch_bounds__(kThreads)
twins_kernel(const int* __restrict__ pix, int total, int* __restrict__ next,
             int* __restrict__ has_prev) {
  __shared__ int pix_s[kThreads];
  pix = seq::at(pix, blockIdx.z, total);
  next = seq::at(next, blockIdx.z, total);
  has_prev = seq::at(has_prev, blockIdx.z, total);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int base = blockIdx.y * kThreads;
  pix_s[threadIdx.x] = base + threadIdx.x < total ? pix[base + threadIdx.x] : -1;
  __syncthreads();
  const int mine = p < total ? pix[p] : -1;
  if (mine < 0) return;
  const int len = min(kThreads, total - base);
  bool prev = false;
  int later = kNone;
#pragma unroll 8
  for (int j = 0; j < len; ++j) {
    if (pix_s[j] != mine || base + j == p) continue;
    if (base + j < p) {
      prev = true;
    } else {
      later = base + j;
      break;
    }
  }
  if (prev) has_prev[p] = 1;
  if (later != kNone) atomicMin(&next[p], later);
}

// the first point of each pixel sums its chain in point order:
// ((0 + d_first) + d_2) + ..., and the count
__global__ void __launch_bounds__(kThreads)
chain_kernel(const int* __restrict__ pix, const float* __restrict__ pidep,
             const int* __restrict__ next, const int* __restrict__ has_prev, int total,
             int cells, float* __restrict__ raw_i, float* __restrict__ raw_w) {
  pix = seq::at(pix, blockIdx.z, total);
  pidep = seq::at(pidep, blockIdx.z, total);
  next = seq::at(next, blockIdx.z, total);
  has_prev = seq::at(has_prev, blockIdx.z, total);
  raw_i = seq::at(raw_i, blockIdx.z, cells);
  raw_w = seq::at(raw_w, blockIdx.z, cells);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= total || pix[p] < 0 || has_prev[p]) return;
  float sum = 0.0f, count = 0.0f;
  for (int q = p; q != kNone; q = next[q]) {
    sum += pidep[q];
    count += 1.0f;
  }
  raw_i[pix[p]] = sum;
  raw_w[pix[p]] = count;
}

// block (tile x, tile y): the coarser levels' pixels of one 16x16 tile of
// level 0, each the pool ((a + b) + c) + d of its four finer ones
__global__ void __launch_bounds__(kPoolTile * kPoolTile)
pool_kernel(Plan plan, float* __restrict__ raw_i, float* __restrict__ raw_w) {
  __shared__ float buf_i[2][kPoolTile][kPoolTile + 1];
  __shared__ float buf_w[2][kPoolTile][kPoolTile + 1];
  raw_i = seq::at(raw_i, blockIdx.z, plan.cells);
  raw_w = seq::at(raw_w, blockIdx.z, plan.cells);
  const int tx = threadIdx.x % kPoolTile, ty = threadIdx.x / kPoolTile;
  const int x0 = blockIdx.x * kPoolTile, y0 = blockIdx.y * kPoolTile;
  const bool in = y0 + ty < plan.h[0] && x0 + tx < plan.w[0];
  const size_t at0 = (size_t)(y0 + ty) * plan.w[0] + x0 + tx;
  buf_i[0][ty][tx] = in ? raw_i[at0] : 0.0f;
  buf_w[0][ty][tx] = in ? raw_w[at0] : 0.0f;
  for (int l = 1; l < plan.levels; ++l) {
    __syncthreads();
    const int side = kPoolTile >> l;
    const int src = (l - 1) & 1, dst = l & 1;
    if (tx < side && ty < side) {
      const int y = (y0 >> l) + ty, x = (x0 >> l) + tx;
      const float a = ((buf_i[src][2 * ty][2 * tx] + buf_i[src][2 * ty][2 * tx + 1]) +
                       buf_i[src][2 * ty + 1][2 * tx]) + buf_i[src][2 * ty + 1][2 * tx + 1];
      const float b = ((buf_w[src][2 * ty][2 * tx] + buf_w[src][2 * ty][2 * tx + 1]) +
                       buf_w[src][2 * ty + 1][2 * tx]) + buf_w[src][2 * ty + 1][2 * tx + 1];
      buf_i[dst][ty][tx] = a;
      buf_w[dst][ty][tx] = b;
      if (y < plan.h[l] && x < plan.w[l]) {
        const size_t at = plan.cell_off[l] + (size_t)y * plan.w[l] + x;
        raw_i[at] = a;
        raw_w[at] = b;
      }
    }
  }
}

// every level's 3x3 fill and the histogram hist[level][c] of its pixels of
// weight class c >= 1
__global__ void __launch_bounds__(kThreads)
dilate_hist_kernel(const float* __restrict__ raw_i, const float* __restrict__ raw_w, Plan plan,
                   float* __restrict__ out_i, float* __restrict__ out_w, int* __restrict__ hist) {
  __shared__ int low[kLowBins];
  const int z = blockIdx.z;
  const int l = segment_of(plan.block_off, plan.levels, blockIdx.x);
  const int h = plan.h[l], w = plan.w[l];
  const float* src_i = raw_i + (size_t)z * plan.cells + plan.cell_off[l];
  const float* src_w = raw_w + (size_t)z * plan.cells + plan.cell_off[l];
  int* level_hist = hist + ((size_t)z * plan.levels + l) * plan.classes;
  if (threadIdx.x < kLowBins) low[threadIdx.x] = 0;
  __syncthreads();
  const int idx = (blockIdx.x - plan.block_off[l]) * kThreads + threadIdx.x;
  if (idx < h * w) {
    float vi = src_i[idx], vw = src_w[idx];
    if (vw == 0.0f) {
      const int y = idx / w, x = idx % w;
      float sum_i = 0.0f, sum_w = 0.0f;
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          const int yy = y + dy, xx = x + dx;
          const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
          sum_i = sum_i + (in ? src_i[yy * w + xx] : 0.0f);
          sum_w = sum_w + (in ? src_w[yy * w + xx] : 0.0f);
        }
      }
      vi = sum_i;
      vw = sum_w;
    }
    out_i[out_cells(plan, l, z) + idx] = vi;
    out_w[out_cells(plan, l, z) + idx] = vw;
    if (vw > 0.0f) {
      const int c = min((int)vw, plan.classes - 1);
      atomicAdd(c < kLowBins ? &low[c] : &level_hist[c], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < kLowBins && threadIdx.x < plan.classes && low[threadIdx.x] > 0)
    atomicAdd(&level_hist[threadIdx.x], low[threadIdx.x]);
}

struct Selection {
  const float* idepth_map;
  const float* weight_map;
  const float* intensity;
  int width;
  float* uv;
  float* idepth;
  float* value;
  unsigned char* valid;
};

// round r of sequence z (grid z), its intensity image read at seq[z]
__device__ Selection round_selection(const Plan& plan, int r, int z, const float* out_i,
                                     const float* out_w, float* uv, float* idepth, float* value,
                                     unsigned char* valid) {
  const int l = plan.level[r];
  const size_t at = sel_at(plan, r, z), cells = out_cells(plan, l, z);
  const size_t plane = (size_t)plan.h[l] * plan.w[l];
  const float* intensity = plan.intensity[l] + (size_t)seq::of(plan.seq_list) * 3 * plane;
  return {out_i + cells, out_w + cells, intensity, plan.w[l], uv + 2 * at, idepth + at,
          value + at, valid + at};
}

__device__ __forceinline__ void write_slot(const Selection& sel, int slot, int idx) {
  const float wv = sel.weight_map[idx];
  const float idep = sel.idepth_map[idx] / fmaxf(wv, 1e-12f);
  sel.uv[2 * slot] = (float)(idx % sel.width);
  sel.uv[2 * slot + 1] = (float)(idx / sel.width);
  sel.idepth[slot] = idep;
  sel.value[slot] = sel.intensity[idx];
  sel.valid[slot] = (wv > 0.0f && idep > 1e-6f) ? 1 : 0;
}

// block r: params[2r] = c*, the class at which the count from the top
// crosses the round's slot count (0 when fewer pixels are positive);
// params[2r + 1] = pixels heavier than c*.  Also pads the slots that no
// pixel can fill (slots > pixels), and zeroes the round's ranks.
__global__ void __launch_bounds__(kBlockThreads)
class_threshold_kernel(const int* __restrict__ hist, Plan plan, int* __restrict__ params,
                       int* __restrict__ rank, float* __restrict__ uv,
                       float* __restrict__ idepth, float* __restrict__ value,
                       unsigned char* __restrict__ valid) {
  __shared__ int sums[33];
  const int r = blockIdx.x, l = plan.level[r], slots = plan.slots[r], z = blockIdx.z;
  const int npix = plan.h[l] * plan.w[l], classes = plan.classes;
  const int* level_hist = hist + ((size_t)z * plan.levels + l) * classes;
  params = seq::at(params, z, 2 * plan.rounds);
  rank = seq::at(rank, z, (size_t)plan.rounds * plan.heavy_stride);
  const int chunk = (classes + kBlockThreads - 1) / kBlockThreads;
  const int hi = classes - 1 - (int)threadIdx.x * chunk;
  const int lo = max(hi - chunk + 1, 1);
  int own = 0;
  for (int c = hi; c >= lo; --c) own += level_hist[c];
  int above = ba::block_exclusive_scan<kBlockThreads>(own, sums);
  for (int c = hi; c >= lo; --c) {
    const int cnt = level_hist[c];
    if (above < slots && above + cnt >= slots) {
      params[2 * r] = c;
      params[2 * r + 1] = above;
    }
    above += cnt;
  }
  if (threadIdx.x == 0 && sums[32] < slots) {
    params[2 * r] = 0;
    params[2 * r + 1] = sums[32];
  }
  for (int i = threadIdx.x; i < plan.heavy_stride; i += kBlockThreads)
    rank[(size_t)r * plan.heavy_stride + i] = 0;
  const size_t at = sel_at(plan, r, z);
  for (int s = npix + threadIdx.x; s < slots; s += kBlockThreads) {
    uv[2 * (at + s)] = 0.0f;
    uv[2 * (at + s) + 1] = 0.0f;
    idepth[at + s] = 0.0f;
    value[at + s] = 0.0f;
    valid[at + s] = 0;
  }
}

// the tile's pixels heavier than c* (high half) and of class c* (low half)
__device__ __forceinline__ int tile_packed(const float* weight, int first, int npix, float cstar,
                                           float* wv) {
  int packed = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    wv[j] = first + j < npix ? weight[first + j] : -1.0f;
    packed += (wv[j] > cstar ? 1 << 16 : 0) + (wv[j] == cstar ? 1 : 0);
  }
  return packed;
}

__global__ void __launch_bounds__(kThreads)
tile_count_kernel(const float* __restrict__ out_w, Plan plan, const int* __restrict__ params,
                  int* __restrict__ tile_counts) {
  __shared__ int sums[33];
  const int z = blockIdx.z;
  const int r = segment_of(plan.tile_off, plan.rounds, blockIdx.x);
  const int l = plan.level[r], npix = plan.h[l] * plan.w[l];
  const int tile = blockIdx.x - plan.tile_off[r];
  params = seq::at(params, z, 2 * plan.rounds);
  tile_counts = seq::at(tile_counts, z, 2 * plan.tiles);
  float wv[kPerThread];
  const int packed = tile_packed(out_w + out_cells(plan, l, z),
                                 tile * kTile + threadIdx.x * kPerThread,
                                 npix, (float)params[2 * r], wv);
  ba::block_exclusive_scan<kThreads>(packed, sums);
  if (threadIdx.x == 0) {
    tile_counts[2 * blockIdx.x] = sums[32] >> 16;
    tile_counts[2 * blockIdx.x + 1] = sums[32] & 0xffff;
  }
}

__global__ void __launch_bounds__(kThreads)
select_write_kernel(const float* __restrict__ out_i, const float* __restrict__ out_w, Plan plan,
                    const int* __restrict__ params, const int* __restrict__ tile_counts,
                    int* __restrict__ heavy, float* __restrict__ uv, float* __restrict__ idepth,
                    float* __restrict__ value, unsigned char* __restrict__ valid) {
  __shared__ int sums[33];
  __shared__ int before[2];
  const int z = blockIdx.z;
  const int r = segment_of(plan.tile_off, plan.rounds, blockIdx.x);
  const int l = plan.level[r], npix = plan.h[l] * plan.w[l], slots = plan.slots[r];
  const int tile = blockIdx.x - plan.tile_off[r];
  const Selection sel = round_selection(plan, r, z, out_i, out_w, uv, idepth, value, valid);
  params = seq::at(params, z, 2 * plan.rounds);
  tile_counts = seq::at(tile_counts, z, 2 * plan.tiles);
  heavy = seq::at(heavy, z, (size_t)plan.rounds * 2 * plan.heavy_stride);
  const float cstar = (float)params[2 * r];
  const int above = params[2 * r + 1];
  int* list = heavy + (size_t)r * 2 * plan.heavy_stride;
  // pixels heavier than c* / of class c* in the round's tiles before this one
  int hi = 0, eq = 0;
  for (int t = threadIdx.x; t < tile; t += kThreads) {
    hi += tile_counts[2 * (plan.tile_off[r] + t)];
    eq += tile_counts[2 * (plan.tile_off[r] + t) + 1];
  }
  ba::block_exclusive_scan<kThreads>(hi, sums);
  if (threadIdx.x == 0) before[0] = sums[32];
  ba::block_exclusive_scan<kThreads>(eq, sums);
  if (threadIdx.x == 0) before[1] = sums[32];

  const int first = tile * kTile + threadIdx.x * kPerThread;
  float wv[kPerThread];
  const int packed = tile_packed(sel.weight_map, first, npix, cstar, wv);
  const int scan = ba::block_exclusive_scan<kThreads>(packed, sums);
  int hi_rank = before[0] + (scan >> 16);
  int eq_rank = before[1] + (scan & 0xffff);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (wv[j] > cstar) {
      list[2 * hi_rank] = first + j;
      list[2 * hi_rank + 1] = (int)wv[j];
      ++hi_rank;
    } else if (wv[j] == cstar) {
      if (above + eq_rank < slots) write_slot(sel, above + eq_rank, first + j);
      ++eq_rank;
    }
  }
}

// block (x, y, round r): entries x of the round's list of pixels heavier
// than c* (index order) against entries y <= x: rank[i] += the earlier
// entries of i's class in tile y (integer sums, whose order does not matter)
__global__ void __launch_bounds__(kThreads)
class_rank_kernel(const int* __restrict__ params, const int* __restrict__ heavy, Plan plan,
                  int* __restrict__ rank) {
  __shared__ int cls_s[kThreads];
  // grid z: sequence z / rounds, round z % rounds
  const int z = blockIdx.z / plan.rounds, r = blockIdx.z % plan.rounds;
  params = seq::at(params, z, 2 * plan.rounds);
  heavy = seq::at(heavy, z, (size_t)plan.rounds * 2 * plan.heavy_stride);
  rank = seq::at(rank, z, (size_t)plan.rounds * plan.heavy_stride);
  const int count = params[2 * r + 1];
  if ((int)blockIdx.x * kThreads >= count || blockIdx.y > blockIdx.x) return;
  const int* list = heavy + (size_t)r * 2 * plan.heavy_stride;
  const int base = blockIdx.y * kThreads, i = blockIdx.x * kThreads + threadIdx.x;
  cls_s[threadIdx.x] = base + threadIdx.x < count ? list[2 * (base + threadIdx.x) + 1] : -1;
  __syncthreads();
  if (i >= count) return;
  const int mine = list[2 * i + 1];
  const int len = min(kThreads, i - base);
  int before = 0;
  for (int j = 0; j < len; ++j) before += cls_s[j] == mine ? 1 : 0;
  if (before) atomicAdd(&rank[(size_t)r * plan.heavy_stride + i], before);
}

// block r: the slot of entry i of the round's list is a stable counting
// sort's: the pixels heavier than its class (the level's histogram summed
// from the top) plus its rank among the list's entries of its class
__global__ void __launch_bounds__(kBlockThreads)
heavy_write_kernel(const float* __restrict__ out_i, const float* __restrict__ out_w,
                   const int* __restrict__ hist, Plan plan, const int* __restrict__ params,
                   const int* __restrict__ heavy, const int* __restrict__ rank,
                   float* __restrict__ uv, float* __restrict__ idepth,
                   float* __restrict__ value, unsigned char* __restrict__ valid) {
  extern __shared__ int first_slot[];    // [classes]
  __shared__ int sums[33];
  const int r = blockIdx.x, classes = plan.classes, z = blockIdx.z;
  params = seq::at(params, z, 2 * plan.rounds);
  heavy = seq::at(heavy, z, (size_t)plan.rounds * 2 * plan.heavy_stride);
  rank = seq::at(rank, z, (size_t)plan.rounds * plan.heavy_stride);
  const int count = params[2 * r + 1];
  const int* level_hist = hist + ((size_t)z * plan.levels + plan.level[r]) * classes;
  const int chunk = (classes + kBlockThreads - 1) / kBlockThreads;
  const int hi = classes - 1 - (int)threadIdx.x * chunk;
  const int lo = max(hi - chunk + 1, 1);
  int own = 0;
  for (int c = hi; c >= lo; --c) own += level_hist[c];
  int above = ba::block_exclusive_scan<kBlockThreads>(own, sums);
  for (int c = hi; c >= lo; --c) {
    first_slot[c] = above;
    above += level_hist[c];
  }
  __syncthreads();
  const Selection sel = round_selection(plan, r, z, out_i, out_w, uv, idepth, value, valid);
  const int* list = heavy + (size_t)r * 2 * plan.heavy_stride;
  const int* round_rank = rank + (size_t)r * plan.heavy_stride;
  for (int i = threadIdx.x; i < count; i += kBlockThreads)
    write_slot(sel, first_slot[list[2 * i + 1]] + round_rank[i], list[2 * i]);
}

}  // namespace

// Window: lm_uv [k,n,2], lm_idepth [k,n] f32; lm_valid, lm_outlier [k,n] and
// frame_valid [k] u8 (bool); t_lin_q [k,4], t_lin_t [k,3], eps [k,8] f32 (the
// pose part is the first 6).  `intensity` is a host array of `levels` device
// pointers: the [h_l, w_l] intensity image of each pyramid level.  Scratch,
// no contents expected and none left: pix, next, has_prev [k*n] int32, pidep
// [k*n] f32, raw_i / raw_w (all levels, concatenated), hist
// [levels*(k*n+1)] int32, params [2*(levels+1)] int32, tile_counts [2*sum of
// ceil(pixels / 1024) over the rounds] int32, heavy [(levels+1)*2*m] and rank
// [(levels+1)*m] int32 with m = max(max_points, flow_points).  Outputs:
// out_i / out_w (all levels, concatenated) and the selections, `levels` of
// max_points slots then one of flow_points slots: uv [.,2], idepth, value
// f32, valid u8; rel_out [k,7] f32 (q, t of T_newest^-1 * T_f) or null.
// `launches` (host, 2 ints) receives the kernels launched and the memsets
// issued.  Sequence axis (seq_axis.cuh): `seqs` sequences; the window's
// tensors are [B, ...] stacks and `intensity[l]` the [B, 3, h_l, w_l] maps of
// level l (channel 0 read), each read at seq_list[z] (null: z); every scratch
// array is [seqs, the size above]; out_i / out_w hold level after level a
// [seqs, h_l, w_l] block, the selections round after round a [seqs, slots]
// block (uv [seqs, slots, 2]); rel_out [seqs, k, 7].  Returns
// cudaErrorInvalidValue (1) for more than 5 levels, more than 16384 points,
// more than 64 frames, a level without pixels, or more than 65535 / (levels +
// 1) sequences.
extern "C" int depth_maps(const float* lm_uv, const float* lm_idepth,
                          const unsigned char* lm_valid, const unsigned char* lm_outlier,
                          const unsigned char* frame_valid, const float* t_lin_q,
                          const float* t_lin_t, const float* eps, int k, int n, float fx,
                          float fy, float cx, float cy, float width, float height, int h, int w,
                          int levels, int max_points, int flow_points,
                          const float* const* intensity, int* pix, float* pidep, int* next,
                          int* has_prev, float* raw_i, float* raw_w, int* hist, int* params,
                          int* tile_counts, int* heavy, int* rank, float* out_i, float* out_w,
                          float* sel_uv, float* sel_idepth, float* sel_value,
                          unsigned char* sel_valid, float* rel_out, int* launches, int seqs,
                          const int* seq_list, void* stream) {
  const int total = k * n;
  if (levels < 1 || levels > kMaxLevels || total < 1 || total > kMaxPoints || k > kMaxFrames ||
      (h >> (levels - 1)) < 1 || (w >> (levels - 1)) < 1 || !seq::valid_count(seqs) ||
      seqs > seq::kMaxSequences / (levels + 1))
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.levels = levels;
  plan.rounds = levels + 1;
  plan.classes = total + 1;
  plan.heavy_stride = max(max_points, flow_points);
  plan.seqs = seqs;
  plan.seq_list = seq_list;
  int cells = 0, blocks = 0;
  for (int l = 0; l < levels; ++l) {
    plan.h[l] = h >> l;
    plan.w[l] = w >> l;
    plan.cell_off[l] = cells;
    plan.block_off[l] = blocks;
    plan.intensity[l] = intensity[l];
    cells += plan.h[l] * plan.w[l];
    blocks += blocks_for(plan.h[l] * plan.w[l], kThreads);
  }
  plan.block_off[levels] = blocks;
  plan.cells = cells;
  int tiles = 0;
  for (int r = 0; r < plan.rounds; ++r) {
    const bool flow = r == levels;        // level 0 once more, for the flow set
    plan.level[r] = flow ? 0 : r;
    plan.slots[r] = flow ? flow_points : max_points;
    plan.sel_off[r] = r * max_points;
    plan.tile_off[r] = tiles;
    tiles += blocks_for(plan.h[plan.level[r]] * plan.w[plan.level[r]], kTile);
  }
  plan.tile_off[plan.rounds] = tiles;
  plan.tiles = tiles;

  static size_t write_opted[smem::kMaxDevices] = {};
  const size_t write_bytes = sizeof(int) * plan.classes;
  const cudaError_t err = smem::fit(heavy_write_kernel, write_bytes, write_opted);
  if (err != cudaSuccess) return (int)err;

  cudaStream_t s = (cudaStream_t)stream;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  const int point_blocks = blocks_for(total, kThreads);
  const int prepare_blocks = point_blocks + blocks_for(plan.h[0] * plan.w[0], kThreads) +
                             blocks_for(levels * plan.classes, kThreads);
  int launched = 0;   // kernels; this entry issues no memset
  prepare_kernel<<<dim3(prepare_blocks, 1, seqs), kThreads, 0, s>>>(
      lm_uv, lm_idepth, lm_valid, lm_outlier, frame_valid, t_lin_q, t_lin_t, eps, k, total, n,
      cam, plan, pix, pidep, next, has_prev, raw_i, raw_w, hist, rel_out);
  ++launched;
  twins_kernel<<<dim3(point_blocks, point_blocks, seqs), kThreads, 0, s>>>(pix, total, next,
                                                                         has_prev);
  ++launched;
  chain_kernel<<<dim3(point_blocks, 1, seqs), kThreads, 0, s>>>(pix, pidep, next, has_prev,
                                                                 total, cells, raw_i, raw_w);
  ++launched;
  pool_kernel<<<dim3(blocks_for(w, kPoolTile), blocks_for(h, kPoolTile), seqs),
                kPoolTile * kPoolTile, 0, s>>>(plan, raw_i, raw_w);
  ++launched;
  dilate_hist_kernel<<<dim3(blocks, 1, seqs), kThreads, 0, s>>>(raw_i, raw_w, plan, out_i,
                                                                 out_w, hist);
  ++launched;
  class_threshold_kernel<<<dim3(plan.rounds, 1, seqs), kBlockThreads, 0, s>>>(
      hist, plan, params, rank, sel_uv, sel_idepth, sel_value, sel_valid);
  ++launched;
  tile_count_kernel<<<dim3(tiles, 1, seqs), kThreads, 0, s>>>(out_w, plan, params,
                                                               tile_counts);
  ++launched;
  select_write_kernel<<<dim3(tiles, 1, seqs), kThreads, 0, s>>>(
      out_i, out_w, plan, params, tile_counts, heavy, sel_uv, sel_idepth, sel_value, sel_valid);
  ++launched;
  const int list_tiles = blocks_for(plan.heavy_stride, kThreads);
  class_rank_kernel<<<dim3(list_tiles, list_tiles, plan.rounds * seqs), kThreads, 0, s>>>(
      params, heavy, plan, rank);
  ++launched;
  heavy_write_kernel<<<dim3(plan.rounds, 1, seqs), kBlockThreads, write_bytes, s>>>(
      out_i, out_w, hist, plan, params, heavy, rank, sel_uv, sel_idepth, sel_value, sel_valid);
  ++launched;
  launches[0] = launched;
  launches[1] = 0;
  return (int)cudaGetLastError();
}
