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
// VGA; the points are a few tens of KB).  Design:
// * the scatter is a fixed-order sum, so two runs give the same bits: a point
//   writes its pixel only if no earlier point shares it, and then adds its
//   later twins in index order (all points staged through shared memory, at
//   most a few thousand);
// * the weights are exact integer counts of at most K * N, so the selection
//   needs no sort: a histogram of the positive weights of a level, the
//   weight class c* at which the running count from the top crosses the slot
//   count, then an ordered compaction: pixels of class c* take the slots after
//   the heavier ones in index order (a block scan per 1024-pixel tile plus the
//   sum of the tile counts before it), and the fewer-than-slot-count heavier
//   pixels are ranked among themselves by (class descending, index
//   ascending).  When fewer pixels are positive than there are slots, c* is 0
//   and the same compaction fills the rest with the lowest-index empty
//   pixels, invalid, as the stable sort of the plain version leaves them.

#include "ba_body.cuh"

namespace {

using namespace ba;

constexpr int kTile = 1024;            // pixels per compaction tile
constexpr int kPerThread = kTile / kThreads;
constexpr int kLowBins = 64;           // weight classes counted in shared memory
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ lm_uv, const float* __restrict__ lm_idepth,
               const unsigned char* __restrict__ lm_mask, const float* __restrict__ rel_q,
               const float* __restrict__ rel_t, int total, int n, Camera cam, int h, int w,
               int* __restrict__ pix, float* __restrict__ pidep) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const int i = p / n;
  const Rigid rel = {{rel_q[4 * i], rel_q[4 * i + 1], rel_q[4 * i + 2], rel_q[4 * i + 3]},
                     {rel_t[3 * i], rel_t[3 * i + 1], rel_t[3 * i + 2]}};
  const float d = lm_idepth[p];
  Vec3 ray;
  const Vec3 q = scaled_target_point(cam, lm_uv[2 * p], lm_uv[2 * p + 1], d, rel, &ray);
  const float z_safe = fabsf(q.z) < 1e-12f ? 1e-12f : q.z;
  const float u_t = cam.fx * q.x / z_safe + cam.cx;
  const float v_t = cam.fy * q.y / z_safe + cam.cy;
  const bool ok = lm_mask[p] != 0 && reprojection_valid(cam, q.z, u_t, v_t, d);
  const int xs = min(max((int)rintf(u_t), 0), w - 1);
  const int ys = min(max((int)rintf(v_t), 0), h - 1);
  pix[p] = ok ? ys * w + xs : -1;
  pidep[p] = d / z_safe;
}

__global__ void __launch_bounds__(kThreads)
depth_scatter_kernel(const int* __restrict__ pix, const float* __restrict__ pidep, int total,
               float* __restrict__ grid_i, float* __restrict__ grid_w) {
  __shared__ int pix_s[kThreads];
  __shared__ float idep_s[kThreads];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int mine = p < total ? pix[p] : -1;
  bool twin_before = false;
  float sum = 0.0f, count = 0.0f;
  for (int base = 0; base < total; base += kThreads) {
    __syncthreads();
    if (base + threadIdx.x < total) {
      pix_s[threadIdx.x] = pix[base + threadIdx.x];
      idep_s[threadIdx.x] = pidep[base + threadIdx.x];
    }
    __syncthreads();
    if (mine < 0) continue;
    const int len = min(kThreads, total - base);
    for (int j = 0; j < len; ++j) {
      if (pix_s[j] != mine) continue;
      if (base + j < p) {
        twin_before = true;
      } else {
        sum += idep_s[j];
        count += 1.0f;
      }
    }
  }
  if (mine >= 0 && !twin_before) {
    grid_i[mine] = sum;
    grid_w[mine] = count;
  }
}

__global__ void __launch_bounds__(kThreads)
pool_kernel(const float* __restrict__ src_i, const float* __restrict__ src_w, int sw, int dh,
            int dw, float* __restrict__ dst_i, float* __restrict__ dst_w) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= dh * dw) return;
  const int y = idx / dw, x = idx % dw;
  const size_t a = (size_t)(2 * y) * sw + 2 * x, c = a + sw;
  dst_i[idx] = ((src_i[a] + src_i[a + 1]) + src_i[c]) + src_i[c + 1];
  dst_w[idx] = ((src_w[a] + src_w[a + 1]) + src_w[c]) + src_w[c + 1];
}

__global__ void __launch_bounds__(kThreads)
dilate_kernel(const float* __restrict__ src_i, const float* __restrict__ src_w, int h, int w,
              float* __restrict__ dst_i, float* __restrict__ dst_w) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= h * w) return;
  const float own = src_w[idx];
  if (own != 0.0f) {
    dst_i[idx] = src_i[idx];
    dst_w[idx] = own;
    return;
  }
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
  dst_i[idx] = sum_i;
  dst_w[idx] = sum_w;
}

// hist[c] = number of pixels of weight class c >= 1
__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ weight, int npix, int classes, int* __restrict__ hist) {
  __shared__ int low[kLowBins];
  if (threadIdx.x < kLowBins) low[threadIdx.x] = 0;
  __syncthreads();
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < npix; idx += gridDim.x * kThreads) {
    const float wv = weight[idx];
    if (!(wv > 0.0f)) continue;
    const int c = min((int)wv, classes - 1);
    atomicAdd(c < kLowBins ? &low[c] : &hist[c], 1);
  }
  __syncthreads();
  if (threadIdx.x < kLowBins && threadIdx.x < classes && low[threadIdx.x] > 0)
    atomicAdd(&hist[threadIdx.x], low[threadIdx.x]);
}

// params[0] = c*, the class at which the count from the top crosses `slots`
// (0 when fewer pixels are positive); params[1] = pixels heavier than c*.
// Also pads the slots that no pixel can fill (slots > npix).
__global__ void __launch_bounds__(kScanThreads)
class_threshold_kernel(const int* __restrict__ hist, int classes, int slots, int npix,
                 int* __restrict__ params, float* __restrict__ uv, float* __restrict__ idepth,
                 float* __restrict__ value, unsigned char* __restrict__ valid) {
  __shared__ int sums[33];
  const int chunk = (classes + kScanThreads - 1) / kScanThreads;
  const int hi = classes - 1 - (int)threadIdx.x * chunk;
  const int lo = max(hi - chunk + 1, 1);
  int own = 0;
  for (int c = hi; c >= lo; --c) own += hist[c];
  int above = block_exclusive_scan<kScanThreads>(own, sums);
  for (int c = hi; c >= lo; --c) {
    const int cnt = hist[c];
    if (above < slots && above + cnt >= slots) {
      params[0] = c;
      params[1] = above;
    }
    above += cnt;
  }
  if (threadIdx.x == 0 && sums[32] < slots) {
    params[0] = 0;
    params[1] = sums[32];
  }
  for (int s = npix + threadIdx.x; s < slots; s += kScanThreads) {
    uv[2 * s] = 0.0f;
    uv[2 * s + 1] = 0.0f;
    idepth[s] = 0.0f;
    value[s] = 0.0f;
    valid[s] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_count_kernel(const float* __restrict__ weight, int npix, const int* __restrict__ params,
                  int* __restrict__ tile_counts) {
  __shared__ int sums[33];
  const float cstar = (float)params[0];
  int packed = 0;   // heavier pixels in the high half, pixels of class c* in the low
  const int first = blockIdx.x * kTile + threadIdx.x * kPerThread;
  for (int j = 0; j < kPerThread; ++j) {
    if (first + j >= npix) break;
    const float wv = weight[first + j];
    packed += (wv > cstar ? 1 << 16 : 0) + (wv == cstar ? 1 : 0);
  }
  block_exclusive_scan<kThreads>(packed, sums);
  if (threadIdx.x == 0) {
    tile_counts[2 * blockIdx.x] = sums[32] >> 16;
    tile_counts[2 * blockIdx.x + 1] = sums[32] & 0xffff;
  }
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

__device__ __forceinline__ void write_slot(const Selection& sel, int slot, int idx) {
  const float wv = sel.weight_map[idx];
  const float idep = sel.idepth_map[idx] / fmaxf(wv, 1e-12f);
  sel.uv[2 * slot] = (float)(idx % sel.width);
  sel.uv[2 * slot + 1] = (float)(idx / sel.width);
  sel.idepth[slot] = idep;
  sel.value[slot] = sel.intensity[idx];
  sel.valid[slot] = (wv > 0.0f && idep > 1e-6f) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
select_write_kernel(Selection sel, int npix, int slots, const int* __restrict__ params,
                    const int* __restrict__ tile_counts, int* __restrict__ heavy) {
  __shared__ int sums[33];
  __shared__ int before[2];
  const float cstar = (float)params[0];
  const int above = params[1];
  // pixels heavier than c* / of class c* in the tiles before this one
  int hi = 0, eq = 0;
  for (int t = threadIdx.x; t < (int)blockIdx.x; t += kThreads) {
    hi += tile_counts[2 * t];
    eq += tile_counts[2 * t + 1];
  }
  block_exclusive_scan<kThreads>(hi, sums);
  if (threadIdx.x == 0) before[0] = sums[32];
  block_exclusive_scan<kThreads>(eq, sums);
  if (threadIdx.x == 0) before[1] = sums[32];

  const int first = blockIdx.x * kTile + threadIdx.x * kPerThread;
  float wv[kPerThread];
  int packed = 0;
  for (int j = 0; j < kPerThread; ++j) {
    wv[j] = first + j < npix ? sel.weight_map[first + j] : -1.0f;
    packed += (wv[j] > cstar ? 1 << 16 : 0) + (wv[j] == cstar ? 1 : 0);
  }
  const int scan = block_exclusive_scan<kThreads>(packed, sums);
  int hi_rank = before[0] + (scan >> 16);
  int eq_rank = before[1] + (scan & 0xffff);
  for (int j = 0; j < kPerThread; ++j) {
    if (wv[j] > cstar) {
      heavy[2 * hi_rank] = first + j;
      heavy[2 * hi_rank + 1] = (int)wv[j];
      ++hi_rank;
    } else if (wv[j] == cstar) {
      if (above + eq_rank < slots) write_slot(sel, above + eq_rank, first + j);
      ++eq_rank;
    }
  }
}

// the pixels heavier than c* (fewer than `slots`, listed in index order):
// slot = heavier ones + equally heavy ones before it
__global__ void __launch_bounds__(kThreads)
heavy_rank_kernel(Selection sel, const int* __restrict__ params,
                  const int* __restrict__ heavy) {
  __shared__ int cls_s[kThreads];
  const int count = params[1];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.x * kThreads >= count) return;
  const int mine = i < count ? heavy[2 * i + 1] : 0;
  int slot = 0;
  for (int base = 0; base < count; base += kThreads) {
    __syncthreads();
    if (base + threadIdx.x < count) cls_s[threadIdx.x] = heavy[2 * (base + threadIdx.x) + 1];
    __syncthreads();
    const int len = min(kThreads, count - base);
    for (int j = 0; j < len; ++j)
      slot += (cls_s[j] > mine || (cls_s[j] == mine && base + j < i)) ? 1 : 0;
  }
  if (i < count) write_slot(sel, slot, heavy[2 * i]);
}

inline int blocks_for(int items, int per_block) { return (items + per_block - 1) / per_block; }

}  // namespace

// Points: lm_uv [k,n,2], lm_idepth [k,n], lm_mask [k,n] u8 (live landmarks of
// the older keyframes), rel_q [k,4] / rel_t [k,3] (newest <- each frame).
// `intensity` is a host array of `levels` device pointers: the [h_l, w_l]
// intensity image of each pyramid level.  Scratch: pix [k*n] int32, pidep
// [k*n] f32, raw_i / raw_w (all levels, concatenated), hist [k*n+1] int32, params [2] int32, tile_counts [2*ceil(h*w/1024)]
// int32, heavy [2*max(max_points, flow_points)] int32.  Outputs: out_i / out_w
// (all levels, concatenated) and the selections, `levels` of max_points slots
// then one of flow_points slots: uv [.,2], idepth, value f32, valid u8.
extern "C" int depth_maps(const float* lm_uv, const float* lm_idepth,
                          const unsigned char* lm_mask, const float* rel_q,
                          const float* rel_t, int k, int n, float fx, float fy, float cx,
                          float cy, float width, float height, int h, int w, int levels,
                          int max_points, int flow_points, const float* const* intensity,
                          int* pix, float* pidep, float* raw_i, float* raw_w, int* hist,
                          int* params, int* tile_counts, int* heavy, float* out_i,
                          float* out_w, float* sel_uv, float* sel_idepth, float* sel_value,
                          unsigned char* sel_valid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ba::Camera cam = {fx, fy, cx, cy, width, height};
  const int total = k * n, classes = total + 1;
  project_kernel<<<blocks_for(total, kThreads), kThreads, 0, s>>>(
      lm_uv, lm_idepth, lm_mask, rel_q, rel_t, total, n, cam, h, w, pix, pidep);
  cudaMemsetAsync(raw_i, 0, sizeof(float) * h * w, s);
  cudaMemsetAsync(raw_w, 0, sizeof(float) * h * w, s);
  depth_scatter_kernel<<<blocks_for(total, kThreads), kThreads, 0, s>>>(pix, pidep, total, raw_i,
                                                                 raw_w);
  size_t off = 0, slot = 0;
  int lh = h, lw = w;
  for (int l = 0; l < levels; ++l) {
    if (l > 0) {
      const size_t src = off;
      const int sw = lw;
      off += (size_t)lh * lw;
      lh /= 2;
      lw /= 2;
      pool_kernel<<<blocks_for(lh * lw, kThreads), kThreads, 0, s>>>(
          raw_i + src, raw_w + src, sw, lh, lw, raw_i + off, raw_w + off);
    }
    const int np = lh * lw;
    dilate_kernel<<<blocks_for(np, kThreads), kThreads, 0, s>>>(raw_i + off, raw_w + off, lh, lw,
                                                               out_i + off, out_w + off);
    cudaMemsetAsync(hist, 0, sizeof(int) * classes, s);
    const int hist_blocks = blocks_for(np, kThreads);
    hist_kernel<<<hist_blocks < 256 ? hist_blocks : 256, kThreads, 0, s>>>(out_w + off, np,
                                                                           classes, hist);
    const int rounds = l == 0 ? 2 : 1;   // level 0 also feeds the flow set
    for (int r = 0; r < rounds; ++r) {
      const int slots = r == 0 ? max_points : flow_points;
      const size_t at = r == 0 ? slot : (size_t)levels * max_points;
      const Selection sel = {out_i + off, out_w + off, intensity[l], lw,
                             sel_uv + 2 * at, sel_idepth + at, sel_value + at, sel_valid + at};
      const int tiles = blocks_for(np, kTile);
      class_threshold_kernel<<<1, kScanThreads, 0, s>>>(hist, classes, slots, np, params, sel.uv,
                                                  sel.idepth, sel.value, sel.valid);
      tile_count_kernel<<<tiles, kThreads, 0, s>>>(out_w + off, np, params, tile_counts);
      select_write_kernel<<<tiles, kThreads, 0, s>>>(sel, np, slots, params, tile_counts, heavy);
      heavy_rank_kernel<<<blocks_for(slots, kThreads), kThreads, 0, s>>>(sel, params, heavy);
    }
    slot += max_points;
  }
  return (int)cudaGetLastError();
}
