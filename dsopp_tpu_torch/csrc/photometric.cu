// K18 photometric_correct: the camera's whole frame intake.  The raw frame
// (u8 or f32) is copied from pinned host memory into a device staging buffer
// and, in one launch, remapped through the undistorter's tables (optional),
// cropped, and corrected: the inverse response G^-1 applied by linear
// interpolation in its 256-entry table, then the division by the vignetting
// attenuation.
//
// Replaces dsopp_tpu/sensors/photometric.py::correct_image (an XLA gather
// over the table) and its host twin dsopp_tpu/native/pixelmap.cpp
// ::photometric_correct, with the host steps of
// dsopp_tpu/sensors/camera.py::Camera.next_frame around it (cv2.remap and
// the crop).  For each output pixel (y, x) of the [out_h, out_w] crop:
//   v = image[y, x] (through the source's row pitch), or with the tables
//       the bilinear, border-replicated remap in the order of
//       sensors/undistorter.py::remap_bilinear: x0f = floor(mx),
//       fx = mx - x0f, x0 = (int64) x0f, x_lo = clamp(x0, 0, w - 1),
//       x_hi = clamp(x0 + 1, 0, w - 1) (and so in y), then
//       top = a * (1 - fx) + b * fx, bottom = c * (1 - fx) + d * fx,
//       v = top * (1 - fy) + bottom * fy;
//   clip v to [0, 255], lo = (int)v, hi = min(lo + 1, 255), frac = v - lo,
//   c = lut[lo] * (1 - frac) + lut[hi] * frac, and with a vignette V,
//   c / max(V, 1e-3) (IEEE division); out is f32.
// The operations and their order are the plain chain's (remap_bilinear, the
// crop, correct_image_plain), and the build's --fmad=false keeps each
// product rounded on its own, as torch's separate mul and add kernels round
// it, so the two are equal to the bit.
//
// Bound: bytes.  At VGA a u8 frame (307 200 B), a vignette and the output
// (1 228 800 B each) are 2.77 MB, 0.83 us at 3.35 TB/s; with the two f32
// tables (2 457 600 B) 5.22 MB, 1.56 us.  ~10 operations a pixel (~30 with
// the remap) are far below the card's rate.  Design: one launch of blocks of
// 32 x 8 threads, each block staging the 1 KB table in shared memory (one
// entry a thread) and covering 128 x 8 output pixels; each thread takes 4
// consecutive pixels of a row with float4 loads of the tables and the
// vignette, one 32-bit u8 load (or a float4) of the source without tables,
// and one float4 store.  The remap's source samples of neighbouring output
// pixels are neighbours in the source, so those loads stay in L1 and L2.
// Pointers or pitches that are not aligned for those loads, and a row's
// last pixels when the width is not a multiple of 4, take a scalar path.
// The upload is issued by the same C call on the same stream, so the host
// never waits for it; the call records the caller's event after the copy,
// and the caller keeps its pinned buffer until that event reports done.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;   // == the table's size
constexpr int kTable = 256;
constexpr int kPixels = 4;      // per thread, along a row

static_assert(kThreads == kTable, "one table entry per thread");

__device__ __forceinline__ float lookup(float v, const float* lut) {
  v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
  const int lo = (int)v;
  const int hi = lo < 255 ? lo + 1 : 255;
  const float frac = v - (float)lo;
  return lut[lo] * (1.f - frac) + lut[hi] * frac;
}

// torch.clamp(V, min=1e-3): a NaN stays NaN
__device__ __forceinline__ float devignette(float c, float vg) {
  return c / (vg < 1e-3f ? 1e-3f : vg);
}

template <bool kU8>
__device__ __forceinline__ float load_pixel(const void* image, long long i) {
  if (kU8) return (float)__ldg(static_cast<const unsigned char*>(image) + i);
  return __ldg(static_cast<const float*>(image) + i);
}

// torch's x.clamp(0, n - 1) of an int64 index
__device__ __forceinline__ long long clamp_index(long long i, int n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// remap_bilinear at one output pixel whose table entries are (mx, my)
template <bool kU8>
__device__ __forceinline__ float remap(const void* image, int h, int w, int pitch, float mx,
                                       float my) {
  const float x0f = floorf(mx), y0f = floorf(my);
  const float fx = mx - x0f, fy = my - y0f;
  const long long x0 = (long long)x0f, y0 = (long long)y0f;
  const long long x_lo = clamp_index(x0, w), x_hi = clamp_index(x0 + 1, w);
  const long long y_lo = clamp_index(y0, h) * pitch, y_hi = clamp_index(y0 + 1, h) * pitch;
  const float gx = 1.f - fx;
  const float top = load_pixel<kU8>(image, y_lo + x_lo) * gx + load_pixel<kU8>(image, y_lo + x_hi) * fx;
  const float bottom =
      load_pixel<kU8>(image, y_hi + x_lo) * gx + load_pixel<kU8>(image, y_hi + x_hi) * fx;
  return top * (1.f - fy) + bottom * fy;
}

template <bool kU8, bool kMaps, bool kVignette>
__global__ void __launch_bounds__(kThreads)
intake_kernel(const void* __restrict__ image, int src_h, int src_w, int src_pitch,
              const float* __restrict__ map_x, const float* __restrict__ map_y, int map_pitch,
              const float* __restrict__ lut_g, const float* __restrict__ vignette, int out_h,
              int out_w, int vec, float* __restrict__ out) {
  __shared__ float lut[kTable];
  const int t = threadIdx.y * kThreadsX + threadIdx.x;
  lut[t] = lut_g[t];
  __syncthreads();
  const int y = blockIdx.y * kThreadsY + threadIdx.y;
  const int x = (blockIdx.x * kThreadsX + threadIdx.x) * kPixels;
  if (y >= out_h || x >= out_w) return;
  const long long o = (long long)y * out_w + x;
  if (vec && x + kPixels <= out_w) {
    float v[kPixels];
    if (kMaps) {
      const long long m = (long long)y * map_pitch + x;
      const float4 mx = __ldg(reinterpret_cast<const float4*>(map_x + m));
      const float4 my = __ldg(reinterpret_cast<const float4*>(map_y + m));
      v[0] = remap<kU8>(image, src_h, src_w, src_pitch, mx.x, my.x);
      v[1] = remap<kU8>(image, src_h, src_w, src_pitch, mx.y, my.y);
      v[2] = remap<kU8>(image, src_h, src_w, src_pitch, mx.z, my.z);
      v[3] = remap<kU8>(image, src_h, src_w, src_pitch, mx.w, my.w);
    } else {
      const long long s = (long long)y * src_pitch + x;
      if (kU8) {
        const uchar4 u = __ldg(reinterpret_cast<const uchar4*>(
            static_cast<const unsigned char*>(image) + s));
        v[0] = (float)u.x; v[1] = (float)u.y; v[2] = (float)u.z; v[3] = (float)u.w;
      } else {
        const float4 f = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(image) + s));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      }
    }
    float4 r = make_float4(lookup(v[0], lut), lookup(v[1], lut), lookup(v[2], lut),
                           lookup(v[3], lut));
    if (kVignette) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(vignette + o));
      r.x = devignette(r.x, g.x); r.y = devignette(r.y, g.y);
      r.z = devignette(r.z, g.z); r.w = devignette(r.w, g.w);
    }
    reinterpret_cast<float4*>(out)[o / kPixels] = r;
    return;
  }
  const int end = x + kPixels < out_w ? x + kPixels : out_w;
  for (int xi = x; xi < end; ++xi) {
    float v;
    if (kMaps) {
      const long long m = (long long)y * map_pitch + xi;
      v = remap<kU8>(image, src_h, src_w, src_pitch, map_x[m], map_y[m]);
    } else {
      v = load_pixel<kU8>(image, (long long)y * src_pitch + xi);
    }
    float c = lookup(v, lut);
    if (kVignette) c = devignette(c, vignette[o + (xi - x)]);
    out[o + (xi - x)] = c;
  }
}

template <bool kU8, bool kMaps>
void launch(const void* image, int src_h, int src_w, int src_pitch, const float* map_x,
            const float* map_y, int map_pitch, const float* lut, const float* vignette,
            int out_h, int out_w, int vec, float* out, cudaStream_t s) {
  const int items = (out_w + kPixels - 1) / kPixels;
  const dim3 grid((unsigned)((items + kThreadsX - 1) / kThreadsX),
                  (unsigned)((out_h + kThreadsY - 1) / kThreadsY));
  const dim3 block(kThreadsX, kThreadsY);
  if (vignette)
    intake_kernel<kU8, kMaps, true><<<grid, block, 0, s>>>(
        image, src_h, src_w, src_pitch, map_x, map_y, map_pitch, lut, vignette, out_h, out_w,
        vec, out);
  else
    intake_kernel<kU8, kMaps, false><<<grid, block, 0, s>>>(
        image, src_h, src_w, src_pitch, map_x, map_y, map_pitch, lut, vignette, out_h, out_w,
        vec, out);
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

}  // namespace

// host: the frame in pinned host memory, [src_h, src_pitch] (u8 if is_u8,
// else f32), copied into image (a device buffer of as many bytes) before the
// launch, and the event copied recorded right after the copy, so that the
// caller knows when it may write host again; or host null, and image is the
// frame on the card, rows src_pitch elements apart.  map_x, map_y: [*,
// map_pitch] f32 tables covering the output, or both null; lut [256] f32;
// vignette [out_h, out_w] f32 or null; out [out_h, out_w] f32.  Without
// tables the output must lie inside the frame.  Returns the CUDA error of
// the copy or of the launch.
extern "C" int photometric_correct(const void* host, void* image, void* copied, int is_u8,
                                   int src_h, int src_w, int src_pitch, const float* map_x,
                                   const float* map_y, int map_pitch, const float* lut,
                                   const float* vignette, int out_h, int out_w, float* out,
                                   void* stream) {
  const bool maps = map_x != nullptr;
  if (src_h < 1 || src_w < 1 || src_pitch < src_w || out_h < 0 || out_w < 0 ||
      (host != nullptr && copied == nullptr) ||
      maps != (map_y != nullptr) || (maps && map_pitch < out_w) ||
      (!maps && (out_h > src_h || out_w > src_w)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (host != nullptr) {
    const size_t bytes = (size_t)src_h * src_pitch * (is_u8 ? 1 : 4);
    cudaError_t err = cudaMemcpyAsync(image, host, bytes, cudaMemcpyHostToDevice, s);
    if (err == cudaSuccess) err = cudaEventRecord((cudaEvent_t)copied, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (out_h == 0 || out_w == 0) return (int)cudaGetLastError();
  const int vec = out_w % kPixels == 0 && aligned(vignette, 16) && aligned(out, 16) &&
                  (maps ? map_pitch % kPixels == 0 && aligned(map_x, 16) && aligned(map_y, 16)
                        : src_pitch % kPixels == 0 && aligned(image, is_u8 ? 4 : 16));
  if (is_u8 && maps)
    launch<true, true>(image, src_h, src_w, src_pitch, map_x, map_y, map_pitch, lut, vignette,
                       out_h, out_w, vec, out, s);
  else if (is_u8)
    launch<true, false>(image, src_h, src_w, src_pitch, map_x, map_y, map_pitch, lut, vignette,
                        out_h, out_w, vec, out, s);
  else if (maps)
    launch<false, true>(image, src_h, src_w, src_pitch, map_x, map_y, map_pitch, lut, vignette,
                        out_h, out_w, vec, out, s);
  else
    launch<false, false>(image, src_h, src_w, src_pitch, map_x, map_y, map_pitch, lut,
                         vignette, out_h, out_w, vec, out, s);
  return (int)cudaGetLastError();
}
