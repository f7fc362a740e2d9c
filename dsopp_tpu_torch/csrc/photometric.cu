// K18 photometric_correct: the inverse response G^-1 applied to a raw frame
// by linear interpolation in its 256-entry table, then the division by the
// vignetting attenuation.
//
// Replaces dsopp_tpu/sensors/photometric.py::correct_image (an XLA gather
// over the table) and its host twin dsopp_tpu/native/pixelmap.cpp
// ::photometric_correct: for each pixel v of an [H, W] u8 or f32 image,
// clip to [0, 255], lo = (int)v, hi = min(lo + 1, 255), frac = v - lo,
// c = lut[lo] * (1 - frac) + lut[hi] * frac, and with a vignette V,
// c / max(V, 1e-3) (IEEE division); out is f32 [H, W].  The operations and
// their order are the plain version's (sensors/photometric.py), and the
// build's --fmad=false keeps each product rounded on its own, so the two
// are equal to the bit.
//
// Bound: bytes.  At VGA a u8 frame (307 200 B), a vignette and the output
// (1 228 800 B each) are 2.77 MB, 0.83 us at 3.35 TB/s; ~10 operations a
// pixel are far below the card's rate.  Design: one launch; each block
// stages the 1 KB table in shared memory (256 threads, one entry each); each
// thread takes 4 consecutive pixels with one 32-bit u8 load (or a float4),
// float4 vignette loads and one float4 store, so reading u8 absorbs the
// u8 -> f32 conversion the JAX package does on the host.  Pointers that are
// not aligned for those loads, and the last pixels of an image whose size is
// not a multiple of 4, take a scalar path.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // == the table's size: one entry per thread
constexpr int kTable = 256;
constexpr int kPixels = 4;      // per thread

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
  if (kU8) return (float)static_cast<const unsigned char*>(image)[i];
  return static_cast<const float*>(image)[i];
}

template <bool kU8, bool kVignette>
__global__ void __launch_bounds__(kThreads)
photometric_kernel(const void* __restrict__ image, const float* __restrict__ lut_g,
                   const float* __restrict__ vignette, int n, int vec,
                   float* __restrict__ out) {
  __shared__ float lut[kTable];
  lut[threadIdx.x] = lut_g[threadIdx.x];
  __syncthreads();
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long p = item * kPixels;
  if (p >= n) return;
  if (vec && p + kPixels <= n) {
    float x[kPixels];
    if (kU8) {
      const uchar4 u = static_cast<const uchar4*>(image)[item];
      x[0] = (float)u.x; x[1] = (float)u.y; x[2] = (float)u.z; x[3] = (float)u.w;
    } else {
      const float4 f = static_cast<const float4*>(image)[item];
      x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
    }
    float4 r = make_float4(lookup(x[0], lut), lookup(x[1], lut), lookup(x[2], lut),
                           lookup(x[3], lut));
    if (kVignette) {
      const float4 g = reinterpret_cast<const float4*>(vignette)[item];
      r.x = devignette(r.x, g.x); r.y = devignette(r.y, g.y);
      r.z = devignette(r.z, g.z); r.w = devignette(r.w, g.w);
    }
    reinterpret_cast<float4*>(out)[item] = r;
    return;
  }
  const long long end = p + kPixels < n ? p + kPixels : n;
  for (long long i = p; i < end; ++i) {
    float c = lookup(load_pixel<kU8>(image, i), lut);
    if (kVignette) c = devignette(c, vignette[i]);
    out[i] = c;
  }
}

template <bool kU8>
void launch(const void* image, const float* lut, const float* vignette, int n, int vec,
            float* out, cudaStream_t s) {
  const long long items = ((long long)n + kPixels - 1) / kPixels;
  const unsigned blocks = (unsigned)((items + kThreads - 1) / kThreads);
  if (vignette)
    photometric_kernel<kU8, true><<<blocks, kThreads, 0, s>>>(image, lut, vignette, n, vec, out);
  else
    photometric_kernel<kU8, false><<<blocks, kThreads, 0, s>>>(image, lut, vignette, n, vec, out);
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

}  // namespace

// image [n] u8 (is_u8 = 1) or f32, lut [256] f32, vignette [n] f32 or null,
// out [n] f32; n = H * W >= 0.
extern "C" int photometric_correct(const void* image, int is_u8, const float* lut,
                                   const float* vignette, int n, float* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = aligned(image, is_u8 ? 4 : 16) && aligned(vignette, 16) && aligned(out, 16);
  if (is_u8)
    launch<true>(image, lut, vignette, n, vec, out, s);
  else
    launch<false>(image, lut, vignette, n, vec, out, s);
  return (int)cudaGetLastError();
}
