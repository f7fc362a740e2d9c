// The opt-in of a kernel to a Hopper block's whole shared memory, made once
// per device (K3 csrc/align_level.cu, K9 csrc/ba_solve.cu): a launch then
// asks for the dynamic bytes it needs, and no call sets the attribute again.

#pragma once

#include <cuda_runtime.h>

namespace smem {

constexpr size_t kBlockMax = 232448;  // bytes a Hopper block may opt in to
constexpr int kMaxDevices = 64;

// On the first call on a device, the largest dynamic size `kernel` may use
// (the block's shared memory less its static part) into opted[device]; then
// cudaSuccess if `bytes` fit, cudaErrorInvalidValue if they do not, or the
// runtime's error.
template <typename Kernel>
cudaError_t fit(Kernel kernel, size_t bytes, size_t (&opted)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted[device] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const size_t dynamic = kBlockMax - attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
    if (err != cudaSuccess) return err;
    opted[device] = dynamic;
  }
  return bytes <= opted[device] ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace smem
