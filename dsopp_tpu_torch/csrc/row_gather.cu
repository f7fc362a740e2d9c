// row_gather: out[j] = table[idx[j]], rows of 8-byte multiples.
//
// Replaces the Pallas kernel of scripts/gather_probe_pallas.py
// (make_vmem_gather(...).run, _vmem_gather_kernel: the table resident in
// VMEM, one row fetch per loop step).  The probe asks how fast ~200k
// scattered rows of a [480·640, 12] table come out: f32 rows of 48 bytes
// (its design A) or bf16 rows of 24 bytes (its designs B-D).  Off every
// path of the tracker: the port's BA kernels sample the frames' maps
// directly (dsopp_tpu_torch/testing/gather_probe.py drives it).
//
// Bound: bytes, the gathered rows read once and written once (2 · 204800 ·
// 48 B + the indices: 20.5 MB in f32, 10.6 MB in bf16); the table (14.7 MB
// in f32) stays in the 50 MB L2, and the reads are scattered.  Design: a row
// is 3 chunks of 16 bytes (f32) or of 8 bytes (bf16); one thread copies one
// chunk with one wide aligned load and one store, so a warp moves ~10 rows
// and neighbouring threads write neighbouring addresses.  An index outside
// the table writes a zero row (the callers check the range beforehand).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Chunk>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const Chunk* __restrict__ table, const int* __restrict__ idx, int rows, int m,
              int chunks, Chunk* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)m * chunks) return;
  const int j = (int)(e / chunks), c = (int)(e % chunks);
  const int row = idx[j];
  Chunk v{};
  if (row >= 0 && row < rows) v = table[(long long)row * chunks + c];
  out[e] = v;
}

}  // namespace

// table [rows, row_bytes / elt] of any 2- or 4-byte type, idx [m] int32,
// out [m, row_bytes / elt] of the table's type.  row_bytes must be a
// multiple of 8 (16-byte chunks where it is a multiple of 16); returns
// cudaErrorInvalidValue (1) otherwise.
extern "C" int row_gather(const void* table, const int* idx, int rows, int m, int row_bytes,
                          void* out, void* stream) {
  if (rows < 1 || m < 0 || row_bytes < 8 || row_bytes % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0) {
    const int chunks = row_bytes / 16;
    const long long n = (long long)m * chunks;
    gather_kernel<uint4><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        (const uint4*)table, idx, rows, m, chunks, (uint4*)out);
  } else {
    const int chunks = row_bytes / 8;
    const long long n = (long long)m * chunks;
    gather_kernel<uint2><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        (const uint2*)table, idx, rows, m, chunks, (uint2*)out);
  }
  return (int)cudaGetLastError();
}
