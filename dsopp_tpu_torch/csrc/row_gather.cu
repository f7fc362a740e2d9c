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
// Bound: bytes, the indices read once, each distinct row they name read
// once and the output written once (204 800 indices: 17.8 MB in f32, 9.3 MB
// in bf16).  What the card really moves is 32-byte sectors: a 24-byte bf16
// row that starts at a multiple of 8 spans 1.5 sectors on average, a
// 48-byte f32 row (16-byte aligned) 2.  From DRAM (a cold L2) the scattered
// reads are latency-bound unless many are in flight.
//
// Design: a block of 128 threads takes a tile of 256 consecutive output
// rows.  It loads the tile's indices once, with 16-byte loads, into shared
// memory (reading each chunk's index from device memory instead measured
// slower with a cold L2).  Its threads then take the tile's
// chunks (8 or 16 bytes) in output order, so that the lanes of a warp read
// whole rows (3 lanes a row here) and write consecutive addresses; a
// thread's row and chunk advance without a division.  Every chunk of the
// tile is requested before any is waited for, 6 a thread at the probe's
// shapes.  Two ways of holding them, chosen by the chunk's width as they
// measured on an H100 (PERF.md, PR 17):
//  - 8-byte chunks (bf16's 24-byte rows): cp.async into a shared-memory
//    copy of the tile, one wait, then the tile's contiguous bytes out with
//    16-byte streaming stores (st.global.cs, so that the output does not
//    evict the table from the 50 MB L2); faster cold than registers;
//  - 16-byte chunks (f32's 48-byte rows): held in registers, each stored by
//    the thread that loaded it, streaming; the output is already coalesced,
//    so the tile's round trip through shared memory and its barrier only
//    cost, warm and cold.
// An index outside the table fills its row with zeros (cp.async's source
// size 0); the callers check the range beforehand.  Rows wider than 96 bytes
// take a warp a row, each lane copying 8- or 16-byte chunks, streaming.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;                   // output rows a block
constexpr int kStagedRowBytes = 96;          // the widest row a tile takes (24 KB)
constexpr int kIndexBytes = kTile * 4;

// an 8-byte chunk into shared memory; a source size of 0 writes zeros
__device__ __forceinline__ void copy_async8(char* dst, const char* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

// kBytes 16: the chunks held in registers; 8: staged by cp.async
template <int kBytes>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const char* __restrict__ table, const int* __restrict__ idx, int rows, int m,
            int row_bytes, int idx_vec, int out_vec, char* __restrict__ out) {
  using Chunk = typename std::conditional<kBytes == 16, int4, int2>::type;
  extern __shared__ __align__(16) char smem[];
  int* tile_idx = reinterpret_cast<int*>(smem);
  const int first = blockIdx.x * kTile;
  const int count = m - first < kTile ? m - first : kTile;
  // the tile's indices, by 16-byte loads where they are aligned
  int staged = 0;
  if (idx_vec) {
    staged = count / 4 * 4;
    for (int i = threadIdx.x; i < count / 4; i += kThreads)
      reinterpret_cast<int4*>(tile_idx)[i] = __ldg(reinterpret_cast<const int4*>(idx + first) + i);
  }
  for (int i = staged + threadIdx.x; i < count; i += kThreads) tile_idx[i] = __ldg(idx + first + i);
  __syncthreads();
  // chunk e = threadIdx.x + i * kThreads of the tile is chunk `chunk` of row `row`
  const int chunks = row_bytes / kBytes;
  const int total = count * chunks;
  const int step_rows = kThreads / chunks, step_chunks = kThreads % chunks;
  int row = threadIdx.x / chunks, chunk = threadIdx.x % chunks;
  if constexpr (kBytes == 16) {
    constexpr int kMaxChunks = kTile * kStagedRowBytes / kBytes / kThreads;
    Chunk v[kMaxChunks];
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      v[i] = Chunk{};
      if (threadIdx.x + i * kThreads < total) {
        const int r = tile_idx[row];
        if (r >= 0 && r < rows)
          v[i] = __ldg(reinterpret_cast<const Chunk*>(table + (long long)r * row_bytes) + chunk);
      }
      row += step_rows;
      chunk += step_chunks;
      if (chunk >= chunks) { chunk -= chunks; ++row; }
    }
    Chunk* o = reinterpret_cast<Chunk*>(out + (long long)first * row_bytes);
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i)
      if (threadIdx.x + i * kThreads < total) __stcs(o + threadIdx.x + i * kThreads, v[i]);
  } else {
    char* tile = smem + kIndexBytes;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int r = tile_idx[row];
      const bool valid = r >= 0 && r < rows;
      copy_async8(tile + e * kBytes,
                  table + (valid ? (long long)r * row_bytes + chunk * kBytes : 0), valid);
      row += step_rows;
      chunk += step_chunks;
      if (chunk >= chunks) { chunk -= chunks; ++row; }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // the tile's contiguous bytes out, consecutive threads on consecutive addresses
    const int bytes = count * row_bytes;
    char* o = out + (long long)first * row_bytes;
    if (out_vec) {
      const int n16 = bytes / 16;
      for (int i = threadIdx.x; i < n16; i += kThreads)
        __stcs(reinterpret_cast<int4*>(o) + i, reinterpret_cast<const int4*>(tile)[i]);
      if (bytes % 16 != 0 && threadIdx.x == 0)   // the last 8 bytes of an odd tile
        __stcs(reinterpret_cast<int2*>(o + n16 * 16),
               *reinterpret_cast<const int2*>(tile + n16 * 16));
    } else {
      for (int i = threadIdx.x; i < bytes / 8; i += kThreads)
        __stcs(reinterpret_cast<int2*>(o) + i, reinterpret_cast<const int2*>(tile)[i]);
    }
  }
}

template <typename Chunk>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const Chunk* __restrict__ table, const int* __restrict__ idx, int rows, int m,
            int chunks, Chunk* __restrict__ out) {
  const int j = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (j >= m) return;
  const int row = __ldg(idx + j);
  const bool valid = row >= 0 && row < rows;
  const Chunk* src = table + (long long)(valid ? row : 0) * chunks;
  Chunk* dst = out + (long long)j * chunks;
  for (int c = threadIdx.x % 32; c < chunks; c += 32) {
    Chunk v{};
    if (valid) v = __ldg(src + c);
    __stcs(dst + c, v);
  }
}

bool aligned(const void* p, uintptr_t bytes) { return (uintptr_t)p % bytes == 0; }

}  // namespace

// table [rows, row_bytes / elt] of any type, 8-byte aligned, idx [m] int32,
// out [m, row_bytes / elt] of the table's type, 8-byte aligned.  row_bytes
// must be a multiple of 8; returns cudaErrorInvalidValue (1) otherwise.
extern "C" int row_gather(const void* table, const int* idx, int rows, int m, int row_bytes,
                          void* out, void* stream) {
  if (rows < 1 || m < 0 || row_bytes < 8 || row_bytes % 8 != 0 || !aligned(table, 8) ||
      !aligned(out, 8))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool chunk16 = row_bytes % 16 == 0 && aligned(table, 16) && aligned(out, 16);
  if (row_bytes <= kStagedRowBytes) {
    const unsigned blocks = (unsigned)((m + kTile - 1) / kTile);
    const size_t tile = (size_t)(m < kTile ? m : kTile) * row_bytes;
    const int idx_vec = aligned(idx, 16), out_vec = aligned(out, 16);
    const char* t = (const char*)table;
    if (chunk16)
      tile_kernel<16><<<blocks, kThreads, kIndexBytes, s>>>(t, idx, rows, m, row_bytes, idx_vec,
                                                           out_vec, (char*)out);
    else
      tile_kernel<8><<<blocks, kThreads, kIndexBytes + tile, s>>>(t, idx, rows, m, row_bytes,
                                                                  idx_vec, out_vec, (char*)out);
  } else {
    const unsigned blocks = (unsigned)((m + kThreads / 32 - 1) / (kThreads / 32));
    if (chunk16)
      wide_kernel<int4><<<blocks, kThreads, 0, s>>>((const int4*)table, idx, rows, m,
                                                    row_bytes / 16, (int4*)out);
    else
      wide_kernel<int2><<<blocks, kThreads, 0, s>>>((const int2*)table, idx, rows, m,
                                                    row_bytes / 8, (int2*)out);
  }
  return (int)cudaGetLastError();
}
