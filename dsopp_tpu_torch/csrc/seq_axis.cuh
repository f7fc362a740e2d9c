// The sequence axis of the keyframe backend's kernels (K7-K16, K15p).
//
// One launch serves S sequences of one shape (the same k, n, h, w and C):
// grid z is a sequence's position in the caller's list, and every block of
// sequence z does exactly what the same block of a launch of that sequence
// alone does, in the same order, on its own slices of the tensors.  A
// pointer argument belongs to one of two groups:
//   - a stacked input [B, ...] of the tracker's state (the window, the
//     ledger, the immature banks), read at the sequence the list names,
//     `list[z]`, and never copied (the maps and the channel bank are tens of
//     MB a sequence);
//   - the launch's own buffers and outputs [S, ...] (the LM loop's carried
//     state and evaluations, the systems, the workspaces), at position z.
// A null list is the identity (z itself): a call of one sequence passes a
// null list and S = 1, so its slices are the tensors themselves.  A kernel
// whose grid z also carries another index (K16's selection rounds) reads its
// sequence with `of_index`.

#pragma once

#include <stddef.h>

namespace seq {

// the most sequences a launch takes (the grid's z extent)
constexpr int kMaxSequences = 65535;

// the sequence of this block's grid z in `list` (null: z itself)
static __device__ __forceinline__ int of(const int* list) {
  return list == nullptr ? (int)blockIdx.z : __ldg(list + blockIdx.z);
}

// the sequence at position z of `list` (null: z itself)
static __device__ __forceinline__ int of_index(const int* list, int z) {
  return list == nullptr ? z : __ldg(list + z);
}

// `p` advanced by `s` slices of `per` elements (null stays null)
template <class T>
static __device__ __forceinline__ T* at(T* p, int s, size_t per) {
  return p == nullptr ? p : p + (size_t)s * per;
}

// whether a launch may take `seqs` sequences
static inline bool valid_count(int seqs) { return seqs >= 1 && seqs <= kMaxSequences; }

}  // namespace seq
