// The device-resident state of the windowed-BA LM loop (K10, ba_lm.cu): nine
// 32-bit words that the loop's kernels read and only ba_lm writes.  The loop
// is a fixed sequence of launches (ba_lm.cu::ba_solve_loop) that never reads
// a flag on the host: K7, K8 and K9 take the state's pointer and return at
// once when the loop is done.  solvers/pba.py mirrors the layout (LM_ENERGY
// ... LM_CARRIED).
//
// The loop keeps two evaluation buffers; kLmCarried says which of them holds
// the carried evaluation.  K7 writes its trial into the other one, K8 reads
// the carried one, and K10 flips the word when it accepts the trial, so that
// no evaluation is copied.  Outside the loop (a null state) both K7 and K8
// use buffer 0.

#pragma once

namespace ba {

enum LmField {
  kLmEnergy = 0,       // float bits: energy of the carried state
  kLmLambda = 1,       // float bits: the LM regularizer
  kLmCount = 2,        // groups with a positive energy in the carried evaluation
  kLmIter = 3,         // iterations run
  kLmAccept = 4,       // the last decision accepted its trial
  kLmDone = 5,         // the loop has ended
  kLmRelin = 6,        // the last decision folded eps into the linearization point
  kLmLedgerEmpty = 7,  // the marginalization ledger is all zero
  kLmCarried = 8,      // the evaluation buffer (0 or 1) that holds the carried evaluation
};
constexpr int kLmFields = 9;

// nullptr: a call outside the loop, never skipped
static __device__ __forceinline__ bool lm_done(const int* state) {
  return state != nullptr && state[kLmDone] != 0;
}

// the buffer K8 reads: the carried evaluation (buffer 0 outside the loop)
static __device__ __forceinline__ int carried_buffer(const int* state) {
  return state != nullptr ? state[kLmCarried] : 0;
}

// the buffer K7 writes: the other one inside the loop (buffer 0 outside it)
static __device__ __forceinline__ int trial_buffer(const int* state) {
  return state != nullptr ? 1 - state[kLmCarried] : 0;
}

}  // namespace ba
