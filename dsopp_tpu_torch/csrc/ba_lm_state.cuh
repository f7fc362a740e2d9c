// The device-resident state of the windowed-BA LM loop (K10, ba_lm.cu): eight
// 32-bit words that the loop's kernels read and only ba_lm writes.  The host
// launches a fixed number of iterations and never reads a flag: K7, K8 and
// K9 take the state's pointer and return at once when the loop is done.
// solvers/pba.py mirrors
// the layout (LM_ENERGY ... LM_LEDGER_EMPTY).

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
};
constexpr int kLmFields = 8;

// nullptr: a call outside the loop, never skipped
static __device__ __forceinline__ bool lm_done(const int* state) {
  return state != nullptr && state[kLmDone] != 0;
}

}  // namespace ba
