// Shared pieces of the value-operand min-plus kernels (mgemm_tri.cuh,
// mgemm_rect.cuh, minplus3.cuh, and mgemm_levels.cu's operand view): the
// block geometry, the operand view, the combines, the stage cut of a
// combine with combine(0, 0) != 0 and the accumulator fill.  Their one main
// loop, for rows 1 / 2 / 3 and 11 / 10, is minplus_pipe.cuh's.  Row 3 is
// bound by the CUDA cores' issue rate (an FMNMX and an FADD a comparison)
// and, on a small diagonal block, by the resident slots its few packed
// tiles leave empty, which its split over grid.z fills (mgemm_tri.cu).
//
// Operands are field-major (k, w) blocks of int8 or float32 values.  Each is
// addressed through its own base pointer and row stride (elements), so a
// column view of a larger block (a 3-way pipeline slice, row stride n_vp) is
// read in place, with no copy.  Rows past k and columns past the operand's
// width load as zero: min(0, 0) = 0 * 0 = 0 adds nothing along k, and a
// compiled combine with combine(0, 0) != 0 (kZero false) cuts its last
// stage to the real fields, so it sums over them only; a zero column only
// feeds outputs past the block, which the wrappers drop.
//
// Conversions to fp32 are exact for int8; sums are fp32.  On integer data
// every partial sum is an integer below 2^24, so the order of the additions
// cannot change the result.
#pragma once

#include "tri_common.cuh"

namespace repro {
namespace minplus {

constexpr int BT = 128;             // output tile edge
constexpr int TM = 8;               // register tile edge
constexpr int TPR = BT / TM;        // 16 threads per tile row
constexpr int THREADS = TPR * TPR;  // 256

enum Combine : int { kMin = 0, kMul = 1 };

// A combine as the kernels call it: a type whose apply(a, b) the compiler
// inlines into the comparison loop, with kZero true where combine(0, 0) ==
// 0 (the zero rows past k then add nothing and whole stages run unrolled).
// min and the CCC product are these two; any other registered combine is
// compiled by repro_torch/kernels/mgemm/combine.py into a function of the
// same shape (combine_entry.cuh).  The product's `acc += a * b` contracts
// to one FFMA, exact on integer data.
struct MinCombine {
  static constexpr bool kZero = true;
  static __device__ __forceinline__ float apply(float a, float b) { return fminf(a, b); }
};

struct MulCombine {
  static constexpr bool kZero = true;
  static __device__ __forceinline__ float apply(float a, float b) { return a * b; }
};

// A strided field-major (k, w) operand: element (q, c) lives at
// base[q * sr + c].
template <typename TIn>
struct Operand {
  const TIn* base;
  long long sr;  // row stride (elements): the width of the array it views
  int w;         // columns of the view
};

// The rows of a stage from field k0 that hold fields: a combine with
// combine(0, 0) != 0 sums over the real fields only (a combine with kZero
// adds nothing for the zero rows past k, so its loops run whole stages).
__device__ __forceinline__ int live_rows(int k, int k0, int bk) {
  return min(bk, k - k0);
}

__device__ __forceinline__ void zero_acc(float (&acc)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;
}

}  // namespace minplus
}  // namespace repro
