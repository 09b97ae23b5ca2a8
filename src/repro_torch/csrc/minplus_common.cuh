// Shared pieces of the value-operand min-plus kernels (mgemm_tri.cu,
// mgemm_rect.cu, minplus3.cu): the block geometry, the operand view and the
// combines; and row 3's (mgemm_tri.cu) main loop: the stage load of a
// field-major operand strip (converted to fp32 on the way in) and the 8 x 8
// register-tile combine-sum update, one buffer, two barriers a stage.  The
// kernels of two different operands (rows 1 / 2, 11 / 10) run the
// pipelined loop of minplus_pipe.cuh instead.
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
constexpr int BK = 16;              // contraction rows per stage
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

// S[r][c] = operand (k0 + r, col0 + c) as fp32, for the BK rows of a stage
// and the BT columns of a tile; zero past k and past the operand's width.
template <typename TIn>
__device__ __forceinline__ void load_stage(float (&S)[BK][BT], const Operand<TIn>& v,
                                           int k, int col0, int k0, int tid) {
  for (int e = tid; e < BK * BT; e += THREADS) {
    const int r = e / BT;
    const int c = e % BT;
    const int q = k0 + r;
    float a = 0.0f;
    if (q < k && col0 + c < v.w) a = static_cast<float>(v.base[q * v.sr + col0 + c]);
    S[r][c] = a;
  }
}

// acc[i][j] += C::apply(As[r][ty*TM + i], Bs[r][tx*TM + j]) for one row r:
// each thread owns a TM x TM register tile of the output and reads its 8 + 8
// operands as float4 pairs, so 4 shared loads feed 64 comparisons.
template <typename C>
__device__ __forceinline__ void fma_row(float (&acc)[TM][TM], const float* Ar, const float* Br,
                                        int ty, int tx) {
  float a[TM], b[TM];
  const float4* ap = reinterpret_cast<const float4*>(Ar + ty * TM);
  const float4* bp = reinterpret_cast<const float4*>(Br + tx * TM);
  const float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] += C::apply(a[i], b[j]);
}

// fma_row over the rows of a stage: all BK, unrolled, unless the combine
// adds something for a zero row (kZero false) and the stage is the last,
// cut to the `rows` that hold fields.
template <typename C>
__device__ __forceinline__ void fma_stage(float (&acc)[TM][TM], const float (&As)[BK][BT],
                                          const float (&Bs)[BK][BT], int ty, int tx,
                                          int rows) {
  if (C::kZero || rows == BK) {
#pragma unroll
    for (int r = 0; r < BK; ++r) fma_row<C>(acc, As[r], Bs[r], ty, tx);
  } else {
#pragma unroll 1
    for (int r = 0; r < rows; ++r) fma_row<C>(acc, As[r], Bs[r], ty, tx);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;
}

// The contraction of one BT x BT output tile: acc = sum over the k rows of
// combine(a[q, col_a + i], b[q, col_b + j]), in BK-row shared-memory stages.
template <typename C, typename TIn>
__device__ __forceinline__ void contract_tile(float (&acc)[TM][TM], float (&As)[BK][BT],
                                              float (&Bs)[BK][BT], const Operand<TIn>& a,
                                              const Operand<TIn>& b, int k, int col_a,
                                              int col_b, int tid, int ty, int tx) {
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    load_stage(As, a, k, col_a, k0, tid);
    load_stage(Bs, b, k, col_b, k0, tid);
    __syncthreads();
    fma_stage<C>(acc, As, Bs, ty, tx, live_rows(k, k0, BK));
    __syncthreads();
  }
}

}  // namespace minplus
}  // namespace repro
