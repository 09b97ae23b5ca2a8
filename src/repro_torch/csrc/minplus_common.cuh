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
// program (kExpr) stops at the last field, so a combine with combine(0, 0)
// != 0 sums over the real fields only; a zero column only feeds outputs past
// the block, which the wrappers drop.
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

enum Combine : int { kMin = 0, kMul = 1, kExpr = 2 };

// kExpr: any combine a registered metric gives, as the postfix program that
// repro_torch/kernels/mgemm/combine.py compiles from it (its OPCODES, WRAP8
// and DEPTH_SHIFT).  Pushes of a, b or a constant; binary ops on the two top values,
// unary ops on the top one.  Every value is held in fp32; one whose dtype is
// int8 is a small integer, wrapped to [-128, 127] after each op whose code
// carries kWrap8, as int8 arithmetic wraps in torch and jnp.  The rounded
// intrinsics keep nvcc from contracting a product and a sum into an FMA.
constexpr int kExprOps = 16;
enum ExprOp : int {
  kPushA = 0, kPushB = 1, kConst = 2, kOpMin = 3, kOpMax = 4, kOpAdd = 5, kOpSub = 6,
  kOpMul = 7, kOpAbs = 8, kOpNeg = 9
};
constexpr int kWrap8 = 1 << 8;
constexpr int kDepthShift = 9;  // code >> kDepthShift: values on the stack before the op

struct ExprProgram {
  int n;                 // ops
  int code[kExprOps];    // ExprOp | kWrap8 | depth << kDepthShift
  float imm[kExprOps];   // the constant of a kConst push
};

// Whether a launch's program argument is usable: a program of 1 to
// kExprOps ops for combine kExpr (any pointer for the built-in combines).
inline bool valid_program(int combine, const ExprProgram* prog) {
  return combine != kExpr || (prog != nullptr && prog->n >= 1 && prog->n <= kExprOps);
}

__device__ __forceinline__ float wrap8(float v) {
  return static_cast<float>(((__float2int_rz(v) + 128) & 255) - 128);
}

// A strided field-major (k, w) operand: element (q, c) lives at
// base[q * sr + c].
template <typename TIn>
struct Operand {
  const TIn* base;
  long long sr;  // row stride (elements): the width of the array it views
  int w;         // columns of the view
};

// A program's value stack for W columns: four registers a column (the
// compiler refuses deeper programs).
template <int W>
struct ExprStack {
  float s[4][W];
};

template <int W>
__device__ __forceinline__ void move_row(float (&dst)[W], const float (&src)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) dst[j] = src[j];
}

// program(a[j], b[j]) for W columns, left in st.s[0]: the W columns of a
// register-tile row (W = TM) or the 4 fields of a 3-way fold (W = 4).  The
// op is decoded once for the W columns, and a push or a pop moves only the
// stack rows that hold values (the depth each code carries), so a program
// of n ops costs about n instructions an element; stack rows past the depth
// are never read before they are written.  Every thread of a launch runs
// the same program, so the branches on the op do not diverge; the program
// is read from the kernel's parameter space.
template <int W>
__device__ __forceinline__ void eval_expr(ExprStack<W>& st, const float (&a)[W],
                                          const float (&b)[W], const ExprProgram& P) {
  float(&s0)[W] = st.s[0];
#pragma unroll 1
  for (int p = 0; p < P.n; ++p) {
    const int c = P.code[p];
    const int op = c & 0xff;
    const int d = (c >> kDepthShift) & 7;
    if (op <= kConst) {
      if (d >= 3) move_row(st.s[3], st.s[2]);
      if (d >= 2) move_row(st.s[2], st.s[1]);
      if (d >= 1) move_row(st.s[1], s0);
      if (op == kPushA) {
        move_row(s0, a);
      } else if (op == kPushB) {
        move_row(s0, b);
      } else {
        const float v = P.imm[p];
#pragma unroll
        for (int j = 0; j < W; ++j) s0[j] = v;
      }
      continue;  // a push never wraps
    }
    const float(&s1)[W] = st.s[1];
    switch (op) {
      case kOpMin:
#pragma unroll
        for (int j = 0; j < W; ++j) s0[j] = fminf(s1[j], s0[j]);
        break;
      case kOpMax:
#pragma unroll
        for (int j = 0; j < W; ++j) s0[j] = fmaxf(s1[j], s0[j]);
        break;
      case kOpAdd:
#pragma unroll
        for (int j = 0; j < W; ++j) s0[j] = __fadd_rn(s1[j], s0[j]);
        break;
      case kOpSub:
#pragma unroll
        for (int j = 0; j < W; ++j) s0[j] = __fsub_rn(s1[j], s0[j]);
        break;
      case kOpMul:
#pragma unroll
        for (int j = 0; j < W; ++j) s0[j] = __fmul_rn(s1[j], s0[j]);
        break;
      case kOpAbs:
#pragma unroll
        for (int j = 0; j < W; ++j) s0[j] = fabsf(s0[j]);
        break;
      default:  // kOpNeg
#pragma unroll
        for (int j = 0; j < W; ++j) s0[j] = -s0[j];
        break;
    }
    if (op < kOpAbs) {  // a binary op popped one value
      if (d >= 3) move_row(st.s[1], st.s[2]);
      if (d >= 4) move_row(st.s[2], st.s[3]);
    }
    if (c & kWrap8) {
#pragma unroll
      for (int j = 0; j < W; ++j) s0[j] = wrap8(s0[j]);
    }
  }
}

// acc[i][j] += program(a[i], b[j]) for a thread's TM x TM register tile,
// one row of TM columns at a time.
__device__ __forceinline__ void expr_tile(float (&acc)[TM][TM], const float (&a)[TM],
                                          const float (&b)[TM], const ExprProgram& P,
                                          ExprStack<TM>& st) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float ai[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) ai[j] = a[i];
    eval_expr(st, ai, b, P);
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] += st.s[0][j];
  }
}

template <int COMBINE>
__device__ __forceinline__ float combine(float a, float b) {
  return COMBINE == kMin ? fminf(a, b) : a * b;
}

// The rows of a stage from field k0 that hold fields: a combine with
// combine(0, 0) != 0 sums over the real fields only (min and the product
// add nothing for the zero rows past k, so their loops run whole stages).
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

// acc[i][j] += combine(As[r][ty*TM + i], Bs[r][tx*TM + j]) for one row r:
// each thread owns a TM x TM register tile of the output and reads its 8 + 8
// operands as float4 pairs, so 4 shared loads feed 64 comparisons.
template <int COMBINE>
__device__ __forceinline__ void fma_row(float (&acc)[TM][TM], const float* Ar, const float* Br,
                                        int ty, int tx, const ExprProgram& P,
                                        ExprStack<TM>& st) {
  float a[TM], b[TM];
  const float4* ap = reinterpret_cast<const float4*>(Ar + ty * TM);
  const float4* bp = reinterpret_cast<const float4*>(Br + tx * TM);
  const float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  if constexpr (COMBINE == kExpr) {
    expr_tile(acc, a, b, P, st);
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] += combine<COMBINE>(a[i], b[j]);
  }
}

// fma_row over the rows of a stage: all BK for min and the product, the
// `rows` that hold fields for a program.
template <int COMBINE>
__device__ __forceinline__ void fma_stage(float (&acc)[TM][TM], const float (&As)[BK][BT],
                                          const float (&Bs)[BK][BT], int ty, int tx,
                                          const ExprProgram& P, int rows) {
  ExprStack<TM> st{};
  if constexpr (COMBINE == kExpr) {
#pragma unroll 1
    for (int r = 0; r < rows; ++r) fma_row<COMBINE>(acc, As[r], Bs[r], ty, tx, P, st);
  } else {
#pragma unroll
    for (int r = 0; r < BK; ++r) fma_row<COMBINE>(acc, As[r], Bs[r], ty, tx, P, st);
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
template <int COMBINE, typename TIn>
__device__ __forceinline__ void contract_tile(float (&acc)[TM][TM], float (&As)[BK][BT],
                                              float (&Bs)[BK][BT], const Operand<TIn>& a,
                                              const Operand<TIn>& b, int k, int col_a,
                                              int col_b, int tid, int ty, int tx,
                                              const ExprProgram& P) {
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    load_stage(As, a, k, col_a, k0, tid);
    load_stage(Bs, b, k, col_b, k0, tid);
    __syncthreads();
    fma_stage<COMBINE>(acc, As, Bs, ty, tx, P, live_rows(k, k0, BK));
    __syncthreads();
  }
}

}  // namespace minplus
}  // namespace repro
