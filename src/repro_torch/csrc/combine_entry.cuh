// The entry points of one compiled combine: rows 2, 3, 10 and 11 of the TPU
// kernel table (repro's metric2_pallas, metric2_tri_pallas,
// threeway_step_pallas and threeway_batch_pallas under a registered
// combine) for one operand type.
//
// repro_torch/kernels/build.py writes one .cu per combine and operand tag
// into build/kernels/: it includes combine_ops.cuh, defines in namespace
// repro_gen the operand type In (int8_t or float: a bfloat16, float16,
// int16 or int32 ring lies widened to float32), the functions that
// repro_torch/kernels/mgemm/combine.py emits, combine(a, b) (on two
// operands of the ring: rows 2 and 3), fold(a, b) (row 11's fold
// combine(own, x_t): its value as fp32, or for an int32 fold its bits,
// which no fp32 holds beyond 2^24) and product(a, b) (combine(fold, right),
// a the fold as fold() gives it), and the flags kCombineZero (combine(0, 0)
// == 0) and kSliceZero (combine(combine(0, 0), 0) == 0), then includes this
// file.  The kernels are the fixed libraries' bodies
// (mgemm_rect.cuh, mgemm_tri.cuh, minplus3.cuh), which call the combine
// inline as they call fminf for min: a combine of n ops costs its n
// instructions and the add a comparison, at min's two blocks an SM and copy
// width.  Where combine(0, 0) != 0 the last stage is cut to the real fields,
// so the sums run over the k fields only.
#pragma once

#include "mgemm_rect.cuh"
#include "mgemm_tri.cuh"
#include "minplus3.cuh"

using namespace repro::minplus;

namespace {

struct GenCombine {
  static constexpr bool kZero = repro_gen::kCombineZero;
  static __device__ __forceinline__ float apply(float a, float b) {
    return repro_gen::combine(a, b);
  }
};

struct GenFold {
  static constexpr bool kZero = repro_gen::kCombineZero;
  static __device__ __forceinline__ float apply(float a, float b) {
    return repro_gen::fold(a, b);
  }
};

struct GenProduct {
  static constexpr bool kZero = repro_gen::kSliceZero;
  static __device__ __forceinline__ float apply(float a, float b) {
    return repro_gen::product(a, b);
  }
};

using In = repro_gen::In;

}  // namespace

// Row 3: V (k, m) field-major In, s (m,) float32, out the packed (P, BT, BT)
// tiles (metric2_tri_launch's layout) in float32 or bfloat16 (out_bf16 =
// 1), the epilogue id epi; scratch of scratch_len >= the fixed library's
// metric2_tri_scratch(...) bytes for the split form, as metric2_tri_launch.
// Returns cudaGetLastError().
extern "C" int combine_tri_launch(const void* V, const float* s, void* out, int out_bf16,
                                  int k, int m, int epi, void* scratch, long long scratch_len,
                                  void* stream) {
  if (tri::bad_args(k, m, epi)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tri::launch<In, GenCombine>(V, s, out, out_bf16, k, m, epi, scratch,
                                                      scratch_len,
                                                      static_cast<cudaStream_t>(stream)));
}

// Row 2: A (k, m) and B (k, n) field-major In by base pointer and row
// stride in elements, stats sa (m,) and sb (n,), out (m, n) float32 or
// bfloat16, as metric2_launch.
extern "C" int combine_rect_launch(const void* A, long long a_sr, const void* B, long long b_sr,
                                   int k, int m, int n, const float* sa, const float* sb,
                                   void* out, int out_bf16, int epi, void* stream) {
  if (rect::bad_metric_args(a_sr, b_sr, k, m, n, sa, sb, epi)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rect::launch_metric<In, GenCombine>(A, a_sr, B, b_sr, k, m, n, sa, sb, out, out_bf16,
                                             epi, static_cast<cudaStream_t>(stream));
}

// Rows 11 / 10: own (k, m), X (k, L) and right (k, n) field-major In by base
// pointer and row stride in elements (row 10: L = 1, x's element stride as
// its row stride), out (L, m, n) float32, as threeway_batch_launch.
extern "C" int combine_slice_launch(const void* own, long long o_sr, const void* X,
                                    long long x_sr, const void* right, long long r_sr, int k,
                                    int m, int L, int n, float* out, void* stream) {
  if (slice::bad_sizes(o_sr, x_sr, r_sr, k, m, L, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return slice::launch<In, GenFold, GenProduct>(own, o_sr, X, x_sr, right, r_sr, k, m, L, n,
                                                out, static_cast<cudaStream_t>(stream));
}
