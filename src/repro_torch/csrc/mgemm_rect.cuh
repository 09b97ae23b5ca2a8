// The rectangular value kernel of rows 1 / 2 (mgemm_rect.cu) as a template
// on its combine, so that the fixed library (min, the CCC product) and a
// compiled combine's library (combine_entry.cuh) instantiate one body.
//
// rect_kernel: one CUDA block of 256 threads per 128 x 128 output tile of
// epilogue(sum_q C::apply(a[q, i], b[q, j]), sa[i], sb[j]) on the grid
// (ceil(n/128), ceil(m/128), splits), on the pipelined main loop of
// minplus_pipe.cuh; split z (the raw form only) sums its split_stages
// stages into its own (m, n) slab of `out`.  What bounds it and how its
// design answers that: mgemm_rect.cu.
#pragma once

#include "minplus_pipe.cuh"

namespace repro {
namespace minplus {
namespace rect {

namespace pp = repro::minplus::pipe;

template <typename TIn, typename C, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
rect_kernel(Operand<TIn> a, Operand<TIn> b, const float* __restrict__ sa,
            const float* __restrict__ sb, void* __restrict__ out, int out_bf16, int k,
            int epi, int split_stages) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int col_a = blockIdx.y * BT;
  const int col_b = blockIdx.x * BT;
  // this block's stages of the contraction (all of it unless split)
  const int stages = (k + pp::BK - 1) / pp::BK;
  const int s_beg = blockIdx.z * split_stages;
  const int ns = min(stages, s_beg + split_stages) - s_beg;

  float acc[TM][TM];
  pp::contract<C, C, false, VEC>(acc, smem, a, b, static_cast<const TIn*>(nullptr), 0, k,
                                 s_beg, ns, col_a, col_b);

  const int m = a.w;
  const int n = b.w;
  const pp::Place p = pp::place_of(threadIdx.x);
  const bool vec = (n & 3) == 0;
  const size_t slab = static_cast<size_t>(blockIdx.z) * m * n;  // a split's partial sums
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = col_a + pp::tile_pos(i, p.ty);
    if (gi >= m) continue;
    const float si = epi == repro::kRaw ? 0.0f : sa[gi];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = col_b + 64 * h + 4 * p.tx;
      const int live = n - gj;
      if (live <= 0) continue;
      float v[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float sj = epi == repro::kRaw || x >= live ? 0.0f : sb[gj + x];
        v[x] = repro::apply_epilogue(epi, acc[i][4 * h + x], si, sj);
      }
      const size_t at = slab + static_cast<size_t>(gi) * n + gj;
      if (out_bf16) {
        pp::store4(static_cast<__nv_bfloat16*>(out) + at, v, live, vec);
      } else {
        pp::store4(static_cast<float*>(out) + at, v, live, vec);
      }
    }
  }
}

template <typename TIn, typename C>
cudaError_t launch_combine(const Operand<TIn>& a, const Operand<TIn>& b, const float* sa,
                           const float* sb, void* out, int out_bf16, int k, int epi,
                           int splits, int split_stages, cudaStream_t st) {
  return pp::with_copy_width(a, b, [&](auto vec) {
    auto kernel = rect_kernel<TIn, C, decltype(vec)::value>;
    constexpr int smem = pp::Layout<TIn>::kSmem;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((b.w + BT - 1) / BT, (a.w + BT - 1) / BT, splits);
    kernel<<<grid, THREADS, smem, st>>>(a, b, sa, sb, out, out_bf16, k, epi, split_stages);
    return cudaGetLastError();
  });
}

// The metric form (row 2): one unsplit launch, the epilogue id epi applied
// in the kernel.
template <typename TIn, typename C>
int launch_metric(const void* A, long long a_sr, const void* B, long long b_sr, int k, int m,
                  int n, const float* sa, const float* sb, void* out, int out_bf16, int epi,
                  cudaStream_t st) {
  const Operand<TIn> a{static_cast<const TIn*>(A), a_sr, m};
  const Operand<TIn> b{static_cast<const TIn*>(B), b_sr, n};
  const int stages = (k + pp::BK - 1) / pp::BK;
  return static_cast<int>(
      launch_combine<TIn, C>(a, b, sa, sb, out, out_bf16, k, epi, 1, stages, st));
}

inline bool bad_sizes(long long a_sr, long long b_sr, int k, int m, int n) {
  return k < 1 || m < 1 || n < 1 || a_sr < m || b_sr < n || (m + BT - 1) / BT > 65535;
}

inline bool bad_metric_args(long long a_sr, long long b_sr, int k, int m, int n,
                            const float* sa, const float* sb, int epi) {
  return bad_sizes(a_sr, b_sr, k, m, n) || epi < repro::kRaw || epi > repro::kCcc ||
         (epi != repro::kRaw && (sa == nullptr || sb == nullptr));
}

}  // namespace rect
}  // namespace minplus
}  // namespace repro
