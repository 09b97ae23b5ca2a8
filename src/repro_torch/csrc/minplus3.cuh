// The CUDA-core value slice kernel of rows 11 / 10 (minplus3.cu) as a
// template on its fold and its product, so that the fixed library (min, the
// CCC product on float32) and a compiled combine's library
// (combine_entry.cuh) instantiate one body.
//
// minplus3_kernel: B[t, i, k] = sum_q P::apply(F::apply(own[q, i], X[q, t]),
// right[q, k]) on the grid (L, ceil(m/128), ceil(n/128)), on the pipelined
// main loop of minplus_pipe.cuh.  What bounds it and how its design answers
// that: minplus3.cu.
#pragma once

#include "minplus_pipe.cuh"

namespace repro {
namespace minplus {
namespace slice {

namespace pp = repro::minplus::pipe;

template <typename TIn, typename F, typename P, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
minplus3_kernel(Operand<TIn> own, Operand<TIn> px, Operand<TIn> right,
                float* __restrict__ out, int k) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = blockIdx.x;
  const int col_a = blockIdx.y * BT;
  const int col_b = blockIdx.z * BT;

  float acc[TM][TM];
  pp::contract<P, F, true, VEC>(acc, smem, own, right, px.base + t, px.sr, k, 0,
                                (k + pp::BK - 1) / pp::BK, col_a, col_b);

  const int m = own.w;
  const int n = right.w;
  const pp::Place p = pp::place_of(threadIdx.x);
  const bool vec = (n & 3) == 0;
  float* slab = out + static_cast<size_t>(t) * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = col_a + pp::tile_pos(i, p.ty);
    if (gi >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = col_b + 64 * h + 4 * p.tx;
      const int live = n - gj;
      if (live <= 0) continue;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      pp::store4(slab + static_cast<size_t>(gi) * n + gj, v, live, vec);
    }
  }
}

// Whether the sizes are out of the kernel's range.
inline bool bad_sizes(long long o_sr, long long x_sr, long long r_sr, int k, int m, int L,
                      int n) {
  return k < 1 || m < 1 || L < 1 || n < 1 || o_sr < m || x_sr < L || r_sr < n ||
         (m + BT - 1) / BT > 65535 || (n + BT - 1) / BT > 65535;
}

// One launch on own (k, m), X (k, L) and right (k, n) of type TIn, each by
// its base pointer and row stride in elements; out (L, m, n) float32.
template <typename TIn, typename F, typename P>
int launch(const void* own, long long o_sr, const void* X, long long x_sr, const void* right,
           long long r_sr, int k, int m, int L, int n, float* out, cudaStream_t st) {
  const Operand<TIn> o{static_cast<const TIn*>(own), o_sr, m};
  const Operand<TIn> x{static_cast<const TIn*>(X), x_sr, L};
  const Operand<TIn> r{static_cast<const TIn*>(right), r_sr, n};
  return static_cast<int>(pp::with_copy_width(o, r, [&](auto vec) {
    auto kernel = minplus3_kernel<TIn, F, P, decltype(vec)::value>;
    constexpr int smem = pp::Layout<TIn>::kSmem;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(L, (m + BT - 1) / BT, (n + BT - 1) / BT);
    kernel<<<grid, THREADS, smem, st>>>(o, x, r, out, k);
    return cudaGetLastError();
  }));
}

}  // namespace slice
}  // namespace minplus
}  // namespace repro
