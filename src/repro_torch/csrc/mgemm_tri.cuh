// The triangular value kernel of row 3 (mgemm_tri.cu) as a template on its
// combine, so that the fixed library (min, the CCC product) and a compiled
// combine's library (combine_entry.cuh) instantiate one body.
//
// metric2_tri_kernel: one CUDA block of 256 threads per packed tile p of the
// tj >= ti schedule, out[p, li, lj] = epilogue(sum_q C::apply(V[q, i],
// V[q, j]), s[i], s[j]), strictly upper on diagonal tiles, on
// minplus_common.cuh's loop.  What bounds it and how its design answers
// that: mgemm_tri.cu.
#pragma once

#include "minplus_common.cuh"

namespace repro {
namespace minplus {
namespace tri {

template <typename TIn, typename C, typename TOut>
__global__ void __launch_bounds__(THREADS)
metric2_tri_kernel(const TIn* __restrict__ V, const float* __restrict__ s,
                   TOut* __restrict__ out, int k, int m, int T, int epi) {
  __shared__ __align__(16) float As[BK][BT];
  __shared__ __align__(16) float Bs[BK][BT];

  int ti, tj;
  repro::tri_decode(blockIdx.x, T, ti, tj);
  const int tid = threadIdx.x;
  const int tx = tid % TPR;  // column group of the register tile
  const int ty = tid / TPR;  // row group
  const int col_a = ti * BT;
  const int col_b = tj * BT;
  const Operand<TIn> v{V, m, m};

  float acc[TM][TM];
  contract_tile<C>(acc, As, Bs, v, v, k, col_a, col_b, tid, ty, tx);

  TOut* tile = out + static_cast<size_t>(blockIdx.x) * BT * BT;
  const bool on_diag = ti == tj;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int li = ty * TM + i;
    const int gi = col_a + li;
    const float si = gi < m ? s[gi] : 0.0f;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int lj = tx * TM + j;
      const int gj = col_b + lj;
      const float sj = gj < m ? s[gj] : 0.0f;
      float val = repro::apply_epilogue(epi, acc[i][j], si, sj);
      if (on_diag && !(li < lj)) val = 0.0f;
      repro::store_out(&tile[li * BT + lj], val);
    }
  }
}

// One launch on V (k, m) int8 or float32 (TIn), s (m,), out the packed
// (P, BT, BT) tiles in float32 or bfloat16 (out_bf16 = 1).
template <typename TIn, typename C>
void launch(const void* V, const float* s, void* out, int out_bf16, int k, int m, int epi,
            cudaStream_t stream) {
  const int T = (m + BT - 1) / BT;
  const int P = T * (T + 1) / 2;
  if (out_bf16) {
    metric2_tri_kernel<TIn, C, __nv_bfloat16><<<P, THREADS, 0, stream>>>(
        static_cast<const TIn*>(V), s, static_cast<__nv_bfloat16*>(out), k, m, T, epi);
  } else {
    metric2_tri_kernel<TIn, C, float><<<P, THREADS, 0, stream>>>(
        static_cast<const TIn*>(V), s, static_cast<float*>(out), k, m, T, epi);
  }
}

inline bool bad_args(int k, int m, int epi) {
  return k < 1 || m < 1 || epi < repro::kRaw || epi > repro::kCcc;
}

}  // namespace tri
}  // namespace minplus
}  // namespace repro
