// Min-plus triangular kernel: the fused diagonal block of a 2-way campaign.
//
// Replaces repro's Pallas kernel metric2_tri_pallas
// (src/repro/kernels/mgemm/kernel.py), which serves impl="pallas"
// (path "fused-vpu").  For one vector block V (k, m), field-major, it
// computes, on the packed tj >= ti tile schedule only,
//
//   out[p, li, lj] = epilogue(sum_q combine(V[q, i], V[q, j]), s[i], s[j])
//
// with i = ti*BT + li, j = tj*BT + lj, combine = min (Czekanowski,
// Sorenson), an fp32 product (CCC) or the program of any other combine
// (kExpr, summed over the k real fields), and the strict-upper mask li < lj
// on on-diagonal tiles.  Operands are int8 (ring_dtype "auto" on small-integer
// data) or float32; accumulation is fp32.
//
// What bounds it on the H100: arithmetic.  min cannot run on the tensor
// cores, so every comparison costs an FMNMX and an FADD on the CUDA cores
// (one FFMA for the product combine; a program its ops and the FADD):
// 2 * n_f * m(m-1)/2 fp32 instructions against 132 SMs x 128 lanes.  Bytes are negligible (the int8 block is read
// once per tile row from L2, the output written once).
//
// Design: one CUDA block per packed tile (no float-sqrt decode: the block
// walks the row starts with integer math).  The K loop, its stage loads
// and the 8 x 8 register tile of each of the 256 threads are
// minplus_common.cuh's, shared with the rectangular and 3-way kernels.
// No double buffering, no tensor memory accelerator yet: right first.
#include "minplus_common.cuh"

namespace {

using namespace repro::minplus;

template <typename TIn, int COMBINE, typename TOut>
__global__ void __launch_bounds__(THREADS)
metric2_tri_kernel(const TIn* __restrict__ V, const float* __restrict__ s,
                   TOut* __restrict__ out, int k, int m, int T, int epi,
                   const __grid_constant__ ExprProgram prog) {
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
  contract_tile<COMBINE>(acc, As, Bs, v, v, k, col_a, col_b, tid, ty, tx, prog);

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

template <typename TIn, int COMBINE, typename TOut>
void launch(const void* V, const float* s, void* out, int k, int m, int epi,
            const ExprProgram& prog, cudaStream_t stream) {
  const int T = (m + BT - 1) / BT;
  const int P = T * (T + 1) / 2;
  metric2_tri_kernel<TIn, COMBINE, TOut><<<P, THREADS, 0, stream>>>(
      static_cast<const TIn*>(V), s, static_cast<TOut*>(out), k, m, T, epi, prog);
}

template <typename TIn, int COMBINE>
void launch_out(const void* V, const float* s, void* out, int out_bf16, int k,
                int m, int epi, const ExprProgram& prog, cudaStream_t stream) {
  if (out_bf16) {
    launch<TIn, COMBINE, __nv_bfloat16>(V, s, out, k, m, epi, prog, stream);
  } else {
    launch<TIn, COMBINE, float>(V, s, out, k, m, epi, prog, stream);
  }
}

template <typename TIn>
void launch_combine(const void* V, const float* s, void* out, int out_bf16,
                    int k, int m, int combine, int epi, const ExprProgram& prog,
                    cudaStream_t stream) {
  if (combine == kMul) {
    launch_out<TIn, kMul>(V, s, out, out_bf16, k, m, epi, prog, stream);
  } else if (combine == kExpr) {
    launch_out<TIn, kExpr>(V, s, out, out_bf16, k, m, epi, prog, stream);
  } else {
    launch_out<TIn, kMin>(V, s, out, out_bf16, k, m, epi, prog, stream);
  }
}

}  // namespace

extern "C" int metric2_tri_tile() { return BT; }

// V (k, m) row-major int8 (in_int8 = 1) or float32; s (m,) float32;
// out (P, BT, BT) float32 or bfloat16 (out_bf16 = 1), P = T(T+1)/2,
// T = ceil(m / BT).  combine: 0 = min, 1 = product, 2 = the program
// *prog (read only for combine 2; may be null otherwise).  epi:
// repro::Epilogue.  Launches on `stream` and returns cudaGetLastError().
extern "C" int metric2_tri_launch(const void* V, int in_int8, const float* s,
                                  void* out, int out_bf16, int k, int m,
                                  int combine, int epi, const ExprProgram* prog,
                                  void* stream) {
  if (k < 1 || m < 1 || epi < repro::kRaw || epi > repro::kCcc || combine < kMin ||
      combine > kExpr || !valid_program(combine, prog)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ExprProgram p = combine == kExpr ? *prog : ExprProgram{};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_int8) {
    launch_combine<int8_t>(V, s, out, out_bf16, k, m, combine, epi, p, st);
  } else {
    launch_combine<float>(V, s, out, out_bf16, k, m, combine, epi, p, st);
  }
  return static_cast<int>(cudaGetLastError());
}
