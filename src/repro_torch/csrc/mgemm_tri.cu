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
// Sorenson) or an fp32 product (CCC), and the strict-upper mask li < lj on
// on-diagonal tiles.  Any other registered combine is compiled into its
// own library on this kernel's body (mgemm_tri.cuh, combine_entry.cuh),
// summed over the k real fields.  Operands are int8 (ring_dtype "auto" on
// small-integer data) or float32; accumulation is fp32.
//
// What bounds it on the H100: arithmetic.  min cannot run on the tensor
// cores, so every comparison costs an FMNMX and an FADD on the CUDA cores
// (one FFMA for the product combine; a compiled combine its ops and the
// FADD): 2 * n_f * m(m-1)/2 fp32 instructions against 132 SMs x 128 lanes.
// Bytes are negligible (the int8 block is read once per tile row from L2,
// the output written once).
//
// Design: one CUDA block per packed tile (no float-sqrt decode: the block
// walks the row starts with integer math).  The K loop, its stage loads
// and the 8 x 8 register tile of each of the 256 threads are
// minplus_common.cuh's, shared with the rectangular and 3-way kernels.
// No double buffering, no tensor memory accelerator yet: right first.
#include "mgemm_tri.cuh"

using namespace repro::minplus;

extern "C" int metric2_tri_tile() { return BT; }

// V (k, m) row-major int8 (in_int8 = 1) or float32; s (m,) float32;
// out (P, BT, BT) float32 or bfloat16 (out_bf16 = 1), P = T(T+1)/2,
// T = ceil(m / BT).  combine: 0 = min, 1 = product.  epi: repro::Epilogue.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int metric2_tri_launch(const void* V, int in_int8, const float* s,
                                  void* out, int out_bf16, int k, int m,
                                  int combine, int epi, void* stream) {
  if (tri::bad_args(k, m, epi) || combine < kMin || combine > kMul) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (combine == kMul) {
    if (in_int8) {
      tri::launch<int8_t, MulCombine>(V, s, out, out_bf16, k, m, epi, st);
    } else {
      tri::launch<float, MulCombine>(V, s, out, out_bf16, k, m, epi, st);
    }
  } else if (in_int8) {
    tri::launch<int8_t, MinCombine>(V, s, out, out_bf16, k, m, epi, st);
  } else {
    tri::launch<float, MinCombine>(V, s, out, out_bf16, k, m, epi, st);
  }
  return static_cast<int>(cudaGetLastError());
}
