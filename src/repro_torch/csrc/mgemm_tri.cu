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
// What bounds it on the H100: arithmetic, as for rows 1 / 2.  min cannot
// run on the tensor cores, so every comparison costs an FMNMX and an FADD
// on the CUDA cores (one FFMA for the product combine; a compiled combine
// its ops and the FADD): 2 * n_f * m(m-1)/2 fp32 instructions against 132
// SMs x 128 lanes.  Bytes are negligible (the block is read once per tile
// row from L2, the output written once).  The second limit is the shape: a
// small diagonal block has few packed tiles, P = T(T+1)/2, and one block a
// tile leaves the card's resident slots empty: at the 2,048 diagonal a
// (1, 4, 1) decomposition gives each rank, 136 tiles on 264 slots (two
// blocks an SM) keep half the card idle for the whole contraction.
//
// Design: one CUDA block of 256 threads per packed tile, on a (T, T) grid
// whose blocks below the diagonal exit at once (a block that decoded its
// packed index would hold the tile's columns in two registers across the
// loop, and float32 min then spilled at the two-blocks-an-SM cap of 128),
// on the pipelined main loop of minplus_pipe.cuh, shared with rows 1 / 2
// and 11 / 10: a cp.async ring two stages ahead, int8 converted to fp32
// once a stage, one barrier a stage, 8 x 8 register tiles.  When
// the packed tiles under-fill the slots, the contraction splits over grid.z
// as row 1's does (waves.cuh plan_splits: 7 splits of 90 stages at the
// 2,048 diagonal, none at 8,192, whose 2,080 tiles fill 98.5% of 8 waves).
// A split writes raw fp32 partial sums to its own (P, BT, BT) slab of a
// scratch buffer that the wrapper allocates (metric2_tri_scratch says its
// size), and a second pass (finish_slabs) adds the slabs in split order,
// then applies the epilogue, the mask and the output type: the bits of the
// unsplit form on integer and quarter-grid data, deterministic on any
// float32 data.
#include "mgemm_tri.cuh"

using namespace repro::minplus;

namespace {

// The split plan of a (k, m) block of TIn values (tri::plan, on the min
// kernel: every instantiation has its occupancy).
template <typename TIn>
cudaError_t plan_of(int k, int m, int& splits, int& split_stages) {
  auto kernel = tri::metric2_tri_kernel<TIn, MinCombine, 16>;
  return tri::plan(kernel, pipe::Layout<TIn>::kSmem, k, m, splits, split_stages);
}

}  // namespace

extern "C" int metric2_tri_tile() { return BT; }

// The scratch bytes metric2_tri_launch needs for these sizes on the current
// device: splits * P * BT * BT floats when it splits the contraction, else
// 0; a negative value is minus a CUDA error.
extern "C" long long metric2_tri_scratch(int in_int8, int k, int m) {
  if (tri::bad_args(k, m, repro::kRaw)) return -static_cast<long long>(cudaErrorInvalidValue);
  int splits = 1, split_stages = 0;
  const cudaError_t err = in_int8 ? plan_of<int8_t>(k, m, splits, split_stages)
                                  : plan_of<float>(k, m, splits, split_stages);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return tri::scratch_bytes(splits, m);
}

// V (k, m) row-major int8 (in_int8 = 1) or float32; s (m,) float32;
// out (P, BT, BT) float32 or bfloat16 (out_bf16 = 1), P = T(T+1)/2,
// T = ceil(m / BT).  combine: 0 = min, 1 = product.  epi: repro::Epilogue.
// scratch of scratch_len >= metric2_tri_scratch(...) bytes, 16-byte
// aligned (unused, and may be null, when that is 0).  Launches on `stream`
// (the slab sum after a split contraction) and returns cudaGetLastError().
extern "C" int metric2_tri_launch(const void* V, int in_int8, const float* s, void* out,
                                  int out_bf16, int k, int m, int combine, int epi,
                                  void* scratch, long long scratch_len, void* stream) {
  if (tri::bad_args(k, m, epi) || combine < kMin || combine > kMul) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (combine == kMul) {
    err = in_int8 ? tri::launch<int8_t, MulCombine>(V, s, out, out_bf16, k, m, epi, scratch,
                                                    scratch_len, st)
                  : tri::launch<float, MulCombine>(V, s, out, out_bf16, k, m, epi, scratch,
                                                   scratch_len, st);
  } else {
    err = in_int8 ? tri::launch<int8_t, MinCombine>(V, s, out, out_bf16, k, m, epi, scratch,
                                                    scratch_len, st)
                  : tri::launch<float, MinCombine>(V, s, out, out_bf16, k, m, epi, scratch,
                                                   scratch_len, st);
  }
  return static_cast<int>(err);
}
