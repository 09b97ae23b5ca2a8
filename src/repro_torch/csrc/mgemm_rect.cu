// Min-plus rectangular kernel: one (m, n) block of combine-sums between two
// different field-major value blocks.  One kernel serves two rows of the TPU
// kernel table through two entry points:
//
//   mgemm_launch    replaces repro's mgemm_pallas
//     (src/repro/kernels/mgemm/kernel.py): out[i, j] = sum_q min(A[q, i],
//     B[q, j]), raw fp32 -- the registered impl="pallas" contraction, which
//     the 3-way campaign's pairwise terms and the 2-way unfused path of a
//     metric without an in-kernel epilogue go through;
//   metric2_launch  replaces repro's metric2_pallas (and czek2_metric_pallas,
//     one instantiation of it): out[i, j] = epilogue(sum_q combine(A[q, i],
//     B[q, j]), sa[i], sb[j]) with combine = min or the fp32 product (CCC)
//     and the epilogue ids of tri_common.cuh -- the off-diagonal 2-way
//     block under impl="pallas".  Any other registered combine is compiled
//     into its own library on this kernel's body (mgemm_rect.cuh,
//     combine_entry.cuh).
//
// Operands are int8 or float32, both of one type, field-major (k, m) and
// (k, n), each with its own row stride: the 3-way pair terms pass a
// pipeline slice of the payload (row stride n_vp) and it is read in place.
//
// What bounds it on the H100: arithmetic, as for mgemm_tri.cu.  min has no
// tensor-core form, so every comparison costs an FMNMX and an FADD on the
// CUDA cores (one FFMA for the product): 2 * k * m * n fp32 instructions at
// 132 SMs x 128 lanes x 1.98 GHz = 33.5e12/s.  Bytes are small next to that.
// A thin block (the 3-way (L, m) pair terms, m = L = 64) fills few of the
// 132 SMs: one CUDA block per 128 x 128 tile gives 12 blocks at (64, 1536),
// and 144 tiles at (1536, 1536) leave a second wave of 12.
//
// Design: one CUDA block of 256 threads per 128 x 128 output tile on the
// grid (ceil(n/128), ceil(m/128)), on the pipelined main loop of
// minplus_pipe.cuh (cp.async ring two stages ahead, int8 converted once a
// stage, one barrier a stage, 8 x 8 register tiles; two blocks an SM).
// The raw form (mgemm_launch) splits the contraction over grid.z until the
// blocks fill whole waves of the card's resident slots (wave_splits: 22
// splits of the 12 tiles at (64, 1536), 5 of the 144 at (1536, 1536)).  The
// split stays deterministic on float32 operands, and one form serves both
// dtypes: split z writes its partial sums to its own (m, n) slab of a
// scratch buffer that the wrapper allocates (mgemm_scratch says its size),
// and a second pass (add_slabs) adds the slabs in split order.  metric2_launch
// (row 2, with its epilogue) is not split.
#include "mgemm_rect.cuh"
#include "waves.cuh"

namespace {

using namespace repro::minplus;
using namespace repro::minplus::rect;

// out[e] = sum over z of slabs[z][e] in the order z = 0, 1, ..., splits - 1:
// the split contraction's second pass.
__global__ void __launch_bounds__(256)
add_slabs(const float* __restrict__ slabs, int splits, long long mn, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float s = slabs[e];
  for (int z = 1; z < splits; ++z) s += slabs[z * mn + e];
  out[e] = s;
}

// The splits of the raw contraction's stages over grid.z (1 for the
// epilogue forms) and the stages of each: the fewest splits whose blocks
// fill the last wave of the card's resident slots to 90% (wave_splits).
template <typename TIn>
cudaError_t plan_splits(int k, int m, int n, int& splits, int& split_stages) {
  auto kernel = rect_kernel<TIn, MinCombine, 16>;
  const long long tiles = static_cast<long long>((n + BT - 1) / BT) * ((m + BT - 1) / BT);
  return repro::plan_splits(kernel, THREADS, pp::Layout<TIn>::kSmem, tiles,
                            (k + pp::BK - 1) / pp::BK, splits, split_stages);
}

template <typename TIn>
int launch_raw(const void* A, long long a_sr, const void* B, long long b_sr, int k, int m,
               int n, void* scratch, long long scratch_len, float* out, cudaStream_t st) {
  const Operand<TIn> a{static_cast<const TIn*>(A), a_sr, m};
  const Operand<TIn> b{static_cast<const TIn*>(B), b_sr, n};
  int splits = 1, split_stages = 0;
  cudaError_t err = plan_splits<TIn>(k, m, n, splits, split_stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mn = static_cast<long long>(m) * n;
  if (splits > 1 && (scratch == nullptr || scratch_len < splits * mn * 4 ||
                     reinterpret_cast<uintptr_t>(scratch) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = launch_combine<TIn, MinCombine>(a, b, nullptr, nullptr, splits > 1 ? scratch : out, 0,
                                        k, repro::kRaw, splits, split_stages, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  add_slabs<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(scratch), splits, mn, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch bytes mgemm_launch needs for these sizes on the current
// device: splits * m * n floats when it splits the contraction, else 0; a
// negative value is minus a CUDA error.
extern "C" long long mgemm_scratch(int in_int8, int k, int m, int n) {
  if (bad_sizes(m, n, k, m, n)) return -static_cast<long long>(cudaErrorInvalidValue);
  int splits = 1, split_stages = 0;
  const cudaError_t err = in_int8 ? plan_splits<int8_t>(k, m, n, splits, split_stages)
                                  : plan_splits<float>(k, m, n, splits, split_stages);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return splits > 1 ? static_cast<long long>(splits) * m * n * sizeof(float) : 0;
}

// A (k, m) and B (k, n) field-major int8 (in_int8 = 1) or float32, each
// given by its base pointer and row stride in elements (columns are
// contiguous); scratch of scratch_len >= mgemm_scratch(...) bytes, 16-byte
// aligned (unused, and may be null, when that is 0); out (m, n) float32,
// contiguous: out[i, j] = sum_q min(A[q, i], B[q, j]).  Launches on
// `stream` (the slab sum after the split contraction) and returns
// cudaGetLastError().
extern "C" int mgemm_launch(const void* A, long long a_sr, const void* B, long long b_sr,
                            int in_int8, int k, int m, int n, void* scratch,
                            long long scratch_len, float* out, void* stream) {
  if (bad_sizes(a_sr, b_sr, k, m, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_int8 ? launch_raw<int8_t>(A, a_sr, B, b_sr, k, m, n, scratch, scratch_len, out, st)
                 : launch_raw<float>(A, a_sr, B, b_sr, k, m, n, scratch, scratch_len, out, st);
}

// As mgemm_launch without the split, with combine (0 = min, 1 = product),
// the epilogue id epi (repro::Epilogue) applied with sa (m,) and sb (n,)
// float32 stats, and out (m, n) float32 or bfloat16 (out_bf16 = 1).  Any
// other combine runs its own compiled library (combine_entry.cuh).
extern "C" int metric2_launch(const void* A, long long a_sr, const void* B,
                              long long b_sr, int in_int8, int k, int m, int n,
                              const float* sa, const float* sb, void* out,
                              int out_bf16, int combine, int epi, void* stream) {
  if (bad_metric_args(a_sr, b_sr, k, m, n, sa, sb, epi) || combine < kMin || combine > kMul) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (combine == kMul) {
    return in_int8 ? launch_metric<int8_t, MulCombine>(A, a_sr, B, b_sr, k, m, n, sa, sb, out,
                                                       out_bf16, epi, st)
                   : launch_metric<float, MulCombine>(A, a_sr, B, b_sr, k, m, n, sa, sb, out,
                                                      out_bf16, epi, st);
  }
  return in_int8 ? launch_metric<int8_t, MinCombine>(A, a_sr, B, b_sr, k, m, n, sa, sb, out,
                                                     out_bf16, epi, st)
                 : launch_metric<float, MinCombine>(A, a_sr, B, b_sr, k, m, n, sa, sb, out,
                                                    out_bf16, epi, st);
}
