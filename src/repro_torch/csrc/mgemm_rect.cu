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
//     and the epilogue ids of tri_common.cuh -- the off-diagonal 2-way block
//     under impl="pallas".
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
// 132 SMs: one CUDA block per 128 x 128 tile gives 12 blocks at (64, 1536).
//
// Design: mgemm_tri.cu's on a rectangular grid (ceil(n/128), ceil(m/128)),
// one CUDA block per output tile, no diagonal mask; the K loop and the 8 x 8
// register tile are minplus_common.cuh's.  No double buffering yet.
#include "minplus_common.cuh"

namespace {

using namespace repro::minplus;

template <typename TIn, int COMBINE, typename TOut>
__global__ void __launch_bounds__(THREADS)
rect_kernel(Operand<TIn> a, Operand<TIn> b, const float* __restrict__ sa,
            const float* __restrict__ sb, TOut* __restrict__ out, int k, int epi) {
  __shared__ __align__(16) float As[BK][BT];
  __shared__ __align__(16) float Bs[BK][BT];

  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;
  const int col_a = blockIdx.y * BT;
  const int col_b = blockIdx.x * BT;

  float acc[TM][TM];
  contract_tile<COMBINE>(acc, As, Bs, a, b, k, col_a, col_b, tid, ty, tx);

  const int m = a.w;
  const int n = b.w;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = col_a + ty * TM + i;
    if (gi >= m) continue;
    const float si = epi == repro::kRaw ? 0.0f : sa[gi];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int gj = col_b + tx * TM + j;
      if (gj >= n) continue;
      const float sj = epi == repro::kRaw ? 0.0f : sb[gj];
      repro::store_out(&out[static_cast<size_t>(gi) * n + gj],
                       repro::apply_epilogue(epi, acc[i][j], si, sj));
    }
  }
}

template <typename TIn, int COMBINE, typename TOut>
void launch_typed(const void* A, long long a_sr, const void* B, long long b_sr,
                  int k, int m, int n, const float* sa, const float* sb, void* out,
                  int epi, cudaStream_t st) {
  const Operand<TIn> a{static_cast<const TIn*>(A), a_sr, m};
  const Operand<TIn> b{static_cast<const TIn*>(B), b_sr, n};
  const dim3 grid((n + BT - 1) / BT, (m + BT - 1) / BT);
  rect_kernel<TIn, COMBINE, TOut><<<grid, THREADS, 0, st>>>(
      a, b, sa, sb, static_cast<TOut*>(out), k, epi);
}

template <typename TIn, int COMBINE>
void launch_out(const void* A, long long a_sr, const void* B, long long b_sr,
                int k, int m, int n, const float* sa, const float* sb, void* out,
                int out_bf16, int epi, cudaStream_t st) {
  if (out_bf16) {
    launch_typed<TIn, COMBINE, __nv_bfloat16>(A, a_sr, B, b_sr, k, m, n, sa, sb,
                                              out, epi, st);
  } else {
    launch_typed<TIn, COMBINE, float>(A, a_sr, B, b_sr, k, m, n, sa, sb, out,
                                      epi, st);
  }
}

template <typename TIn>
void launch_combine(const void* A, long long a_sr, const void* B, long long b_sr,
                    int k, int m, int n, const float* sa, const float* sb,
                    void* out, int out_bf16, int combine, int epi, cudaStream_t st) {
  if (combine == kMul) {
    launch_out<TIn, kMul>(A, a_sr, B, b_sr, k, m, n, sa, sb, out, out_bf16, epi, st);
  } else {
    launch_out<TIn, kMin>(A, a_sr, B, b_sr, k, m, n, sa, sb, out, out_bf16, epi, st);
  }
}

int launch(const void* A, long long a_sr, const void* B, long long b_sr,
           int in_int8, int k, int m, int n, const float* sa, const float* sb,
           void* out, int out_bf16, int combine, int epi, void* stream) {
  if (k < 1 || m < 1 || n < 1 || a_sr < m || b_sr < n || epi < repro::kRaw ||
      epi > repro::kCcc || (combine != kMin && combine != kMul) ||
      (m + BT - 1) / BT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_int8) {
    launch_combine<int8_t>(A, a_sr, B, b_sr, k, m, n, sa, sb, out, out_bf16,
                           combine, epi, st);
  } else {
    launch_combine<float>(A, a_sr, B, b_sr, k, m, n, sa, sb, out, out_bf16,
                          combine, epi, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (k, m) and B (k, n) field-major int8 (in_int8 = 1) or float32, each
// given by its base pointer and row stride in elements (columns are
// contiguous); out (m, n) float32, contiguous: out[i, j] = sum_q min(A[q, i],
// B[q, j]).  Launches on `stream` and returns cudaGetLastError().
extern "C" int mgemm_launch(const void* A, long long a_sr, const void* B,
                            long long b_sr, int in_int8, int k, int m, int n,
                            float* out, void* stream) {
  return launch(A, a_sr, B, b_sr, in_int8, k, m, n, nullptr, nullptr, out, 0,
                kMin, repro::kRaw, stream);
}

// As mgemm_launch, with combine (0 = min, 1 = product), the epilogue id epi
// (repro::Epilogue) applied with sa (m,) and sb (n,) float32 stats, and out
// (m, n) float32 or bfloat16 (out_bf16 = 1).
extern "C" int metric2_launch(const void* A, long long a_sr, const void* B,
                              long long b_sr, int in_int8, int k, int m, int n,
                              const float* sa, const float* sb, void* out,
                              int out_bf16, int combine, int epi, void* stream) {
  if (epi != repro::kRaw && (sa == nullptr || sb == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(A, a_sr, B, b_sr, in_int8, k, m, n, sa, sb, out, out_bf16,
                combine, epi, stream);
}
