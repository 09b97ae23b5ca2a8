// 3-way value slice kernel: the batched pipeline slice of a 3-way campaign
// on value operands (the paper's Algorithm 3).  One kernel serves two rows
// of the TPU kernel table through two entry points:
//
//   threeway_batch_launch  replaces repro's threeway_batch_pallas
//     (src/repro/kernels/czek3/kernel.py), path3 "fused-vpu"
//     (impl="pallas"): one launch per pipeline slice;
//   threeway_step_launch   replaces repro's threeway_step_pallas, the
//     single-column form (one pipeline column x, output (m, n)).
//
// B[t, i, k] = sum_q combine(combine(own[q, i], X[q, t]), right[q, k]) for
// field-major own (k, m), X (k, L) and right (k, n), combine = min
// (Czekanowski, Sorenson) or the fp32 product (CCC).  Output (L, m, n) fp32,
// raw: the metric assembly runs outside the kernel, as in repro.  Operands
// are int8 or float32, converted to fp32 at the stage load (exact for
// int8); on integer data every partial sum is an integer below 2^24
// (at most 8 * n_f for CCC's triple product on {0, 1, 2}), so the result is
// exact in any summation order.
//
// What bounds it on the H100: arithmetic.  min has no tensor-core form, so
// every comparison costs an FMNMX and an FADD on the CUDA cores (one FFMA
// for the product): 2 * n_f * L * m * n fp32 instructions at 132 SMs x 128
// lanes x 1.98 GHz = 33.5e12/s (half that count for the product).  Building
// X_t costs one more instruction per (field, own column) per output tile,
// 1/128 of the contraction.  Bytes: the output, 4 * L * m * n, written
// once, is the largest term and far below the arithmetic.
//
// Design: grid (L, ceil(m/128), ceil(n/128)), one CUDA block per pipeline
// column t and 128 x 128 output tile, so one launch covers a whole slice,
// as on the TPU.  Each stage first loads the BK values of column x_t into
// shared memory, then loads the own strip combined with them: the X_t tile
// combine(own, x_t) is built in shared memory as the A stage is loaded and
// never touches device memory.  The rest is mgemm_tri.cu's register-tiled
// contraction (minplus_common.cuh).  X is the pipeline slice Vb[:, j0:j0+L],
// a view with row stride n_vp: each operand is read in place through its own
// row stride.  On a diagonal item own and right are the same tensor.
#include "minplus_common.cuh"

namespace {

using namespace repro::minplus;

template <typename TIn, int COMBINE>
__global__ void __launch_bounds__(THREADS)
minplus3_kernel(Operand<TIn> own, Operand<TIn> px, Operand<TIn> right,
                float* __restrict__ out, int k) {
  __shared__ __align__(16) float As[BK][BT];
  __shared__ __align__(16) float Bs[BK][BT];
  __shared__ float Xs[BK];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;
  const int col_a = blockIdx.y * BT;
  const int col_b = blockIdx.z * BT;

  float acc[TM][TM];
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    if (tid < BK) {
      const int q = k0 + tid;
      Xs[tid] = q < k ? static_cast<float>(px.base[q * px.sr + t]) : 0.0f;
    }
    __syncthreads();
    load_stage<COMBINE>(As, own, k, col_a, k0, tid, Xs);
    load_stage<COMBINE>(Bs, right, k, col_b, k0, tid);
    __syncthreads();
    fma_stage<COMBINE>(acc, As, Bs, ty, tx);
    __syncthreads();
  }

  const int m = own.w;
  const int n = right.w;
  float* slab = out + static_cast<size_t>(t) * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = col_a + ty * TM + i;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int gj = col_b + tx * TM + j;
      if (gj >= n) continue;
      slab[static_cast<size_t>(gi) * n + gj] = acc[i][j];
    }
  }
}

template <typename TIn, int COMBINE>
void launch_typed(const void* own, long long o_sr, const void* X, long long x_sr,
                  const void* right, long long r_sr, int k, int m, int L, int n,
                  float* out, cudaStream_t st) {
  const Operand<TIn> o{static_cast<const TIn*>(own), o_sr, m};
  const Operand<TIn> x{static_cast<const TIn*>(X), x_sr, L};
  const Operand<TIn> r{static_cast<const TIn*>(right), r_sr, n};
  const dim3 grid(L, (m + BT - 1) / BT, (n + BT - 1) / BT);
  minplus3_kernel<TIn, COMBINE><<<grid, THREADS, 0, st>>>(o, x, r, out, k);
}

template <typename TIn>
void launch_combine(const void* own, long long o_sr, const void* X, long long x_sr,
                    const void* right, long long r_sr, int k, int m, int L, int n,
                    int combine, float* out, cudaStream_t st) {
  if (combine == kMul) {
    launch_typed<TIn, kMul>(own, o_sr, X, x_sr, right, r_sr, k, m, L, n, out, st);
  } else {
    launch_typed<TIn, kMin>(own, o_sr, X, x_sr, right, r_sr, k, m, L, n, out, st);
  }
}

int launch(const void* own, long long o_sr, const void* X, long long x_sr,
           const void* right, long long r_sr, int in_int8, int k, int m, int L,
           int n, int combine, float* out, void* stream) {
  if (k < 1 || m < 1 || L < 1 || n < 1 || o_sr < m || x_sr < L || r_sr < n ||
      (combine != kMin && combine != kMul) || (m + BT - 1) / BT > 65535 ||
      (n + BT - 1) / BT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_int8) {
    launch_combine<int8_t>(own, o_sr, X, x_sr, right, r_sr, k, m, L, n, combine,
                           out, st);
  } else {
    launch_combine<float>(own, o_sr, X, x_sr, right, r_sr, k, m, L, n, combine,
                          out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// own (k, m), X (k, L) pipeline columns and right (k, n), field-major int8
// (in_int8 = 1) or float32, each given by its base pointer and row stride in
// elements (columns are contiguous; X's row stride is n_vp on the campaign
// path).  combine: 0 = min, 1 = product.  out (L, m, n) float32,
// contiguous.  Launches on `stream` and returns cudaGetLastError().
extern "C" int threeway_batch_launch(const void* own, long long o_sr, const void* X,
                                     long long x_sr, const void* right,
                                     long long r_sr, int in_int8, int k, int m,
                                     int L, int n, int combine, float* out,
                                     void* stream) {
  return launch(own, o_sr, X, x_sr, right, r_sr, in_int8, k, m, L, n, combine,
                out, stream);
}

// The single-column form: x (k,) with element stride x_s, out (m, n).
extern "C" int threeway_step_launch(const void* own, long long o_sr, const void* x,
                                    long long x_s, const void* right, long long r_sr,
                                    int in_int8, int k, int m, int n, int combine,
                                    float* out, void* stream) {
  return launch(own, o_sr, x, x_s, right, r_sr, in_int8, k, m, 1, n, combine, out,
                stream);
}
