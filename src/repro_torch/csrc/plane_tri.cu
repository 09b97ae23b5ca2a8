// Packed bit-plane triangular kernel: the fused diagonal block of a 2-way
// campaign on leveled integer data.  One kernel serves two rows of the TPU
// kernel table through two entry points:
//
//   metric2_levels_tri_launch  replaces repro's metric2_levels_tri_pallas
//     (src/repro/kernels/mgemm_levels/kernel.py), impl="levels",
//     levels >= 2, path "fused-levels";
//   metric2_pop_tri_launch     replaces repro's metric2_pop_tri_pallas
//     (src/repro/kernels/popgemm/kernel.py), levels == 1, path
//     "fused-popcount".
//
// Input is the documented wire format (docs/BITPLANE_FORMAT.md): planes P
// (levels, kb, m) uint8, field-major, 8 plane-bits per byte LSB-first.  For 0/1
// planes sum_t plane_t(a) . plane_t(b) = sum_t popcount(P_t[a] AND P_t[b]),
// so the kernel ANDs 32-bit words and accumulates __popc in int32 registers
// (exact; numerators are at most n_f), then flushes through the epilogue
// like the min-plus kernel, on the same packed tj >= ti tile schedule.
//
// What bounds it on the H100.  This design is held by the popcount issue
// rate: each 32 fields of a vector pair and plane cost one LOP3 (AND), one
// POPC and one IADD, and POPC issues at 16 per clock per SM, so
// ceil(n_f / 32) * levels * m(m-1)/2 POPC results cap it.  The card's
// bound for the same numerator is lower: it is an int8 product of the
// unpacked 0/1 indicators, (m, levels*n_f) x (levels*n_f, m), so
// 2 * levels * n_f * m(m-1)/2 ops at the int8 tensor-core peak, about 7x
// less time than the POPC cap.  Bytes are tiny: the planes are
// n_f / 8 * levels bytes per vector.
//
// Design: one CUDA block per packed tile; the planes loop outside the K
// loop so shared memory does not grow with the plane count.  The stage load
// (byte rows -> 32-bit words) and the AND + __popc register-tile update
// live in plane_common.cuh, which this kernel alone still uses.
// Each of the 256 threads owns an 8 x 8 register tile.  Tensor-core (b1 MMA
// or wgmma) designs are later work.
#include "plane_common.cuh"
#include "tri_common.cuh"

namespace {

using namespace repro::planes;

template <typename TOut>
__global__ void __launch_bounds__(THREADS)
plane_tri_kernel(const uint8_t* __restrict__ P, const float* __restrict__ s,
                 TOut* __restrict__ out, int levels, int kb, int m, int T, int epi) {
  __shared__ __align__(16) uint32_t As[WK][BT];
  __shared__ __align__(16) uint32_t Bs[WK][BT];

  int ti, tj;
  repro::tri_decode(blockIdx.x, T, ti, tj);
  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;
  const int col_a = ti * BT;
  const int col_b = tj * BT;
  const int nw = (kb + 3) / 4;
  const View pv{P, static_cast<long long>(kb) * m, m, m};

  uint32_t acc[TM][TM];
  zero_acc(acc);
  for (int t = 0; t < levels; ++t) {
    const uint8_t* plane = plane_of(pv, t);
    for (int w0 = 0; w0 < nw; w0 += WK) {
      load_stage(As, pv, plane, kb, col_a, w0, tid);
      load_stage(Bs, pv, plane, kb, col_b, w0, tid);
      __syncthreads();
      popc_stage(acc, As, Bs, ty, tx);
      __syncthreads();
    }
  }

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
      float v = repro::apply_epilogue(epi, static_cast<float>(acc[i][j]), si, sj);
      if (on_diag && !(li < lj)) v = 0.0f;
      repro::store_out(&tile[li * BT + lj], v);
    }
  }
}

int launch(const void* P, int levels, int kb, int m, const float* s, void* out,
           int out_bf16, int epi, void* stream) {
  if (levels < 1 || kb < 1 || m < 1 || epi < repro::kRaw || epi > repro::kCcc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int T = (m + BT - 1) / BT;
  const int nP = T * (T + 1) / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* planes = static_cast<const uint8_t*>(P);
  if (out_bf16) {
    plane_tri_kernel<__nv_bfloat16><<<nP, THREADS, 0, st>>>(
        planes, s, static_cast<__nv_bfloat16*>(out), levels, kb, m, T, epi);
  } else {
    plane_tri_kernel<float><<<nP, THREADS, 0, st>>>(
        planes, s, static_cast<float*>(out), levels, kb, m, T, epi);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int plane_tri_tile() { return BT; }

// P (levels, kb, m) uint8 packed planes; s (m,) float32; out (nP, BT, BT)
// float32 or bfloat16 (out_bf16 = 1).  epi: repro::Epilogue.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int metric2_levels_tri_launch(const void* P, int levels, int kb, int m,
                                         const float* s, void* out, int out_bf16,
                                         int epi, void* stream) {
  return launch(P, levels, kb, m, s, out, out_bf16, epi, stream);
}

// The levels == 1 (binary) entry point: one plane, so the kernel is a pure
// AND + popcount bit-GEMM.
extern "C" int metric2_pop_tri_launch(const void* P, int kb, int m, const float* s,
                                      void* out, int out_bf16, int epi, void* stream) {
  return launch(P, 1, kb, m, s, out, out_bf16, epi, stream);
}
