// Packed bit-plane rectangular kernel: one (m, n) block of plane products
// between two different vector blocks.  One kernel serves two rows of the
// TPU kernel table through two entry points:
//
//   metric2_levels_launch  replaces repro's metric2_levels_pallas
//     (src/repro/kernels/mgemm_levels/kernel.py), levels >= 2;
//   metric2_pop_launch     replaces repro's metric2_pop_pallas
//     (src/repro/kernels/popgemm/kernel.py), levels == 1.
//
// out[i, j] = epilogue(sum_t popcount(Pa_t[:, i] AND Pb_t[:, j]), sa[i],
// sb[j]) for planes Pa (levels, kb, m) and Pb (levels, kb, n) in the wire
// format (docs/BITPLANE_FORMAT.md).  With the raw epilogue (kRaw) the
// numerator itself is written: that is what the 3-way campaign's pairwise
// terms use (repro's mgemm_levels_planes / pop_planes), and it is exact in
// int32 and fp32 (at most n_f * levels).
//
// What bounds it on the H100.  As for plane_tri.cu: the card's bound is the
// same numerator as an int8 product of the unpacked 0/1 indicators,
// 2 * levels * n_f * m * n ops at the int8 tensor-core peak; this CUDA-core
// design is capped lower by the POPC issue rate, ceil(kb / 4) * levels * m * n
// results at 16 per clock per SM.  Bytes are tiny next to either.
//
// Design: plane_tri.cu's on a rectangular grid, one CUDA block per 128 x 128
// output tile, no diagonal mask.  The stage load and the AND + __popc
// register-tile update are plane_common.cuh's.  Each operand carries its own
// plane and row strides, so a pipeline slice of the 3-way payload (a
// byte-range view along the vector axis) is read in place.  Tensor-core
// designs are later work.
#include "plane_common.cuh"
#include "tri_common.cuh"

namespace {

using namespace repro::planes;

template <typename TOut>
__global__ void __launch_bounds__(THREADS)
plane_rect_kernel(View a, View b, const float* __restrict__ sa,
                  const float* __restrict__ sb, TOut* __restrict__ out,
                  int levels, int kb, int epi) {
  __shared__ __align__(16) uint32_t As[WK][BT];
  __shared__ __align__(16) uint32_t Bs[WK][BT];

  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;
  const int col_a = blockIdx.y * BT;
  const int col_b = blockIdx.x * BT;
  const int nw = (kb + 3) / 4;

  uint32_t acc[TM][TM];
  zero_acc(acc);
  for (int t = 0; t < levels; ++t) {
    const uint8_t* pa = plane_of(a, t);
    const uint8_t* pb = plane_of(b, t);
    for (int w0 = 0; w0 < nw; w0 += WK) {
      load_stage(As, a, pa, kb, col_a, w0, tid);
      load_stage(Bs, b, pb, kb, col_b, w0, tid);
      __syncthreads();
      popc_stage(acc, As, Bs, ty, tx);
      __syncthreads();
    }
  }

  const int m = a.w;
  const int n = b.w;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = col_a + ty * TM + i;
    if (gi >= m) continue;
    const float si = sa[gi];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int gj = col_b + tx * TM + j;
      if (gj >= n) continue;
      const float val = repro::apply_epilogue(epi, static_cast<float>(acc[i][j]),
                                              si, sb[gj]);
      repro::store_out(&out[static_cast<size_t>(gi) * n + gj], val);
    }
  }
}

int launch(const void* Pa, long long a_sp, long long a_sr, const void* Pb,
           long long b_sp, long long b_sr, int levels, int kb, int m, int n,
           const float* sa, const float* sb, void* out, int out_bf16, int epi,
           void* stream) {
  if (levels < 1 || kb < 1 || m < 1 || n < 1 || epi < repro::kRaw ||
      epi > repro::kCcc || (m + BT - 1) / BT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const View a{static_cast<const uint8_t*>(Pa), a_sp, a_sr, m};
  const View b{static_cast<const uint8_t*>(Pb), b_sp, b_sr, n};
  const dim3 grid((n + BT - 1) / BT, (m + BT - 1) / BT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    plane_rect_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        a, b, sa, sb, static_cast<__nv_bfloat16*>(out), levels, kb, epi);
  } else {
    plane_rect_kernel<float><<<grid, THREADS, 0, st>>>(
        a, b, sa, sb, static_cast<float*>(out), levels, kb, epi);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pa (levels, kb, m) and Pb (levels, kb, n) uint8 packed planes, each given
// by its base pointer, plane stride and row stride in bytes (columns are
// contiguous); sa (m,), sb (n,) float32; out (m, n) float32 or bfloat16
// (out_bf16 = 1), contiguous.  epi: repro::Epilogue.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int metric2_levels_launch(const void* Pa, long long a_sp, long long a_sr,
                                     const void* Pb, long long b_sp, long long b_sr,
                                     int levels, int kb, int m, int n,
                                     const float* sa, const float* sb, void* out,
                                     int out_bf16, int epi, void* stream) {
  return launch(Pa, a_sp, a_sr, Pb, b_sp, b_sr, levels, kb, m, n, sa, sb, out,
                out_bf16, epi, stream);
}

// The levels == 1 (binary) entry point: one plane, a pure AND + popcount
// bit-GEMM.
extern "C" int metric2_pop_launch(const void* Pa, long long a_sp, long long a_sr,
                                  const void* Pb, long long b_sp, long long b_sr,
                                  int kb, int m, int n, const float* sa,
                                  const float* sb, void* out, int out_bf16, int epi,
                                  void* stream) {
  return launch(Pa, a_sp, a_sr, Pb, b_sp, b_sr, 1, kb, m, n, sa, sb, out,
                out_bf16, epi, stream);
}
