// Packed bit-plane triangular kernel: the fused diagonal block of a 2-way
// campaign on leveled integer data, on the b1 tensor cores.  One kernel
// serves two rows of the TPU kernel table through two entry points:
//
//   metric2_levels_tri_launch  replaces repro's metric2_levels_tri_pallas
//     (src/repro/kernels/mgemm_levels/kernel.py), impl="levels",
//     levels >= 2, path "fused-levels";
//   metric2_pop_tri_launch     replaces repro's metric2_pop_tri_pallas
//     (src/repro/kernels/popgemm/kernel.py), levels == 1, path
//     "fused-popcount".
//
// Input is the documented wire format (docs/BITPLANE_FORMAT.md): planes P
// (levels, kb, m) uint8, field-major, 8 plane-bits per byte LSB-first.  For
// 0/1 planes sum_t plane_t(a) . plane_t(b) = sum_t popcount(P_t[a] AND
// P_t[b]): the numerator is the plane product of the block with itself,
// accumulated exactly in int32 (at most n_f * levels), then flushed through
// the epilogue on the packed tj >= ti tile schedule of tri_common.cuh.
//
// What bounds it on the H100: mma.sync m16n8k256 .b1 .and.popc computes
// popcount(a AND b) on the packed words themselves, so the work is 2 *
// levels * n_f * m(m-1)/2 bit-ops at the measured b1 rate, 1.024e16/s
// (tools/mma_rates.py; the data sheet lists no b1 rate), 5.2x the int8
// tensor-core rate.  The packed tiles it computes hold 128^2 outputs each,
// 1.6% more than m(m-1)/2 at m = 8,192.  Bytes are small beside it: the
// planes are n_f / 8 * levels bytes per vector and fit the 50 MB L2 at
// full width; the packed output, 2,080 tiles of 64 KB (fp32) at m = 8,192,
// is written once.  Like rows 5 / 7 it is held by what feeds the products
// (the stage copies, the fragment loads and byte transposes), not by them.
//
// Design: one block of 8 warps per packed tile, (ti, tj) from the block
// index (tri_decode), on the b1 main loop of plane_b1.cuh that it shares
// with plane_rect.cu: A and B are the same operand at columns 128 ti and
// 128 tj.  The diagonal block of a campaign has T(T+1)/2 tiles (2,080 at m
// = 8,192, 7.9 waves of the card's 264 resident slots), so the grid fills
// the card without a split of the contraction.  The epilogue writes every
// entry of every tile, as the output is not zeroed: rows and columns past
// m hold epilogue(0, 0, 0), the entries li >= lj of a diagonal tile 0.
#include "plane_b1.cuh"

namespace {

using namespace repro::planes;

template <int VEC, typename TOut>
__global__ void __launch_bounds__(THREADS, 2)
plane_tri_kernel(View p, const float* __restrict__ s, TOut* __restrict__ out, int levels,
                 int kb, int T, int epi) {
  extern __shared__ __align__(16) uint8_t ring[];

  int ti, tj;
  repro::tri_decode(blockIdx.x, T, ti, tj);
  const Lane ln = lane_of(threadIdx.x);
  const int col_a = ti * BM;
  const int col_b = tj * BN;
  int acc[2][2][4][4] = {};
  b1_mainloop<VEC>(acc, ring, p, p, kb, 0, levels * ((kb + KR - 1) / KR), col_a, col_b);

  const int m = p.w;
  const bool on_diag = ti == tj;
  TOut* tile = out + static_cast<size_t>(blockIdx.x) * BM * BN;
  // the stats of the lane's 16 columns; 0 past m
  float sj[2][8];
#pragma unroll
  for (int qb = 0; qb < 2; ++qb)
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int gj = col_b + ln.wb + 32 * qb + 8 * ln.c + x;
      sj[qb][x] = gj < m ? s[gj] : 0.0f;
    }
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int li = ln.wa + 4 * ln.g + rr;
    const float si = col_a + li < m ? s[col_a + li] : 0.0f;
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      const int lj = ln.wb + 32 * qb + 8 * ln.c;
      float v[8];
      row8(v, acc, rr, qb);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        v[x] = on_diag && li >= lj + x ? 0.0f
                                       : repro::apply_epilogue(epi, v[x], si, sj[qb][x]);
      }
      store8(tile + li * BN + lj, v, 8, true);
    }
  }
}

template <typename TOut>
int launch_typed(const View& p, const float* s, TOut* out, int levels, int kb, int epi,
                 int vec, cudaStream_t st) {
  auto kernel = vec == 16 ? plane_tri_kernel<16, TOut>
              : vec == 4  ? plane_tri_kernel<4, TOut>
                          : plane_tri_kernel<1, TOut>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int T = (p.w + BM - 1) / BM;
  kernel<<<T * (T + 1) / 2, THREADS, SMEM, st>>>(p, s, out, levels, kb, T, epi);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* P, int levels, int kb, int m, const float* s, void* out,
           int out_bf16, int epi, void* stream) {
  if (levels < 1 || kb < 1 || m < 1 || epi < repro::kRaw || epi > repro::kCcc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // P is contiguous: row stride m, plane stride kb * m
  const View p{static_cast<const uint8_t*>(P), static_cast<long long>(kb) * m, m, m};
  const int vec = copy_width(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch_typed(p, s, static_cast<__nv_bfloat16*>(out), levels, kb, epi, vec, st);
  }
  return launch_typed(p, s, static_cast<float*>(out), levels, kb, epi, vec, st);
}

}  // namespace

extern "C" int plane_tri_tile() { return BT; }

// P (levels, kb, m) uint8 packed planes, contiguous; s (m,) float32; out
// (nP, BT, BT) float32 or bfloat16 (out_bf16 = 1), nP = T(T+1)/2 for T =
// ceil(m / BT).  epi: repro::Epilogue.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int metric2_levels_tri_launch(const void* P, int levels, int kb, int m,
                                         const float* s, void* out, int out_bf16,
                                         int epi, void* stream) {
  return launch(P, levels, kb, m, s, out, out_bf16, epi, stream);
}

// The levels == 1 (binary) entry point: one plane, a pure AND + popcount
// bit-GEMM.
extern "C" int metric2_pop_tri_launch(const void* P, int kb, int m, const float* s,
                                      void* out, int out_bf16, int epi, void* stream) {
  return launch(P, 1, kb, m, s, out, out_bf16, epi, stream);
}
