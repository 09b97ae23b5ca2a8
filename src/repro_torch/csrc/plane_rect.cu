// Packed bit-plane rectangular kernel: one (m, n) block of plane products
// between two different vector blocks, on the b1 tensor cores.  One kernel
// serves two rows of the TPU kernel table through two entry points:
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
// What bounds it on the H100: mma.sync m16n8k256 .b1 .and.popc computes
// popcount(a AND b) on the packed words themselves, 2 * levels * n_f * m *
// n bit-ops at its measured 1.024e16/s (tools/mma_rates.py; the data sheet
// lists no b1 rate), 5.2x the int8 tensor-core rate and with no spread of
// the fields to bytes.  Bytes are small beside it: the output is written
// once, each packed tile is read from L2 by the blocks of its tile row or
// column.  This design is held by what feeds the products, not by them
// (PERF.md section 6): the stage copies, and each warp's shared-memory
// reads and byte transposes of its fragment words.
//
// Design: one block of 8 warps per 128 x 128 output tile, on the b1 main
// loop that it shares with the triangular form (plane_b1.cuh: a 4-deep
// cp.async ring of 64-byte-row stages copied as they lie, b1_words
// transposes, 8 warps of 32 x 64, two blocks an SM), its results stored
// through the epilogue as 16- or 32-byte rows.  The raw fp32 form (the
// 3-way pair terms) splits the contraction over grid.z until the blocks
// fill whole waves of the card's resident slots; split blocks add their
// integer partial sums with fp32 vector atomics into a zeroed output,
// exact in any order.
#include "plane_b1.cuh"
#include "waves.cuh"

namespace {

using namespace repro::planes;

template <int VEC, typename TOut>
__global__ void __launch_bounds__(THREADS)
plane_rect_kernel(View a, View b, const float* __restrict__ sa,
                  const float* __restrict__ sb, TOut* __restrict__ out, int levels,
                  int kb, int epi, int split_stages) {
  extern __shared__ __align__(16) uint8_t ring[];

  const Lane ln = lane_of(threadIdx.x);
  const int col_a = blockIdx.y * BM;
  const int col_b = blockIdx.x * BN;
  // this block's stages of the contraction (all of it unless split)
  const int stages = levels * ((kb + KR - 1) / KR);
  const int s_beg = blockIdx.z * split_stages;
  const int ns = min(stages, s_beg + split_stages) - s_beg;
  int acc[2][2][4][4] = {};
  b1_mainloop<VEC>(acc, ring, a, b, kb, s_beg, ns, col_a, col_b);

  const int m = a.w;
  const int n = b.w;
  const bool split = gridDim.z > 1;
  const bool vec = (n & 7) == 0;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int gi = col_a + ln.wa + 4 * ln.g + rr;
    if (gi >= m) continue;
    const float si = sa[gi];
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      const int gj = col_b + ln.wb + 32 * qb + 8 * ln.c;
      const int live = n - gj;
      if (live <= 0) continue;
      float v[8];
      row8(v, acc, rr, qb);
      TOut* dst = out + static_cast<size_t>(gi) * n + gj;
      if constexpr (sizeof(TOut) == 4) {
        if (split) {
          add8(dst, v, live, vec);
          continue;
        }
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        if (x < live) v[x] = repro::apply_epilogue(epi, v[x], si, sb[gj + x]);
      }
      store8(dst, v, live, vec);
    }
  }
}

template <typename TOut>
int launch_typed(const View& a, const View& b, const float* sa, const float* sb, TOut* out,
                 int levels, int kb, int epi, int vec, int splits, int split_stages,
                 cudaStream_t st) {
  auto kernel = vec == 16 ? plane_rect_kernel<16, TOut>
              : vec == 4  ? plane_rect_kernel<4, TOut>
                          : plane_rect_kernel<1, TOut>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((b.w + BN - 1) / BN, (a.w + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, SMEM, st>>>(a, b, sa, sb, out, levels, kb, epi, split_stages);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* Pa, long long a_sp, long long a_sr, const void* Pb,
           long long b_sp, long long b_sr, int levels, int kb, int m, int n,
           const float* sa, const float* sb, void* out, int out_bf16, int epi,
           void* stream) {
  if (levels < 1 || kb < 1 || m < 1 || n < 1 || epi < repro::kRaw ||
      epi > repro::kCcc || (m + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const View a{static_cast<const uint8_t*>(Pa), a_sp, a_sr, m};
  const View b{static_cast<const uint8_t*>(Pb), b_sp, b_sr, n};
  const int vec = min(copy_width(a), copy_width(b));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int stages = levels * ((kb + KR - 1) / KR);
  const long long tiles = static_cast<long long>((n + BN - 1) / BN) * ((m + BM - 1) / BM);
  int splits = 1;
  if (!out_bf16 && epi == repro::kRaw) {
    // the raw fp32 form splits the contraction over grid.z until the
    // blocks fill whole waves of the card's resident slots (a thin (64,
    // 1536) pair term is 12 tiles, a (1536, 1536) block 144)
    auto kernel = plane_rect_kernel<16, float>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    splits = repro::wave_splits(tiles, stages, static_cast<long long>(max(per_sm, 1)) * sms);
  }
  const int split_stages = (stages + splits - 1) / splits;
  splits = (stages + split_stages - 1) / split_stages;
  if (splits > 1) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, static_cast<size_t>(m) * n * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (out_bf16) {
    return launch_typed(a, b, sa, sb, static_cast<__nv_bfloat16*>(out), levels, kb, epi, vec,
                        splits, split_stages, st);
  }
  return launch_typed(a, b, sa, sb, static_cast<float*>(out), levels, kb, epi, vec, splits,
                      split_stages, st);
}

}  // namespace

// Pa (levels, kb, m) and Pb (levels, kb, n) uint8 packed planes, each given
// by its base pointer, plane stride and row stride in bytes (columns are
// contiguous); sa (m,), sb (n,) float32; out (m, n) float32 or bfloat16
// (out_bf16 = 1), contiguous.  epi: repro::Epilogue.  Launches on `stream`
// (a memset first when the raw fp32 contraction is split) and returns
// cudaGetLastError().
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
