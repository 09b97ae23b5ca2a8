// 3-way plane slice kernel: the batched pipeline slice of a 3-way campaign
// on the packed bit-plane ring.  One kernel serves two rows of the TPU
// kernel table through two entry points:
//
//   threeway_batch_levels_launch  replaces repro's
//     threeway_batch_levels_pallas (src/repro/kernels/czek3/kernel.py),
//     path3 "fused-levels-ring" (levels >= 2);
//   threeway_batch_pop_launch     replaces repro's threeway_batch_pop_pallas
//     (src/repro/kernels/popgemm/kernel.py), path3 "fused-popcount-ring"
//     (levels == 1).
//
// B[t, i, k] = sum_levels popcount(own_i AND X_t AND right_k) for planes
// Pown (levels, kb, m), PX (levels, kb, L) and Pright (levels, kb, n): on
// leveled integer data this is sum_q min(own[q, i], X[q, t], right[q, k]),
// the 3-way numerator of one pipeline slice.  Output (L, m, n) fp32, raw:
// the metric assembly runs outside the kernel, as in repro.  Sums are at
// most n_f * levels, exact in int32 and fp32.
//
// What bounds it on the H100.  The card's bound is the same numerator as an
// int8 product of the unpacked 0/1 indicators with the pipeline axis folded
// into M, (L*m, levels*n_f) x (levels*n_f, n): 2 * levels * n_f * L * m * n
// ops at the int8 tensor-core peak.  This CUDA-core design is capped by the
// POPC issue rate instead, ceil(kb / 4) * levels * L * m * n results at 16
// per clock per SM, several times above the card's bound.  Bytes are small:
// the output (4 * L * m * n) dominates and is written once.
//
// Design: grid (L, ceil(m / 128), ceil(n / 128)), one CUDA block per
// pipeline column t and 128 x 128 output tile, so one launch covers a whole
// slice, as on the TPU.  Each stage first assembles the WK words of column
// x_t in shared memory, then loads the own tile ANDed with them: the X_t
// tile (own AND x_t) is built while the A stage is loaded and never touches
// device memory.  The rest is plane_rect.cu's design (plane_common.cuh).
// PX is a byte-range view of the ring payload (row stride n_vp, not L): each
// operand is read in place through its own plane and row strides.  On a
// diagonal item own and right are the same tensor.
#include "plane_common.cuh"
#include "tri_common.cuh"

namespace {

using namespace repro::planes;

__global__ void __launch_bounds__(THREADS)
plane3_kernel(View own, View px, View right, float* __restrict__ out, int levels,
              int kb) {
  __shared__ __align__(16) uint32_t As[WK][BT];
  __shared__ __align__(16) uint32_t Bs[WK][BT];
  __shared__ uint32_t Xs[WK];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;
  const int col_a = blockIdx.y * BT;
  const int col_b = blockIdx.z * BT;
  const int nw = (kb + 3) / 4;

  uint32_t acc[TM][TM];
  zero_acc(acc);
  for (int lv = 0; lv < levels; ++lv) {
    const uint8_t* po = plane_of(own, lv);
    const uint8_t* pxl = plane_of(px, lv);
    const uint8_t* pr = plane_of(right, lv);
    for (int w0 = 0; w0 < nw; w0 += WK) {
      if (tid < WK) {
        const int w = w0 + tid;
        Xs[tid] = w < nw ? word_at(pxl, px.sr, kb, w, t) : 0u;
      }
      __syncthreads();
      load_stage(As, own, po, kb, col_a, w0, tid, Xs);
      load_stage(Bs, right, pr, kb, col_b, w0, tid);
      __syncthreads();
      popc_stage(acc, As, Bs, ty, tx);
      __syncthreads();
    }
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
      slab[static_cast<size_t>(gi) * n + gj] = static_cast<float>(acc[i][j]);
    }
  }
}

int launch(const void* Pown, long long o_sp, long long o_sr, const void* PX,
           long long x_sp, long long x_sr, const void* Pright, long long r_sp,
           long long r_sr, int levels, int kb, int m, int L, int n, float* out,
           void* stream) {
  if (levels < 1 || kb < 1 || m < 1 || L < 1 || n < 1 ||
      (m + BT - 1) / BT > 65535 || (n + BT - 1) / BT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const View own{static_cast<const uint8_t*>(Pown), o_sp, o_sr, m};
  const View px{static_cast<const uint8_t*>(PX), x_sp, x_sr, L};
  const View right{static_cast<const uint8_t*>(Pright), r_sp, r_sr, n};
  const dim3 grid(L, (m + BT - 1) / BT, (n + BT - 1) / BT);
  plane3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      own, px, right, out, levels, kb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pown (levels, kb, m), PX (levels, kb, L) and Pright (levels, kb, n) uint8
// packed planes, each given by its base pointer, plane stride and row
// stride in bytes (columns are contiguous); out (L, m, n) float32,
// contiguous.  Launches on `stream` and returns cudaGetLastError().
extern "C" int threeway_batch_levels_launch(
    const void* Pown, long long o_sp, long long o_sr, const void* PX,
    long long x_sp, long long x_sr, const void* Pright, long long r_sp,
    long long r_sr, int levels, int kb, int m, int L, int n, float* out,
    void* stream) {
  return launch(Pown, o_sp, o_sr, PX, x_sp, x_sr, Pright, r_sp, r_sr, levels, kb,
                m, L, n, out, stream);
}

// The levels == 1 (binary) entry point: popcount(own AND x_t AND right) on
// the one plane.
extern "C" int threeway_batch_pop_launch(
    const void* Pown, long long o_sp, long long o_sr, const void* PX,
    long long x_sp, long long x_sr, const void* Pright, long long r_sp,
    long long r_sr, int kb, int m, int L, int n, float* out, void* stream) {
  return launch(Pown, o_sp, o_sr, PX, x_sp, x_sr, Pright, r_sp, r_sr, 1, kb, m,
                L, n, out, stream);
}
