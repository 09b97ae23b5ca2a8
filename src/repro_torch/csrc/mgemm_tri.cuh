// The triangular value kernel of row 3 (mgemm_tri.cu) as a template on its
// combine, so that the fixed library (min, the CCC product) and a compiled
// combine's library (combine_entry.cuh) instantiate one body.
//
// metric2_tri_kernel: one CUDA block of 256 threads per packed tile p of the
// tj >= ti schedule and split z of the contraction, on the grid (T, T,
// splits) (tj = blockIdx.x, ti = blockIdx.y; the blocks below the diagonal
// exit at once), on the pipelined main loop of minplus_pipe.cuh with the
// one operand V read as both sides.  Unsplit (splits = 1) it writes
// out[p, li, lj] = epilogue(sum_q C::apply(V[q, i], V[q, j]), s[i], s[j]),
// strictly upper on diagonal tiles; split, block (p, z) writes the raw
// partial sums of its stages to its own (P, BT, BT) slab of a scratch
// buffer, and finish_slabs adds the slabs in split order, then applies the
// epilogue, the mask and the output type.  It is bound by the CUDA cores'
// issue rate and, on a small block, by the card's slots its few packed
// tiles leave empty, which the split fills; in full: mgemm_tri.cu.
#pragma once

#include "minplus_pipe.cuh"
#include "waves.cuh"

namespace repro {
namespace minplus {
namespace tri {

namespace pp = repro::minplus::pipe;

constexpr int kTile = BT * BT;  // elements of one packed tile

// Four sums of row li, columns lj .. lj + 3, of packed tile (ti, tj) through
// the epilogue with their stats (0 past m), zero where a diagonal tile is
// not strictly upper, stored at element `at` of out as fp32 or bf16 (round
// to nearest even).
__device__ __forceinline__ void finish4(float (&v)[4], void* out, int out_bf16, size_t at,
                                        const float* s, int m, int epi, int ti, int tj, int li,
                                        int lj) {
  const int gi = ti * BT + li;
  const float si = gi < m ? s[gi] : 0.0f;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int gj = tj * BT + lj + x;
    const float sj = gj < m ? s[gj] : 0.0f;
    v[x] = repro::apply_epilogue(epi, v[x], si, sj);
    if (ti == tj && !(li < lj + x)) v[x] = 0.0f;
  }
  if (out_bf16) {
    pp::store4(static_cast<__nv_bfloat16*>(out) + at, v, 4, true);
  } else {
    pp::store4(static_cast<float*>(out) + at, v, 4, true);
  }
}

template <typename TIn, typename C, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
metric2_tri_kernel(Operand<TIn> v, const float* __restrict__ s, void* __restrict__ out,
                   int out_bf16, float* __restrict__ slabs, int k, int epi, int split_stages) {
  extern __shared__ __align__(16) uint8_t smem[];
  // the tile from blockIdx, which the loop's copies re-read for free: a
  // decoded packed index would hold two registers across the loop
  const int ti = blockIdx.y;
  const int tj = blockIdx.x;
  if (tj < ti) return;
  // this block's stages of the contraction (all of it unless split)
  const int stages = (k + pp::BK - 1) / pp::BK;
  const int s_beg = blockIdx.z * split_stages;
  const int ns = min(stages, s_beg + split_stages) - s_beg;

  float acc[TM][TM];
  pp::contract<C, C, false, VEC>(acc, smem, v, v, static_cast<const TIn*>(nullptr), 0, k, s_beg,
                                 ns, ti * BT, tj * BT);

  const pp::Place p = pp::place_of(threadIdx.x);
  const size_t T = gridDim.x, a = ti, b = tj;
  const size_t tile = (a * T - a * (a - 1) / 2 + (b - a)) * kTile;  // packed index p, in elements
  const size_t slab = blockIdx.z * (T * (T + 1) / 2) * kTile + tile;  // split form
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int li = pp::tile_pos(i, p.ty);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lj = 64 * h + 4 * p.tx;
      float r[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (gridDim.z > 1) {
        pp::store4(slabs + slab + li * BT + lj, r, 4, true);
      } else {
        finish4(r, out, out_bf16, tile + li * BT + lj, s, v.w, epi, ti, tj, li, lj);
      }
    }
  }
}

// The split form's second pass: out[p] = the sum over z = 0, 1, ..., splits
// - 1 of slabs[z][p], in that order, through finish4.  Grid (P, kTile /
// 1024): a thread takes 4 consecutive elements of one tile row.
__global__ void __launch_bounds__(256)
finish_slabs(const float* __restrict__ slabs, int splits, const float* __restrict__ s,
             void* __restrict__ out, int out_bf16, int m, int T, int epi) {
  int ti, tj;
  repro::tri_decode(blockIdx.x, T, ti, tj);
  const int e = 4 * (blockIdx.y * blockDim.x + threadIdx.x);  // element of the tile
  const size_t at = static_cast<size_t>(blockIdx.x) * kTile + e;
  const size_t slab = static_cast<size_t>(gridDim.x) * kTile;
  float4 a = *reinterpret_cast<const float4*>(slabs + at);
  for (int z = 1; z < splits; ++z) {
    const float4 b = *reinterpret_cast<const float4*>(slabs + z * slab + at);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  float r[4] = {a.x, a.y, a.z, a.w};
  finish4(r, out, out_bf16, at, s, m, epi, ti, tj, e / BT, e % BT);
}

// P, the packed tiles of an m-column block.
inline long long tiles_of(int m) {
  const long long T = (m + BT - 1) / BT;
  return T * (T + 1) / 2;
}

// The splits of the stages of a (k, m) contraction over grid.z for `kernel`
// (repro::plan_splits on its resident slots).  Every instantiation takes
// Layout<TIn>::kSmem and two blocks an SM, so one plan serves all of them.
template <typename K>
cudaError_t plan(K kernel, int smem, int k, int m, int& splits, int& split_stages) {
  return repro::plan_splits(kernel, THREADS, smem, tiles_of(m), (k + pp::BK - 1) / pp::BK,
                            splits, split_stages);
}

// The scratch bytes launch needs for the split form: splits slabs of P
// tiles, 0 when unsplit.
inline long long scratch_bytes(int splits, int m) {
  return splits > 1 ? splits * tiles_of(m) * kTile * static_cast<long long>(sizeof(float)) : 0;
}

// One launch on V (k, m) int8 or float32 (TIn), s (m,), out the packed
// (P, BT, BT) tiles in float32 or bfloat16 (out_bf16 = 1); the split form's
// slabs in scratch (scratch_len bytes, 16-byte aligned; unused, and may be
// null, when the plan does not split).
template <typename TIn, typename C>
cudaError_t launch(const void* V, const float* s, void* out, int out_bf16, int k, int m, int epi,
                   void* scratch, long long scratch_len, cudaStream_t st) {
  const Operand<TIn> v{static_cast<const TIn*>(V), m, m};
  return pp::with_copy_width(v, v, [&](auto vec) {
    auto kernel = metric2_tri_kernel<TIn, C, decltype(vec)::value>;
    constexpr int smem = pp::Layout<TIn>::kSmem;
    int splits = 1, split_stages = 0;
    cudaError_t err = plan(kernel, smem, k, m, splits, split_stages);
    if (err != cudaSuccess) return err;
    if (splits > 1 && (scratch == nullptr || scratch_len < scratch_bytes(splits, m) ||
                       reinterpret_cast<uintptr_t>(scratch) % 16 != 0)) {
      return cudaErrorInvalidValue;
    }
    const unsigned T = (m + BT - 1) / BT;
    float* slabs = static_cast<float*>(scratch);
    kernel<<<dim3(T, T, splits), THREADS, smem, st>>>(v, s, out, out_bf16, slabs, k, epi,
                                                     split_stages);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    const unsigned P = static_cast<unsigned>(tiles_of(m));
    finish_slabs<<<dim3(P, kTile / (4 * 256)), 256, 0, st>>>(slabs, splits, s, out, out_bf16, m,
                                                            T, epi);
    return cudaGetLastError();
  });
}

inline bool bad_args(int k, int m, int epi) {
  return k < 1 || m < 1 || (m + BT - 1) / BT > 65535 || epi < repro::kRaw || epi > repro::kCcc;
}

}  // namespace tri
}  // namespace minplus
}  // namespace repro
