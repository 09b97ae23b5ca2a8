// Host-side sizing of a split contraction for the kernels whose raw fp32
// form splits the contraction over grid.z: with atomics into a zeroed
// output (mgemm_levels.cu, row 4; plane_rect.cu, rows 5 / 7) or into
// per-split slabs added in order (mgemm_rect.cu, row 1; mgemm_tri.cuh, rows
// 3 / 3x).
#pragma once

#include <cuda_runtime.h>

namespace repro {

// The number of splits of `stages` over grid.z for a grid of `tiles` output
// tiles on `slots` resident blocks: the fewest whose blocks fill the last
// wave of slots to at least 90%, else the best fill of any.  A lone
// 128 x 128 tile is latency-bound, and 144 tiles on 132 SMs would leave most
// SMs one tile and a few two.
inline int wave_splits(long long tiles, int stages, long long slots) {
  int splits = 1;
  double best = 0.0;
  for (int s = 1; s <= stages; ++s) {
    const long long blocks = tiles * s;
    const double fill =
        static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
    if (fill > best) {
      best = fill;
      splits = s;
    }
    if (blocks >= slots && fill >= 0.9) break;
  }
  return splits;
}

// wave_splits of `tiles` blocks of `kernel` (`threads` a block, `smem`
// bytes of dynamic shared memory, set here as its limit) on the current
// device's resident slots (occupancy x SMs), then as even as whole stages
// allow: split_stages stages a split, the last one shorter.
template <typename K>
cudaError_t plan_splits(K kernel, int threads, int smem, long long tiles, int stages,
                        int& splits, int& split_stages) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return err;
  splits = wave_splits(tiles, stages, static_cast<long long>(per_sm > 1 ? per_sm : 1) * sms);
  split_stages = (stages + splits - 1) / splits;
  splits = (stages + split_stages - 1) / split_stages;
  return cudaSuccess;
}

}  // namespace repro
