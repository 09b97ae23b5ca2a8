// Host-side sizing of a split contraction for the kernels whose raw fp32
// form splits the contraction over grid.z: with atomics into a zeroed
// output (mgemm_levels.cu, row 4; plane_rect.cu, rows 5 / 7) or into
// per-split slabs added in order (mgemm_rect.cu, row 1).
#pragma once

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

}  // namespace repro
