// Level-decomposition GEMM on the b1 tensor cores.
//
//   mgemm_levels_launch  replaces repro's mgemm_levels_pallas
//     (src/repro/kernels/mgemm_levels/kernel.py): out[i, j] = sum_q sum_{t=1
//     .. levels} [A[q, i] >= t] [B[q, j] >= t], raw fp32 -- the registered
//     impl="levels" contraction, which the 3-way pair terms of the levels
//     value ring (encoding="none", or data outside [0, levels]) and the
//     2-way unfused path of a metric without an in-kernel epilogue go
//     through.
//
// Operands are int8 or float32, both of one type, field-major (k, m) and
// (k, n), each with its own row stride: the 3-way pair terms pass a
// pipeline slice of the payload (row stride n_vp) and it is read in place.
//
// The indicator sets are nested, so sum_t [a >= t][b >= t] = min(c(a),
// c(b)) with the level count c(x) = clamp(floor(x), 0, levels) (NaN -> 0,
// +inf -> levels): the kernel holds on any values, not only on leveled
// ones.  Each sum is an integer; it is kept in int32 and written as fp32,
// exact below 2^24.
//
// What bounds it on the H100: the product of the 0/1 indicators, 2 *
// levels * k * m * n ops, which the b1 tensor cores (mma.sync m16n8k256
// .and.popc) compute on packed indicator bits at the measured 1.024e16/s
// (tools/mma_rates.py), 0.018 ms at (1,536, 1,536), levels 2, n_f 20,000
// (0.095 ms at the int8 rate); and the values, each read once (bytes bound
// the thin (64, 1,536) shape).  The plane bits must be formed from the
// values on chip first: that, and the feed of the products, is what limits
// this design (PERF.md section 6).
//
// Design: two kernels a launch.  pack_kernel reads each value once (a
// thread 4 columns and a byte row: 8 fields, 4- or 16-byte loads coalesced
// along the vectors where base and row stride allow, else one column),
// turns it into its level count and writes the packed planes [c >= t] of
// both operands, 8 fields a byte, to a scratch buffer that the wrapper
// allocates, its rows padded to 16 bytes.  The bit order inside a byte
// (field 8 r + f at bit f, as in docs/BITPLANE_FORMAT.md) does not matter
// to the result: sum popcount(a AND b) is the same for any order that A and
// B share.  gemm_kernel is rows 5 / 7's raw form (plane_rect.cu) on those
// planes: the b1 main loop of plane_b1.cuh (a 4-deep cp.async ring of
// 64-byte-row stages, 16-byte copies, b1_words transposes, 8 warps of 32 x
// 64 on a 128 x 128 tile, two blocks an SM), the contraction split over
// grid.z until the blocks fill whole waves of the card (a thin (64, 1536)
// pair term gives 12 tiles, a (1536, 1536) block 144 on 132 SMs); split
// blocks add their integer partial sums with fp32 atomics into a zeroed
// output, exact in any order.  Planes come in windows of at most kWin: a
// window packs planes tb + 1 .. tb + kWin of the counts and adds its
// products to the output, so the scratch stays small at any levels.  On
// int8 values a count is at most 127, so planes past 127 are all zero and
// never packed.
#include <algorithm>

#include "minplus_common.cuh"
#include "plane_b1.cuh"
#include "waves.cuh"

namespace {

namespace pl = repro::planes;
using repro::minplus::Operand;

constexpr int kWin = 16;         // planes packed a window
constexpr int kPackThreads = 128;

__device__ __forceinline__ int level_count(int8_t x, int levels) {
  const int v = x;
  return v < 0 ? 0 : (v > levels ? levels : v);
}

__device__ __forceinline__ int level_count(float x, int levels) {
  if (!(x >= 1.0f)) return 0;  // NaN, -inf and everything below 1
  if (x >= static_cast<float>(levels)) return levels;
  return static_cast<int>(floorf(x));
}

// Four consecutive float32 values in one 16-byte load; the launcher checked
// the alignment.
__device__ __forceinline__ void load_cv(float (&x)[4], const float* p) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  x[0] = w.x;
  x[1] = w.y;
  x[2] = w.z;
  x[3] = w.w;
}

// Byte-wise max(x, 0) of four int8 values: the count before the clamp at
// levels, which no plane of an int8 window reaches past 127.
__device__ __forceinline__ uint32_t clear_negatives(uint32_t x) {
  return x & ~(((x >> 7) & 0x01010101u) * 0xFFu);
}

// Byte-wise [c >= u] of four counts c <= 127, 1 <= u <= 127: c + 128 - u
// stays below 256, so no carry crosses a byte, and its bit 7 is the
// indicator.
__device__ __forceinline__ uint32_t indicator(uint32_t c, int u) {
  return ((c + (0x80u - static_cast<uint32_t>(u)) * 0x01010101u) >> 7) & 0x01010101u;
}

// Planes tb + 1 .. tb + np of the counts of v into P (np, kb, sr) uint8:
// bit f of byte (t, r, i) is [c(v[8 r + f, i]) >= tb + 1 + t], 0 past k.
// Block (byte row r, kPackThreads x CV columns); a thread takes CV columns.
template <typename TIn, int CV>
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(Operand<TIn> v, int k, int levels, int tb, int np, uint8_t* __restrict__ P,
            long long sp, long long sr) {
  const int r = blockIdx.x;
  const int i = (blockIdx.y * kPackThreads + threadIdx.x) * CV;
  if (i >= v.w) return;
  const bool whole = CV == 4 && i + 4 <= v.w;
  uint8_t* dst = P + r * sr + i;
  if constexpr (sizeof(TIn) == 1 && CV == 4) {
    // int8: the four columns' counts stay packed in one word a field
    uint32_t c[8];
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int q = 8 * r + f;
      const TIn* row = v.base + static_cast<long long>(q) * v.sr + i;
      uint32_t w = 0;
      if (q < k) {
        if (whole) {
          w = *reinterpret_cast<const uint32_t*>(row);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (i + e < v.w) w |= static_cast<uint32_t>(static_cast<uint8_t>(row[e])) << (8 * e);
          }
        }
      }
      c[f] = clear_negatives(w);
    }
    for (int t = 0; t < np; ++t) {
      uint32_t word = 0;
#pragma unroll
      for (int f = 0; f < 8; ++f) word |= indicator(c[f], tb + 1 + t) << f;
      if (whole) {
        *reinterpret_cast<uint32_t*>(dst + t * sp) = word;
      } else {
        for (int e = 0; i + e < v.w; ++e) dst[t * sp + e] = static_cast<uint8_t>(word >> (8 * e));
      }
    }
  } else {
    int c[8][CV];
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int q = 8 * r + f;
      const TIn* row = v.base + static_cast<long long>(q) * v.sr + i;
      if constexpr (CV == 4) {
        TIn x[4] = {};
        if (q < k) {
          if (whole) {
            load_cv(x, row);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (i + e < v.w) x[e] = row[e];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) c[f][e] = q < k ? level_count(x[e], levels) - tb : 0;
      } else {
        c[f][0] = q < k ? level_count(row[0], levels) - tb : 0;
      }
    }
    for (int t = 0; t < np; ++t) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < CV; ++e) {
#pragma unroll
        for (int f = 0; f < 8; ++f) word |= static_cast<uint32_t>(c[f][e] > t) << (8 * e + f);
      }
      if (whole) {
        *reinterpret_cast<uint32_t*>(dst + t * sp) = word;
      } else {
        for (int e = 0; e < CV && i + e < v.w; ++e) dst[t * sp + e] = static_cast<uint8_t>(word >> (8 * e));
      }
    }
  }
}

// Packs planes tb + 1 .. tb + np of operand v into P (row stride sr).
template <typename TIn>
void pack(const Operand<TIn>& v, int k, int kb, int levels, int tb, int np, uint8_t* P,
          long long sr, cudaStream_t st) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(v.base);
  const bool vec = base % (4 * sizeof(TIn)) == 0 && v.sr % 4 == 0;
  const int per_block = kPackThreads * (vec ? 4 : 1);
  const dim3 grid(kb, (v.w + per_block - 1) / per_block);
  if (vec) {
    pack_kernel<TIn, 4><<<grid, kPackThreads, 0, st>>>(v, k, levels, tb, np, P, kb * sr, sr);
  } else {
    pack_kernel<TIn, 1><<<grid, kPackThreads, 0, st>>>(v, k, levels, tb, np, P, kb * sr, sr);
  }
}

// out (m, n) fp32 = sum over this block's stages of the planes of a and b:
// stored, or added with atomics when accumulate (a split contraction, or a
// window after the first).
__global__ void __launch_bounds__(pl::THREADS)
gemm_kernel(pl::View a, pl::View b, float* __restrict__ out, int np, int kb, int split_stages,
            int accumulate) {
  extern __shared__ __align__(16) uint8_t ring[];

  const pl::Lane ln = pl::lane_of(threadIdx.x);
  const int col_a = blockIdx.y * pl::BM;
  const int col_b = blockIdx.x * pl::BN;
  const int stages = np * ((kb + pl::KR - 1) / pl::KR);
  const int s_beg = blockIdx.z * split_stages;
  const int ns = min(stages, s_beg + split_stages) - s_beg;
  int acc[2][2][4][4] = {};
  pl::b1_mainloop<16>(acc, ring, a, b, kb, s_beg, ns, col_a, col_b);

  const int m = a.w;
  const int n = b.w;
  const bool vec = (n & 7) == 0;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int gi = col_a + ln.wa + 4 * ln.g + rr;
    if (gi >= m) continue;
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      const int gj = col_b + ln.wb + 32 * qb + 8 * ln.c;
      const int live = n - gj;
      if (live <= 0) continue;
      float v[8];
      pl::row8(v, acc, rr, qb);
      float* dst = out + static_cast<size_t>(gi) * n + gj;
      if (accumulate) {
        pl::add8(dst, v, live, vec);
      } else {
        pl::store8(dst, v, live, vec);
      }
    }
  }
}

long long pad16(long long w) { return (w + 15) / 16 * 16; }

template <typename TIn>
int launch_typed(const void* A, long long a_sr, const void* B, long long b_sr, int k, int m,
                 int n, int levels, float* out, uint8_t* scratch, cudaStream_t st) {
  const Operand<TIn> a{static_cast<const TIn*>(A), a_sr, m};
  const Operand<TIn> b{static_cast<const TIn*>(B), b_sr, n};
  // one operand packed once when both are the same view
  const bool same = A == B && a_sr == b_sr && m == n;
  const int kb = (k + 7) / 8;
  const int top = sizeof(TIn) == 1 ? std::min(levels, 127) : levels;
  const int win = std::min(kWin, top);
  const long long wa = pad16(m);
  const long long wb = pad16(n);
  uint8_t* pa = scratch;
  uint8_t* pb = same ? scratch : scratch + win * kb * wa;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl::SMEM);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_kernel, pl::THREADS, pl::SMEM);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = (top + win - 1) / win;
  const long long tiles = static_cast<long long>((n + pl::BN - 1) / pl::BN) * ((m + pl::BM - 1) / pl::BM);
  const int spp = (kb + pl::KR - 1) / pl::KR;  // stages a plane
  // split the contraction until the blocks fill whole waves of the card's
  // resident block slots
  const int stages = win * spp;
  int splits = repro::wave_splits(tiles, stages, static_cast<long long>(std::max(per_sm, 1)) * sms);
  const int split_stages = (stages + splits - 1) / splits;
  splits = (stages + split_stages - 1) / split_stages;
  const int accumulate = splits > 1 || windows > 1;
  if (accumulate) {
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(m) * n * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int tb = 0; tb < top; tb += win) {
    const int np = std::min(win, top - tb);
    pack(a, k, kb, levels, tb, np, pa, wa, st);
    if (!same) pack(b, k, kb, levels, tb, np, pb, wb, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const pl::View va{pa, kb * wa, wa, m};
    const pl::View vb{pb, kb * wb, wb, n};
    // a short last window splits its fewer stages into as many parts
    const int w_stages = np * spp;
    const int w_split = std::min(split_stages, w_stages);
    const dim3 grid((n + pl::BN - 1) / pl::BN, (m + pl::BM - 1) / pl::BM,
                    (w_stages + w_split - 1) / w_split);
    gemm_kernel<<<grid, pl::THREADS, pl::SMEM, st>>>(va, vb, out, np, kb, w_split, accumulate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// The scratch bytes mgemm_levels_launch needs: the packed planes of one
// window of both operands.
extern "C" long long mgemm_levels_scratch(int in_int8, int k, int m, int n, int levels) {
  const int top = in_int8 ? std::min(levels, 127) : levels;
  const long long win = std::min(kWin, top);
  const long long kb = (k + 7) / 8;
  return win * kb * (pad16(m) + pad16(n));
}

// A (k, m) and B (k, n) field-major int8 (in_int8 = 1) or float32, each
// given by its base pointer and row stride in elements (columns are
// contiguous); out (m, n) float32, contiguous: out[i, j] = sum_q sum_{t=1
// .. levels} [A[q, i] >= t] [B[q, j] >= t]; scratch of
// mgemm_levels_scratch(...) bytes, 16-byte aligned.  Launches on `stream`
// (a memset first when the output is accumulated) and returns
// cudaGetLastError().
extern "C" int mgemm_levels_launch(const void* A, long long a_sr, const void* B,
                                   long long b_sr, int in_int8, int k, int m, int n,
                                   int levels, float* out, void* scratch, void* stream) {
  if (k < 1 || m < 1 || n < 1 || levels < 1 || a_sr < m || b_sr < n ||
      (m + pl::BM - 1) / pl::BM > 65535 || (n + kPackThreads - 1) / kPackThreads > 65535 ||
      (m + kPackThreads - 1) / kPackThreads > 65535 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  if (in_int8) return launch_typed<int8_t>(A, a_sr, B, b_sr, k, m, n, levels, out, s, st);
  return launch_typed<float>(A, a_sr, B, b_sr, k, m, n, levels, out, s, st);
}
