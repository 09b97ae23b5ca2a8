// Level-decomposition GEMM on the int8 tensor cores.
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
// What bounds it on the H100: the products of 0/1 indicators are an int8
// GEMM, 2 * levels * k * m * n ops at the tensor cores' 1,979 TOP/s; the
// bytes (each value read once) bound only thin blocks.
//
// Design: one CUDA block of 8 warps per 128 x 128 output tile, two blocks
// per SM (128 registers, 80 KB of shared memory).  Each stage of 64 fields
// loads 4 x 16 units of values (warps 0-3 for A, 4-7 for B) coalesced
// along the vector axis, as 16-byte rows when base, row stride and width
// allow it (int8), turns each value into its level count once, and
// transposes the counts with byte permutes into words of four fields of one
// vector.  For each plane t it writes the 0/1 bytes [c >= t] into shared
// memory vector-major (fields contiguous, rows padded to 80 bytes, the
// upper half-warp's rows rotated, so the stores and the ldmatrix loads are
// free of bank conflicts), and each warp issues mma.sync m16n8k32 s8 on
// its 64 x 32 sub-tile into int32 accumulators (mma_s8.cuh).  Two planes
// share a pass; passes alternate between two buffers, one barrier each.
// The contraction is split over grid.z until the blocks fill whole waves
// of the card (a thin (64, 1536) pair term gives 12 tiles, a (1536, 1536)
// block 144 on 132 SMs); split blocks add their partial sums with fp32
// atomics into a zeroed output: the partials are integers, so the order of
// the additions cannot change the result.  No cp.async / TMA pipeline and
// no wgmma yet.
#include <algorithm>

#include "minplus_common.cuh"
#include "mma_s8.cuh"
#include "waves.cuh"

namespace {

using repro::minplus::Operand;

constexpr int BT = 128;            // output tile edge
constexpr int BK = 64;             // fields per stage
constexpr int LDS = BK + 16;       // shared row stride (bytes)
constexpr int THREADS = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int WM = 64;             // warp tile rows
constexpr int WN = 32;             // warp tile columns
constexpr int MT = WM / 16;        // m16 tiles per warp
constexpr int NT = WN / 8;         // n8 tiles per warp
constexpr int UC = 16;             // columns of a load unit (4 fields x 16)
constexpr int LP = 2;              // planes per shared-memory pass
constexpr int WIN = 127;           // planes per count window (bytes <= 127)
constexpr int TILE_BYTES = BT * LDS;                 // one operand's plane
constexpr int SMEM_BYTES = 2 * 2 * LP * TILE_BYTES;  // 80 KB: 2 buffers
constexpr int BLOCKS_PER_SM = 2;
static_assert((BK / 4) * (BT / UC) * 2 == THREADS, "one load unit per thread");

__device__ __forceinline__ int level_count(int8_t x, int levels) {
  const int v = x;
  return v < 0 ? 0 : (v > levels ? levels : v);
}

__device__ __forceinline__ int level_count(float x, int levels) {
  if (!(x >= 1.0f)) return 0;  // NaN, -inf and everything below 1
  if (x >= static_cast<float>(levels)) return levels;
  return static_cast<int>(floorf(x));
}

// The count byte of one value relative to the window base tb, capped at
// WIN: clamp(c(x) - tb, 0, WIN).
template <typename TIn>
__device__ __forceinline__ uint32_t count_byte(TIn x, int levels, int tb) {
  return static_cast<uint32_t>(min(max(level_count(x, levels) - tb, 0), WIN));
}

// A load unit is fields q .. q+3 of columns col .. col+15 of one operand;
// its counts are cw[c] = the count bytes of column col + c (byte j = field
// q + j, little-endian), zero past kend and past the width.
//
// Int8 values need no window and no upper clamp: the kernel runs t = 1 ..
// min(levels, 127) on int8, where [c(x) >= t] = [max(x, 0) >= t].  With
// VEC (int8 operands whose base, row stride and width the launcher checked
// to be multiples of 16) a unit is four 16-byte rows (fetch_unit), turned
// into counts by byte transposes (count_unit).
__device__ __forceinline__ void fetch_unit(uint4 (&r)[4], const Operand<int8_t>& v,
                                           int col, int q, int kend) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = make_uint4(0, 0, 0, 0);
    if (q + j < kend && col < v.w) {
      r[j] = *reinterpret_cast<const uint4*>(&v.base[(q + j) * v.sr + col]);
    }
  }
}

__device__ __forceinline__ uint32_t clear_negatives(uint32_t x) {
  return x & ~(((x >> 7) & 0x01010101u) * 0xFFu);
}

__device__ __forceinline__ void count_unit(uint32_t (&cw)[UC], const uint4 (&r)[4]) {
  using repro::mma::transpose4;
  transpose4(cw + 0, clear_negatives(r[0].x), clear_negatives(r[1].x),
             clear_negatives(r[2].x), clear_negatives(r[3].x));
  transpose4(cw + 4, clear_negatives(r[0].y), clear_negatives(r[1].y),
             clear_negatives(r[2].y), clear_negatives(r[3].y));
  transpose4(cw + 8, clear_negatives(r[0].z), clear_negatives(r[1].z),
             clear_negatives(r[2].z), clear_negatives(r[3].z));
  transpose4(cw + 12, clear_negatives(r[0].w), clear_negatives(r[1].w),
             clear_negatives(r[2].w), clear_negatives(r[3].w));
}

// The unit's counts on the other paths (float32, and int8 that VEC does
// not take), each value loaded alone.
template <typename TIn>
__device__ __forceinline__ void load_unit(uint32_t (&cw)[UC], const Operand<TIn>& v,
                                          int col, int q, int kend, int levels,
                                          int tb) {
#pragma unroll
  for (int c = 0; c < UC; ++c) cw[c] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (q + j >= kend) continue;
    const TIn* row = &v.base[(q + j) * v.sr + col];
#pragma unroll
    for (int c = 0; c < UC; ++c) {
      if (col + c < v.w) cw[c] |= count_byte(row[c], levels, tb) << (8 * j);
    }
  }
}

// Byte-wise [c >= u] of four packed counts c <= 127, 1 <= u <= 127: c + 128
// - u stays below 256, so no carry crosses a byte, and its bit 7 is the
// indicator.
__device__ __forceinline__ uint32_t indicator(uint32_t cw, int u) {
  return ((cw + (0x80u - static_cast<uint32_t>(u)) * 0x01010101u) >> 7) & 0x01010101u;
}

// VEC: int8 operands that vec_ok accepts
template <typename TIn, bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
levels_kernel(Operand<TIn> a, Operand<TIn> b, float* __restrict__ out, int k,
              int levels, int k_split) {
  // two buffers of LP indicator planes of each operand: a pass writes one
  // while the warps still in the previous pass read the other
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * WM;
  const int wn = (warp & 3) * WN;
  const int col_a = blockIdx.y * BT;
  const int col_b = blockIdx.x * BT;
  const int kbeg = blockIdx.z * k_split;
  const int kend = min(k, kbeg + k_split);
  // this thread's load unit: warps 0-3 load A, warps 4-7 B; fields 4 qg ..
  // 4 qg + 3 of the stage, columns UC cg .. UC cg + 15 of the tile.  Lanes
  // run along the fields, and the upper half-warp stores its columns
  // rotated by 4 rows, so a warp's shared stores hit 32 different banks.
  const int op = tid / (THREADS / 2);
  const Operand<TIn> v{op ? b.base : a.base, op ? b.sr : a.sr, op ? b.w : a.w};
  const int qg = tid % (BK / 4);
  const int row0 = UC * ((tid % (THREADS / 2)) / (BK / 4));
  const int col = (op ? col_b : col_a) + row0;
  const int rot = (lane >> 4) * 4;
  const int top = sizeof(TIn) == 1 ? min(levels, 127) : levels;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  int buf = 0;
  for (int tb = 0; tb < top; tb += WIN) {
    const int nu = min(WIN, top - tb);
    for (int k0 = kbeg; k0 < kend; k0 += BK) {
      uint32_t cw[UC];
      if constexpr (VEC) {
        uint4 raw[4];
        fetch_unit(raw, v, col, k0 + 4 * qg, kend);
        count_unit(cw, raw);
      } else {
        load_unit(cw, v, col, k0 + 4 * qg, kend, levels, tb);
      }
      for (int u0 = 1; u0 <= nu; u0 += LP, buf ^= 1) {
        const int np = min(LP, nu - u0 + 1);
        uint8_t* As = smem + buf * 2 * LP * TILE_BYTES;
        uint8_t* Bs = As + LP * TILE_BYTES;
        uint8_t* mine = (op ? Bs : As) + (row0 * LDS + 4 * qg);
        for (int p = 0; p < np; ++p) {
#pragma unroll
          for (int c = 0; c < UC; ++c) {
            const uint32_t w = rot ? cw[(c + 4) % UC] : cw[c];
            *reinterpret_cast<uint32_t*>(mine + p * TILE_BYTES + ((c + rot) % UC) * LDS) =
                indicator(w, u0 + p);
          }
        }
        // the planes are written; the buffer written next was last read
        // before this barrier, one pass ago
        __syncthreads();
        for (int p = 0; p < np; ++p) {
#pragma unroll
          for (int f0 = 0; f0 < BK; f0 += 32) {
            uint32_t bf[NT / 2][4];
#pragma unroll
            for (int j = 0; j < NT / 2; ++j)
              repro::mma::load_b2(bf[j], Bs + p * TILE_BYTES, LDS, wn + 16 * j, f0, lane);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              uint32_t af[4];
              repro::mma::load_a(af, As + p * TILE_BYTES, LDS, wm + 16 * i, f0, lane);
#pragma unroll
              for (int j = 0; j < NT; ++j)
                repro::mma::mma_s8(acc[i][j], af, bf[j / 2][2 * (j & 1)],
                                   bf[j / 2][2 * (j & 1) + 1]);
            }
          }
        }
      }
    }
  }

  const int m = a.w;
  const int n = b.w;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = col_a + wm + 16 * i + g + 8 * h;
      if (gi >= m) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gj = col_b + wn + 8 * j + c2 + e;
          if (gj >= n) continue;
          float* dst = &out[static_cast<size_t>(gi) * n + gj];
          const float val = static_cast<float>(acc[i][j][2 * h + e]);
          if (split) {
            atomicAdd(dst, val);
          } else {
            *dst = val;
          }
        }
    }
}

// Whether an int8 operand can take the VEC loads: base, row stride and
// width multiples of 16.
bool vec_ok(const Operand<int8_t>& v) {
  return reinterpret_cast<uintptr_t>(v.base) % 16 == 0 && v.sr % 16 == 0 && v.w % UC == 0;
}

template <typename TIn>
int launch_typed(const void* A, long long a_sr, const void* B, long long b_sr, int k,
                 int m, int n, int levels, float* out, cudaStream_t st) {
  const Operand<TIn> a{static_cast<const TIn*>(A), a_sr, m};
  const Operand<TIn> b{static_cast<const TIn*>(B), b_sr, n};
  const int tiles = ((n + BT - 1) / BT) * ((m + BT - 1) / BT);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // split the contraction until the blocks fill whole waves of the
  // card's resident block slots
  const int stages = (k + BK - 1) / BK;
  int splits = repro::wave_splits(tiles, stages, static_cast<long long>(BLOCKS_PER_SM) * sms);
  const int k_split = ((stages + splits - 1) / splits) * BK;
  splits = (k + k_split - 1) / k_split;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = levels_kernel<TIn, false>;
  if constexpr (sizeof(TIn) == 1) {
    if (vec_ok(a) && vec_ok(b)) kernel = levels_kernel<TIn, true>;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(m) * n * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + BT - 1) / BT, (m + BT - 1) / BT, splits);
  kernel<<<grid, THREADS, SMEM_BYTES, st>>>(a, b, out, k, levels, k_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (k, m) and B (k, n) field-major int8 (in_int8 = 1) or float32, each
// given by its base pointer and row stride in elements (columns are
// contiguous); out (m, n) float32, contiguous: out[i, j] = sum_q sum_{t=1
// .. levels} [A[q, i] >= t] [B[q, j] >= t].  Launches on `stream` (a
// memset first when the contraction is split) and returns
// cudaGetLastError().
extern "C" int mgemm_levels_launch(const void* A, long long a_sr, const void* B,
                                   long long b_sr, int in_int8, int k, int m, int n,
                                   int levels, float* out, void* stream) {
  if (k < 1 || m < 1 || n < 1 || levels < 1 || a_sr < m || b_sr < n ||
      (m + BT - 1) / BT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_int8) {
    return launch_typed<int8_t>(A, a_sr, B, b_sr, k, m, n, levels, out, st);
  }
  return launch_typed<float>(A, a_sr, B, b_sr, k, m, n, levels, out, st);
}
