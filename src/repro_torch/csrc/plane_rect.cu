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
// Design: one block of 8 warps per 128 x 128 output tile, each warp a 32 x
// 64 sub-tile: 16 m16n8 products a k256 step into 64 int32 accumulators a
// thread, two blocks an SM.  Stages of 64 byte rows (512 fields, two k256
// steps) of both packed tiles are copied as they lie, field-major, into a
// 4-deep cp.async ring: 16-byte copies where base and strides allow it,
// 4-byte or byte copies otherwise, so a byte-range view at any column
// offset (a 3-way pipeline slice) is read in place; byte rows past kb and
// columns past the view's width land as zeros, and a step whose byte rows
// all lie past kb is skipped.  One barrier a stage.  Each lane builds its
// fragment words from the field-major rows with one 4 x 4 byte transpose
// per four words (plane_mma.cuh b1_words); the fragment rows and columns
// are a permutation of the tile's vectors that leaves lane (g, c) owning
// rows 4 g .. 4 g + 3 and columns 8 c .. 8 c + 7 of each 32 x 32 quarter,
// converted to fp32 once and stored through the epilogue as 16- or 32-byte
// rows.  The raw fp32 form (the 3-way pair terms) splits the contraction
// over grid.z until the blocks fill whole waves of the card's resident
// slots; split blocks add their integer partial sums with fp32 vector
// atomics into a zeroed output, exact in any order.
#include "plane_mma.cuh"
#include "tri_common.cuh"
#include "waves.cuh"

namespace {

using namespace repro::planes;

constexpr int BM = 128;      // output tile rows
constexpr int BN = 128;      // output tile columns
constexpr int KR = 64;       // packed byte rows per stage: two k256 steps
constexpr int NSTAGE = 4;    // cp.async ring depth
constexpr int WN = BN / 64;  // warps along a tile row: each owns 32 x 64
constexpr int THREADS = 32 * (BM / 32) * WN;  // 8 warps
constexpr int LDA = BM + 32;  // row strides of the packed tiles: 32 (mod 128)
constexpr int LDB = BN + 32;
constexpr int SLOT = KR * (LDA + LDB);  // one ring stage
constexpr int SMEM = NSTAGE * SLOT;     // 80 KB: two blocks an SM

// Copy stage (plane lv, byte rows r0 .. r0 + KR - 1) of the two packed
// tiles into a ring slot: A's KR rows of BM bytes (row stride LDA), then
// B's of BN bytes.  Thread tid takes chunks tid, tid + THREADS, ...
template <int VEC>
__device__ __forceinline__ void issue_stage(uint8_t* slot, const View& a, const View& b,
                                            int kb, int lv, int r0, int col_a, int col_b,
                                            int tid) {
  constexpr int CA = BM / VEC;  // chunks per byte row
  constexpr int CB = BN / VEC;
  constexpr int NA = KR * CA;
  constexpr int N = KR * (CA + CB);
  static_assert(NA % THREADS == 0 && N % THREADS == 0, "whole chunks a thread");
  const uint8_t* pa = plane_of(a, lv) + static_cast<long long>(r0) * a.sr;
  const uint8_t* pb = plane_of(b, lv) + static_cast<long long>(r0) * b.sr;
#pragma unroll 4
  for (int i = 0; i < N / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const bool op = e >= NA;
    const int f = op ? e - NA : e;
    const int r = op ? f / CB : f / CA;
    const int c = (op ? f % CB : f % CA) * VEC;
    const int col = (op ? col_b : col_a) + c;
    const int bytes = r0 + r < kb ? min(max((op ? b.w : a.w) - col, 0), VEC) : 0;
    const uint8_t* src = bytes > 0 ? (op ? pb + r * b.sr : pa + r * a.sr) + col : a.base;
    copy_chunk<VEC>(slot + (op ? KR * LDA + r * LDB : r * LDA) + c, src, bytes);
  }
}

// The stage after (lv, r0): the next KR byte rows, or the next plane.
__device__ __forceinline__ void advance(int& lv, int& r0, int kb) {
  r0 += KR;
  if (r0 >= kb) {
    r0 = 0;
    ++lv;
  }
}

// Eight outputs of one row, columns gj .. gj + 7, of which `live` lie in
// the block: one or two 16-byte stores when the row has them all and n is
// a multiple of 8 (so the row starts 16-byte aligned), else one by one.
__device__ __forceinline__ void store8(float* dst, const float (&v)[8], int live, bool vec) {
  if (vec && live >= 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  for (int x = 0; x < min(live, 8); ++x) dst[x] = v[x];
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8], int live,
                                       bool vec) {
  if (vec && live >= 8) {
    uint32_t p[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * x], v[2 * x + 1]);
      p[x] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
    return;
  }
  for (int x = 0; x < min(live, 8); ++x) repro::store_out(dst + x, v[x]);
}

// The same eight outputs added into dst (a split contraction's partial sums).
__device__ __forceinline__ void add8(float* dst, const float (&v)[8], int live, bool vec) {
  if (vec && live >= 8) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    atomicAdd(reinterpret_cast<float4*>(dst) + 1, make_float4(v[4], v[5], v[6], v[7]));
    return;
  }
  for (int x = 0; x < min(live, 8); ++x) atomicAdd(dst + x, v[x]);
}

template <int VEC, typename TOut>
__global__ void __launch_bounds__(THREADS)
plane_rect_kernel(View a, View b, const float* __restrict__ sa,
                  const float* __restrict__ sb, TOut* __restrict__ out, int levels,
                  int kb, int epi, int split_stages) {
  extern __shared__ __align__(16) uint8_t ring[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int col_a = blockIdx.y * BM;
  const int col_b = blockIdx.x * BN;
  const int wa = 32 * (warp / WN);  // the warp's 32 x 64 sub-tile
  const int wb = 64 * (warp % WN);
  // this block's stages of the contraction (all of it unless split)
  const int spp = (kb + KR - 1) / KR;  // stages per plane
  const int s_beg = blockIdx.z * split_stages;
  const int ns = min(levels * spp, s_beg + split_stages) - s_beg;

  int lv = s_beg / spp;  // the next stage to copy
  int r0 = (s_beg % spp) * KR;
  int rc = r0;  // first byte row of the stage being multiplied
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < ns) {
      issue_stage<VEC>(ring + s * SLOT, a, b, kb, lv, r0, col_a, col_b, tid);
      advance(lv, r0, kb);
    }
    cp_async_commit();
  }

  // acc[h][qb][q]: m16 tile h times n8 tile q of 32-column quarter qb of
  // the warp's sub-tile
  int acc[2][2][4][4] = {};
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<NSTAGE - 2>();
    // stage s has landed for every thread; every product of stage s - 1 is
    // done, so its slot may be refilled
    __syncthreads();
    if (s + NSTAGE - 1 < ns) {
      issue_stage<VEC>(ring + ((s + NSTAGE - 1) % NSTAGE) * SLOT, a, b, kb, lv, r0, col_a,
                       col_b, tid);
      advance(lv, r0, kb);
    }
    cp_async_commit();
    const uint8_t* As = ring + (s % NSTAGE) * SLOT;
    const uint8_t* Bs = As + KR * LDA;
#pragma unroll
    for (int j = 0; j < KR / 32; ++j) {
      if (rc + 32 * j >= kb) break;  // only zero rows left (block-uniform)
      uint32_t bw[2][8];
#pragma unroll
      for (int qb = 0; qb < 2; ++qb) {
        b1_words(bw[qb], Bs + 32 * j * LDB + wb + 32 * qb + 4 * g, LDB, c);
      }
      uint32_t aw[8];
      b1_words(aw, As + 32 * j * LDA + wa + 4 * g, LDA, c);
      // m16 tile h: fragment row g is vector 4 g + 2 h, row g + 8 is 4 g + 2
      // h + 1; n8 tile q: fragment column g is vector 4 g + q
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t af[4] = {aw[2 * h], aw[2 * h + 1], aw[4 + 2 * h], aw[5 + 2 * h]};
#pragma unroll
        for (int qb = 0; qb < 2; ++qb)
#pragma unroll
          for (int q = 0; q < 4; ++q) mma_b1(acc[h][qb][q], af, bw[qb][q], bw[qb][4 + q]);
      }
    }
    rc += KR;
    if (rc >= kb) rc = 0;
  }

  // acc[h][qb][q][e]: row 4 g + 2 h + (e >> 1), column 8 c + 4 (e & 1) + q of
  // quarter qb
  const int m = a.w;
  const int n = b.w;
  const bool split = gridDim.z > 1;
  const bool vec = (n & 7) == 0;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int gi = col_a + wa + 4 * g + rr;
    if (gi >= m) continue;
    const float si = sa[gi];
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      const int gj = col_b + wb + 32 * qb + 8 * c;
      const int live = n - gj;
      if (live <= 0) continue;
      float v[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        v[x] = static_cast<float>(acc[rr >> 1][qb][x & 3][2 * (rr & 1) + (x >> 2)]);
      }
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
