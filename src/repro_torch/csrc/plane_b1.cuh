// The b1 tensor-core main loop of the plane GEMM kernels, shared by the
// rectangular (plane_rect.cu, rows 5 / 7) and the triangular (plane_tri.cu,
// rows 6 / 8) forms and by row 4 (mgemm_levels.cu, on planes it packs from
// values): one block of 8 warps computes the 128 x 128 tile
// acc[i][j] = sum_t popcount(A_t[:, col_a + i] AND B_t[:, col_b + j]) of two
// packed plane operands, in int32 registers.
//
// mma.sync m16n8k256 .b1 .and.popc (plane_mma.cuh mma_b1) computes
// popcount(a AND b) on the packed words themselves, with no spread of the
// fields to bytes.  Each warp owns a 32 x 64 sub-tile: 16 m16n8 products a
// k256 step into 64 int32 accumulators a thread, two blocks an SM.  Stages
// of 64 byte rows (512 fields, two k256 steps) of both packed tiles are
// copied as they lie, field-major, into a 4-deep cp.async ring: 16-byte
// copies where base and strides allow it, 4-byte or byte copies otherwise
// (copy_width), so a byte-range view at any column offset is read in
// place; byte rows past kb and columns past the view's width land as
// zeros, and a step whose byte rows all lie past kb is skipped.  One
// barrier a stage.  Each lane builds its fragment words from the
// field-major rows with one 4 x 4 byte transpose per four words
// (b1_words); the fragment rows and columns are a permutation of the
// tile's vectors that leaves lane (g, c) owning rows 4 g .. 4 g + 3 and
// columns 8 c .. 8 c + 7 of each 32 x 32 quarter of its warp's sub-tile
// (row8), so the epilogues store 16- or 32-byte rows (store8).
#pragma once

#include "plane_mma.cuh"
#include "tri_common.cuh"

namespace repro {
namespace planes {

constexpr int BM = BT;       // output tile rows
constexpr int BN = BT;       // output tile columns
constexpr int KR = 64;       // packed byte rows per stage: two k256 steps
constexpr int NSTAGE = 4;    // cp.async ring depth
constexpr int WN = BN / 64;  // warps along a tile row: each owns 32 x 64
constexpr int THREADS = 32 * (BM / 32) * WN;  // 8 warps
constexpr int LDA = BM + 32;  // row strides of the packed tiles: 32 (mod 128)
constexpr int LDB = BN + 32;
constexpr int SLOT = KR * (LDA + LDB);  // one ring stage
constexpr int SMEM = NSTAGE * SLOT;     // 80 KB: two blocks an SM

// The calling thread's place in the block's tile: lane (g, c) of its warp,
// whose 32 x 64 sub-tile starts at row wa, column wb.
struct Lane {
  int g, c, wa, wb;
};

__device__ __forceinline__ Lane lane_of(int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  return Lane{lane >> 2, lane & 3, 32 * (warp / WN), 64 * (warp % WN)};
}

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

// acc += the products of stages s_beg .. s_beg + ns - 1 (stage s: plane s /
// spp, byte rows KR (s % spp) .., spp = ceil(kb / KR) stages a plane) of
// the tiles at columns col_a of a and col_b of b.  acc[h][qb][q]: m16 tile
// h times n8 tile q of 32-column quarter qb of the warp's sub-tile.  Every
// thread of the block calls it; ring is the block's SMEM bytes of dynamic
// shared memory.
template <int VEC>
__device__ __forceinline__ void b1_mainloop(int (&acc)[2][2][4][4], uint8_t* ring,
                                            const View& a, const View& b, int kb,
                                            int s_beg, int ns, int col_a, int col_b) {
  const int tid = threadIdx.x;
  const Lane ln = lane_of(tid);
  const int spp = (kb + KR - 1) / KR;
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
        b1_words(bw[qb], Bs + 32 * j * LDB + ln.wb + 32 * qb + 4 * ln.g, LDB, ln.c);
      }
      uint32_t aw[8];
      b1_words(aw, As + 32 * j * LDA + ln.wa + 4 * ln.g, LDA, ln.c);
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
}

// The lane's eight sums of tile row wa + 4 g + rr (rr < 4), columns wb + 32
// qb + 8 c .. + 7, as fp32: acc[h][qb][q][e] is row 4 g + 2 h + (e >> 1),
// column 8 c + 4 (e & 1) + q of quarter qb.
__device__ __forceinline__ void row8(float (&v)[8], const int (&acc)[2][2][4][4], int rr,
                                     int qb) {
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    v[x] = static_cast<float>(acc[rr >> 1][qb][x & 3][2 * (rr & 1) + (x >> 2)]);
  }
}

// Eight outputs of one row, columns gj .. gj + 7, of which `live` lie in
// the block: one or two 16-byte stores when the row has them all and the
// row starts 16-byte aligned (vec), else one by one.
__device__ __forceinline__ void store8(float* dst, const float (&v)[8], int live, bool vec) {
  if (vec && live >= 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  for (int x = 0; x < min(live, 8); ++x) dst[x] = v[x];
}

// The same eight outputs added into dst (a split contraction's partial sums,
// integers: exact in fp32 in any order).
__device__ __forceinline__ void add8(float* dst, const float (&v)[8], int live, bool vec) {
  if (vec && live >= 8) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    atomicAdd(reinterpret_cast<float4*>(dst) + 1, make_float4(v[4], v[5], v[6], v[7]));
    return;
  }
  for (int x = 0; x < min(live, 8); ++x) atomicAdd(dst + x, v[x]);
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

}  // namespace planes
}  // namespace repro
