// 3-way plane slice kernel: the batched pipeline slice of a 3-way campaign
// on packed bit-planes, on the int8 tensor cores.  One kernel serves two
// rows of the TPU kernel table through two entry points:
//
//   threeway_batch_levels_launch  replaces repro's
//     threeway_batch_levels_pallas (src/repro/kernels/czek3/kernel.py),
//     path3 "fused-levels-ring" / "fused-levels" (levels >= 2);
//   threeway_batch_pop_launch     replaces repro's threeway_batch_pop_pallas
//     (src/repro/kernels/popgemm/kernel.py), path3 "fused-popcount-ring" /
//     "fused-popcount" (levels == 1).
//
// B[t, i, k] = sum_levels popcount(own_i AND X_t AND right_k) for planes
// Pown (levels, kb, m), PX (levels, kb, L) and Pright (levels, kb, n): on
// leveled integer data this is sum_q min(own[q, i], X[q, t], right[q, k]),
// the 3-way numerator of one pipeline slice.  Output (L, m, n) fp32, raw:
// the metric assembly runs outside the kernel, as in repro.  Sums are at
// most n_f * levels, exact in int32 and fp32.
//
// What bounds it on the H100: the numerator is one int8 GEMM of the 0/1
// indicators, M = L * m (rows ordered (t, i)), N = n, K = levels * 8 * kb:
// 2 * levels * n_f * L * m * n ops at the tensor cores' 1,979 TOP/s.  Bytes
// are small: the output (4 * L * m * n) is written once, the packed planes
// are read a few times from L2.  The packed planes must be spread to 0/1
// bytes on chip; that spread, not the product, is what the design keeps
// small (plane_mma.cuh).
//
// Design: grid (ceil(L / 2), ceil(m / 128), ceil(n / 128)), one block of 4
// warpgroups per pair of pipeline columns and 128 x 128 output tile, the
// pipeline index fastest so that the blocks sharing an own and a right tile
// run together and find them in L2.  Warpgroup (tp, h) owns own rows 64 h ..
// 64 h + 63 for column t0 + tp and runs wgmma.mma_async m64n128k32 s8 into
// 64 int32 accumulator registers a thread, converted to fp32 once at the
// store.  Each stage of 384 fields (48 byte rows, three swizzle atoms):
//   - warps 8-15 copy the packed own and right tiles and the two columns'
//     bytes of x into a 3-deep cp.async ring: 16-byte copies where base and
//     strides allow it, 4-byte or byte copies otherwise, so a view that
//     starts at any column is read in place;
//   - every thread spreads right's packed bytes once into 0/1 bytes, stored
//     K-major with the 128-byte swizzle that the wgmma B descriptor reads
//     (three buffers: one being spread, two read by products in flight);
//     the spread tile feeds all four warpgroups, both columns;
//   - warps 0-7 AND own's packed bytes with x_t's and transpose them to one
//     48-byte row per vector;
//   - each warpgroup builds its A fragments in registers from those packed
//     rows (no shared-memory indicator tile for A) in six commit groups of
//     two k32 steps, one group's registers built while the group before
//     runs.
// One barrier per stage: stage s + 1 is spread while stage s's products
// run.
#include "plane_mma.cuh"
#include "tri_common.cuh"

namespace {

using namespace repro::planes;
using repro::mma::smem_addr;
using repro::mma::transpose4;

constexpr int TP = 2;          // pipeline columns per block
constexpr int NTHREADS = 512;  // 4 warpgroups: (column, own rows 0-63 / 64-127)
constexpr int NCOPY = 256;     // warps 8-15 copy the stages; warps 0-7 transpose own
constexpr int KR = 48;         // packed byte rows per stage (384 fields)
constexpr int KA = KR / 16;    // 128-field swizzle atoms per stage
constexpr int PLD = BT + 16;   // row stride of a packed tile in shared memory
constexpr int PTILE = KR * PLD;             // one operand's packed stage
constexpr int NSTAGE = 3;      // cp.async ring depth
constexpr int NBUF = 3;        // right's indicator tiles: one spread, two in products
constexpr int ATILE = BT * 128;             // one swizzle atom of right's indicators
constexpr int BTILE = KA * ATILE;
constexpr int OTILE = BT * KR;              // own AND x_t, packed, vector-major
constexpr int XOFF = 2 * PTILE;             // x words [TP][KR], then selectors
constexpr int SLOT = XOFF + 2 * TP * KR * 4;  // ring slot: own, right, x
constexpr int SMEM_BYTES = 1024 + NBUF * BTILE + 2 * TP * OTILE + NSTAGE * SLOT;  // 216,832
static_assert(SLOT % 16 == 0, "ring slots stay 16-byte aligned");

// Copy stage (lv, byte rows r0 .. r0 + KR - 1) of the own and right tiles
// and of the block's TP pipeline columns into a ring slot: copier cu (0 ..
// NCOPY - 1) takes chunks cu, cu + NCOPY, ... of the 2 KR (BT / VEC)
// chunks of the two tiles (own's first), and copiers cu < TP KR copy, for
// byte row r0 + r of column t, the aligned word that holds the byte (it
// lies in the allocation, whose size is a whole number of words) and store
// the __byte_perm selector that replicates the byte.
template <int VEC>
__device__ __forceinline__ void issue_stage(uint8_t* slot, const View& own,
                                            const View& right, const View& px, int kb,
                                            int lv, int r0, int col_a, int col_b, int t0,
                                            int cu) {
  constexpr int CPR = BT / VEC;  // chunks per row
  constexpr int PER_OP = KR * CPR;
  const uint8_t* orow = plane_of(own, lv) + r0 * own.sr;
  const uint8_t* rrow = plane_of(right, lv) + r0 * right.sr;
#pragma unroll
  for (int i = 0; i < 2 * PER_OP / NCOPY; ++i) {
    const int e = cu + i * NCOPY;
    const bool op = e >= PER_OP;
    const int f = op ? e - PER_OP : e;
    const int r = f / CPR;
    const int c = (f % CPR) * VEC;
    const int col = (op ? col_b : col_a) + c;
    const long long sr = op ? right.sr : own.sr;
    const int bytes = r0 + r < kb ? min(max((op ? right.w : own.w) - col, 0), VEC) : 0;
    const uint8_t* src = bytes > 0 ? (op ? rrow : orow) + r * sr + col : own.base;
    copy_chunk<VEC>(slot + (op ? PTILE : 0) + r * PLD + c, src, bytes);
  }
  if (cu < TP * KR) {
    const int row = r0 + (cu % KR);
    const int t = t0 + cu / KR;
    const bool live = row < kb && t < px.w;
    const uintptr_t a = reinterpret_cast<uintptr_t>(plane_of(px, lv) + row * px.sr + t);
    uint32_t* X = reinterpret_cast<uint32_t*>(slot + XOFF);
    cp_async<4>(X + cu, live ? reinterpret_cast<const void*>(a & ~uintptr_t{3}) : px.base,
                live ? 4 : 0);
    X[TP * KR + cu] = static_cast<uint32_t>(a & 3) * 0x1111u;
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

// A ring slot into B (right's 0/1 bytes, KA swizzle atoms) and O (own AND
// x_t for the TP columns, packed, one KR-byte row per vector).  Every
// thread spreads, in each atom a, byte rows 16 a + q and 16 a + q + 8 of
// right's columns 2 cp and 2 cp + 1, cp = (lane >> 3) + 4 warp, lanes along
// q so that each warp phase of 16-byte stores covers all banks; threads 0 -
// 255 transpose byte rows 4 rg .. 4 rg + 3 of own's columns 4 cg .. 4 cg +
// 3, each ANDed with x_t's byte, for column tp.
__device__ __forceinline__ void prep_stage(uint8_t* B, uint8_t* O, const uint8_t* slot,
                                           int tid, int lane, int warp) {
  {
    const int q = lane & 7;
    const int c = 2 * ((lane >> 3) + 4 * warp);
    const uint8_t* P = slot + PTILE + c;
#pragma unroll
    for (int a = 0; a < KA; ++a) {
      const uint32_t w0 = *reinterpret_cast<const uint16_t*>(P + (16 * a + q) * PLD);
      const uint32_t w1 = *reinterpret_cast<const uint16_t*>(P + (16 * a + q + 8) * PLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<uint4*>(B + a * ATILE + sw128_offset(c + j, q)) =
            spread_chunk(w0, w1, j);
      }
    }
  }
  if (tid < NTHREADS - NCOPY) {
    const int tp = tid / ((NTHREADS - NCOPY) / TP);
    const int c = 4 * ((tid >> 2) % (BT / 4));
    const uint32_t* X = reinterpret_cast<const uint32_t*>(slot + XOFF) + tp * KR;
    uint8_t* Ot = O + tp * OTILE;
#pragma unroll
    for (int i = 0; i < KR / 16; ++i) {
      const int rg = (tid & 3) + 4 * i;
      const uint4 xw = *reinterpret_cast<const uint4*>(X + 4 * rg);
      const uint4 xs = *reinterpret_cast<const uint4*>(X + TP * KR + 4 * rg);
      const uint8_t* P = slot + 4 * rg * PLD + c;
      uint32_t cw[4];
      transpose4(cw,
                 *reinterpret_cast<const uint32_t*>(P) & __byte_perm(xw.x, 0u, xs.x),
                 *reinterpret_cast<const uint32_t*>(P + PLD) & __byte_perm(xw.y, 0u, xs.y),
                 *reinterpret_cast<const uint32_t*>(P + 2 * PLD) & __byte_perm(xw.z, 0u, xs.z),
                 *reinterpret_cast<const uint32_t*>(P + 3 * PLD) & __byte_perm(xw.w, 0u, xs.w));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint32_t*>(Ot + (c + j) * KR + 4 * rg) = cw[j];
      }
    }
  }
  fence_proxy_async();
}

template <int VEC>
__global__ void __launch_bounds__(NTHREADS, 1)
plane3_kernel(View own, View px, View right, float* __restrict__ out, int levels,
              int kb) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled B tiles need 1,024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* bsw = smem;                      // [NBUF][BTILE]
  uint8_t* own_t = smem + NBUF * BTILE;     // [2][TP][OTILE]
  uint8_t* ring = own_t + 2 * TP * OTILE;   // [NSTAGE][SLOT]

  const int t0 = TP * blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col_a = blockIdx.y * BT;
  const int col_b = blockIdx.z * BT;
  // warpgroup (tp, h): column t0 + tp, own rows 64 h .. 64 h + 63; this
  // thread's fragment rows are g and g + 8 of its warp's 16
  const int tp = warp >> 3;
  const int row = 64 * ((warp >> 2) & 1) + 16 * (warp & 3) + (lane >> 2);
  const int half = 8 * ((lane & 3) >> 1);
  const bool copier = tid >= NTHREADS - NCOPY;
  const int ns = levels * ((kb + KR - 1) / KR);  // stages: planes x byte-row blocks

  // the next stage to copy, (plane, first byte row)
  int lv = 0;
  int r0 = 0;
  for (int s = 0; s < NSTAGE; ++s) {
    if (s < ns) {
      if (copier) {
        issue_stage<VEC>(ring + s * SLOT, own, right, px, kb, lv, r0, col_a, col_b, t0,
                         tid - (NTHREADS - NCOPY));
      }
      advance(lv, r0, kb);
    }
    cp_async_commit();
    if (s == NSTAGE - 2) {
      cp_async_wait<NSTAGE - 2>();  // stage 0 has landed
      __syncthreads();
      prep_stage(bsw, own_t, ring, tid, lane, warp);
    }
  }

  // the first product of the block overwrites acc: registers set by other
  // instructions (a zero fill) would make ptxas serialize the wgmmas
  int acc[64];
  int bm = 0;  // stage s's B buffer, s % NBUF
  for (int s = 0; s < ns; ++s) {
    const int bp = bm == NBUF - 1 ? 0 : bm + 1;  // stage s + 1's
    cp_async_wait<NSTAGE - 2>();
    // stage s + 1 has landed and stage s is spread, for every thread; every
    // product of stage s - 2 and every A load of stage s - 1 is done
    __syncthreads();
    if (s + NSTAGE < ns) {
      if (copier) {
        issue_stage<VEC>(ring + (s % NSTAGE) * SLOT, own, right, px, kb, lv, r0,
                         col_a, col_b, t0, tid - (NTHREADS - NCOPY));
      }
      advance(lv, r0, kb);
    }
    cp_async_commit();
    // a commit group for every two k32 steps: the A registers of one group
    // are built while the products of the one before run
    const uint8_t* O = own_t + ((s & 1) * TP + tp) * OTILE;
#pragma unroll
    for (int a = 0; a < KA; ++a) {
      const uint2 u = *reinterpret_cast<const uint2*>(O + row * KR + 16 * a + half);
      const uint2 v = *reinterpret_cast<const uint2*>(O + (row + 8) * KR + 16 * a + half);
      const uint64_t desc = sw128_desc(bsw + bm * BTILE + a * ATILE);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        wgmma_wait<1>();
        uint32_t af[2][4];
        a_frags(af, hh ? u.y : u.x, hh ? v.y : v.x, lane & 3);
        if (a == 0 && hh == 0) fence_operands(acc);
        wgmma_fence();
        wgmma_m64n128k32(acc, af[0], desc + 4 * hh, s > 0 || a > 0 || hh > 0);
        wgmma_m64n128k32(acc, af[1], desc + 4 * hh + 2, 1);
        wgmma_commit();
      }
    }
    // stage s + 1 is spread while stage s's products run
    if (s + 1 < ns) {
      prep_stage(bsw + bp * BTILE, own_t + ((s + 1) & 1) * TP * OTILE,
                 ring + ((s + 1) % NSTAGE) * SLOT, tid, lane, warp);
    }
    bm = bp;
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // accumulator register 4 j + e: row g (e < 2) or g + 8, column 8 j + 2 (lane
  // & 3) + (e & 1) of the warpgroup's 64 x 128 tile
  const int t = t0 + tp;
  const int m = own.w;
  const int n = right.w;
  if (t >= px.w) return;
  float* slab = out + static_cast<size_t>(t) * m * n;
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = col_a + row + 8 * h;
    if (gi >= m) continue;
    float* dst = slab + static_cast<size_t>(gi) * n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gj = col_b + 8 * j + c2;
      const float v0 = static_cast<float>(acc[4 * j + 2 * h]);
      const float v1 = static_cast<float>(acc[4 * j + 2 * h + 1]);
      if ((n & 1) == 0 && gj + 1 < n) {
        *reinterpret_cast<float2*>(dst + gj) = make_float2(v0, v1);
      } else {
        if (gj < n) dst[gj] = v0;
        if (gj + 1 < n) dst[gj + 1] = v1;
      }
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
  const int vec = min(copy_width(own), copy_width(right));
  auto kernel = vec == 16 ? plane3_kernel<16> : vec == 4 ? plane3_kernel<4> : plane3_kernel<1>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + TP - 1) / TP, (m + BT - 1) / BT, (n + BT - 1) / BT);
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
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
