// 3-way value slice kernels: the batched pipeline slice of a 3-way campaign
// on value operands (the paper's Algorithm 3).  They serve two rows of the
// TPU kernel table through their entry points:
//
//   threeway_batch_launch  replaces repro's threeway_batch_pallas
//     (src/repro/kernels/czek3/kernel.py), path3 "fused-vpu"
//     (impl="pallas"): one launch per pipeline slice;
//   threeway_step_launch   replaces repro's threeway_step_pallas, the
//     single-column form (one pipeline column x, output (m, n));
//   threeway_ccc_s8_launch  both of them for the CCC product on int8
//     operands (L columns, or one), on the int8 tensor cores.
//
// B[t, i, k] = sum_q combine(combine(own[q, i], X[q, t]), right[q, k]) for
// field-major own (k, m), X (k, L) and right (k, n), combine = min
// (Czekanowski, Sorenson) or the product (CCC); any other registered
// combine is compiled into its own library on the CUDA-core kernel's body
// (minplus3.cuh, combine_entry.cuh: the fold and the product are two
// functions, since a mixed-dtype combine turns an int8 fold into float32;
// summed over the k real fields).  Output (L, m, n) fp32,
// raw: the metric assembly runs outside the kernel, as in repro.  X is the
// pipeline slice Vb[:, j0:j0+L], a view with row stride n_vp: each operand
// is read in place through its own row stride.  On a diagonal item own and
// right are the same tensor.
//
// 1. min, and float32 operands: a CUDA-core kernel (minplus3_kernel).  min
// has no tensor-core form and a float32 product no exact one (TF32 stays
// off), so every comparison costs an FMNMX and an FADD (one FFMA for the
// product): 2 * n_f * L * m * n fp32 instructions at 132 SMs x 128 lanes x
// 1.98 GHz = 33.5e12/s (half that count for the product).  On integer and
// quarter-grid (dosage) data every partial sum is exact in fp32, in any
// order.  Grid (L, ceil(m/128), ceil(n/128)), the pipeline column fastest,
// so the L blocks that share an own and a right tile run together and read
// them from L2.  The main loop is minplus_pipe.cuh's: own and right copied
// with cp.async two stages ahead, int8 converted to fp32 once a stage, the
// X_t tile combine(own, x_t) built once a stage in shared memory (x_t's
// values copied with the stage), one barrier a stage, 8 x 8 register
// tiles, two blocks an SM.
//
// 2. The CCC product on int8 operands: one GEMM of the fold own * x_t (the
// pipeline axis folded into M, L * m rows ordered (t, i)) with right, K =
// n_f, on the int8 tensor cores (ccc8_kernel): 2 * n_f * L * m * n ops at
// 1,979e12/s, 3.05 ms a full-width slice (n_f 20,000, L 64, m = n = 1,536).
// The fold of two int8 values, f = own * x in [-16256, 16384], does not fit
// a byte, so it is split f = 256 hi + lo with lo = f & 255 (u8) and hi = f >>
// 8 (s8, in [-64, 64]) and B = lo . right + 256 (hi . right): the lo pass is
// wgmma u8 x s8, the hi pass s8 x s8.  Sums are int32; modulo 2^32 the result
// is exact whenever the true sum fits int32, which covers every case where
// repro's fp32 sum is exact (below 2^24).  On {0,1,2} data (the paper's
// genotypes) hi is 0 everywhere and only the lo pass runs.
//
// Design: two prepasses write each operand once a launch as a tile image
// that a stage copies as it lies: right^T K-major in the 128-byte swizzle
// of the wgmma B descriptor (right_image), own's field rows in the layout
// the fold reads (own_image).  The blocks that share a tile (L / 4 x m / 64
// of them for a right tile) thus neither transpose it again nor copy it
// chunk by chunk.  Grid (ceil(L / 4), ceil(m / 64), ceil(n / 128)), the
// pipeline index fastest so that the blocks sharing an own and a right tile
// run together and find them in L2; one block of 4 warpgroups, warpgroup w
// for pipeline column t0 + w and all 64 own rows x 128 right columns
// (wgmma.mma_async m64n128k32 into 64 int32 accumulators a thread, both
// operands in shared memory).  Stages of 128 fields in a 4-deep ring,
// copied three stages ahead by one thread: two bulk copies (the TMA engine)
// a stage, 16 KB of right^T and 8 KB of own, completing on the slot's
// mbarrier, which every thread waits on; x_t's bytes are loaded a stage
// ahead into registers.  Each warpgroup builds its own column's fold tile
// in shared memory, K-major and swizzled for the A descriptor: a thread
// takes 16 fields x 4 own vectors, multiplies each field row's word by
// x_t's byte for that field, and transposes the four products of each 4 x
// 4 byte block with byte permutes.  Where the 4 bytes and x are in [0, 15],
// one 32-bit multiply forms all four products (each at most 225, no
// carry); elsewhere the products are formed byte by byte.  The fold of
// stage s + 1 is built while stage s's products run (two fold tiles a
// column); one barrier a stage, which also votes whether a product of the
// stage leaves [0, 255].  That pass multiplies the lo bytes.  Only a block
// whose vote ever said so runs a second pass over the contraction, which
// multiplies the hi bytes on just those stages: each thread parks its lo
// sums in its own output positions (the int32 bits, read back by the same
// thread) between the passes and adds them to 256 times the hi sums at the
// end.  Bytes: the output, 4 * L * m * n, is written once; the operands are
// read from L2 by the blocks that share them, 17 GB a full-width slice.
// What limits it (tools/value_mma_bench.py, PERF.md section 6): the stage
// copies, the fold and the products each take 5-6 ms of a slice alone and
// overlap poorly.
#include "minplus3.cuh"

namespace {

using namespace repro::minplus;

int launch(const void* own, long long o_sr, const void* X, long long x_sr,
           const void* right, long long r_sr, int in_int8, int k, int m, int L,
           int n, int combine, float* out, void* stream) {
  if (slice::bad_sizes(o_sr, x_sr, r_sr, k, m, L, n) || combine < kMin || combine > kMul) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_int8) {
    // the CCC product on int8 operands runs threeway_ccc_s8_launch
    if (combine == kMul) return static_cast<int>(cudaErrorInvalidValue);
    return slice::launch<int8_t, MinCombine, MinCombine>(own, o_sr, X, x_sr, right, r_sr, k, m,
                                                         L, n, out, st);
  }
  if (combine == kMul) {
    return slice::launch<float, MulCombine, MulCombine>(own, o_sr, X, x_sr, right, r_sr, k, m,
                                                        L, n, out, st);
  }
  return slice::launch<float, MinCombine, MinCombine>(own, o_sr, X, x_sr, right, r_sr, k, m, L,
                                                      n, out, st);
}

}  // namespace

// own (k, m), X (k, L) pipeline columns and right (k, n), field-major int8
// (in_int8 = 1) or float32, each given by its base pointer and row stride in
// elements (columns are contiguous; X's row stride is n_vp on the campaign
// path).  combine: 0 = min, 1 = product (float32 only: the product on int8
// takes threeway_ccc_s8_launch); any other combine runs its own compiled
// library (combine_entry.cuh).  out (L, m, n) float32, contiguous.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int threeway_batch_launch(const void* own, long long o_sr, const void* X,
                                     long long x_sr, const void* right,
                                     long long r_sr, int in_int8, int k, int m,
                                     int L, int n, int combine, float* out, void* stream) {
  return launch(own, o_sr, X, x_sr, right, r_sr, in_int8, k, m, L, n, combine, out, stream);
}

// The single-column form: x (k,) with element stride x_s, out (m, n).
extern "C" int threeway_step_launch(const void* own, long long o_sr, const void* x,
                                    long long x_s, const void* right, long long r_sr,
                                    int in_int8, int k, int m, int n, int combine,
                                    float* out, void* stream) {
  return launch(own, o_sr, x, x_s, right, r_sr, in_int8, k, m, 1, n, combine, out, stream);
}

// -- the CCC product on int8 operands, on the int8 tensor cores -----------

namespace {
namespace ccc8 {

namespace pl = repro::planes;
using repro::mma::smem_addr;
using repro::mma::transpose4;

constexpr int kTP = 4;         // pipeline columns per block, one warpgroup each
constexpr int kRM = 64;        // own vectors per block: the wgmma M tile
constexpr int kCN = 128;       // right vectors per block: the wgmma N
constexpr int kF = 128;        // fields per stage: one 128-byte swizzled row
constexpr int kThreads = 512;  // 4 warpgroups
constexpr int kSlots = 4;      // ring depth
constexpr int kAhead = 3;      // stages copied ahead of the one multiplied
constexpr int kBTile = kCN * kF;                     // right^T, swizzled: 16 KB
constexpr int kOwnBytes = kF * kRM + (kF / 16) * 16; // own, 16-byte skew per 16 rows
constexpr int kATile = kRM * kF;                     // one column's fold: 8 KB
// right^T ring, fold tiles (one built, one in products), own ring, x bytes
// (two stages each), the ring's mbarriers
constexpr int kSmem = 1024 + kSlots * kBTile + 2 * kTP * kATile + kSlots * kOwnBytes +
                      2 * kTP * kF + kSlots * 8;  // 166,432
static_assert(kThreads == kTP * kF, "one x byte a thread and stage");
static_assert(kSmem <= 232448 && kSlots > kAhead, "a slot outlives its products");
static_assert(kOwnBytes % 16 == 0, "bulk copies move whole 16-byte units");

// Byte offset of own's field row q in an own tile.  The 16-byte skew of
// each 16-row group puts the 32 lanes of a fold load (8 chunks x 4 vector
// words) in 32 different banks.
__device__ __forceinline__ int own_row(int q) { return q * kRM + (q >> 4) * 16; }

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// -- the stage ring: bulk copies (the TMA engine) completing on mbarriers --

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Stage g of a pass (global stage index gs for the ring) into its slot: the
// right^T tile and the own tile, as the prepasses laid them out, one bulk
// copy each.  One thread issues it.
__device__ __forceinline__ void issue_stage(uint8_t* bring, uint8_t* oring, uint64_t* full,
                                            const uint8_t* rimg, const uint8_t* oimg, int ns,
                                            int g, int gs) {
  const int slot = gs % kSlots;
  mbar_expect_tx(full + slot, kBTile + kOwnBytes);
  bulk_copy(bring + slot * kBTile, rimg + (static_cast<long long>(blockIdx.z) * ns + g) * kBTile,
            kBTile, full + slot);
  bulk_copy(oring + slot * kOwnBytes,
            oimg + (static_cast<long long>(blockIdx.y) * ns + g) * kOwnBytes, kOwnBytes,
            full + slot);
}

// x's byte for field k0 + tid % kF of pipeline column t0 + tid / kF (0 past
// the view).
__device__ __forceinline__ uint8_t load_x(const pl::View& px, int k, int k0, int t0,
                                          int tid) {
  const int t = t0 + tid / kF;
  const int q = k0 + tid % kF;
  return t < px.w && q < k ? px.base[static_cast<long long>(q) * px.sr + t] : 0;
}

// The low (shift 0) or high (shift 8) bytes of the signed products of own's
// four bytes o with x, one byte each; any |= a non-zero value where a
// product leaves [0, 255] (its high byte is not 0).
__device__ __forceinline__ uint32_t fold_bytes(uint32_t o, int x, int shift, uint32_t& any) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = static_cast<int>(static_cast<int8_t>(o >> (8 * i))) * x;
    w |= (static_cast<uint32_t>(f >> shift) & 0xFFu) << (8 * i);
    any |= static_cast<uint32_t>(f >> 8);
  }
  return w;
}

// Fold chunk j (fields 16 j .. 16 j + 15 of the stage) of own vectors 4 v ..
// 4 v + 3 for one pipeline column into A, that column's swizzled tile: the
// lo bytes of own * x_t, or with HI the hi bytes.  own: the slot's field
// rows; xs: the column's kF x bytes.  Returns whether a product of the chunk
// leaves [0, 255], that is whether a hi byte is not 0.
template <bool HI>
__device__ __forceinline__ int fold_unit(uint8_t* A, const uint8_t* own, const uint8_t* xs,
                                         int v, int j) {
  const uint4 xq = *reinterpret_cast<const uint4*>(xs + 16 * j);
  const uint32_t xw[4] = {xq.x, xq.y, xq.z, xq.w};
  uint32_t w[4][4];
  uint32_t any = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t ow[4], f[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ow[r] = ld32(own + own_row(16 * j + 4 * g + r) + 4 * v);
    if (((ow[0] | ow[1] | ow[2] | ow[3] | xw[g]) & 0xF0F0F0F0u) == 0) {
      // bytes and multipliers in [0, 15]: each byte's product is at most
      // 225, so one 32-bit multiply forms the four products, no carry, and
      // the hi bytes are 0
#pragma unroll
      for (int r = 0; r < 4; ++r) f[r] = HI ? 0u : ow[r] * pl::byte_of(xw[g], r);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        f[r] = fold_bytes(ow[r], static_cast<int8_t>(xw[g] >> (8 * r)), HI ? 8 : 0, any);
      }
    }
    // f[r] holds field 16 j + 4 g + r of the four vectors; w[g][i] fields
    // 4 g .. 4 g + 3 of vector 4 v + i
    transpose4(w[g], f[0], f[1], f[2], f[3]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<uint4*>(A + pl::sw128_offset(4 * v + i, j)) =
        make_uint4(w[0][i], w[1][i], w[2][i], w[3][i]);
  }
  return any != 0;
}

// One pass over the contraction into acc: without HI, the lo bytes of the
// fold times right (u8 x s8) on every stage, and it returns whether a stage
// has a non-zero hi byte (the same for every thread of the block); with HI,
// the hi bytes times right (s8 x s8) on just those stages.  Every thread of
// the block calls it; it leaves the shared memory free for another pass.
template <bool HI>
__device__ __forceinline__ bool contract(int (&acc)[64], uint8_t* smem, const pl::View& px,
                                         const uint8_t* rimg, const uint8_t* oimg, int k,
                                         int g0) {
  uint8_t* bring = smem;                           // [kSlots][kBTile]: right^T
  uint8_t* afold = bring + kSlots * kBTile;        // [2][kTP][kATile]
  uint8_t* oring = afold + 2 * kTP * kATile;       // [kSlots][kOwnBytes]: own
  uint8_t* xs = oring + kSlots * kOwnBytes;        // [2][kTP][kF]
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + 2 * kTP * kF);  // [kSlots]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // this warpgroup's pipeline column is t0 + wg
  const int t0 = kTP * blockIdx.x;
  const bool live = t0 + wg < px.w;
  const int ns = (k + kF - 1) / kF;
  // this thread's fold chunk: fields 16 j .., own vectors 4 v ..; the 8
  // lanes of a 16-byte store phase take the 8 chunks of one vector group
  const int j = lane & 7;
  const int v = 4 * (warp & 3) + (lane >> 3);
  // ring stage gs = g0 + s sits in slot gs % kSlots, in phase gs / kSlots

  if (tid == 0) {
    for (int s = 0; s < kAhead && s < ns; ++s) {
      issue_stage(bring, oring, full, rimg, oimg, ns, s, g0 + s);
    }
  }
  xs[tid] = load_x(px, k, 0, t0, tid);
  uint8_t xr = load_x(px, k, kF, t0, tid);
  mbar_wait(full + g0 % kSlots, (g0 / kSlots) & 1);  // stage 0 has landed
  __syncthreads();
  int flag = live ? fold_unit<HI>(afold + wg * kATile, oring + (g0 % kSlots) * kOwnBytes,
                                  xs + wg * kF, v, j)
                  : 0;
  pl::fence_proxy_async();

  bool any = false;
  bool started = false;
  for (int s = 0; s < ns; ++s) {
    const int gs = g0 + s;
    xs[((s + 1) & 1) * kTP * kF + tid] = xr;  // stage s + 1's x bytes
    if (s + 1 < ns) mbar_wait(full + (gs + 1) % kSlots, ((gs + 1) / kSlots) & 1);
    pl::wgmma_wait<0>();                     // this warpgroup's stage s - 1 products
    // stage s is folded and stage s + 1 has landed, for every thread; every
    // product of stage s - 1 is done, so its fold tiles may be rebuilt and
    // its slot refilled
    const int vote = __syncthreads_or(flag);
    any |= vote != 0;
    if (tid == 0 && s + kAhead < ns) {
      pl::fence_proxy_async();  // the slot's last generic reads, before the copy
      issue_stage(bring, oring, full, rimg, oimg, ns, s + kAhead, gs + kAhead);
    }
    if (live && (!HI || vote)) {
      const uint64_t da = pl::sw128_desc(afold + ((s & 1) * kTP + wg) * kATile);
      const uint64_t db = pl::sw128_desc(bring + (gs % kSlots) * kBTile);
      pl::fence_operands(acc);
      pl::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kF / 32; ++kk) {
        pl::wgmma_m64n128k32_ss<!HI>(acc, da + 2 * kk, db + 2 * kk, started || kk > 0);
      }
      pl::wgmma_commit();
      started = true;
    }
    xr = load_x(px, k, (s + 2) * kF, t0, tid);
    // stage s + 1 is folded while stage s's products run
    if (s + 1 < ns) {
      flag = live ? fold_unit<HI>(afold + (((s + 1) & 1) * kTP + wg) * kATile,
                                  oring + ((gs + 1) % kSlots) * kOwnBytes,
                                  xs + (((s + 1) & 1) * kTP + wg) * kF, v, j)
                  : 0;
      pl::fence_proxy_async();
    }
  }
  pl::wgmma_wait<0>();
  pl::fence_operands(acc);
  __syncthreads();
  return any;
}

__global__ void __launch_bounds__(kThreads, 1)
ccc8_kernel(pl::View px, const uint8_t* __restrict__ rimg, const uint8_t* __restrict__ oimg,
            int m, int n, int k, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1,024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = kTP * blockIdx.x + (warp >> 2);
  if (threadIdx.x == 0) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmem - 1024 - kSlots * 8);
    for (int i = 0; i < kSlots; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // accumulator register 4 jj + 2 h + e: row gi0 + 8 h, column gj0 + 8 jj +
  // e of the output slab of column t
  const int gi0 = blockIdx.y * kRM + 16 * (warp & 3) + (lane >> 2);
  const int gj0 = blockIdx.z * kCN + 2 * (lane & 3);

  // the first product of a pass overwrites acc: registers set by other
  // instructions (a zero fill) would make ptxas serialize the wgmmas
  int acc[64];
  const int ns = (k + kF - 1) / kF;
  const bool hi = contract<false>(acc, smem, px, rimg, oimg, k, 0);
  if (hi) {
    // some stage has a product outside [0, 255]: park the lo sums in this
    // thread's own output positions (their int32 bits), run the hi pass,
    // and add the parked sums to 256 times its sums (modulo 2^32)
    int* slab = reinterpret_cast<int*>(out) + static_cast<size_t>(t) * m * n;
    if (t < px.w) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int gi = gi0 + 8 * h;
            const int gj = gj0 + 8 * jj + e;
            if (gi < m && gj < n) slab[static_cast<size_t>(gi) * n + gj] = acc[4 * jj + 2 * h + e];
          }
    }
    contract<true>(acc, smem, px, rimg, oimg, k, ns);
    if (t < px.w) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int gi = gi0 + 8 * h;
            const int gj = gj0 + 8 * jj + e;
            const uint32_t parked =
                gi < m && gj < n ? static_cast<uint32_t>(slab[static_cast<size_t>(gi) * n + gj])
                                 : 0u;
            int& a = acc[4 * jj + 2 * h + e];
            a = static_cast<int>(parked + (static_cast<uint32_t>(a) << 8));
          }
    }
  }
  if (t >= px.w) return;

  float* slab = out + static_cast<size_t>(t) * m * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = gi0 + 8 * h;
    if (gi >= m) continue;
    float* dst = slab + static_cast<size_t>(gi) * n;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int gj = gj0 + 8 * jj;
      const float v0 = static_cast<float>(acc[4 * jj + 2 * h]);
      const float v1 = static_cast<float>(acc[4 * jj + 2 * h + 1]);
      if ((n & 1) == 0 && gj + 1 < n) {
        *reinterpret_cast<float2*>(dst + gj) = make_float2(v0, v1);
      } else {
        if (gj < n) dst[gj] = v0;
        if (gj + 1 < n) dst[gj + 1] = v1;
      }
    }
  }
}

// The tile images the ring copies, stage by stage, written once a launch
// (a prepass each; the blocks that share a tile, L / 4 x m / 64 of them for
// a right tile, copy it from here as it lies).  Right's image: tile z of
// 128 columns, stage g of 128 fields at ((z ns + g) kBTile), right^T K-major
// with the 128-byte swizzle of the wgmma B descriptor; 64 x 64 byte tiles
// through shared memory.  Zero past k and n.
__global__ void __launch_bounds__(256)
right_image(const int8_t* __restrict__ r, long long r_sr, int k, int n,
            uint8_t* __restrict__ rimg, int ns) {
  __shared__ uint8_t tile[64][68];
  const int q0 = blockIdx.x * 64;
  const int c0 = blockIdx.y * 64;
  for (int e = threadIdx.x; e < 64 * 64; e += 256) {
    const int q = e >> 6;
    const int c = e & 63;
    tile[q][c] = q0 + q < k && c0 + c < n
                     ? static_cast<uint8_t>(r[static_cast<long long>(q0 + q) * r_sr + c0 + c])
                     : 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 64; e += 256) {
    const int col = c0 + (e >> 6);
    const int q = q0 + (e & 63);
    const long long at = (static_cast<long long>(col >> 7) * ns + (q >> 7)) * kBTile +
                         pl::sw128_offset(col & 127, (q >> 4) & 7) + (q & 15);
    rimg[at] = tile[e & 63][e >> 6];
  }
}

// Own's image: tile y of 64 columns, stage g at ((y ns + g) kOwnBytes), the
// field rows as the fold reads them (own_row).  Zero past k and m.
__global__ void __launch_bounds__(256)
own_image(const int8_t* __restrict__ own, long long o_sr, int k, int m,
          uint8_t* __restrict__ oimg, int ns) {
  const int g = blockIdx.x;
  const int y = blockIdx.y;
  uint8_t* dst = oimg + (static_cast<long long>(y) * ns + g) * kOwnBytes;
  for (int e = threadIdx.x; e < kF * kRM; e += 256) {
    const int q = kF * g + (e >> 6);
    const int c = kRM * y + (e & 63);
    dst[own_row(e >> 6) + (e & 63)] =
        q < k && c < m ? static_cast<uint8_t>(own[static_cast<long long>(q) * o_sr + c]) : 0;
  }
}

// Bytes of the two images.
long long scratch_bytes(int k, int m, int n) {
  const long long ns = (k + kF - 1) / kF;
  return ns * (static_cast<long long>((n + kCN - 1) / kCN) * kBTile +
               static_cast<long long>((m + kRM - 1) / kRM) * kOwnBytes);
}

int launch(const void* own, long long o_sr, const void* X, long long x_sr,
           const void* right, long long r_sr, int k, int m, int L, int n, void* scratch,
           float* out, void* stream) {
  const int ns = (k + kF - 1) / kF;
  const int nz = (n + kCN - 1) / kCN;
  const int ny = (m + kRM - 1) / kRM;
  if (k < 1 || m < 1 || L < 1 || n < 1 || o_sr < m || x_sr < L || r_sr < n ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 || 2LL * nz > 65535 || ny > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* rimg = static_cast<uint8_t*>(scratch);
  uint8_t* oimg = rimg + static_cast<long long>(nz) * ns * kBTile;
  right_image<<<dim3(2 * ns, 2 * nz), 256, 0, st>>>(static_cast<const int8_t*>(right), r_sr, k,
                                                    n, rimg, ns);
  own_image<<<dim3(ns, ny), 256, 0, st>>>(static_cast<const int8_t*>(own), o_sr, k, m, oimg, ns);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ccc8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pl::View x{static_cast<const uint8_t*>(X), 0, x_sr, L};
  const dim3 grid((L + kTP - 1) / kTP, ny, nz);
  ccc8_kernel<<<grid, kThreads, kSmem, st>>>(x, rimg, oimg, m, n, k, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ccc8
}  // namespace

// The scratch bytes threeway_ccc_s8_launch needs: the tile images of right
// and own.
extern "C" long long threeway_ccc_s8_scratch(int k, int m, int n) {
  return ccc8::scratch_bytes(k, m, n);
}

// The CCC product on int8 operands: own (k, m), X (k, L) and right (k, n)
// field-major int8, each given by its base pointer and row stride in bytes
// (columns are contiguous; L = 1 for the single-column form, with x's
// element stride as its row stride); scratch of threeway_ccc_s8_scratch
// bytes, 16-byte aligned; out (L, m, n) float32, contiguous.  Launches the
// two image prepasses and the slice kernel on `stream` and returns
// cudaGetLastError().
extern "C" int threeway_ccc_s8_launch(const void* own, long long o_sr, const void* X,
                                      long long x_sr, const void* right, long long r_sr,
                                      int k, int m, int L, int n, void* scratch, float* out,
                                      void* stream) {
  return ccc8::launch(own, o_sr, X, x_sr, right, r_sr, k, m, L, n, scratch, out, stream);
}
