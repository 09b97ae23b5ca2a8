// The pipelined CUDA-core main loop of the value kernels: mgemm_rect.cu
// (rows 1 / 2), mgemm_tri.cu (row 3, one operand read as both sides, a and
// b the same view) and minplus3.cu's minplus3_kernel (rows 11 / 10).  One
// block of 256 threads computes the 128 x 128 tile
//
//   acc[i][j] = sum_q combine(fold(a[q, col_a + i]), b[q, col_b + j])
//
// in fp32 on the CUDA cores, with fold(v) = combine(v, x[q]) for row 11's
// pipeline column x (combine(own, x_t), built once a stage in shared
// memory) and fold(v) = v otherwise.  min has no tensor-core form and a
// float32 product no exact one (TF32 stays off), so each comparison is an
// FMNMX and an FADD, or one FFMA for the product; any other registered
// combine is compiled into the loop as a function of its own
// (combine_ops.cuh, combine_entry.cuh), inlined as fminf is: its ops and
// the add a comparison, at the same two blocks an SM and copy width.  On
// integer and quarter-grid data every partial sum is exact in fp32, in any
// order.
//
// Stages of BK = 32 field rows.  The raw operand rows (int8 or float32, as
// they lie in device memory: each operand a strided view read in place
// through its own row stride) are copied into a ring of shared-memory slots
// with cp.async, two stages ahead of the one multiplied: 16-byte copies
// where the view's base and row stride are 16-byte aligned, else 4-byte
// (float32, or int8 at a 4-byte alignment) or byte copies; rows past k and
// columns past the view's width land as zero.  A stage is prepared once,
// between the barrier that says it has landed and the one before its
// products: float32 rows are folded in place in their slot (nothing to do
// for rows 1 / 2) and the products read the slot; int8 rows are converted to
// fp32 into a double-buffered operand tile (a byte permute into 2^23 + b +
// 128 and one FADD each, full rate, where I2F runs at a quarter) and folded
// there.  Row 11's x values ride the ring too, one 4-byte copy a field.  So each stage costs one __syncthreads: copy of stage s + 2,
// preparation of stage s + 1 and products of stage s all run between two
// barriers.  Shared memory: float32 3 slots x 32 KB = 96 KB; int8 2 slots
// x 8 KB + 2 x 32 KB of fp32 tiles = 80 KB; two blocks an SM.
//
// What holds it (tools/minplus_bench.py, one H100 80GB HBM3 at 700 W): the
// products themselves.  Without the copies and the preparation a
// full-width 3-way slice (n_f 20,000, L 64, m = n = 1,536) takes 114.9 ms
// of 123.8 for the float32 CCC product (fp32-issue bound 90.1) and 208.7 of
// 229.7 for min on int8 (bound 180.3); copies and preparation alone take
// 13-24 ms and hide under the products.  Row 3 is bound the same way at a
// large diagonal block; a small one has too few packed tiles to fill the
// card's two blocks an SM, so mgemm_tri.cuh splits its stages over grid.z,
// each split one contract() over its own stage range (s_beg, ns).
//
// Each thread owns an 8 x 8 register tile: rows 4 ty .. 4 ty + 3 and
// 64 + 4 ty .. 64 + 4 ty + 3, columns likewise with tx (tile_pos).  A warp
// spans 4 ty x 8 tx, so a row's fragment reads are two 16-byte loads of A
// (4 distinct addresses a warp) and two of B (8 distinct, 128 contiguous
// bytes): no bank conflicts, 4 shared loads for 64 comparisons.
#pragma once

#include <type_traits>

#include "minplus_common.cuh"
#include "plane_mma.cuh"

namespace repro {
namespace minplus {
namespace pipe {

constexpr int BK = 32;        // contraction rows per stage
constexpr int TILE = BK * BT;  // elements of one operand's stage tile

// Shared-memory layout of one operand type: kSlots raw slots (A's stage
// tile, B's, then the 4-byte words that hold x for the stage's BK fields),
// then, for int8, two fp32 buffers of (A, B).
template <typename TIn>
struct Layout {
  static constexpr bool kInPlace = std::is_same<TIn, float>::value;
  static constexpr int kSlots = kInPlace ? 3 : 2;
  static constexpr int kAhead = 2;  // stages copied ahead of the one multiplied
  static constexpr int kSlotBytes = 2 * TILE * static_cast<int>(sizeof(TIn)) + 4 * BK;
  static constexpr int kSmem = kSlots * kSlotBytes + (kInPlace ? 0 : 2 * 2 * TILE * 4);
  static_assert(kSlots >= kAhead + (kInPlace ? 1 : 0), "a slot outlives its readers");
  static_assert(2 * (kSmem + 1024) <= 228 * 1024, "two blocks an SM");
};

// The calling thread's register tile: rows tile_pos(i, ty), columns
// tile_pos(j, tx) of the block's tile.
struct Place {
  int ty, tx;
};

__device__ __forceinline__ Place place_of(int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  return Place{4 * (warp >> 1) + (lane >> 3), 8 * (warp & 1) + (lane & 7)};
}

__host__ __device__ __forceinline__ int tile_pos(int i, int t) {
  return (i < 4 ? 0 : 64) + 4 * t + (i & 3);
}

// The widest copy (16, 4 or 1 bytes) that every chunk of a view takes: its
// base and row stride both multiples of it (a tile starts at a multiple of
// 128 columns).
template <typename TIn>
inline int copy_width(const Operand<TIn>& v) {
  const unsigned long long a = reinterpret_cast<uintptr_t>(v.base);
  const long long rb = v.sr * static_cast<long long>(sizeof(TIn));
  if (a % 16 == 0 && rb % 16 == 0) return 16;
  if (a % 4 == 0 && rb % 4 == 0) return 4;
  return 1;
}

// f(std::integral_constant<int, VEC>{}) for the widest copy VEC that both
// copied views a and b take: f launches that instantiation of its kernel.
template <typename TIn, typename F>
cudaError_t with_copy_width(const Operand<TIn>& a, const Operand<TIn>& b, F&& f) {
  const int vec = min(copy_width(a), copy_width(b));
  if (vec == 16) return f(std::integral_constant<int, 16>{});
  if constexpr (sizeof(TIn) == 1) {
    if (vec == 1) return f(std::integral_constant<int, 1>{});
  }
  return f(std::integral_constant<int, 4>{});
}

// The BK rows from k0 of the BT columns from col0 of v into dst (row-major,
// BT elements a row), in VEC-byte chunks; zero past k and past v's width.
// A thread's chunks share a column and lie RSTEP rows apart, so it walks
// one pointer.  k0 passes through an empty asm: the compiler then cannot
// turn each chunk's address into an induction variable of the stage loop,
// which would hold 2 registers a chunk across the products.
template <int VEC, typename TIn>
__device__ __forceinline__ void copy_operand(uint8_t* dst, const Operand<TIn>& v, int k,
                                             int k0, int col0, int tid) {
  constexpr int ES = static_cast<int>(sizeof(TIn));
  constexpr int ROW = BT * ES;  // bytes of one tile row
  constexpr int CPR = ROW / VEC;
  constexpr int RSTEP = THREADS / CPR;
  static_assert(VEC >= ES && THREADS % CPR == 0 && BK % RSTEP == 0, "whole chunks a thread");
  asm volatile("" : "+r"(k0));
  const int r0 = tid / CPR;
  const int cb = (tid % CPR) * VEC;
  const int c = col0 + cb / ES;
  const int live = min(max(v.w - c, 0) * ES, VEC);  // bytes of the chunk in the view
  int q = k0 + r0;
  const TIn* src = v.base + q * v.sr + c;
  uint8_t* d = dst + r0 * ROW + cb;
#pragma unroll
  for (int i = 0; i < BK / RSTEP; ++i) {
    const int bytes = q < k ? live : 0;
    planes::copy_chunk<VEC>(d, reinterpret_cast<const uint8_t*>(bytes > 0 ? src : v.base),
                            bytes);
    q += RSTEP;
    src += RSTEP * v.sr;
    d += RSTEP * ROW;
  }
}

// x for fields k0 .. k0 + BK - 1 into xs, one 4-byte cp.async a field by
// the block's first BK threads: the float itself, or for int8 the aligned
// word that holds the byte (x_of picks it out); 0 past k.
template <typename TIn>
__device__ __forceinline__ void copy_x(uint8_t* xs, const TIn* x, long long x_sr, int k, int k0,
                                       int tid) {
  if (tid < BK) {
    const int q = k0 + tid;
    const uintptr_t at = reinterpret_cast<uintptr_t>(q < k ? x + q * x_sr : x) & ~uintptr_t{3};
    planes::cp_async<4>(xs + 4 * tid, reinterpret_cast<const void*>(at), q < k ? 4 : 0);
  }
}

// x for field q (row r of its stage) from the stage's words xs, as fp32.
template <typename TIn>
__device__ __forceinline__ float x_of(const uint8_t* xs, const TIn* x, long long x_sr, int q,
                                      int r) {
  if constexpr (Layout<TIn>::kInPlace) {
    return reinterpret_cast<const float*>(xs)[r];
  } else {
    const int byte = static_cast<int>(reinterpret_cast<uintptr_t>(x + q * x_sr) & 3);
    return static_cast<float>(static_cast<int8_t>(xs[4 * r + byte]));
  }
}

// The four signed bytes of w as fp32, exactly: byte b, biased to b + 128
// in [0, 255], becomes the low byte of the float 2^23 + b + 128.
__device__ __forceinline__ float4 s8x4_to_f32(uint32_t w) {
  constexpr float kBias = 8388736.0f;  // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441u)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442u)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443u)) - kBias);
}

template <typename F>
__device__ __forceinline__ float4 fold4(float4 v, float x) {
  return make_float4(F::apply(v.x, x), F::apply(v.y, x), F::apply(v.z, x), F::apply(v.w, x));
}

// A thread's share of the preparation of the stage from field k0: rows r =
// (tid / 32) + 8 i of both operand tiles, columns 4 (tid % 32) .. + 3.
// float32: A folded in place with x by the fold F (rows 11 / 10 only).
// int8: A (folded) and B converted from the raw slot into the fp32 buffers
// Af, Bf.
template <typename F, bool FOLD, typename TIn>
__device__ __forceinline__ void prepare(const uint8_t* slot, float* Af, float* Bf,
                                        const TIn* x, long long x_sr, int k0, int tid) {
  const int c = tid & 31;
  const uint8_t* xs = slot + 2 * TILE * sizeof(TIn);
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const int r = (tid >> 5) + 8 * i;
    const int e = r * BT + 4 * c;
    if constexpr (Layout<TIn>::kInPlace) {
      if constexpr (FOLD) {
        float4* p = reinterpret_cast<float4*>(Af + e);
        *p = fold4<F>(*p, x_of(xs, x, x_sr, k0 + r, r));
      }
    } else {
      const uint32_t* raw = reinterpret_cast<const uint32_t*>(slot);
      float4 a = s8x4_to_f32(raw[e / 4]);
      if constexpr (FOLD) a = fold4<F>(a, x_of(xs, x, x_sr, k0 + r, r));
      *reinterpret_cast<float4*>(Af + e) = a;
      *reinterpret_cast<float4*>(Bf + e) = s8x4_to_f32(raw[(TILE + e) / 4]);
    }
  }
}

// acc[i][j] += C::apply(A[r][tile_pos(i, ty)], B[r][tile_pos(j, tx)]) for
// one row r of a stage.
template <typename C>
__device__ __forceinline__ void fma_row(float (&acc)[TM][TM], const float* As,
                                        const float* Bs, Place p, int r) {
  const float4 a0 = *reinterpret_cast<const float4*>(As + r * BT + 4 * p.ty);
  const float4 a1 = *reinterpret_cast<const float4*>(As + r * BT + 64 + 4 * p.ty);
  const float4 b0 = *reinterpret_cast<const float4*>(Bs + r * BT + 4 * p.tx);
  const float4 b1 = *reinterpret_cast<const float4*>(Bs + r * BT + 64 + 4 * p.tx);
  const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[TM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] += C::apply(a[i], b[j]);
}

// fma_row over the BK rows of a stage, unless the combine adds something
// for a zero row (kZero false) and the stage is the last: then over the
// `rows` that hold fields, one at a time.  The row loop is unrolled 4 deep,
// and fully for the product, which each form ran fastest at on the H100
// (tools/minplus_bench.py probes unroll2 .. unroll32).
template <typename C>
__device__ __forceinline__ void fma_stage(float (&acc)[TM][TM], const float* As,
                                          const float* Bs, Place p, int rows) {
  if (C::kZero || rows == BK) {
    constexpr int kUnroll = std::is_same<C, MulCombine>::value ? BK : 4;
#pragma unroll(kUnroll)
    for (int r = 0; r < BK; ++r) fma_row<C>(acc, As, Bs, p, r);
  } else {
#pragma unroll 1
    for (int r = 0; r < rows; ++r) fma_row<C>(acc, As, Bs, p, r);
  }
}

// The contraction of one tile over stages s_beg .. s_beg + ns - 1 (stage s:
// fields BK s ..) of a (columns from col_a) and b (from col_b), into acc.
// With FOLD, a's rows are first combined with x by F: field q's value is
// x[q * x_sr], copied with the stage; the products then combine by C.  A
// compiled combine's fold and product are two functions: a mixed-dtype
// combine makes the fold float32 where the operands are int8.  Every thread
// of the block calls it; smem is the block's Layout<TIn>::kSmem bytes of
// dynamic shared memory.
template <typename C, typename F, bool FOLD, int VEC, typename TIn>
__device__ __forceinline__ void contract(float (&acc)[TM][TM], uint8_t* smem,
                                         const Operand<TIn>& a, const Operand<TIn>& b,
                                         const TIn* x, long long x_sr, int k, int s_beg,
                                         int ns, int col_a, int col_b) {
  using L = Layout<TIn>;
  const int tid = threadIdx.x;
  const Place p = place_of(tid);
  zero_acc(acc);
  float* fbuf = reinterpret_cast<float*>(smem + L::kSlots * L::kSlotBytes);  // int8 only

  // stage s (relative to s_beg): its raw slot, and where its products read
  auto slot = [&](int s) { return smem + (s % L::kSlots) * L::kSlotBytes; };
  auto tile_a = [&](int s) {
    return L::kInPlace ? reinterpret_cast<float*>(slot(s)) : fbuf + (s & 1) * 2 * TILE;
  };
  auto issue = [&](int s) {
    if (s < ns) {
      const int k0 = (s_beg + s) * BK;
      copy_operand<VEC>(slot(s), a, k, k0, col_a, tid);
      copy_operand<VEC>(slot(s) + TILE * sizeof(TIn), b, k, k0, col_b, tid);
      if constexpr (FOLD) copy_x(slot(s) + 2 * TILE * sizeof(TIn), x, x_sr, k, k0, tid);
    }
    planes::cp_async_commit();
  };
  auto prep = [&](int s) {
    prepare<F, FOLD, TIn>(slot(s), tile_a(s), tile_a(s) + TILE, x, x_sr, (s_beg + s) * BK,
                          tid);
  };

  if (ns <= 0) return;
#pragma unroll
  for (int s = 0; s < L::kAhead; ++s) issue(s);
  planes::cp_async_wait<L::kAhead - 1>();  // stage 0 has landed
  __syncthreads();
  prep(0);

  for (int s = 0; s < ns; ++s) {
    planes::cp_async_wait<L::kAhead - 2>();  // stage s + 1 has landed
    // for every thread: stage s + 1 has landed and stage s is prepared;
    // stage s - 1's products are done, so its slot and buffer are free
    __syncthreads();
    issue(s + L::kAhead);
    if (s + 1 < ns) prep(s + 1);
    fma_stage<C>(acc, tile_a(s), tile_a(s) + TILE, p, live_rows(k, (s_beg + s) * BK, BK));
  }
}

// Four outputs of one row, columns gj .. gj + 3, of which `live` lie in the
// block: one 16-byte store when all four do and the rows start 16-byte
// aligned (vec), else one by one at constant indices (a loop bounded at run
// time would index v, and the accumulators behind it, in local memory).
template <typename TOut>
__device__ __forceinline__ void store4(TOut* dst, const float (&v)[4], int live, bool vec) {
  if constexpr (sizeof(TOut) == 4) {
    if (vec && live >= 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (x < live) store_out(dst + x, v[x]);
  }
}

}  // namespace pipe
}  // namespace minplus
}  // namespace repro
