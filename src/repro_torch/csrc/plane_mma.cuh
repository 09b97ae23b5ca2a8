// Tensor-core pieces for the packed bit-plane kernels, all of which run on
// the tensor cores: the copies that bring packed plane bytes into shared
// memory, for all of them; the spread of packed fields to the 0/1 bytes
// that an int8 product takes, the wgmma A fragments built in registers
// from packed words, and the wgmma instructions (sm_90a), for plane3.cu
// (minplus3.cu's int8 CCC kernel uses the swizzle and the wgmma form with
// both operands in shared memory); the b1 .and.popc product on the packed
// words themselves, and its fragment words, for the b1 main loop of
// plane_rect.cu, plane_tri.cu and mgemm_levels.cu (plane_b1.cuh).
//
// Planes use the wire format of docs/BITPLANE_FORMAT.md: (levels, kb, w)
// uint8, fields packed 8 per byte LSB-first along the kb axis, each operand
// addressed through its own plane and row strides (View, plane_common.cuh).
// Tiles are copied as they lie in device memory, 8x fewer bytes than the
// indicators; byte rows past kb and columns past the view's width land as
// zero, and a zero field adds nothing to any product.
//
// The spread: nibble n (4 fields) -> the word whose byte i is bit i of n,
// (n * 0x00204081) & 0x01010101.  The multiplier puts copies of n at bit 0,
// 7, 14 and 21; they do not overlap, so nothing carries, and the mask keeps
// bit i of the copy at 7i, which is bit 8i: byte i, little-endian.
//
// The s8 contraction axis runs in atoms of 16 byte rows (128 fields, one
// 128-byte row of a swizzled tile per vector).  Within an atom the order is
// by 16-byte chunks: chunk q (q < 8) holds the 8 fields of the atom's byte
// row q, then the 8 of byte row q + 8.  Any order of the fields is the same
// sum as long as both operands use it.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_s8.cuh"
#include "plane_common.cuh"

namespace repro {
namespace planes {

// cp.async of `bytes` (<= N) from src, the rest of the N-byte destination
// zero-filled; bytes == 0 reads nothing.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(mma::smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(mma::smem_addr(dst)), "l"(src), "n"(N), "r"(bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The largest copy width (16, 4 or 1 bytes) that every chunk of an operand
// can take: its base, plane stride and row stride all multiples of it.
inline int copy_width(const View& v) {
  const long long a = static_cast<long long>(reinterpret_cast<uintptr_t>(v.base));
  if (a % 16 == 0 && v.sp % 16 == 0 && v.sr % 16 == 0) return 16;
  if (a % 4 == 0 && v.sp % 4 == 0 && v.sr % 4 == 0) return 4;
  return 1;
}

// One VEC-byte chunk (bytes <= VEC of them from src, the rest zero) into
// shared memory: cp.async for 16 and 4, a plain byte load and store for 1.
template <int VEC>
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src, int bytes) {
  if constexpr (VEC == 1) {
    *dst = bytes > 0 ? *src : 0;
  } else {
    cp_async<VEC>(dst, src, bytes);
  }
}

// The 0/1 bytes of the 4 fields of nibble n (bits 0-3).
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// Byte j of x as a 32-bit value.
__device__ __forceinline__ uint32_t byte_of(uint32_t x, int j) {
  return __byte_perm(x, 0u, 0x4440u | static_cast<uint32_t>(j));
}

// The spread of one stage chunk of 4 columns: w0 / w1 hold byte rows q and
// q + 8 of columns c .. c+3 (one byte each); column c + j gets the 16 bytes
// of its chunk q, fields of byte row q first.
__device__ __forceinline__ uint4 spread_chunk(uint32_t w0, uint32_t w1, int j) {
  const uint32_t lo0 = w0 & 0x0F0F0F0Fu, hi0 = (w0 >> 4) & 0x0F0F0F0Fu;
  const uint32_t lo1 = w1 & 0x0F0F0F0Fu, hi1 = (w1 >> 4) & 0x0F0F0F0Fu;
  return make_uint4(spread4(byte_of(lo0, j)), spread4(byte_of(hi0, j)),
                    spread4(byte_of(lo1, j)), spread4(byte_of(hi1, j)));
}


// The wgmma A fragments of two k32 steps of an atom for rows g and g + 8 of
// a warp's 16, lane = 4 g + c.  Step kk of the atom, register e: row g (e
// even) / g + 8 (e odd), fields 4c .. 4c+3 (e < 2) or 16 + 4c .. 16 + 4c + 3
// of the step, which in the chunk order above are nibble c & 1 of byte row
// 8 (c >> 1) + 2 kk (e < 2) or 8 (c >> 1) + 2 kk + 1.  u (row g) and v (row
// g + 8) hold byte rows b .. b + 3, b = 8 (c >> 1) + 4 p, of the atom, one
// byte each: steps 2 p and 2 p + 1 go to a[0] and a[1].
__device__ __forceinline__ void a_frags(uint32_t (&a)[2][4], uint32_t u, uint32_t v, int c) {
  const int sh = 4 * (c & 1);
  const uint32_t gu = (u >> sh) & 0x0F0F0F0Fu;
  const uint32_t gv = (v >> sh) & 0x0F0F0F0Fu;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    a[k][0] = spread4(byte_of(gu, 2 * k));
    a[k][1] = spread4(byte_of(gv, 2 * k));
    a[k][2] = spread4(byte_of(gu, 2 * k + 1));
    a[k][3] = spread4(byte_of(gv, 2 * k + 1));
  }
}

// -- b1 mma.sync (sm_80 and up) ------------------------------------------

// d += popcount(a AND b) over one 16 x 8 x 256-bit product, into int32:
// mma.sync m16n8k256 .b1 .and.popc.  Its fragments are those of the s8
// m16n8k32 form (mma_s8.cuh) with a byte of 8 fields where s8 has one
// field: lane = 4 g + c, a[0] = row g, k bits 32 c .. 32 c + 31, a[1] = row
// g + 8, a[2] / a[3] the same rows at k bits 128 + 32 c ..; b0 / b1 =
// column g, k bits 32 c .. / 128 + 32 c ..; d[0] / d[1] = row g, columns 2
// c / 2 c + 1, d[2] / d[3] = row g + 8.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The b1 fragment words of four vectors at one k256 step (32 byte rows) of
// a packed tile kept field-major in shared memory, as it was copied: S
// points at byte row 0 of the step, column 4 g of a 32-column group; ld is
// the row stride.  Lane (g, c) reads byte rows c + 4 i and 16 + c + 4 i (i
// < 4), four columns each, and transposes them: w[q] / w[4 + q] are vector
// 4 g + q's words for k bits 32 c .. 32 c + 31 / 128 + 32 c .. 128 + 32 c +
// 31 of the step, byte i of each from byte row c + 4 i / 16 + c + 4 i.
// Every byte row of the step lands in one word of one lane; both operands
// of a product use this order, so the sum is the popcount of the whole
// step.  A row stride of 32 or 96 (mod 128) bytes puts the four row groups
// c in four different 8-bank groups: the loads are free of bank conflicts.
__device__ __forceinline__ void b1_words(uint32_t (&w)[8], const uint8_t* S, int ld, int c) {
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = *reinterpret_cast<const uint32_t*>(S + (c + 4 * i) * ld);
    r[4 + i] = *reinterpret_cast<const uint32_t*>(S + (16 + c + 4 * i) * ld);
  }
  mma::transpose4(w, r[0], r[1], r[2], r[3]);
  mma::transpose4(w + 4, r[4], r[5], r[6], r[7]);
}

// -- wgmma (sm_90a) ------------------------------------------------------

// Descriptor of a K-major B tile in shared memory with the 128-byte swizzle:
// rows of 128 bytes (one vector's fields), 8-row atoms of 1,024 bytes, the
// atom 1,024-byte aligned, 16-byte chunk i of row r stored at chunk i ^ r.
// Start address and strides in 16-byte units: leading offset 1 (unused by
// this layout), stride between 8-row atoms 1,024 bytes, layout 1 (128B).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((mma::smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of chunk `chunk` of row `row` in such a tile.
__device__ __forceinline__ int sw128_offset(int row, int chunk) {
  return (row >> 3) * 1024 + (row & 7) * 128 + ((chunk ^ (row & 7)) << 4);
}

// Generic-proxy stores to shared memory -> visible to wgmma's async proxy
// (then a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Pins the accumulator registers here: no read or copy of them moves
// across this point, since a wgmma in flight writes them asynchronously
// (no instruction is emitted).
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (the 64 registers of an m64n128 s32 accumulator) = A . B, plus d when
// `accumulate` is not 0, for one k32 step: A (64 x 32 s8) in registers as a
// warpgroup fragment, B (32 x 128 s8) in shared memory through its
// descriptor.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The same product with A (64 x 32 bytes) also read from shared memory
// through its descriptor (K-major, the 128-byte swizzle of sw128_desc):
// unsigned A bytes times signed B bytes when A_U8, else signed times signed.
#define REPRO_WGMMA_SS(TYPES)                                                          \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32." TYPES " {"                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                       \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                       \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                       \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                       \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                       \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                                       \
      "%64, %65, p;\n}\n"                                                              \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),        \
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),      \
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),  \
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),  \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),  \
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),  \
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),  \
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),  \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),  \
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),  \
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])                             \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

template <bool A_U8>
__device__ __forceinline__ void wgmma_m64n128k32_ss(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  if constexpr (A_U8) {
    REPRO_WGMMA_SS("u8.s8");
  } else {
    REPRO_WGMMA_SS("s8.s8");
  }
}

#undef REPRO_WGMMA_SS

}  // namespace planes
}  // namespace repro
