// Int8 tensor-core fragments for mma.sync.aligned.m16n8k32 (sm_80 and up,
// so also Hopper's sm_90a): the shared-memory fragment loads (ldmatrix)
// and the MMA itself, for operands kept in shared memory "vector-major":
// one row per output row (A) or output column (B), fields contiguous along
// the row, which is the layout the row.col form reads; and the 4 x 4 byte
// transpose that builds such rows from field-major bytes.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k32", .s8):
// lane = 4 * g + c.  A (16 x 32): reg 0 = row g, fields 4c .. 4c+3; reg 1 =
// row g+8, same fields; regs 2 / 3 = the same rows, fields 16 + 4c ...  B
// (32 x 8, one column per output column): reg 0 = column g, fields 4c ..
// 4c+3; reg 1 = fields 16 + 4c ...  D (16 x 8, s32): regs 0 / 1 = row g,
// columns 2c / 2c+1; regs 2 / 3 = row g+8.  ldmatrix.x4 hands lane l the
// bytes 4(l%4) .. 4(l%4)+3 of row l/4 of each of four 8 x 16-byte
// matrices, lanes 8j .. 8j+7 giving the row addresses of matrix j, which is
// exactly this layout.
//
// Row addresses must be 16-byte aligned; a row stride of 16 (mod 128)
// bytes puts the 8 rows of each matrix in 8 different bank groups, so the
// loads are conflict-free.
#pragma once

#include <cstdint>

namespace repro {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// The A fragment of rows r0 .. r0+15 and fields f0 .. f0+31 of a
// vector-major byte tile S (row stride `stride` bytes).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* S, int stride,
                                       int r0, int f0, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(a, S + row * stride + f0 + (lane >> 4) * 16);
}

// The B fragments of two n8 tiles, columns c0 .. c0+7 (regs 0 / 1) and
// c0+8 .. c0+15 (regs 2 / 3), fields f0 .. f0+31 of a vector-major tile S.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const uint8_t* S, int stride,
                                        int c0, int f0, int lane) {
  const int row = c0 + (lane & 7) + (lane >> 4) * 8;
  ldmatrix_x4(b, S + row * stride + f0 + ((lane >> 3) & 1) * 16);
}

// Four words of four columns (byte i = column i of rows 0 .. 3) -> four
// columns' words: cw[j] byte i = byte j of r_i.  Turns field-major bytes
// into the vector-major words that the products read.
__device__ __forceinline__ void transpose4(uint32_t* cw, uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  cw[0] = __byte_perm(t0, t2, 0x5410);
  cw[1] = __byte_perm(t0, t2, 0x7632);
  cw[2] = __byte_perm(t1, t3, 0x5410);
  cw[3] = __byte_perm(t1, t3, 0x7632);
}

// d += a . b, int8 x int8 -> int32, one 16 x 8 x 32 product.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
}  // namespace repro
