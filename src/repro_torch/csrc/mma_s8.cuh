// Shared-memory addressing and the 4 x 4 byte transpose of the tensor-core
// kernels, and the fragment layout of mma.sync.aligned.m16n8k32 .s8 (sm_80
// and up), which the b1 form m16n8k256 (plane_mma.cuh mma_b1) shares with a
// byte of 8 fields where s8 has one field.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k32", .s8):
// lane = 4 * g + c.  A (16 x 32): reg 0 = row g, fields 4c .. 4c+3; reg 1 =
// row g+8, same fields; regs 2 / 3 = the same rows, fields 16 + 4c ...  B
// (32 x 8, one column per output column): reg 0 = column g, fields 4c ..
// 4c+3; reg 1 = fields 16 + 4c ...  D (16 x 8, s32): regs 0 / 1 = row g,
// columns 2c / 2c+1; regs 2 / 3 = row g+8.
#pragma once

#include <cstdint>

namespace repro {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

}  // namespace mma
}  // namespace repro
