// Shared pieces of the packed bit-plane kernels (plane_tri.cu,
// plane_rect.cu and plane3.cu, through plane_mma.cuh): the output tile
// edge and the operand view (View, plane_of).
//
// Planes use the wire format of docs/BITPLANE_FORMAT.md: (levels, kb, w)
// uint8, fields packed 8 per byte LSB-first along the kb axis, so the
// bytes of one vector's fields lie one row stride apart.  Each operand is
// addressed through its own plane and row strides, so a byte-range view
// along the vector axis (a 3-way pipeline slice) is read in place, with no
// copy.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace planes {

constexpr int BT = 128;  // output tile edge

// A strided (levels, kb, w) plane operand: byte (t, r, c) lives at
// base[t * sp + r * sr + c].
struct View {
  const uint8_t* base;
  long long sp;  // plane stride (bytes)
  long long sr;  // row stride (bytes): the width of the array it views
  int w;         // columns of the view
};

__device__ __forceinline__ const uint8_t* plane_of(const View& v, int t) {
  return v.base + static_cast<long long>(t) * v.sp;
}

}  // namespace planes
}  // namespace repro
