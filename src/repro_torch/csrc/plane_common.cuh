// Shared pieces of the packed bit-plane kernels: the operand view (View,
// plane_of; also the tensor-core plane3.cu's and plane_rect.cu's, through
// plane_mma.cuh) and, for plane_tri.cu, the last AND + __popc kernel, the
// block geometry, the stage load that assembles 32-bit words from
// field-major byte rows (load_stage), and the register-tile update
// (popc_stage).
//
// Planes use the wire format of docs/BITPLANE_FORMAT.md: (levels, kb, w)
// uint8, fields packed 8 per byte LSB-first along the kb axis.  The 4 bytes
// of one vector's 32-bit word (fields 32w .. 32w+31) sit in 4 consecutive
// byte rows, one row stride apart, so a stage loads byte rows coalesced along
// the vector axis and forms little-endian words in registers.  Pad bytes past
// kb and pad columns past the operand's width load as zero: AND with zero
// adds nothing, so the padding is inert.
//
// Each operand is addressed through its own plane and row strides, so a
// byte-range view along the vector axis (a 3-way pipeline slice) is read in
// place, with no copy.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace planes {

constexpr int BT = 128;             // output tile edge
constexpr int WK = 8;               // 32-bit words (256 fields) per stage
constexpr int TM = 8;               // register tile edge
constexpr int TPR = BT / TM;        // 16 threads per tile row
constexpr int THREADS = TPR * TPR;  // 256

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

// Word w (fields 32w .. 32w+31) of column c of one plane; bytes past kb
// read as zero.
__device__ __forceinline__ uint32_t word_at(const uint8_t* plane, long long sr,
                                            int kb, int w, int c) {
  uint32_t v = 0u;
#pragma unroll
  for (int byte = 0; byte < 4; ++byte) {
    const int row = 4 * w + byte;
    if (row < kb) v |= static_cast<uint32_t>(plane[row * sr + c]) << (8 * byte);
  }
  return v;
}

// S[r][c] = word (w0 + r) of column (col0 + c), for the WK words of a stage
// and the BT columns of a tile; zero past the last word and past the view's
// width.
__device__ __forceinline__ void load_stage(uint32_t (&S)[WK][BT], const View& v,
                                           const uint8_t* plane, int kb, int col0,
                                           int w0, int tid) {
  const int nw = (kb + 3) / 4;
  for (int e = tid; e < WK * BT; e += THREADS) {
    const int r = e / BT;
    const int c = e % BT;
    const int w = w0 + r;
    uint32_t word = 0u;
    if (w < nw && col0 + c < v.w) word = word_at(plane, v.sr, kb, w, col0 + c);
    S[r][c] = word;
  }
}

// acc[i][j] += popcount(As[r][ty*TM + i] AND Bs[r][tx*TM + j]) over the WK
// words of a stage: each thread owns a TM x TM register tile of the output.
__device__ __forceinline__ void popc_stage(uint32_t (&acc)[TM][TM],
                                           const uint32_t (&As)[WK][BT],
                                           const uint32_t (&Bs)[WK][BT], int ty,
                                           int tx) {
#pragma unroll
  for (int r = 0; r < WK; ++r) {
    uint32_t a[TM], b[TM];
    const uint4* ap = reinterpret_cast<const uint4*>(&As[r][ty * TM]);
    const uint4* bp = reinterpret_cast<const uint4*>(&Bs[r][tx * TM]);
    const uint4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] += __popc(a[i] & b[j]);
  }
}

__device__ __forceinline__ void zero_acc(uint32_t (&acc)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0u;
}

}  // namespace planes
}  // namespace repro
