// The operations a compiled combine is made of (repro_torch/kernels/mgemm/
// combine.py emits C++ over these): the value kernels call the emitted
// function inline on each element, as they call fminf for min.  The same
// text compiles as host C++ (g++ -ffp-contract=off), where the tests hold
// it against torch on every int8 pair.
//
// Every value enters and leaves a combine as fp32: an int8 value is a small
// integer held exactly.  Inside, an int8-tagged value that torch wraps is
// held as an int: sx8 sign-extends its low byte, as int8 arithmetic wraps
// in torch and jnp, so abs(-128) stays -128.  f2i and i2f move a small
// integer between the two exactly, with a float add and an integer add (the
// 1.5 * 2^23 magic number) where a conversion instruction runs at a quarter
// of the rate.  Sums and products are the rounded intrinsics on the card,
// so nvcc cannot contract a product and a sum into an FMA; on the host the
// tests compile with -ffp-contract=off for the same reason.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define REPRO_CC __host__ __device__ __forceinline__
#else
#define REPRO_CC inline
#endif

namespace repro {
namespace cc {

REPRO_CC float bits_float(int v) {
#ifdef __CUDA_ARCH__
  return __int_as_float(v);
#else
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
#endif
}

REPRO_CC int float_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int v;
  std::memcpy(&v, &f, sizeof v);
  return v;
#endif
}

constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23: its low mantissa bits hold an int
constexpr int kMagicBits = 0x4B400000;

// An integer-valued float in [-2^22, 2^22] as an int, and back.
REPRO_CC int f2i(float v) { return float_bits(v + kMagic) - kMagicBits; }
REPRO_CC float i2f(int v) { return bits_float(v + kMagicBits) - kMagic; }

// The int8 wrap: the low byte, sign-extended.
REPRO_CC int sx8(int v) { return static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(v))); }

REPRO_CC int imin(int a, int b) { return a < b ? a : b; }
REPRO_CC int imax(int a, int b) { return a > b ? a : b; }
REPRO_CC int iabs(int a) { return a < 0 ? -a : a; }

REPRO_CC float fadd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

REPRO_CC float fsub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

REPRO_CC float fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

REPRO_CC float fmin(float a, float b) {
#ifdef __CUDA_ARCH__
  return fminf(a, b);
#else
  return std::fmin(a, b);
#endif
}

REPRO_CC float fmax(float a, float b) {
#ifdef __CUDA_ARCH__
  return fmaxf(a, b);
#else
  return std::fmax(a, b);
#endif
}

REPRO_CC float fabs(float a) {
#ifdef __CUDA_ARCH__
  return fabsf(a);
#else
  return std::fabs(a);
#endif
}

// abs(x - y) of two int8 values as torch computes it, wrapping twice, in
// float ops: d = x - y in [-255, 255] is exact, 128 - ||d| - 128| is
// |wrap(d)| in [0, 128], and the wrap of that only takes 128 to -128.  Its
// three adds and one multiply-add run on the FMA pipes, its one compare on
// the ALU, where the int form (a subtract, two sign-extends, an abs) holds
// the ALU pipe at four ops a comparison.
REPRO_CC float absdiff8(float x, float y) {
  const float g = fsub(128.0f, fabs(fsub(fabs(fsub(x, y)), 128.0f)));
  return g - 256.0f * static_cast<float>(g >= 128.0f);
}

}  // namespace cc
}  // namespace repro
