// The operations a compiled combine is made of (repro_torch/kernels/mgemm/
// combine.py emits C++ over these): the value kernels call the emitted
// function inline on each element, as they call fminf for min.  The same
// text compiles as host C++ (g++ -ffp-contract=off), where the tests hold
// it against torch on every int8 pair and on seeded pairs of every tag.
//
// Every value enters and leaves a combine as fp32: an int8 or int16 value
// is a small integer held exactly, an int32 operand is one below 2^24 (the
// rings' fp32-sum gate), a bfloat16 or float16 value is exact in fp32.
// Inside, an int-tagged value that torch wraps is held as an int: sx8 /
// sx16 sign-extend its low byte / half, as int8 / int16 arithmetic wraps in
// torch and jnp, so abs(-128) stays -128; int32 sums, differences and
// products run on unsigned ints (add32 .. abs32), which wrap without
// undefined behaviour.  f2i and i2f move a small integer between the two
// exactly, with a float add and an integer add (the 1.5 * 2^23 magic
// number) where a conversion instruction runs at a quarter of the rate;
// f2i32 / i2f32 are the conversion instructions, for int32 values beyond
// 2^22 (i2f32 rounds to nearest, as .astype(float32) does).  A bfloat16 or
// float16 op is the fp32 op rounded to the ring (rbf16, rf16, round to
// nearest even on the bits, so the same text runs on the host): fp32's 24
// bits are at least 2p + 2 for p = 8 and 11, so the double rounding of + -
// * / sqrt gives the correctly rounded result.  Sums, products, quotients
// and square roots are the rounded intrinsics on the card, so nvcc cannot
// contract a product and a sum into an FMA; on the host the tests compile
// with -ffp-contract=off for the same reason.
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

// An int32 value as fp32, rounded to nearest; an integer-valued fp32
// below 2^31 as an int.
REPRO_CC float i2f32(int v) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(v);
#else
  return static_cast<float>(v);
#endif
}
REPRO_CC int f2i32(float v) { return static_cast<int>(v); }

// The int8 and int16 wraps: the low byte / half, sign-extended.
REPRO_CC int sx8(int v) { return static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(v))); }
REPRO_CC int sx16(int v) {
  return static_cast<int>(static_cast<int16_t>(static_cast<uint16_t>(v)));
}

// int32 arithmetic, wrapping: on unsigned ints, whose overflow is defined.
REPRO_CC int add32(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
REPRO_CC int sub32(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
REPRO_CC int mul32(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
REPRO_CC int neg32(int a) { return static_cast<int>(0u - static_cast<uint32_t>(a)); }
REPRO_CC int abs32(int a) { return a < 0 ? neg32(a) : a; }

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

REPRO_CC float fdiv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

REPRO_CC float fsqrt(float a) {
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(a);
#else
  return std::sqrt(a);
#endif
}

// min / max that pass a NaN through, as torch.minimum / maximum and XLA's
// min / max do (fminf / fmaxf and std::fmin / fmax drop it): a quotient 0/0
// or the root of a negative that a clamp meets stays NaN.  One instruction
// on the card (max.NaN, sm_80 on), whose NaN is the canonical one.
REPRO_CC float fmin(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : b != b ? b : std::fmin(a, b);
#endif
}

REPRO_CC float fmax(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : b != b ? b : std::fmax(a, b);
#endif
}

REPRO_CC float fabs(float a) {
#ifdef __CUDA_ARCH__
  return fabsf(a);
#else
  return std::fabs(a);
#endif
}

// An fp32 value rounded to bfloat16 (8 significant bits), round to nearest
// even, as torch's and jnp's conversions: the same exponent range, so
// subnormals and overflow to inf fall out of the carry; a NaN becomes
// torch's quiet NaN.
REPRO_CC float rbf16(float x) {
  const uint32_t u = static_cast<uint32_t>(float_bits(x));
  if ((u & 0x7fffffffu) > 0x7f800000u) return bits_float(0x7fc00000);
  const uint32_t r = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return bits_float(static_cast<int>(r));
}

// An fp32 value rounded to float16 (11 significant bits, exponents from
// -14, largest finite 65504), round to nearest even: below 2^-14 to a
// multiple of 2^-24 (the add of 0.5 rounds there, the subtract is exact),
// else on the bits, a result of 2^16 or more becoming inf; a NaN keeps its
// sign, as torch's conversion does.
REPRO_CC float rf16(float x) {
  const uint32_t u = static_cast<uint32_t>(float_bits(x));
  const uint32_t s = u & 0x80000000u;
  const uint32_t a = u ^ s;
  if (a > 0x7f800000u) return bits_float(static_cast<int>(s | 0x7fc00000u));
  if (a < 0x38800000u) {
    const float r = fsub(fadd(bits_float(static_cast<int>(a)), 0.5f), 0.5f);
    return bits_float(static_cast<int>(static_cast<uint32_t>(float_bits(r)) | s));
  }
  const uint32_t r = (a + 0xfffu + ((a >> 13) & 1u)) & ~0x1fffu;
  return bits_float(static_cast<int>((r >= 0x47800000u ? 0x7f800000u : r) | s));
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
