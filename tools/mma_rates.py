#!/usr/bin/env python3
"""Issue rates of the tensor-core instructions a 0/1-plane product can use.

Run from the root of a checkout on a machine with one Hopper GPU and the
CUDA toolkit:

    python3 tools/mma_rates.py

Each form runs a loop of independent products on every SM (operands in
registers, or B in shared memory for ``wgmma``), long enough that launch
overhead is noise, and prints its rate in operations per second (a
multiply-add counts as 2; a ``b1`` product counts 2 per bit pair):

* ``mma.sync`` m16n8k32 ``.s8`` -> s32 (row 4's and the plane kernels'
  ``mma.sync`` form);
* ``mma.sync`` m16n8k256 ``.b1`` ``.and.popc`` -> s32 (the packed-bit form,
  which needs no spread of the planes to bytes);
* ``wgmma.mma_async`` m64n128k32 and m64n256k32 ``.s8`` -> s32 with A in
  registers and B in shared memory (128-byte swizzle);
* ``wgmma.mma_async`` m64n128k32 ``.u8.s8`` -> s32 with both operands in
  shared memory (row 11's CCC form);
* on the CUDA cores, the min-plus step of the value kernels: the fp32 form
  they run (FMNMX + FADD, one comparison) and Hopper's packed 16-bit min
  (``__vimin_s16x2``, a DPX instruction; PTX ``min.s16x2``) plus a 32-bit
  add (two comparisons), counted in comparisons per second.  This only measures: it
  says whether a packed-integer ``min`` would halve the fp32-issue bound of
  row 11 with ``min`` on int8.

The card's name and power limit come first, as ``nvidia-smi`` gives them;
the last line is a JSON object of the rates.  The CUDA source is built with
``nvcc`` into ``build/tools/`` (git-ignored).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KIND>
__global__ void __launch_bounds__(256) mma_loop(int iters, int* out) {
  const uint32_t x = threadIdx.x * 2654435761u + blockIdx.x;
  const uint32_t a[4] = {x, x ^ 0x55555555u, x + 7u, x * 3u};
  const uint32_t b0 = x >> 3, b1 = x ^ 0xF0F0F0F0u;
  int acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (KIND == 0) mma_s8(acc[c], a, b0, b1);
      else mma_b1(acc[c], a, b0, b1);
    }
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 0x7fffffff) out[0] = s;  // keeps the products live
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

@WGMMA@

template <int N>
__global__ void __launch_bounds__(128) wgmma_loop(int iters, int* out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* B = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
  for (int i = threadIdx.x; i < N * 128 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(B)[i] = i * 0x01000193u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t x = threadIdx.x * 2654435761u + blockIdx.x;
  const uint32_t a[4] = {x & 0x01010101u, (x >> 1) & 0x01010101u,
                         (x >> 2) & 0x01010101u, (x >> 3) & 0x01010101u};
  const uint64_t desc = sw128_desc(B);
  int acc[N / 2] = {};
  for (int i = 0; i < iters; ++i) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma<N>(acc, a, desc + 2 * k);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int s = 0;
#pragma unroll
  for (int c = 0; c < N / 2; ++c) s += acc[c];
  if (s == 0x7fffffff) out[0] = s;
}

// The same product with A (64 x 32 bytes) also read from shared memory
// through its descriptor (both operands K-major, 128-byte swizzle).
__global__ void __launch_bounds__(128) wgmma_ss_loop(int iters, int* out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* B = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* A = B + 128 * 128;
  for (int i = threadIdx.x; i < (128 + 64) * 128 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(B)[i] = i * 0x01000193u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t db = sw128_desc(B);
  const uint64_t da = sw128_desc(A);
  int acc[64] = {};
  for (int i = 0; i < iters; ++i) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_ss(acc, da + 2 * k, db + 2 * k);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int s = 0;
#pragma unroll
  for (int c = 0; c < 64; ++c) s += acc[c];
  if (s == 0x7fffffff) out[0] = s;
}

// Hopper's packed 16-bit min (the DPX instruction behind __vimin_s16x2),
// written in PTX: the toolkit's headers do not declare the intrinsic.
__device__ __forceinline__ uint32_t vimin_s16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.s16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The min-plus step on 16 independent accumulators a thread: KIND 0 the
// packed 16-bit min (DPX) and one 32-bit add per two comparisons, KIND 1
// fminf and an fp32 add per comparison.  b steps by one multiply-add an
// iteration, so no min is loop-invariant.
template <int KIND>
__global__ void __launch_bounds__(256) minadd_loop(int iters, int* out) {
  const uint32_t x = threadIdx.x * 2654435761u + blockIdx.x;
  if (KIND == 0) {
    uint32_t a[16], acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      a[c] = x ^ (c * 0x9E3779B9u);
      acc[c] = 0;
    }
    uint32_t b = x >> 3;
    for (int i = 0; i < iters; ++i) {
      b = b * 1664525u + 1013904223u;
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] += vimin_s16x2(a[c], b);
    }
    uint32_t s = 0;
#pragma unroll
    for (int c = 0; c < 16; ++c) s += acc[c];
    if (s == 0x7fffffffu) out[0] = static_cast<int>(s);
  } else {
    float a[16], acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      a[c] = static_cast<float>((x >> c) & 255);
      acc[c] = 0.0f;
    }
    float b = static_cast<float>(x & 255);
    for (int i = 0; i < iters; ++i) {
      b = b * 0.5f + 3.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] += fminf(a[c], b);
    }
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < 16; ++c) s += acc[c];
    if (s == -1.0f) out[0] = 1;
  }
}

extern "C" int rates_launch(int kind, int blocks, int iters, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) mma_loop<0><<<blocks, 256, 0, st>>>(iters, out);
  if (kind == 1) mma_loop<1><<<blocks, 256, 0, st>>>(iters, out);
  if (kind == 2 || kind == 3) {
    const int n = kind == 2 ? 128 : 256;
    const int smem = n * 128 + 1024;
    if (kind == 2) {
      cudaFuncSetAttribute(wgmma_loop<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      wgmma_loop<128><<<blocks, 128, smem, st>>>(iters, out);
    } else {
      cudaFuncSetAttribute(wgmma_loop<256>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      wgmma_loop<256><<<blocks, 128, smem, st>>>(iters, out);
    }
  }
  if (kind == 4) {
    const int smem = (128 + 64) * 128 + 1024;
    cudaFuncSetAttribute(wgmma_ss_loop, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    wgmma_ss_loop<<<blocks, 128, smem, st>>>(iters, out);
  }
  if (kind == 5) minadd_loop<0><<<blocks, 256, 0, st>>>(iters, out);
  if (kind == 6) minadd_loop<1><<<blocks, 256, 0, st>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def wgmma_source() -> str:
    """The ``wgmma<N>`` wrappers (m64nNk32 s32.s8.s8, A in registers): the
    instruction names every accumulator register, so it is written out."""
    parts = []
    for n in (128, 256):
        acc = n // 2
        regs = ", ".join(f"%{i}" for i in range(acc))
        outs = ", ".join(f'"+r"(d[{i}])' for i in range(acc))
        parts.append(
            f"template <> __device__ __forceinline__ void wgmma<{n}>(int* d, "
            "const uint32_t (&a)[4], uint64_t desc) {\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 5}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{{regs}}}, "\n'
            f'      "{{%{acc}, %{acc + 1}, %{acc + 2}, %{acc + 3}}}, %{acc + 4}, p;\\n}}\\n"\n'
            f"      : {outs}\n"
            '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));\n'
            "}\n")
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+r"(d[{i}])' for i in range(64))
    parts.append(
        "__device__ __forceinline__ void wgmma_ss(int* d, uint64_t da, uint64_t db) {\n"
        '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 {{{regs}}}, "\n'
        '      "%64, %65, p;\\n}\\n"\n'
        f"      : {outs}\n"
        '      : "l"(da), "l"(db), "r"(1));\n'
        "}\n")
    return ("template <int N> __device__ __forceinline__ void wgmma(int* d, "
            "const uint32_t (&a)[4], uint64_t desc);\n" + "".join(parts))


def build() -> Path:
    from repro_torch.kernels.build import _nvcc

    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_rates.cu"
    src.write_text(SOURCE.replace("@WGMMA@", wgmma_source()))
    lib = out_dir / "mma_rates.so"
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o",
                    str(lib), str(src)], check=True)
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rates: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip())
    lib = ctypes.CDLL(str(build()))
    fn = lib.rates_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # (name, kind, blocks, threads, ops per instruction per warp or warpgroup)
    forms = [
        ("mma.sync m16n8k32 s8", 0, 4 * sms, 256, 2 * 16 * 8 * 32),
        ("mma.sync m16n8k256 b1 and.popc", 1, 4 * sms, 256, 2 * 16 * 8 * 256),
        ("wgmma m64n128k32 s8 RS", 2, 2 * sms, 128, 2 * 64 * 128 * 32),
        ("wgmma m64n256k32 s8 RS", 3, 1 * sms, 128, 2 * 64 * 256 * 32),
        ("wgmma m64n128k32 u8.s8 SS", 4, 2 * sms, 128, 2 * 64 * 128 * 32),
        # comparisons a thread and iteration, not ops a product
        ("vimin.s16x2 + add (comparisons)", 5, 8 * sms, 256, 2 * 16),
        ("fminf + fadd (comparisons)", 6, 8 * sms, 256, 16),
    ]
    rates = {}
    for name, kind, blocks, threads, ops in forms:
        iters = 4096 if kind < 5 else 16384
        # products issued: 8 per warp per iteration for mma.sync, 4 per
        # warpgroup per iteration for wgmma; the min-plus steps count per thread
        per_iter = (threads // 32) * 8 if kind < 2 else (threads // 128) * 4 if kind < 5 \
            else threads
        total = blocks * per_iter * iters * ops
        for _ in range(2):  # warm-up, then the timed launch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(kind, blocks, iters, out.data_ptr(), stream)
            end.record()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        ms = start.elapsed_time(end)
        rates[name] = total / (ms * 1e-3)
        print(f"{name}: {ms:.3f} ms, {rates[name]:.4g} ops/s", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ops_per_s": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
