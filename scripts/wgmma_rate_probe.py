#!/usr/bin/env python3
"""Measure, on one H100, the rate of Hopper's warpgroup MMA (wgmma) in tf32
at the shapes a float32 attention kernel can give it, and check the
128-byte-swizzled operand layout before a kernel relies on it.

Rates: every SM holds one block (its dynamic shared memory keeps a second
out) of one or two warpgroups; each warpgroup issues, per turn, 24 wgmma
m64nNk8 (eight k-steps over a 64-float K tile, three times over: the three
products of 3xTF32), commits and waits, for many turns.  Cases: A and B
from shared memory (q·kᵀ: N is the keys of a key block) and A from
registers (p·v: N is the head size), each with the operands K-major
without swizzle (8-row by 16-byte core matrices, as the float32 wide
kernel lays them out) and with the 128-byte swizzle.  Two warpgroups of a
block read the same B tile and A tiles of their own.  Printed: TFLOP/s
(2·64·N·8 a wgmma) against the card's dense tf32 peak of 495.

Then q·kᵀ as the float32 key-block kernel issues it, 3xTF32 over a K of
128 floats (16 k-steps, core-matrix order, rows 512 bytes apart in 8-row
groups), two warpgroups of 64 query rows sharing one key block of K:
``three`` issues a_lo·b_hi, a_hi·b_lo and a_hi·b_hi per k-step, each
m64nKk8 for a key block of K keys; ``stacked`` issues a_hi against K's hi
and lo parts as one B of 2K rows (m64n2Kk8) and a_lo·b_hi (m64nKk8), so
that A is read twice a k-step, not three times.  Printed: the TFLOP/s of
the three products.

Layouts: products of small integers (exact) through the swizzled layout,
A and B from shared memory at N = 32 and A from registers at N = 64, over
a K of 64 floats (two swizzle atoms, eight k-steps), against torch.

    python3 scripts/wgmma_rate_probe.py

It builds its own source into build/probe/ (a few seconds of nvcc).
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SS_N = (16, 24, 32, 64, 128)
RS_N = (64, 128, 256)
QK_KEYS = (32, 64)
TURNS = 2000
PEAK_TF32 = 495e12


def operands(n):
    return ", ".join(f"%{i}" for i in range(n))


def wgmma_fns():
    """wgmma_ss<N> and wgmma_rs<N> for every N of the cases."""
    out = []
    for n in sorted(set(SS_N) | set(RS_N) | {32, 64} | set(QK_KEYS)
                    | {2 * k for k in QK_KEYS}):
        acc = n // 2
        outs = ", ".join(f'"+f"(d[{i}])' for i in range(acc))
        out.append(f"""
__device__ __forceinline__ void wgmma_ss{n}(float (&d)[{acc}], uint64_t a, uint64_t b) {{
  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 2}, 0;\\n"
               "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 {{{operands(acc)}}}, "
               "%{acc}, %{acc + 1}, p, 1, 1;\\n}}\\n"
               : {outs} : "l"(a), "l"(b), "r"(1));
}}
__device__ __forceinline__ void wgmma_rs{n}(float (&d)[{acc}], const uint32_t (&a)[4],
                                           uint64_t b) {{
  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 5}, 0;\\n"
               "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 {{{operands(acc)}}}, "
               "{{%{acc}, %{acc + 1}, %{acc + 2}, %{acc + 3}}}, %{acc + 4}, p, 1, 1;\\n}}\\n"
               : {outs} : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}}""")
    return "\n".join(out)


def rate_kernels():
    out = []
    for mode, ns in (("ss", SS_N), ("rs", RS_N)):
        for n in ns:
            acc = n // 2
            a_op = ("swz ? wgmma_desc(a_at + 32 * (k & 3) + (k >> 2) * a_atom, 1) "
                    ": wgmma_desc(a_at + 256 * k, 0)" if mode == "ss" else "a")
            out.append(f"""
extern "C" __global__ void __launch_bounds__(256, 1) rate_{mode}{n}(float* sink, int turns, int swz) {{
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = threadIdx.x / 128;
  // B: N rows x 64 floats; A: 64 rows x 64 floats a warpgroup; swizzled or
  // core-matrix order, both 1024-byte aligned, contents zero
  for (int i = threadIdx.x; i < (2 * 64 + {n}) * 64; i += blockDim.x)
    reinterpret_cast<float*>(smem)[i] = 0.0f;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t b_at = base, a_at = base + {n} * 256 + wg * 64 * 256;
  // swizzled: each 32-float atom of K holds all rows (128 bytes each); core
  // order: K-adjacent core matrices 128 bytes apart, rows 8 at a time
  const uint32_t b_atom = swz ? {n} * 128 : 0, a_atom = swz ? 64 * 128 : 0;
  const uint32_t a[4] = {{0u, 0u, 0u, 0u}};
  float d[{acc}];
#pragma unroll
  for (int i = 0; i < {acc}; ++i) d[i] = 0.0f;
  for (int t = 0; t < turns; ++t) {{
    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) {{
        const uint64_t bd = swz ? wgmma_desc(b_at + 32 * (k & 3) + (k >> 2) * b_atom, 1)
                                : wgmma_desc(b_at + 256 * k, 0);
        wgmma_{mode}{n}(d, {a_op}, bd);
      }}
    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
  }}
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < {acc}; ++i) s += d[i];
  if (s != 0.0f) sink[threadIdx.x] = s;
}}""")
    return "\n".join(out)


def qk_kernels():
    """q·kᵀ of a key block of K keys, 3xTF32, as ``three`` or ``stacked``."""
    out = []
    for keys in QK_KEYS:
        acc = keys // 2
        out.append(f"""
extern "C" __global__ void __launch_bounds__(256, 1) qk_three{keys}(float* sink, int turns) {{
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = threadIdx.x / 128;
  for (int i = threadIdx.x; i < (4 * 64 + 2 * {keys}) * 128; i += blockDim.x)
    reinterpret_cast<float*>(smem)[i] = 0.0f;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  // A: hi and lo (64 x 128) a warpgroup; B: hi then lo ({keys} x 128)
  const uint32_t a_hi = base + wg * 2 * 64 * 512, a_lo = a_hi + 64 * 512;
  const uint32_t b_hi = base + 4 * 64 * 512, b_lo = b_hi + {keys} * 512;
  float d[{acc}];
  for (int i = 0; i < {acc}; ++i) d[i] = 0.0f;
  for (int t = 0; t < turns; ++t) {{
    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {{
      wgmma_ss{keys}(d, wgmma_desc512(a_lo + 256 * k), wgmma_desc512(b_hi + 256 * k));
      wgmma_ss{keys}(d, wgmma_desc512(a_hi + 256 * k), wgmma_desc512(b_lo + 256 * k));
      wgmma_ss{keys}(d, wgmma_desc512(a_hi + 256 * k), wgmma_desc512(b_hi + 256 * k));
    }}
    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
  }}
  float s = 0.0f;
  for (int i = 0; i < {acc}; ++i) s += d[i];
  if (s != 0.0f) sink[threadIdx.x] = s;
}}

extern "C" __global__ void __launch_bounds__(256, 1) qk_stacked{keys}(float* sink, int turns) {{
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = threadIdx.x / 128;
  for (int i = threadIdx.x; i < (4 * 64 + 2 * {keys}) * 128; i += blockDim.x)
    reinterpret_cast<float*>(smem)[i] = 0.0f;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t a_hi = base + wg * 2 * 64 * 512, a_lo = a_hi + 64 * 512;
  const uint32_t b_hi = base + 4 * 64 * 512;
  float d2[{keys}], d1[{acc}];
  for (int i = 0; i < {keys}; ++i) d2[i] = 0.0f;
  for (int i = 0; i < {acc}; ++i) d1[i] = 0.0f;
  for (int t = 0; t < turns; ++t) {{
    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {{
      wgmma_ss{keys}(d1, wgmma_desc512(a_lo + 256 * k), wgmma_desc512(b_hi + 256 * k));
      wgmma_ss{2 * keys}(d2, wgmma_desc512(a_hi + 256 * k), wgmma_desc512(b_hi + 256 * k));
    }}
    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
  }}
  float s = 0.0f;
  for (int i = 0; i < {keys}; ++i) s += d2[i];
  for (int i = 0; i < {acc}; ++i) s += d1[i];
  if (s != 0.0f) sink[threadIdx.x] = s;
}}""")
    return "\n".join(out)


def source():
    return r"""
#include <cuda_runtime.h>
#include <stdint.h>

// a wgmma operand descriptor at shared-memory byte address addr.  swz 0:
// core-matrix order as the float32 wide kernel lays out a tile of 64
// floats of K (core matrices along K 128 bytes apart, the next 8 rows 2048
// bytes on; a k-step moves the address by 256).  swz 1: 128-byte swizzle,
// stride offset 1024 (8 rows of 128 bytes); a k-step inside a 32-float
// atom moves the address by 32 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int swz) {
  if (swz)
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(2048 >> 4) << 32);
}
// core-matrix order for a tile of 128 floats of K: core matrices along K
// 128 bytes apart, the next 8 rows 4096 bytes on
__device__ __forceinline__ uint64_t wgmma_desc512(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(4096 >> 4) << 32);
}
""" + wgmma_fns() + rate_kernels() + qk_kernels() + r"""

// byte offset of element (r, k) of a K-major tile of `rows` rows, 128-byte
// swizzle: atoms of 32 floats of K, each all rows of 128 bytes, 16-byte
// chunks XORed by the row's index in its 8-row group
__device__ __forceinline__ int swz_at(int r, int k, int rows) {
  return (k / 32) * rows * 128 + r * 128 + ((((k % 32) / 4) ^ (r % 8)) * 16) + (k % 4) * 4;
}

extern "C" __global__ void check_ss32(const float* a, const float* b, float* out) {
  __shared__ __align__(1024) unsigned char as[64 * 64 * 4];
  __shared__ __align__(1024) unsigned char bs[32 * 64 * 4];
  for (int i = threadIdx.x; i < 64 * 64; i += 128)
    *reinterpret_cast<float*>(as + swz_at(i / 64, i % 64, 64)) = a[i];
  for (int i = threadIdx.x; i < 32 * 64; i += 128)
    *reinterpret_cast<float*>(bs + swz_at(i / 64, i % 64, 32)) = b[i];
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t a0 = (uint32_t)__cvta_generic_to_shared(as);
  const uint32_t b0 = (uint32_t)__cvta_generic_to_shared(bs);
  float d[16];
  for (int i = 0; i < 16; ++i) d[i] = 0.0f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int k = 0; k < 8; ++k)
    wgmma_ss32(d, wgmma_desc(a0 + (k >> 2) * 64 * 128 + 32 * (k & 3), 1),
               wgmma_desc(b0 + (k >> 2) * 32 * 128 + 32 * (k & 3), 1));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  for (int i = 0; i < 4; ++i)
    for (int e = 0; e < 4; ++e)
      out[(16 * w + g + 8 * (e / 2)) * 32 + 8 * i + 2 * t + e % 2] = d[4 * i + e];
}

extern "C" __global__ void check_rs64(const float* a, const float* b, float* out) {
  __shared__ __align__(1024) unsigned char bs[64 * 64 * 4];
  for (int i = threadIdx.x; i < 64 * 64; i += 128)
    *reinterpret_cast<float*>(bs + swz_at(i / 64, i % 64, 64)) = b[i];
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t b0 = (uint32_t)__cvta_generic_to_shared(bs);
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r = 16 * w + g;
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int k = 0; k < 8; ++k) {
    const uint32_t f[4] = {__float_as_uint(a[r * 64 + 8 * k + t]),
                           __float_as_uint(a[(r + 8) * 64 + 8 * k + t]),
                           __float_as_uint(a[r * 64 + 8 * k + t + 4]),
                           __float_as_uint(a[(r + 8) * 64 + 8 * k + t + 4])};
    wgmma_rs64(d, f, wgmma_desc(b0 + (k >> 2) * 64 * 128 + 32 * (k & 3), 1));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  for (int i = 0; i < 8; ++i)
    for (int e = 0; e < 4; ++e)
      out[(r + 8 * (e / 2)) * 64 + 8 * i + 2 * t + e % 2] = d[4 * i + e];
}

extern "C" int launch(const char* name, int grid, int threads, int smem, void* sink, int turns,
                      int swz);
"""


LAUNCHER = r"""
#include <string.h>
#define CASE(fn)                                                                         \
  if (!strcmp(name, #fn)) {                                                              \
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
    fn<<<grid, threads, smem>>>((float*)sink, turns, swz);                               \
    return (int)cudaGetLastError();                                                      \
  }
#define QK_CASE(fn)                                                                      \
  if (!strcmp(name, #fn)) {                                                              \
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
    fn<<<grid, threads, smem>>>((float*)sink, turns);                                    \
    return (int)cudaGetLastError();                                                      \
  }
extern "C" int launch(const char* name, int grid, int threads, int smem, void* sink, int turns,
                      int swz) {
""" + "".join(f"  CASE(rate_ss{n})\n" for n in SS_N) + "".join(
    f"  CASE(rate_rs{n})\n" for n in RS_N) + "".join(
    f"  QK_CASE(qk_three{n})\n  QK_CASE(qk_stacked{n})\n" for n in QK_KEYS) + r"""  return -1;
}
extern "C" int run_check(int which, const void* a, const void* b, void* out) {
  if (which == 0) check_ss32<<<1, 128>>>((const float*)a, (const float*)b, (float*)out);
  else check_rs64<<<1, 128>>>((const float*)a, (const float*)b, (float*)out);
  return (int)cudaGetLastError();
}
"""


def main():
    if not torch.cuda.is_available():
        print("wgmma_rate_probe: no CUDA device", file=sys.stderr)
        return 1
    build = os.path.join(ROOT, "build", "probe")
    os.makedirs(build, exist_ok=True)
    src, lib = os.path.join(build, "wgmma_rate.cu"), os.path.join(build, "libwgmma_rate.so")
    with open(src, "w") as f:
        f.write(source() + LAUNCHER)
    out = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                          "-o", lib, src], capture_output=True, text=True)
    print("\n".join(line for line in (out.stdout + out.stderr).splitlines()
                    if "error" in line or "serializ" in line or "spill" in line.lower()
                    and "0 bytes spill" not in line))
    if out.returncode:
        print(out.stderr)
        return 1
    so = ctypes.CDLL(lib)
    so.launch.restype = so.run_check.restype = ctypes.c_int
    so.launch.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [
        ctypes.c_int] * 2
    so.run_check.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    gen = torch.Generator().manual_seed(0)
    ok = True
    for which, n in ((0, 32), (1, 64)):
        a = torch.randint(-8, 9, (64, 64), generator=gen).float().to(dev)
        b = torch.randint(-8, 9, (n, 64), generator=gen).float().to(dev)
        out = torch.full((64, n), float("nan"), device=dev)
        if so.run_check(which, a.data_ptr(), b.data_ptr(), out.data_ptr()):
            print("wgmma_rate_probe: check launch failed")
            return 1
        torch.cuda.synchronize()
        err = (out - a @ b.T).abs().max().item()
        print(f"128-byte swizzle, {'A and B from shared memory, N = 32' if which == 0 else 'A from registers, N = 64'}, K = 64: max_abs_err {err}")
        ok &= err == 0
    sink = torch.zeros(256, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mode, ns in (("ss", SS_N), ("rs", RS_N)):
        for n in ns:
            for swz in (0, 1):
                for wgs in (1, 2):
                    name = f"rate_{mode}{n}".encode()
                    smem = 120 * 1024  # one block an SM
                    fn = lambda: so.launch(name, sms, 128 * wgs, smem, sink.data_ptr(), TURNS, swz)
                    if fn():
                        print(f"wgmma_rate_probe: {name.decode()} launch failed")
                        return 1
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    start.record()
                    for _ in range(3):
                        fn()
                    end.record()
                    end.synchronize()
                    ms = start.elapsed_time(end) / 3
                    flops = sms * wgs * TURNS * 24 * 2 * 64 * n * 8
                    rate = flops / (ms * 1e-3)
                    print(f"m64n{n}k8 tf32, {'A and B from shared memory' if mode == 'ss' else 'A from registers'}, "
                          f"{'128-byte swizzle' if swz else 'no swizzle'}, {wgs} warpgroup(s) an SM: "
                          f"{rate / 1e12:.1f} TFLOP/s ({100 * rate / PEAK_TF32:.0f}% of 495)")
    for keys in QK_KEYS:
        for kind in ("three", "stacked"):
            name = f"qk_{kind}{keys}".encode()
            smem = 4 * (4 * 64 + 2 * keys) * 128
            fn = lambda: so.launch(name, sms, 256, smem, sink.data_ptr(), TURNS // 4, 0)
            if fn():
                print(f"wgmma_rate_probe: {name.decode()} launch failed")
                return 1
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 3
            rate = sms * 2 * (TURNS // 4) * 16 * 3 * 2 * 64 * keys * 8 / (ms * 1e-3)
            print(f"q·kᵀ, {keys}-key blocks, K = 128, {kind}, 2 warpgroups an SM: "
                  f"{rate / 1e12:.1f} TFLOP/s of the three products ({100 * rate / PEAK_TF32:.0f}% of 495)")
    print(f"wgmma_rate_probe: {'the swizzled layouts hold' if ok else 'a swizzled layout is wrong'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
