#!/usr/bin/env python3
"""Check, on one H100, the operand layouts that the float32 wide attention
kernel (cross_modal_attn_wide_f32_kernel in csrc/cross_modal_attn.cu)
assumes for Hopper's warpgroup MMA in tf32:

* B (and A) from shared memory, K-major, no swizzle: 8-row by 16-byte core
  matrices of 128 contiguous bytes, K-adjacent ones ``lbo`` bytes apart,
  the next 8 rows ``sbo`` bytes on; the descriptor is tried with the
  leading and stride offsets as the kernel sets them and swapped;
* A from registers: a0 (row g, column t), a1 (g + 8, t), a2 (g, t + 4),
  a3 (g + 8, t + 4) of the warp's 16 rows (g = lane / 4, t = lane % 4);
* the accumulator: d[4i + e] at row g + 8(e / 2), column 8i + 2t + e % 2;
* an m64n136k8 product from registers, the kernel's p·v shape.

Each product's inputs are small integers, so every product is exact; the
script prints the largest error of each case and exits non-zero unless the
kernel's layouts give 0.  It builds its own source into build/probe/.

    python3 scripts/wgmma_layout_probe.py
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def regs(n, start=0):
    return ", ".join(f"%{i}" for i in range(start, start + n))


def source():
    outs16 = ", ".join(f'"+f"(d[{i}])' for i in range(8))
    outs136 = ", ".join(f'"+f"(d[{i}])' for i in range(68))
    return r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// element (r, k) of a K-major tile of rows x kw floats, core-matrix order
__device__ __forceinline__ int at(int r, int k, int kw) {
  return (r / 8) * (kw * 8) + (k / 4) * 32 + (r % 8) * 4 + (k % 4);
}

__global__ void ss16(const float* a, const float* b, float* out, int swap) {
  __shared__ __align__(128) float as[64 * 8];
  __shared__ __align__(128) float bs[16 * 8];
  for (int i = threadIdx.x; i < 64 * 8; i += 128) as[at(i / 8, i % 8, 8)] = a[i];
  for (int i = threadIdx.x; i < 16 * 8; i += 128) bs[at(i / 8, i % 8, 8)] = b[i];
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float d[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const uint64_t da = swap ? desc(as, 256, 128) : desc(as, 128, 256);
  const uint64_t db = swap ? desc(bs, 256, 128) : desc(bs, 128, 256);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {""" + regs(8) + r"""}, %8, %9, p, 1, 1;\n}\n"
               : """ + outs16 + r""" : "l"(da), "l"(db), "r"(1));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  for (int i = 0; i < 2; ++i)
    for (int e = 0; e < 4; ++e)
      out[(16 * w + g + 8 * (e / 2)) * 16 + 8 * i + 2 * t + e % 2] = d[4 * i + e];
}

__global__ void rs136(const float* a, const float* b, float* out) {
  __shared__ __align__(128) float bs[136 * 8];
  for (int i = threadIdx.x; i < 136 * 8; i += 128) bs[at(i / 8, i % 8, 8)] = b[i];
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r = 16 * w + g;
  const uint32_t a0 = __float_as_uint(a[r * 8 + t]), a1 = __float_as_uint(a[(r + 8) * 8 + t]);
  const uint32_t a2 = __float_as_uint(a[r * 8 + t + 4]);
  const uint32_t a3 = __float_as_uint(a[(r + 8) * 8 + t + 4]);
  float d[68];
  for (int i = 0; i < 68; ++i) d[i] = 0.0f;
  const uint64_t db = desc(bs, 128, 256);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {""" + regs(68) + r"""}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
               : """ + outs136 + r"""
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  for (int i = 0; i < 17; ++i)
    for (int e = 0; e < 4; ++e)
      out[(r + 8 * (e / 2)) * 136 + 8 * i + 2 * t + e % 2] = d[4 * i + e];
}

extern "C" int run_ss16(const void* a, const void* b, void* out, int swap) {
  ss16<<<1, 128>>>((const float*)a, (const float*)b, (float*)out, swap);
  return (int)cudaGetLastError();
}

extern "C" int run_rs136(const void* a, const void* b, void* out) {
  rs136<<<1, 128>>>((const float*)a, (const float*)b, (float*)out);
  return (int)cudaGetLastError();
}
"""


def main():
    if not torch.cuda.is_available():
        print("wgmma_layout_probe: no CUDA device", file=sys.stderr)
        return 1
    build = os.path.join(ROOT, "build", "probe")
    os.makedirs(build, exist_ok=True)
    src, lib = os.path.join(build, "wgmma_layout.cu"), os.path.join(build, "libwgmma_layout.so")
    with open(src, "w") as f:
        f.write(source())
    nvcc = "/usr/local/cuda/bin/nvcc"
    out = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                          "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                         capture_output=True, text=True)
    print(out.stdout + out.stderr)
    if out.returncode:
        return 1
    so = ctypes.CDLL(lib)
    for fn in (so.run_ss16, so.run_rs136):
        fn.restype = ctypes.c_int
    so.run_ss16.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    so.run_rs136.argtypes = [ctypes.c_void_p] * 3
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda", 0)
    a = torch.randint(-8, 9, (64, 8), generator=gen).float().to(dev)
    ok = True
    for swap in (0, 1):
        b = torch.randint(-8, 9, (16, 8), generator=gen).float().to(dev)
        out = torch.full((64, 16), float("nan"), device=dev)
        if so.run_ss16(a.data_ptr(), b.data_ptr(), out.data_ptr(), swap):
            print("wgmma_layout_probe: ss16 launch failed")
            return 1
        torch.cuda.synchronize()
        err = (out - a @ b.T).abs().max().item()
        print(f"m64n16k8 tf32, A and B from shared memory, lbo/sbo "
              f"{'swapped' if swap else 'as the kernel sets them'}: max_abs_err {err}")
        ok &= swap == 1 or err == 0
    b = torch.randint(-8, 9, (136, 8), generator=gen).float().to(dev)
    out = torch.full((64, 136), float("nan"), device=dev)
    if so.run_rs136(a.data_ptr(), b.data_ptr(), out.data_ptr()):
        print("wgmma_layout_probe: rs136 launch failed")
        return 1
    torch.cuda.synchronize()
    err = (out - a @ b.T).abs().max().item()
    print(f"m64n136k8 tf32, A from registers: max_abs_err {err}")
    ok &= err == 0
    print(f"wgmma_layout_probe: {'the kernel layouts hold' if ok else 'a layout is wrong'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
