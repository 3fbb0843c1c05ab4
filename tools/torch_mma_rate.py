#!/usr/bin/env python3
"""Measure the tensor-core rate that ``mma.sync`` reaches on this GPU.

    python3 tools/torch_mma_rate.py

Builds a small CUDA file with nvcc (sm_90a) in a temporary directory and
times, with CUDA events, blocks of warps that issue independent chains of
``mma.sync``: TF32 m16n8k8, bf16 m16n8k16, and the 3xTF32 step of the
port's kernels (three dependent TF32 products into one accumulator, as
``csrc/tensor_core.cuh``'s ``mma3``), each at 4, 8 and 16 warps per SM and
8 independent accumulators a warp. Prints one line per case (TFLOP/s of
the products issued, counting a 3xTF32 step as three) and the card's name
and power limit (nvidia-smi). Needs a GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// KIND 0: TF32 m16n8k8, 1: bf16 m16n8k16, 2: 3xTF32 (three dependent TF32).
template <int KIND>
__global__ void rate(float* out, int iters) {
  uint32_t a[4], a2[4], b[2], b2[2];
  for (int i = 0; i < 4; ++i) {
    a[i] = 0x3f800000u + threadIdx.x * 8192u + i;
    a2[i] = 0x33800000u + threadIdx.x;
  }
  b[0] = b2[0] = 0x3f000000u;
  b[1] = b2[1] = 0x3e800000u;
  float acc[8][4];
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0) tf32(acc[j], a, b);
      if (KIND == 1) bf16(acc[j], a, b);
      if (KIND == 2) {
        tf32(acc[j], a2, b);
        tf32(acc[j], a, b2);
        tf32(acc[j], a, b);
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(int kind, int blocks, int threads, int iters, float* out,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) rate<0><<<blocks, threads, 0, st>>>(out, iters);
  if (kind == 1) rate<1><<<blocks, threads, 0, st>>>(out, iters);
  if (kind == 2) rate<2><<<blocks, threads, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(gpu)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "rate.cu"), os.path.join(tmp, "rate.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc, "-std=c++17", "-O3", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-shared",
                        "-Xcompiler", "-fPIC", src, "-o", lib], check=True)
        fn = ctypes.CDLL(lib).mma_rate
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        iters = 4096
        for kind, name, flop in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                                 (1, "bf16 m16n8k16", 2 * 16 * 8 * 16),
                                 (2, "3xTF32 step", 3 * 2 * 16 * 8 * 8)):
            for warps in (4, 8, 16):
                threads = 32 * warps
                out = torch.empty(sms * threads, device="cuda")
                st = torch.cuda.current_stream().cuda_stream
                call = lambda: fn(kind, sms, threads, iters, out.data_ptr(), st)
                for _ in range(2):
                    assert call() == 0
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(5):
                    call()
                t1.record()
                t1.synchronize()
                ms = t0.elapsed_time(t1) / 5
                tflops = sms * warps * iters * 8 * flop / (ms * 1e-3) / 1e12
                print(f"{name}, {warps} warps an SM: {ms:.4f} ms, "
                      f"{tflops:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
