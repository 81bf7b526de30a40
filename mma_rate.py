"""Measure the card's mma.sync TF32 rate: the ceiling of B3's tiled path.

    python3 mma_rate.py

Builds one small kernel with ``nvcc`` (into the gitignored ``tmp/``) in
which every warp issues ``mma.sync.aligned.m16n8k8`` TF32 products into
ACC independent accumulators, many times over, with no memory traffic,
and times it with CUDA events at several blocks per SM; prints the card's
name and power limit, then one JSON line: TFLOP/s of TF32 (2·16·8·8 per
instruction) and the cycles an SM sub-partition takes per instruction at
the card's largest SM clock (``clocks.max.sm``; the card may run below it
under load, so this is a lower bound on the cycles). ``keystone_tpu_torch/csrc/fv_stats.cu``'s
tiled path issues these instructions and little else of note, so its
kernels' HMMA count over their time sits under this rate.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from keystone_tpu_torch import _cuda  # noqa: E402

ACC, ITERS = 8, 4096
SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "mma_tf32.cuh"

__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = tf32_rna(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = tf32_rna(0.5f - threadIdx.x * 1e-3f + i);
  float c[ACC][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < ACC; ++j) mma_tf32(c[j], a, b);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < ACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int ks_mma_loop(float* out, int blocks, int threads, int iters, void* stream) {
  mma_loop<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
""".replace("ACC", str(ACC))


def main():
    if not torch.cuda.is_available():
        print("mma_rate: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    work = os.path.join(ROOT, "tmp", "mma_rate")
    os.makedirs(work, exist_ok=True)
    src, lib_path = os.path.join(work, "mma_loop.cu"), os.path.join(work, "libmma_loop.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", _cuda.CSRC_DIR, "-o", lib_path, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.ks_mma_loop.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ks_mma_loop.restype = ctypes.c_int
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads = 256
    rows = []
    for per_sm in (1, 2, 4):
        blocks = per_sm * sms
        out = torch.empty(blocks * threads, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            _cuda.check(lib.ks_mma_loop(out.data_ptr(), blocks, threads, ITERS, stream), "mma_loop")

        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        instrs = blocks * threads // 32 * ITERS * ACC
        clock_hz = max_sm_mhz * 1e6
        rows.append({"blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32, "ms": ms,
                     "tf32_tflops": instrs * 2 * 16 * 8 * 8 / ms / 1e9,
                     "cycles_per_mma_per_subpartition": ms / 1e3 * clock_hz / (instrs / (4 * sms))})
    print(smi)
    print(json.dumps({"card": smi, "accumulators": ACC, "rows": rows}))


if __name__ == "__main__":
    main()
