"""Probe of the port's forward feed-forward kernel on one NVIDIA GPU.

    python3 scripts/probe_ff_fwd.py

1. ``mma``: a kernel that issues nothing but independent ``mma.sync``
   instructions (bf16 m16n8k16 and TF32 m16n8k8, f32 sums; 8 accumulators a
   warp) on every SM, at 4, 8 and 16 warps an SM: the rate the products of
   ``csrc/fused_ff.cu::ff_fwd`` can reach on this card.
2. ``rows``: ``fused_ff_cuda``'s device time (profiler) in f32 and bf16 at
   the flagship widths over a range of rows, and its time for 77,824 rows
   from the slope between the largest two, which leaves out what a launch
   costs whatever its rows (weight staging, the last partial round of tiles).
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import DTYPES, ROWS, device_ms, ff_inputs, log, phase_device  # noqa: E402
from fourierflow_tpu_torch.ops import _cuda  # noqa: E402
from fourierflow_tpu_torch.ops.fused_ff import fused_ff_cuda  # noqa: E402

MMA_SOURCE = r"""
#include <stdint.h>
#include <cuda_runtime.h>
template <int KIND>
__global__ void mma_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  b[0] = threadIdx.x;
  b[1] = threadIdx.x * 3;
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int k = 0; k < 8; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// Milliseconds of one launch of `blocks` blocks of `warps` warps, after a warm-up.
extern "C" float mma_rate_ms(int kind, int warps, int blocks, int iters) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * warps * 32);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (kind == 0) mma_rate<0><<<blocks, warps * 32>>>(out, iters);
    else mma_rate<1><<<blocks, warps * 32>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def probe_mma():
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = os.path.join(tmp, "mma_rate.cu"), os.path.join(tmp, "mma_rate.so")
        with open(src, "w") as f:
            f.write(MMA_SOURCE)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path, src], check=True,
                       capture_output=True, timeout=300)
        lib = ctypes.CDLL(lib_path)
    lib.mma_rate_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for kind, name, flop in ((0, "bf16 m16n8k16", 4096), (1, "tf32 m16n8k8", 2048)):
        for warps in (4, 8, 16):
            ms = lib.mma_rate_ms(kind, warps, sms, iters)
            if ms <= 0:
                raise RuntimeError("mma: the launch failed")
            n = sms * warps * iters * 8
            log(f"mma {name}, {warps} warps an SM: {n * flop / ms / 1e9:.1f} TFLOP/s")


def probe_rows():
    dev = torch.device("cuda", 0)
    sizes = (1, ROWS // 4, ROWS // 2, ROWS, 2 * ROWS, 4 * ROWS)
    for dtype in DTYPES:
        times = {}
        for rows in sizes:
            args = ff_inputs(rows, dtype, dev, 0)
            times[rows] = device_ms(lambda: fused_ff_cuda(*args))
            log(f"rows {str(dtype).replace('torch.', '')} {rows}: {times[rows]:.4f} ms")
        slope = (times[4 * ROWS] - times[2 * ROWS]) / (2 * ROWS)
        log(f"rows {str(dtype).replace('torch.', '')}: {slope * ROWS:.4f} ms for {ROWS} rows "
            f"from the slope, {times[ROWS] - slope * ROWS:.4f} ms fixed")


def main():
    if not torch.cuda.is_available():
        print("probe_ff_fwd: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    phase_device()
    probe_mma()
    probe_rows()


if __name__ == "__main__":
    main()
