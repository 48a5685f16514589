"""Host time per call of the port's kernel wrappers on one NVIDIA GPU.

    python3 scripts/probe_op_host_time.py [--calls 2000] [--repeats 5]

Times the public entry points the model calls, at the flagship's widths
and one sample, in float32 (FF: 4,096 rows, C 64, H 256, weights as the
model passes them; spectral mix: x [1, 64, 64, 64], 16 modes). Where the
card takes longer for a call than the host, the launch queue (about a
thousand launches) fills and the card's time is read instead: on an H100
the spectral forward (two launches a call) reads so.

- ``fused_ff`` and ``fused_mix_2d`` forward under ``torch.no_grad()`` (the
  rollout's and the serving artifact's call);
- forward with gradients on, then ``torch.autograd.grad`` (one train
  step's call of each kernel pair: forward and backward kernels).

For each, ``--calls`` calls are made back to back without a
synchronisation, after warm-up calls and a ``torch.cuda.synchronize()``;
the host's wall time and CPU time (``time.process_time``) of making them,
divided by the calls, is the host time per call (the CPU clock of a
shared host may tick in 10 ms steps: 2,000 calls resolve 5 us). Each of
``--repeats`` repeats prints one line. It uses only what the port's
``ops`` package offered since the training slice, so it runs unchanged
from the root of a checkout of an earlier commit (run it with that
directory as the working directory) for a comparison.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.getcwd() if os.path.exists("chip_smoke.py") else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fourierflow_tpu_torch.ops import _cuda, fused_ff, fused_mix_2d  # noqa: E402

ROWS, C, H, B, N, M = 64 * 64, 64, 256, 1, 64, 16


def host_us(fn, calls):
    """Host wall and CPU microseconds per call of ``calls`` calls of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(calls):
        fn()
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    torch.cuda.synchronize()
    return wall / calls * 1e6, cpu / calls * 1e6


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_op_host_time: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev)
    x = r(ROWS, C)
    ff_w = (r(H, C, scale=C ** -0.5).t(), r(H, scale=0.1), r(C, H, scale=H ** -0.5).t(),
            r(C, scale=0.1))
    xm = r(B, N, N, C)
    mix_w = (r(C, C, M, 2, scale=0.02), r(C, C, M, 2, scale=0.02))

    def forward(fn, *args):
        def run():
            with torch.no_grad():
                fn(*args)
        return run

    def train(fn, *args):
        leaves = [a.detach().requires_grad_() for a in args]
        go = torch.ones_like(fn(*leaves))
        return lambda: torch.autograd.grad(fn(*leaves), leaves, go)

    cases = {"fused_ff forward": forward(fused_ff, x, *ff_w),
             "fused_mix_2d forward": forward(fused_mix_2d, xm, *mix_w),
             "fused_ff forward+backward": train(fused_ff, x, *ff_w),
             "fused_mix_2d forward+backward": train(fused_mix_2d, xm, *mix_w)}
    results = {name: [] for name in cases}
    for repeat in range(args.repeats):
        for name, fn in cases.items():
            results[name].append(host_us(fn, args.calls))
        print(json.dumps({"repeat": repeat, **{k: [round(v, 2) for v in vs[-1]]
                                               for k, vs in results.items()}}), flush=True)
    for name, runs in results.items():
        wall = statistics.median(w for w, _ in runs)
        cpu = statistics.median(c for _, c in runs)
        print(f"{name}: host {wall:.2f} us/call wall, {cpu:.2f} us/call CPU (median of "
              f"{args.repeats} x {args.calls} calls); root {ROOT}", flush=True)


if __name__ == "__main__":
    main()
