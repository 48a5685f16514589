"""Probe of the port's backward feed-forward kernel (``ff_bwd``) on one NVIDIA GPU.

    python3 scripts/probe_ff_bwd.py

Times ``csrc/fused_ff.cu::ff_bwd`` (main pass and reduction pass) at the
flagship shapes (rows 77,824, C 64, H 256, the weights as the model passes
them) in f32 and bf16, and variants of the same source with one part
switched off, to see where the time goes. Each variant is the source with
one textual change, built by ``nvcc`` with the flags of ``ops/_cuda.py``
(all builds at once) and loaded with ctypes; the variants are timed in
turns in one process, by CUDA events around 30 back-to-back launches after
a warm-up, three rounds, median reported. Only the variant ``kernel`` is
the kernel itself: the others compute wrong gradients on purpose. Also the
device time of the kernel itself by kernel name, from a profiler trace.
"""

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import ROWS, ff_bwd_inputs, log, phase_device  # noqa: E402
from fourierflow_tpu_torch.ops import _cuda  # noqa: E402
from fourierflow_tpu_torch.ops.fused_ff import _DTYPE_CODE, _sm_count  # noqa: E402

# name -> [(text in the source, replacement)]; each text must occur once.
VARIANTS = {
    "kernel": [],
    "no mask recompute": [("if (fabsf(pre[j][e]) < kMaskEps",
                           "if (false && fabsf(pre[j][e]) < kMaskEps")],
    "no |x| @ |W1| product (so no recompute)": [
        ("warp_mm<false, false>(xs, w1t, m0, n0, lane, pre, mag)",
         "warp_mm<false, false>(xs, w1t, m0, n0, lane, pre)")],
    "no column sums (db1, db2)": [("add_column_sums(s_b2, gs, cout);", ""),
                                  ("add_column_sums(s_b1 + h0, dhs, n_h);", "")],
    "no products 1-3": [
        ("warp_mm<false, false>(xs, w1t", "if (false) warp_mm<false, false>(xs, w1t"),
        ("warp_mm<false, true>(gs, w2t", "if (false) warp_mm<false, true>(gs, w2t"),
        ("warp_mm<false, true>(dhs, w1t", "if (false) warp_mm<false, true>(dhs, w1t")],
    "no products 4, 5 (dW1, dW2)": [
        ("warp_mm<true, true>(xs, dhs", "if (false) warp_mm<true, true>(xs, dhs"),
        ("warp_mm<true, true>(hs, gs", "if (false) warp_mm<true, true>(hs, gs")],
    "weights staged on the first tile only": [
        ("stage_tile(w1t, w1 +", "if (tile == blockIdx.x) stage_tile(w1t, w1 +"),
        ("stage_tile(w2t, w2 +", "if (tile == blockIdx.x) stage_tile(w2t, w2 +")],
    "x and g staged on the first tile only": [
        ("stage_tile(xs, x +", "if (tile == blockIdx.x) stage_tile(xs, x +"),
        ("stage_tile(gs, g +", "if (tile == blockIdx.x) stage_tile(gs, g +")],
}


def build_variants(tmp):
    src = open(os.path.join(ROOT, "fourierflow_tpu_torch/csrc/fused_ff.cu")).read()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"variant {name!r}: {old!r} occurs {text.count(old)} times")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed to build:\n{out}")
        regs = [line.strip() for line in out.splitlines() if "registers" in line]
        log(f"build {name}: {' | '.join(regs)}")
        lib = ctypes.CDLL(so)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ff_bwd.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, vp]
        lib.ff_bwd.restype = i
        libs[name] = lib
    return libs


def launcher(lib, dtype, dev):
    x, g, w1, b1, w2 = ff_bwd_inputs(ROWS, dtype, dev, seed=0)
    rows, cin, hidden, cout = ROWS, x.shape[1], w1.shape[1], w2.shape[1]
    n = cin * hidden + hidden + hidden * cout + cout
    blocks = min(-(-rows // 64), _sm_count(dev.index))
    dx, out = torch.empty_like(x), torch.empty(n, device=dev)
    partial = torch.empty(blocks, n, device=dev)
    stream = _cuda.stream_ptr(dev)
    args = (_DTYPE_CODE[dtype], x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), dx.data_ptr(), partial.data_ptr(), out.data_ptr(), rows, cin, hidden,
            cout, *w1.stride(), *w2.stride(), blocks, stream)

    def run():
        err = lib.ff_bwd(*args)
        if err:
            raise RuntimeError(f"ff_bwd: CUDA error {err}")
    return run


def events_ms(fn, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_by_name(fn, iters=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            key = ("reduce" if "reduce" in e.name else
                   "main" if "ff_bwd_kernel" in e.name else e.name)
            us, n = by_name.get(key, (0.0, 0))
            by_name[key] = (us + e.time_range.elapsed_us(), n + 1)
    return {k: (us / iters / 1e3, n // iters) for k, (us, n) in by_name.items()}


def main():
    if not torch.cuda.is_available():
        print("probe_ff_bwd: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    card = phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).replace("torch.", "")
            runs = {name: launcher(lib, dtype, dev) for name, lib in libs.items()}
            times = {name: [] for name in runs}
            for _ in range(3):
                for name, fn in runs.items():
                    times[name].append(events_ms(fn))
            for name, ts in times.items():
                log(f"ff_bwd[{tag}] {name}: {statistics.median(ts):.4f} ms "
                    f"({' '.join(f'{t:.4f}' for t in ts)})")
            parts = profile_by_name(runs["kernel"])
            log(f"ff_bwd[{tag}] kernel, device time by kernel (ms, launches per call): "
                + ", ".join(f"{k} {ms:.4f} ({n})" for k, (ms, n) in parts.items()))
    log(card)


if __name__ == "__main__":
    main()
