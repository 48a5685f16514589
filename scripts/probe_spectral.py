"""Probe of the port's spectral-mix kernel (``spectral_axis_kernel``) on one NVIDIA GPU.

    python3 scripts/probe_spectral.py [--parent-source PATH]

Times one forward call of ``csrc/fused_spectral.cu`` (the Y launch, which
writes a float32 scratch, then the X launch, which adds it, as
``fused_mix_2d`` launches them) at the flagship shapes (x [19, 64, 64, 64],
16 modes, float32 mode weights) in f32 and bf16, and variants of the same
source with one part switched off, to see where the time goes. With
``--parent-source`` it also times another version of the source whole
(an earlier design, e.g. from a ``git archive`` of an older commit); the C
interface before and after the mode chunks' partial-sum
argument is told apart by the source. Each variant is its
source with textual changes, built by ``nvcc`` with the flags of
``ops/_cuda.py`` (all builds at once) and loaded with ctypes; the variants
are timed in turns in one process, by CUDA events around 30 back-to-back
calls after a warm-up, three rounds, median reported. Only the variants
``kernel`` and the ring variant compute the mix: the others are wrong
on purpose.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import B, M, N, log, mix_inputs, phase_device  # noqa: E402
from fourierflow_tpu_torch.ops import _cuda  # noqa: E402
from fourierflow_tpu_torch.ops.fused_spectral import _DTYPE_CODE  # noqa: E402
from fourierflow_tpu_torch.ops.spectral import stacked_bases  # noqa: E402

SOURCE = os.path.join(ROOT, "fourierflow_tpu_torch/csrc/fused_spectral.cu")

# name -> [(text in the source, replacement)]; each text must occur once.
# This design: x and the weights streamed through shared-memory rings, the
# modes walked in chunks (one chunk at the flagship).
VARIANTS = {
    "kernel": [],
    "no x staging": [("if (q < nq) {", "if (false) {")],
    "no forward product": [("if (tt < rows) {", "if (tt < 0) {")],
    "no weight staging": [("if (ch < nch) {", "if (false) {")],
    "no mix": [("if (ii >= ni) break;", "break;")],
    "no weight staging, no mix": [
        ("if (ch < nch) {", "if (false) {"),
        ("if (ii >= ni) break;", "break;")],
    "no inverse product": [("for (int m = 0; m < mc; ++m) {", "for (int m = 0; m < 0; ++m) {")],
    "no inverse, no store": [
        ("p.out[base[l] + (tc * SC + j) * p.elem_stride] = from_f<TO>(acc[l][j]);", ";")],
    # A deeper x ring in the same shared memory: more, smaller steps. (The
    # weight ring has two stages by design: the mix loop starts the next
    # chunk only.)
    "x ring of 4 stages of 4 samples": [("constexpr int TC = 8;", "constexpr int TC = 4;"),
                                        ("constexpr int XS = 2;", "constexpr int XS = 4;")],
}
# An earlier version of the source (e.g. the parent commit's), timed whole.
PARENT_VARIANTS = {"kernel": []}


def variant_sources(src, variants, tag):
    """{(tag, name): source text} with each variant's edits applied."""
    out = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{tag} variant {name!r}: {old!r} occurs {text.count(old)} times")
            text = text.replace(old, new)
        out[(tag, name)] = text
    return out


def build(sources, tmp):
    procs = {}
    for i, (key, text) in enumerate(sources.items()):
        cu, so = os.path.join(tmp, f"v{i}.cu"), os.path.join(tmp, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so, cu]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so, text)
    libs = {}
    for key, (proc, so, text) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key} failed to build:\n{out}")
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in out.splitlines() if "Used" in line and "registers" in line})
        log(f"build {key[0]} / {key[1]}: {', '.join(regs)}")
        lib = ctypes.CDLL(so)
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # Sources since the mode chunks take a partial-sum array after prev.
        takes_acc = "void* acc" in text
        lib.spectral_axis.argtypes = [i, i, i, vp, vp, vp, vp, ll, ll, ll, ll, i, vp,
                                      *([vp] if takes_acc else []), vp, i, i, ll, ll, ll, i, i,
                                      i, vp]
        lib.spectral_axis.restype = i
        libs[key] = (lib, takes_acc)
    return libs


def launcher(lib, takes_acc, dtype, dev):
    """One forward call: the Y launch writes an f32 scratch, the X launch adds it."""
    x, wy, wx = mix_inputs(B, N, N, M, dtype, dev, seed=0)
    b, sx, sy, c = x.shape
    fwd, inv = stacked_bases(N, M, dev)
    first = torch.empty(x.shape, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    code = _DTYPE_CODE[dtype]
    stream = _cuda.stream_ptr(dev)
    launches = []
    for w, lines, line_stride, elem_stride, prev, dst, out_code in (
            (wy, sx, sy * c, c, None, first, 0), (wx, sy, c, sy * c, first, out, code)):
        launches.append((code, 0, out_code, x.data_ptr(), fwd.data_ptr(), inv.data_ptr(),
                         w.data_ptr(), *w.stride(), 0, None if prev is None else prev.data_ptr(),
                         *([first.data_ptr()] if takes_acc else []), dst.data_ptr(), b * lines, lines, sx * sy * c, line_stride, elem_stride,
                         N, M, c, stream))

    def run():
        for args in launches:
            err = lib.spectral_axis(*args)
            if err:
                raise RuntimeError(f"spectral_axis: CUDA error {err}")
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent-source", help="another fused_spectral.cu to time beside this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_spectral: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    card = phase_device()
    sources = variant_sources(open(SOURCE).read(), VARIANTS, "this")
    if args.parent_source:
        sources.update(variant_sources(open(args.parent_source).read(), PARENT_VARIANTS, "parent"))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).replace("torch.", "")
            runs = {key: launcher(*lib, dtype, dev) for key, lib in libs.items()}
            times = {key: [] for key in runs}
            for _ in range(3):
                for key, fn in runs.items():
                    times[key].append(events_ms(fn))
            for (design, name), ts in times.items():
                log(f"spectral[{tag}] {design} / {name}: {statistics.median(ts):.4f} ms a call "
                    f"({' '.join(f'{t:.4f}' for t in ts)})")
    log(card)


if __name__ == "__main__":
    main()
