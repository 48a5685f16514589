"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each reporting on its own lines; every run goes through all six:

1. ``device``: the card's name and power limit (nvidia-smi), torch and CUDA versions.
2. ``build``: compile every CUDA source in ``csrc/``, all at once.
3. ``check``: each kernel against its plain PyTorch version at the flagship
   shapes, in float32 (TF32 off) and bf16, with the weights laid out as the
   model hands them over; with ragged rows (one row short of a whole tile,
   1037, 1 and 0), contiguous weights and a narrower shape for the
   feed-forward, and odd, non-square and Nyquist-mode grids, strided and
   bf16 mode weights, line counts that are not a multiple of the kernel's
   10 lines a block, above one round of blocks and below one block, for the
   spectral mix and its adjoint; two runs of each kernel at the flagship
   bit-identical; and the whole
   backward of each autograd Function (dx, dW, db) against
   ``torch.autograd.grad`` through its plain forward.
   The ``sass`` lines count the tensor-core instructions (HMMA) of the
   forward and backward feed-forward kernels in the built library
   (``cuobjdump``), hold the wrappers' shared-memory formulas to the
   kernels' and give the spectral kernel's registers and spills.
4. ``main`` (inference): a synthetic [38, 64, 64, 20] trajectory file made
   from the seed, the normalizer pass, a checkpoint, then the port's
   ``infer`` on the flagship config (24 layers, width 64) for a 10-step
   rollout at batch 19, with the launch counts read around it;
   ``valid_step`` on the same batch; and the model's kernel path against
   its plain path on a small input.
5. ``train``: the port's ``train`` on the flagship config at full width on
   the same synthetic file (the normalizer epoch, then one epoch of 18
   steps of batch 19, a validation rollout and the test pass), with the
   launch counts read around it; exactly 24 launches of each kernel in one
   train step; one train step's loss and every parameter gradient on the
   kernel path against the plain path (a float32 CPU copy); the time of a
   train step, and its device time by kernel group from a profiler trace.
6. ``time``: each kernel, its plain version and a PyTorch yardstick the port
   never calls, by their device time in a profiler trace (and the kernel's
   wall time back to back, between CUDA events); the least time the card
   could take and the kernel's time over it. It runs last, so that no
   profiler session precedes the timed rollout and train steps.

Prints a JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; it
exits non-zero without printing a result when CUDA is unavailable.
"""

import argparse
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fourierflow_tpu_torch.commands import infer, train  # noqa: E402
from fourierflow_tpu_torch.commands.train import build_routine  # noqa: E402
from fourierflow_tpu_torch.config import instantiate, load_config  # noqa: E402
from fourierflow_tpu_torch.ops import (  # noqa: E402
    _cuda, fused_ff, fused_ff_bwd, fused_mix_2d, launch_counts, reset_launch_counts)
from fourierflow_tpu_torch.ops.fused_ff import (  # noqa: E402
    _DTYPE_CODE, _bwd_smem_bytes, _fwd_smem_bytes, _lib, fused_ff_bwd_cuda, fused_ff_bwd_plain,
    fused_ff_cuda, fused_ff_plain)
from fourierflow_tpu_torch.ops.fused_spectral import (  # noqa: E402
    _lib as _spectral_lib, _smem_bytes as _mix_smem_bytes, fused_mix_2d_adjoint_cuda,
    fused_mix_2d_adjoint_plain, fused_mix_2d_cuda, fused_mix_2d_plain)
from fourierflow_tpu_torch.utils.checkpoint import save_state  # noqa: E402

CONFIG = "configs/torus_li/markov/24_layers.yaml"
N_STEPS = 10
N_LAYERS = 24
# Flagship shapes: batch 19 on a 64x64 grid, width 64, hidden 256, 16 modes.
B, N, C, H, M = 19, 64, 64, 256, 16
ROWS = B * N * N
# H100 SXM data sheet: HBM 3.35 TB/s; 989 TFLOP/s bf16 and 495 TFLOP/s TF32 dense. The
# float32 peak is that of work done to f32 accuracy on the tensor cores: three TF32
# products (3xTF32) per f32 product, so 495/3 TFLOP/s.
MEM_RATE = 3.35e12
PEAK = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # max |err| / max |ref|
DTYPES = (torch.float32, torch.bfloat16)
# Kernel, source, the TPU kernel it replaces, and the main path whose launch
# count the kernel line reports.
KERNELS = {
    "fused_ff": dict(source="fourierflow_tpu_torch/csrc/fused_ff.cu",
                     replaces="fourierflow_tpu/ops/pallas_ff.py:39", path="infer"),
    "fused_ff_bwd": dict(source="fourierflow_tpu_torch/csrc/fused_ff.cu",
                         replaces="fourierflow_tpu/ops/pallas_ff.py:76", path="train"),
    "fused_mix_2d": dict(source="fourierflow_tpu_torch/csrc/fused_spectral.cu",
                         replaces="fourierflow_tpu/ops/pallas_spectral.py:83", path="infer"),
    "fused_mix_2d_adjoint": dict(source="fourierflow_tpu_torch/csrc/fused_spectral.cu",
                                 replaces="fourierflow_tpu/ops/pallas_spectral.py:83 "
                                          "(second launch, _fused_mix_bwd :191)", path="train"),
}
TRAIN_TOL = 1e-3  # train step, kernel path vs plain path: max |err| / max |ref|, per tensor
# The forward FF kernel's rows per block and round (8 warps of 32 bf16 rows; a
# multiple of the f32 warp's 16, and of the backward kernel's 64-row tile),
# and a narrower shape than the flagship's that both FF kernels take.
FF_TILE_ROWS = 256
FF_NARROW = dict(cin=32, hidden=128, cout=40)
# Spectral-mix grids (batch, X, Y, modes) and weight options checked on the
# card: the flagship (1,216 lines an axis launch: 122 blocks of 10 lines, one
# round on 132 SMs); odd, non-square and Nyquist-mode grids; strided weights
# (copied to contiguous runs by the wrapper); 1,472 lines, not a multiple of
# the kernel's 10 lines a block and more than one round; 7 and 9 lines, less
# than one block; 20 channels (bf16 rows of x then are not 16-byte pieces).
MIX_CASES = (((B, N, N, M), {}), ((2, 63, 65, M), {}), ((2, 32, 32, 17), {}),
             ((3, 48, 40, 12), dict(strided=True)), ((23, N, N, M), {}), ((1, 7, 9, 4), {}),
             ((2, 24, 20, 6), dict(c=20)))
MIX_BF16_CASES = (((2, 40, 48, 12), dict(w_dtype=torch.bfloat16)),)


def log(*args):
    print(*args, flush=True)


# --- inputs ----------------------------------------------------------------
def ff_inputs(rows, dtype, dev, seed, model_layout=True, cin=C, hidden=H, cout=C):
    """x, w1 [C_in, H], b1, w2 [H, C_out], b2. With ``model_layout`` the weights
    are transposed views of torch's [out, in] tensors, as ``FeedForward`` passes them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev, dtype)
    x, b1, b2 = r(rows, cin), r(hidden, scale=0.1), r(cout, scale=0.1)
    if model_layout:
        return (x, r(hidden, cin, scale=cin ** -0.5).t(), b1,
                r(cout, hidden, scale=hidden ** -0.5).t(), b2)
    return x, r(cin, hidden, scale=cin ** -0.5), b1, r(hidden, cout, scale=hidden ** -0.5), b2


def mix_inputs(b, sx, sy, modes, dtype, dev, seed, w_dtype=torch.float32, strided=False, c=C):
    """x and two [C, C, M, 2] mode weights: float32 parameters as the model
    holds them, or ``w_dtype``; ``strided`` makes them non-contiguous views."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, sx, sy, c, generator=g).to(dev, dtype)
    scale = (2.0 / (2 * c * modes * 2)) ** 0.5
    if strided:
        w = lambda: (torch.randn(modes, 2, c, c, generator=g) * scale).to(dev, w_dtype).permute(2, 3, 0, 1)
    else:
        w = lambda: (torch.randn(c, c, modes, 2, generator=g) * scale).to(dev, w_dtype)
    return x, w(), w()


def rel_err(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def compare(name, got, want, tol):
    """Tensor or tuple of tensors against the reference; returns the
    largest max |err|. An empty reference must be matched by an empty or
    all-zero result."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    errs, rels = [], []
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if a.shape != b.shape:
            raise AssertionError(f"{name}[{i}]: shape {tuple(a.shape)} != {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}[{i}]: non-finite output")
        err, rel = rel_err(a, b) if b.numel() else (0.0, 0.0)
        errs.append(err)
        rels.append(rel)
    ok = max(rels) <= tol
    log(f"check {name}: max_abs_err {max(errs):.3e} rel {' '.join(f'{r:.2e}' for r in rels)} "
        f"tol {tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: relative error {max(rels):.3e} above {tol:.0e}")
    return max(errs)


def check(name, fn, plain, args, dtype):
    got = fn(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    torch.cuda.synchronize()
    return compare(name, got, want, TOL[dtype])


def check_function(name, fn, plain, args, dtype, seed):
    """The whole backward of an autograd Function on the card against
    ``torch.autograd.grad`` through its plain forward, for every input."""
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    leaves = lambda: [a.detach().requires_grad_() for a in args]
    ins = leaves()
    out = fn(*ins)
    go = torch.randn(out.shape, generator=g).to(out.device, out.dtype)
    got = torch.autograd.grad(out, ins, go)
    ref = leaves()
    want = torch.autograd.grad(plain(*ref), ref, go)
    torch.cuda.synchronize()
    return compare(f"{name} backward (all inputs)", got, want, TOL[dtype])


def cuda_ms(fn, iters=20, warmup=3):
    """Wall time per call of back-to-back calls, between CUDA events: the
    device time, or the host's time per call where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Device time per call: the summed durations of the kernels and copies
    that ``iters`` calls ran on the card, from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    if us <= 0:
        raise AssertionError("time: the profiler saw no device time")
    return us / iters / 1e3


def bound(flops, nbytes, dtype):
    t_ops, t_mem = flops / PEAK[dtype], nbytes / MEM_RATE
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


# --- phases ------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    t0 = time.perf_counter()
    seconds = _cuda.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
        f"wall {time.perf_counter() - t0:.2f} s")
    for name, text in _cuda.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"ptxas {name}: {line.strip()}")


def ptxas_report(log, kernel):
    """{instance: (registers, spill stores, spill loads)} of every entry
    function whose name holds ``kernel``, from a ``-Xptxas -v`` log."""
    report, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and "spill stores" in line:
            words = line.split()
            spills = (int(words[words.index("spill") - 2]), int(words[-4]))
        elif name and "Used" in line and "registers" in line:
            words = line.split()
            report[name] = (int(words[words.index("registers,") - 1]), *spills)
            name = None
    # Template arguments of each instance, demangled where c++filt is found.
    tool, names = shutil.which("c++filt"), list(report)
    if tool:
        names = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                               check=True, timeout=60).stdout.splitlines()
    short = lambda s: s.split(kernel)[-1].split(">(")[0].lstrip("<").replace("__nv_bfloat16", "bf16")
    return {short(s): v for s, v in zip(names, report.values(), strict=True)}


def phase_sass():
    """Tensor-core (HMMA) and CUDA-core FMA (FFMA) instructions in each
    instantiation of the forward and backward FF kernels, from
    ``cuobjdump --dump-sass`` of the built library; fails if one has no
    HMMA. Also holds the wrapper's shared-memory formulas to the kernels',
    and prints the spectral kernel's registers and spills."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    lib = _cuda._lib_path("fused_ff")
    out = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if "ff_fwd_kernel" in name or "ff_bwd_kernel" in name:
                counts[name] = {"HMMA": 0, "FFMA": 0}
        elif name in counts:
            for op in counts[name]:
                counts[name][op] += f" {op}." in line or f" {op} " in line
    log(f"sass ff_fwd_kernel, ff_bwd_kernel: {json.dumps(counts)}")
    if len(counts) != 4 or not all(c["HMMA"] > 0 for c in counts.values()):
        raise AssertionError(f"sass: an FF kernel lacks tensor-core instructions {counts}")
    for dtype, code in _DTYPE_CODE.items():
        for hidden, cout in ((H, C), (FF_NARROW["hidden"], FF_NARROW["cout"])):
            sizes = ((_fwd_smem_bytes(hidden, cout, dtype),
                      _lib().ff_fwd_smem_bytes(code, hidden, cout)),
                     (_bwd_smem_bytes(hidden, dtype), _lib().ff_bwd_smem_bytes(code, hidden)))
            for kernel, (got, want) in zip(("forward", "backward"), sizes):
                if got != want:
                    raise AssertionError(f"fused_ff {kernel}: the wrapper's shared-memory size for "
                                         f"{dtype}, H {hidden} is {got}, the kernel's {want}")
    wtypes = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16))
    for (_, sx, sy, modes), opts in MIX_CASES + MIX_BF16_CASES:
        c = opts.get("c", C)
        for n in (sx, sy):
            for xt, wt in wtypes:
                got = _mix_smem_bytes(n, modes, c, xt, wt)
                want = _spectral_lib().spectral_axis_smem_bytes(
                    _DTYPE_CODE[xt], _DTYPE_CODE[wt], n, modes, c)
                if got != want:
                    raise AssertionError(f"fused_mix_2d: the wrapper's shared-memory size at n {n}, "
                                         f"M {modes}, {xt}/{wt} is {got}, the kernel's {want}")
    log(f"sass fused_mix_2d: shared memory at the flagship {_mix_smem_bytes(N, M, C, *wtypes[0])} "
        f"B (f32), {_mix_smem_bytes(N, M, C, *wtypes[1])} B (bf16 x); the wrapper's formula "
        f"holds at every checked shape")
    if "fused_spectral" in _cuda.build_logs:
        report = ptxas_report(_cuda.build_logs["fused_spectral"], "spectral_axis_kernel")
        log(f"ptxas spectral_axis_kernel (registers, spill stores, spill loads): "
            f"{json.dumps(report)}")


def ff_bwd_inputs(rows, dtype, dev, seed, model_layout=True, **widths):
    """x, g, w1, b1, w2 for the feed-forward's backward."""
    x, w1, b1, w2, _ = ff_inputs(rows, dtype, dev, seed, model_layout, **widths)
    g = torch.randn(rows, w2.shape[1], generator=torch.Generator().manual_seed(seed + 2))
    return x, g.to(dev, dtype), w1, b1, w2


def phase_check(dev, seed):
    errs = {}
    for dtype in DTYPES:
        tag = str(dtype).replace("torch.", "")
        for rows, model_layout, widths in ((ROWS, True, {}), (1000 + 37, False, {}),
                                           (FF_TILE_ROWS * 50 - 1, True, {}), (1, True, {}),
                                           (0, True, {}), (999, True, FF_NARROW)):
            before = fused_ff.launches
            e = check(f"fused_ff[{tag}, rows {rows}, {'model' if model_layout else 'contiguous'} "
                      f"weights{', ' + str(widths) if widths else ''}]", fused_ff_cuda,
                      fused_ff_plain, ff_inputs(rows, dtype, dev, seed, model_layout, **widths),
                      dtype)
            if rows == ROWS:
                errs[("fused_ff", dtype)] = e
            if (fused_ff.launches - before) != (rows > 0):
                raise AssertionError(f"fused_ff: {fused_ff.launches - before} launches for "
                                     f"{rows} rows")
        for rows, model_layout, widths in ((ROWS, True, {}), (1000 + 37, False, {}),
                                           (FF_TILE_ROWS * 50 - 1, True, {}), (1, True, {}),
                                           (0, True, {}), (999, True, FF_NARROW)):
            args = ff_bwd_inputs(rows, dtype, dev, seed, model_layout, **widths)
            before = fused_ff_bwd.launches
            e = check(f"fused_ff_bwd[{tag}, rows {rows}, "
                      f"{'model' if model_layout else 'contiguous'} weights"
                      f"{', ' + str(widths) if widths else ''}]",
                      fused_ff_bwd_cuda, fused_ff_bwd_plain, args, dtype)
            if rows == ROWS:
                errs[("fused_ff_bwd", dtype)] = e
                again = fused_ff_bwd_cuda(*args)
                first = fused_ff_bwd_cuda(*args)
                if not all(torch.equal(a, b) for a, b in zip(again, first)):
                    raise AssertionError("fused_ff_bwd: two runs on one input differ")
                log(f"check fused_ff_bwd[{tag}]: bit-identical in two runs")
            if rows == 0 and fused_ff_bwd.launches != before:
                raise AssertionError("fused_ff_bwd launched a kernel for 0 rows")
        check_function(f"fused_ff[{tag}, rows 1037, model weights]", fused_ff, fused_ff_plain,
                       ff_inputs(1000 + 37, dtype, dev, seed), dtype, seed)
        cases = MIX_CASES + (MIX_BF16_CASES if dtype == torch.bfloat16 else ())
        for (b, sx, sy, modes), opts in cases:
            what = f"[{tag}, {b}x{sx}x{sy}x{opts.get('c', C)}, M {modes}, {opts or 'f32 weights'}]"
            args = mix_inputs(b, sx, sy, modes, dtype, dev, seed, **opts)
            e = check(f"fused_mix_2d{what}", fused_mix_2d_cuda, fused_mix_2d_plain, args, dtype)
            e_adj = check(f"fused_mix_2d_adjoint{what}", fused_mix_2d_adjoint_cuda,
                          fused_mix_2d_adjoint_plain, args, dtype)
            if (b, sx, sy) == (B, N, N):
                errs[("fused_mix_2d", dtype)] = e
                errs[("fused_mix_2d_adjoint", dtype)] = e_adj
                for name, fn in (("fused_mix_2d", fused_mix_2d_cuda),
                                 ("fused_mix_2d_adjoint", fused_mix_2d_adjoint_cuda)):
                    if not torch.equal(fn(*args), fn(*args)):
                        raise AssertionError(f"{name}: two runs on one input differ")
                log(f"check fused_mix_2d, fused_mix_2d_adjoint[{tag}]: bit-identical in two runs")
        check_function(f"fused_mix_2d[{tag}, 2x63x65x{C}, M {M}]", fused_mix_2d,
                       fused_mix_2d_plain, mix_inputs(2, 63, 65, M, dtype, dev, seed), dtype, seed)
    return errs


def _library_ff(x, w1, b1, w2, b2):
    w1t, w2t = w1.t(), w2.t()  # torch's [out, in] tensors
    return lambda: F.linear(torch.relu(F.linear(x, w1t, b1)), w2t, b2)


def _library_mix(x, wy, wx):
    xf = x.float()
    cw = lambda w: torch.view_as_complex(w.float().contiguous())  # [Ci, Co, M]

    def branch(w, dim):
        n = xf.shape[dim]
        s = torch.fft.rfft(xf, dim=dim, norm="ortho").narrow(dim, 0, w.shape[2])
        s = s.movedim(dim, -2)                       # [..., M, Ci]
        y = torch.einsum("...mi,iom->...mo", s, cw(w))
        return torch.fft.irfft(y, n=n, dim=-2, norm="ortho").movedim(-2, dim)

    return lambda: branch(wy, 2) + branch(wx, 1)


def _library_ff_bwd(x, g, w1, b1, w2):
    """The unfused backward of the JAX package's ``_ff_bwd`` (its five
    products), in the input type."""
    def run():
        pre = torch.addmm(b1, x, w1)
        dh = (g @ w2.t()) * (pre > 0)
        return dh @ w1.t(), x.t() @ dh, dh.sum(0), torch.relu(pre).t() @ g, g.sum(0)

    return run


def _library_mix_adjoint(x, wy, wx):
    """Autograd's gradient with respect to x through the rfft/irfft
    yardstick of the forward (the backward alone is timed)."""
    xg = x.detach().requires_grad_()
    y = _library_mix(xg, wy, wx)()
    g = torch.randn_like(y)
    return lambda: torch.autograd.grad(y, xg, g, retain_graph=True)


def timed(kernel, plain, library, flops, nbytes, dtype):
    """Device times of a kernel, its plain version and its library
    yardstick; the kernel's wall time back to back; the bound."""
    return dict(ms=device_ms(kernel), wall_ms=cuda_ms(kernel), plain_ms=device_ms(plain),
                library_ms=device_ms(library), bound=bound(flops, nbytes, dtype))


def phase_time(dev, seed):
    rows = {}
    for dtype in DTYPES:
        isz = torch.tensor([], dtype=dtype).element_size()
        args = ff_inputs(ROWS, dtype, dev, seed)
        flops = 2 * ROWS * (C * H + H * C)
        nbytes = (2 * ROWS * C + C * H + H + H * C + C) * isz
        rows[("fused_ff", dtype)] = timed(
            lambda: fused_ff_cuda(*args), lambda: fused_ff_plain(*args), _library_ff(*args),
            flops, nbytes, dtype)
        bargs = ff_bwd_inputs(ROWS, dtype, dev, seed)
        flops = 10 * ROWS * C * H
        nbytes = 3 * ROWS * C * isz + (2 * C * H + H) * isz + (2 * C * H + H + C) * 4
        rows[("fused_ff_bwd", dtype)] = timed(
            lambda: fused_ff_bwd_cuda(*bargs), lambda: fused_ff_bwd_plain(*bargs),
            _library_ff_bwd(*bargs), flops, nbytes, dtype)
        x, wy, wx = mix_inputs(B, N, N, M, dtype, dev, seed)
        flops = B * 2 * (N * 2 * M * N * C + 4 * M * N * C * C + N * N * 2 * M * C) * 2
        nbytes = 2 * x.numel() * isz + (wy.numel() + wx.numel()) * wy.element_size()
        rows[("fused_mix_2d", dtype)] = timed(
            lambda: fused_mix_2d_cuda(x, wy, wx), lambda: fused_mix_2d_plain(x, wy, wx),
            _library_mix(x, wy, wx), flops, nbytes, dtype)
        rows[("fused_mix_2d_adjoint", dtype)] = timed(
            lambda: fused_mix_2d_adjoint_cuda(x, wy, wx),
            lambda: fused_mix_2d_adjoint_plain(x, wy, wx), _library_mix_adjoint(x, wy, wx),
            flops, nbytes, dtype)
    for (name, dtype), r in rows.items():
        log(f"time {name}[{str(dtype).replace('torch.', '')}]: kernel {r['ms']:.4f} ms "
            f"(back to back {r['wall_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"ms/bound {r['ms'] / r['bound'][0]:.2f}")
    return rows


def synthetic_trajectories(path, seed, b=2 * B, n=N, t=20):
    """Smooth random vorticity-like fields with drifting phases, unit std."""
    rs = np.random.RandomState(seed)
    k = np.fft.fftfreq(n) * n
    kx, ky = np.meshgrid(k, k[: n // 2 + 1], indexing="ij")
    amp = np.exp(-(kx ** 2 + ky ** 2) / (2 * 4.0 ** 2))
    coef = (rs.randn(b, n, n // 2 + 1) + 1j * rs.randn(b, n, n // 2 + 1)) * amp
    omega = 0.3 * rs.randn(n, n // 2 + 1)
    w = np.stack([np.fft.irfft2(coef * np.exp(1j * omega * s), s=(n, n)) for s in range(t)], -1)
    w = (w / w.std()).astype(np.float32)
    np.save(path, w)
    return w.shape


def phase_main(dev, seed):
    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "trajectories.npy")
        log(f"main: synthetic data {synthetic_trajectories(data_path, seed)}")
        overrides = [f"builder.data_path={data_path}", f"builder.train_size={B}",
                     f"builder.test_size={B}"]
        cfg = load_config(CONFIG, overrides)
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"])
        state = routine.init(7231, builder.sample_batch(), dev)
        for batch in builder.train_batches(rng=np.random.default_rng(seed)):
            state = routine.accumulate_step(state, batch)
        ckpt = os.path.join(tmp, "state.pt")
        save_state(ckpt, state)

        reset_launch_counts()
        run = infer.main(CONFIG, ckpt, overrides=overrides, n_steps=N_STEPS, device="cuda")
        counts = launch_counts()
    res = run.result
    preds = res["preds"]
    if tuple(preds.shape) != (B, N, N, N_STEPS) or not torch.isfinite(preds).all():
        raise AssertionError(f"main: rollout output {tuple(preds.shape)} not finite/expected")
    for name, n in res["kernel_launches"].items():
        want = N_LAYERS * N_STEPS if KERNELS[name]["path"] == "infer" else 0
        if n != want:
            raise AssertionError(f"main: {name} launched {n} times in the timed rollout, "
                                 f"expected {want}")
    for name, n in counts.items():
        if KERNELS[name]["path"] == "infer" and n < 1:
            raise AssertionError(f"main: {name} was never launched on the main path")
    log(f"main: launches over infer (warm-up + timed) {counts}, timed {res['kernel_launches']}")

    metrics = run.routine.valid_step(run.state, run.batch)
    scalars = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
    if not all(math.isfinite(v) for v in scalars.values()) or not all(
            torch.isfinite(v).all() for v in metrics.values()):
        raise AssertionError(f"main: non-finite metrics {scalars}")
    log(f"main: valid_step {json.dumps(scalars)}")
    log(f"main: rollout {res['elapsed'] / N_STEPS * 1e3:.3f} ms/step, "
        f"{res['inference_time']:.6e} s/sample/sim-second, elapsed {res['elapsed']:.4f} s")

    # The model's kernel path against its plain path (CPU copy) on a small input.
    model = run.state.model
    x = torch.randn(2, N, N, 3, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        got = model(x.to(dev))["forecast"].cpu()
        want = copy.deepcopy(model).cpu()(x)["forecast"]
    err, rel = rel_err(got, want)
    log(f"main: model kernel path vs plain path max_abs_err {err:.3e} rel {rel:.3e} tol 1e-3")
    if not rel <= 1e-3:
        raise AssertionError(f"main: model disagrees with its plain path (rel {rel:.3e})")
    return counts


def phase_train(dev, seed):
    """The port's ``train`` on the flagship at full width, then one train
    step counted, checked against its plain path, and timed."""
    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "trajectories.npy")
        synthetic_trajectories(data_path, seed)
        overrides = [f"builder.data_path={data_path}", f"builder.train_size={B}",
                     f"builder.test_size={B}", "trainer.max_epochs=2"]
        reset_launch_counts()
        trainer, state = train.main(CONFIG, overrides, config_dir=tmp, device="cuda")
        counts = launch_counts()
        run_dir = next(os.scandir(os.path.join(tmp, "checkpoints"))).path
        written = sorted(os.listdir(run_dir))
        cfg = load_config(CONFIG, overrides)
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"])
        start = routine.init(7231, builder.sample_batch(), dev)  # train.main's seed, trial 0
    logs = trainer.logs
    log(f"train: {trainer.global_step} steps in {logs['epoch'] + 1} epochs, wrote {written}, "
        f"launches over train {counts}")
    if trainer.global_step != 18 or "last.ckpt" not in written or "metrics.jsonl" not in written:
        raise AssertionError(f"train: {trainer.global_step} steps, files {written}")
    losses = {k: float(v) for k, v in logs.items() if k.endswith("loss") or k.endswith("loss_avg")}
    log(f"train: {json.dumps(losses)}, epoch_time {logs['epoch_time']:.3f} s")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"train: non-finite losses {losses}")
    moved = max((a - b).abs().max().item() for a, b in zip(
        state.model.parameters(), start.model.parameters(), strict=True))
    log(f"train: largest parameter change from the initial weights {moved:.3e}")
    if not moved > 0:
        raise AssertionError("train: the parameters did not move")
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"train: {name} was never launched on the main path")

    batch = next(builder.train_batches(np.random.default_rng(seed)))
    reset_launch_counts()
    state, _ = routine.train_step(state, batch, trainer.step_generator(dev))
    torch.cuda.synchronize()
    step_counts = launch_counts()
    log(f"train: launches in one train step {step_counts}")
    if any(n != N_LAYERS for n in step_counts.values()):
        raise AssertionError(f"train: expected {N_LAYERS} launches of each kernel per step")

    gen = trainer.step_generator(dev)
    for _ in range(3):
        state, _ = routine.train_step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, metrics = routine.train_step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    if not math.isfinite(float(metrics["train_loss"])):
        raise AssertionError("train: non-finite loss in the timed steps")
    log(f"train: {step_ms:.3f} ms per train step (batch {B}, f32, mean of 10 after 3 warm-ups)")
    profile_train_step(routine, state, batch, gen, step_ms)

    # One step from one state, on the kernel path and on the plain path (a
    # float32 CPU copy), without noise: loss and every parameter gradient.
    norm = state.normalizer
    plain = dataclasses.replace(state, model=copy.deepcopy(state.model).cpu(), normalizer=(
        dataclasses.replace(norm, sum=norm.sum.cpu(), sum_squared=norm.sum_squared.cpu(),
                            count=norm.count.cpu(), n_accumulations=norm.n_accumulations.cpu())))
    quiet = copy.copy(routine)
    quiet.noise_std = 0.0
    loss, grads, _ = quiet.loss_and_grads(state, batch)
    want_loss, want_grads, _ = quiet.loss_and_grads(plain, batch)
    names = [n for n, _ in state.model.named_parameters()]
    rels = {n: rel_err(a, b)[1] for n, a, b in zip(names, grads, want_grads, strict=True)}
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    worst = max(rels, key=rels.get)
    log(f"train: step on the kernel path vs plain path: loss {float(loss):.6f} vs "
        f"{float(want_loss):.6f} (rel {loss_rel:.2e}); gradients of {len(rels)} parameters, "
        f"largest rel {rels[worst]:.2e} ({worst}), tol {TRAIN_TOL:.0e}")
    if not (loss_rel <= TRAIN_TOL and rels[worst] <= TRAIN_TOL):
        raise AssertionError("train: kernel path disagrees with the plain path")
    return counts


# Device-time groups of a train step, by kernel name.
STEP_GROUPS = (("spectral kernel (forward + adjoint)", ("spectral_axis_kernel",)),
               ("FF backward kernel", ("ff_bwd",)), ("FF forward kernel", ("ff_fwd_kernel",)),
               ("cuBLAS GEMM (weight gradients, projections)", ("gemm", "gemv", "xmma")))


def profile_train_step(routine, state, batch, gen, step_ms, steps=2):
    """Device time of a train step by kernel group, from a torch.profiler
    trace of ``steps`` steps; the idle share is taken against the untraced
    step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = routine.train_step(state, batch, gen)
        torch.cuda.synchronize()
    groups = {name: 0.0 for name, _ in STEP_GROUPS}
    other, by_name = "other (elementwise, reductions, copies, AdamW)", {}
    groups[other] = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us() / steps, n + 1)
    for name, (us, _) in by_name.items():
        groups[next((g for g, keys in STEP_GROUPS if any(k in name for k in keys)), other)] += us
    device_ms = sum(groups.values()) / 1e3
    launches = sum(n for _, n in by_name.values()) // steps
    log(f"train: traced device time {device_ms:.3f} ms per step in {launches} device "
        f"operations; idle {max(0.0, 1 - device_ms / step_ms):.1%} of the {step_ms:.3f} ms step")
    for name, us in groups.items():
        log(f"train:   {us / 1e3:8.3f} ms  {name}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"train:   top {us / 1e3:8.3f} ms  {n // steps:4d}x  {name[:90]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = phase_device()
    phase_build()
    phase_sass()
    errs = phase_check(dev, args.seed)
    counts = {"infer": phase_main(dev, args.seed), "train": phase_train(dev, args.seed)}
    times = phase_time(dev, args.seed)

    kernels = []
    for name, meta in KERNELS.items():
        t = times[(name, torch.float32)]
        kernels.append({"name": name, "route": "cuda", "source": meta["source"],
                        "replaces": meta["replaces"], "launches": counts[meta["path"]][name],
                        "launches_by_path": {p: c[name] for p, c in counts.items()},
                        "max_abs_err": errs[(name, torch.float32)],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                        "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
