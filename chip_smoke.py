"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each reporting on its own lines; every run goes through all five:

1. ``device``: the card's name and power limit (nvidia-smi), torch and CUDA versions.
2. ``build``: compile every CUDA kernel of the rollout path from ``csrc/``.
3. ``check``: each kernel against its plain PyTorch version at the flagship
   shapes, in float32 (TF32 off) and bf16, with the weights laid out as the
   model hands them over; with ragged rows and contiguous weights for the
   feed-forward, and odd, non-square and Nyquist-mode grids, strided and
   bf16 mode weights for the spectral mix.
4. ``time``: each kernel, its plain version and a PyTorch yardstick the port
   never calls, timed with CUDA events; the least time the card could take.
5. ``main``: a synthetic [38, 64, 64, 20] trajectory file made from the seed,
   the normalizer pass, a checkpoint, then the port's ``infer`` on the
   flagship config (24 layers, width 64) for a 10-step rollout at batch 19,
   with the launch counts read around it; ``valid_step`` on the same batch;
   and the model's kernel path against its plain path on a small input.

Prints a JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; it
exits non-zero without printing a result when CUDA is unavailable.
"""

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fourierflow_tpu_torch.commands import infer  # noqa: E402
from fourierflow_tpu_torch.commands.train import build_routine  # noqa: E402
from fourierflow_tpu_torch.config import instantiate, load_config  # noqa: E402
from fourierflow_tpu_torch.ops import _cuda, launch_counts, reset_launch_counts  # noqa: E402
from fourierflow_tpu_torch.ops.fused_ff import fused_ff_cuda, fused_ff_plain  # noqa: E402
from fourierflow_tpu_torch.ops.fused_spectral import fused_mix_2d_cuda, fused_mix_2d_plain  # noqa: E402
from fourierflow_tpu_torch.utils.checkpoint import save_state  # noqa: E402

CONFIG = "configs/torus_li/markov/24_layers.yaml"
N_STEPS = 10
N_LAYERS = 24
# Flagship shapes: batch 19 on a 64x64 grid, width 64, hidden 256, 16 modes.
B, N, C, H, M = 19, 64, 64, 256, 16
ROWS = B * N * N
# H100 SXM data sheet: HBM 3.35 TB/s; 67 TFLOP/s f32 (CUDA cores); 989 TFLOP/s bf16 dense.
MEM_RATE = 3.35e12
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # max |err| / max |ref|
DTYPES = (torch.float32, torch.bfloat16)
KERNELS = {
    "fused_ff": dict(source="fourierflow_tpu_torch/csrc/fused_ff.cu",
                     replaces="fourierflow_tpu/ops/pallas_ff.py:39"),
    "fused_mix_2d": dict(source="fourierflow_tpu_torch/csrc/fused_spectral.cu",
                         replaces="fourierflow_tpu/ops/pallas_spectral.py:83"),
}


def log(*args):
    print(*args, flush=True)


# --- inputs ----------------------------------------------------------------
def ff_inputs(rows, dtype, dev, seed, model_layout=True):
    """x, w1 [C, H], b1, w2 [H, C], b2. With ``model_layout`` the weights are
    transposed views of torch's [out, in] tensors, as ``FeedForward`` passes them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev, dtype)
    x, b1, b2 = r(rows, C), r(H, scale=0.1), r(C, scale=0.1)
    if model_layout:
        return x, r(H, C, scale=C ** -0.5).t(), b1, r(C, H, scale=H ** -0.5).t(), b2
    return x, r(C, H, scale=C ** -0.5), b1, r(H, C, scale=H ** -0.5), b2


def mix_inputs(b, sx, sy, modes, dtype, dev, seed, w_dtype=torch.float32, strided=False):
    """x and two [C, C, M, 2] mode weights: float32 parameters as the model
    holds them, or ``w_dtype``; ``strided`` makes them non-contiguous views."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, sx, sy, C, generator=g).to(dev, dtype)
    scale = (2.0 / (2 * C * modes * 2)) ** 0.5
    if strided:
        w = lambda: (torch.randn(modes, 2, C, C, generator=g) * scale).to(dev, w_dtype).permute(2, 3, 0, 1)
    else:
        w = lambda: (torch.randn(C, C, modes, 2, generator=g) * scale).to(dev, w_dtype)
    return x, w(), w()


def rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check(name, fn, plain, args, dtype):
    got = fn(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err, rel = rel_err(got, want)
    ok = rel <= TOL[dtype]
    log(f"check {name}: max_abs_err {err:.3e} rel {rel:.3e} tol {TOL[dtype]:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: relative error {rel:.3e} above {TOL[dtype]:.0e}")
    return err


def cuda_ms(fn, iters=20, warmup=3):
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


def phase_check(dev, seed):
    errs = {}
    for dtype in DTYPES:
        tag = str(dtype).replace("torch.", "")
        for rows, model_layout in ((ROWS, True), (1000 + 37, False)):
            e = check(f"fused_ff[{tag}, rows {rows}, {'model' if model_layout else 'contiguous'} "
                      f"weights]", fused_ff_cuda, fused_ff_plain,
                      ff_inputs(rows, dtype, dev, seed, model_layout), dtype)
            if rows == ROWS:
                errs[("fused_ff", dtype)] = e
        cases = [((B, N, N, M), {}), ((2, 63, 65, M), {}), ((2, 32, 32, 17), {}),
                 ((3, 48, 40, 12), dict(strided=True))]
        if dtype == torch.bfloat16:
            cases.append(((2, 40, 48, 12), dict(w_dtype=dtype)))
        for (b, sx, sy, modes), opts in cases:
            e = check(f"fused_mix_2d[{tag}, {b}x{sx}x{sy}x{C}, M {modes}, {opts or 'f32 weights'}]",
                      fused_mix_2d_cuda, fused_mix_2d_plain,
                      mix_inputs(b, sx, sy, modes, dtype, dev, seed, **opts), dtype)
            if (b, sx, sy) == (B, N, N):
                errs[("fused_mix_2d", dtype)] = e
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


def phase_time(dev, seed):
    rows = {}
    for dtype in DTYPES:
        isz = torch.tensor([], dtype=dtype).element_size()
        args = ff_inputs(ROWS, dtype, dev, seed)
        flops = 2 * ROWS * (C * H + H * C)
        nbytes = (2 * ROWS * C + C * H + H + H * C + C) * isz
        rows[("fused_ff", dtype)] = dict(
            ms=cuda_ms(lambda: fused_ff_cuda(*args)), plain_ms=cuda_ms(lambda: fused_ff_plain(*args)),
            library_ms=cuda_ms(_library_ff(*args)), bound=bound(flops, nbytes, dtype))
        x, wy, wx = mix_inputs(B, N, N, M, dtype, dev, seed)
        flops = B * 2 * (N * 2 * M * N * C + 4 * M * N * C * C + N * N * 2 * M * C) * 2
        nbytes = 2 * x.numel() * isz + (wy.numel() + wx.numel()) * wy.element_size()
        rows[("fused_mix_2d", dtype)] = dict(
            ms=cuda_ms(lambda: fused_mix_2d_cuda(x, wy, wx)),
            plain_ms=cuda_ms(lambda: fused_mix_2d_plain(x, wy, wx)),
            library_ms=cuda_ms(_library_mix(x, wy, wx)), bound=bound(flops, nbytes, dtype))
    for (name, dtype), r in rows.items():
        log(f"time {name}[{str(dtype).replace('torch.', '')}]: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
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
        if n != N_LAYERS * N_STEPS:
            raise AssertionError(f"main: {name} launched {n} times in the timed rollout, "
                                 f"expected {N_LAYERS * N_STEPS}")
    for name, n in counts.items():
        if n < 1:
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
    errs = phase_check(dev, args.seed)
    times = phase_time(dev, args.seed)
    counts = phase_main(dev, args.seed)

    kernels = []
    for name, meta in KERNELS.items():
        t = times[(name, torch.float32)]
        kernels.append({"name": name, "route": "cuda", **meta,
                        "launches": counts[name], "max_abs_err": errs[(name, torch.float32)],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                        "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
