"""Wall time and host CPU time of the port's flagship train step on one NVIDIA GPU.

    python3 scripts/probe_train_step.py [--repeats 5] [--steps 10]

Builds the flagship routine (24 layers, width 64, batch 19, f32) on random
trajectories ``[38, 64, 64, 20]`` made from ``--seed`` (their values do not
change a step's work), runs the normalizer pass and 3
warm-up steps, then ``--repeats`` times ``--steps`` train steps on one
batch, ended by ``torch.cuda.synchronize()``. Each repeat prints the wall
time per step and the CPU time the process spent per step
(``time.process_time``): where the step is held by the host, the CPU time
is the host's own cost, which other load on the machine stretches in wall
time but not in CPU time. It uses only what the port's public modules and
``chip_smoke.py`` offered since the training slice, so it runs unchanged
in a checkout of an earlier commit (copy it there) for a comparison.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.getcwd() if os.path.exists("chip_smoke.py") else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import B, CONFIG, log  # noqa: E402
from fourierflow_tpu_torch.commands.train import build_routine  # noqa: E402
from fourierflow_tpu_torch.config import instantiate, load_config  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_train_step: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "trajectories.npy")
        rng = np.random.default_rng(args.seed)
        np.save(data_path, rng.standard_normal((2 * B, 64, 64, 20), dtype=np.float32))
        overrides = [f"builder.data_path={data_path}", f"builder.train_size={B}",
                     f"builder.test_size={B}"]
        cfg = load_config(CONFIG, overrides)
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"])
        state = routine.init(7231, builder.sample_batch(), dev)
        for batch in builder.train_batches(rng=np.random.default_rng(args.seed)):
            state = routine.accumulate_step(state, batch)
    batch = next(builder.train_batches(np.random.default_rng(args.seed)))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for _ in range(3):
        state, _ = routine.train_step(state, batch, gen)
    torch.cuda.synchronize()
    for r in range(args.repeats):
        w0, c0 = time.perf_counter(), time.process_time()
        for _ in range(args.steps):
            state, metrics = routine.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall, cpu = time.perf_counter() - w0, time.process_time() - c0
        log(f"train step {r}: wall {wall / args.steps * 1e3:.3f} ms, host CPU "
            f"{cpu / args.steps * 1e3:.3f} ms per step, loss {float(metrics['train_loss']):.6f}")


if __name__ == "__main__":
    main()
