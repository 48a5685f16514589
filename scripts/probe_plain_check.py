"""Layer by layer: the flagship train step on the card against its float32 CPU copy.

    python3 scripts/probe_plain_check.py [--seed 0] [--timing-rounds 2]

Replays ``chip_smoke.py`` phase ``train`` up to its check of one train
step on the kernel path against the plain path (a float32 CPU copy, noise
off): the generated flagship file, ``train`` through the device-resident
epoch, ``--timing-rounds`` rounds of ``time_epoch_loops`` (two epochs a
round; 0 leaves them out), then the phase's 1 + 3 + 10 + 2 steps. For that
state it prints every parameter gradient's error (max |err| / max |CPU|)
above 1e-4, and for each layer's feed-forward ``relu(x W1 + b1) W2 + b2``:

- the hidden units (of rows x 256) whose preactivation changes sign
  between the card's layer input and the CPU's (both products in float64),
  and the smallest |preactivation| among them;
- the error of the card's ``b1`` gradient against the CPU copy's, and
  against the CPU copy's recomputed in float64 from its own output
  gradient with the card's ReLU mask in place of its own: what is left
  once the sign changes are taken out.
"""

import argparse
import copy
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.getcwd() if os.path.exists("chip_smoke.py") else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _ff_io(model):
    """Hooks that keep each layer's feed-forward input and output gradient."""
    io, handles = {}, []
    for i, layer in enumerate(model.spectral_layers):
        ff = layer.backcast_ff
        handles.append(ff.register_forward_pre_hook(
            lambda m, args, i=i: io.__setitem__(("x", i), args[0].detach())))
        handles.append(ff.register_full_backward_hook(
            lambda m, g_in, g_out, i=i: io.__setitem__(("g", i), g_out[0].detach())))
    return io, handles


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--timing-rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_plain_check: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, seed = torch.device("cuda", 0), args.seed
    cs.log(cs.card_line())
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        data_path = cs.phase_generate(dev, tmp, seed)[0]
        overrides = cs.data_overrides(data_path) + ["trainer.max_epochs=2"]
        trainer, state = cs.train.main(cs.CONFIG, overrides, config_dir=os.path.join(tmp, "run"),
                                       device="cuda")
        cfg = cs.load_config(cs.CONFIG, overrides)
        builder = cs.instantiate(cfg["builder"])
        routine = cs.build_routine(cfg["routine"], builder)
    if args.timing_rounds:
        state, _ = cs.time_epoch_loops(routine, state, builder, trainer, dev, seed,
                                       rounds=args.timing_rounds)
    batch = next(builder.train_batches(np.random.default_rng(seed)))
    state, _ = routine.train_step(state, batch, trainer.step_generator(dev))
    gen = trainer.step_generator(dev)
    for _ in range(3 + 10 + 2):  # warm-ups, timed steps, the profiled steps (in place)
        routine.train_step(state, batch, gen)
    torch.cuda.synchronize()

    plain = cs.cpu_copy(routine, state)
    quiet = copy.copy(routine)
    quiet.noise_std = 0.0
    runs = {}
    for name, st in (("card", state), ("cpu", plain)):
        io, handles = _ff_io(st.model)
        loss, grads, _ = quiet.loss_and_grads(st, batch)
        for h in handles:
            h.remove()
        runs[name] = (loss, dict(zip([n for n, _ in st.model.named_parameters()], grads)), io)
    (loss, grads, io), (want_loss, want_grads, want_io) = runs["card"], runs["cpu"]
    cs.log(f"probe: {args.timing_rounds} timing rounds; loss {float(loss):.6f} vs "
           f"{float(want_loss):.6f}")
    for n, g in grads.items():
        rel = _rel(g, want_grads[n])
        if rel > 1e-4:
            cs.log(f"probe: gradient {n}: rel {rel:.3e}")
    for i, layer in enumerate(plain.model.spectral_layers):
        (w1, b1), (w2, _) = (seq[0].dense() for seq in layer.backcast_ff.layers)
        w1, b1, w2 = (t.detach().double() for t in (w1, b1, w2))
        x_card = io[("x", i)].double().cpu().reshape(-1, w1.shape[1])
        x_cpu = want_io[("x", i)].double().reshape(-1, w1.shape[1])
        pre_card, pre_cpu = x_card @ w1.t() + b1, x_cpu @ w1.t() + b1
        flips = (pre_card > 0) != (pre_cpu > 0)
        name = f"spectral_layers.{i}.backcast_ff.layers.0.0.bias"
        line = (f"probe: layer {i}: {int(flips.sum())} sign changes of {pre_card.numel():,} "
                f"hidden units" + (f" (smallest |pre| {float(pre_cpu[flips].abs().min()):.3e})"
                                   if flips.any() else "")
                + f"; b1 gradient rel {_rel(grads[name], want_grads[name]):.3e}")
        if ("g", i) in want_io:
            dh = want_io[("g", i)].double().reshape(-1, w2.shape[0]) @ w2
            own = (dh * (pre_cpu > 0)).sum(0)
            card_mask = (dh * (pre_card > 0)).sum(0)
            line += (f", against the CPU's float64 recomputation {_rel(grads[name], own):.3e}, "
                     f"with the card's ReLU mask {_rel(grads[name], card_mask):.3e}")
        cs.log(line)


if __name__ == "__main__":
    main()
