"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases PHASE ...]

Phases, each reporting on its own lines; a run goes through all nineteen, or
with ``--phases`` through the named ones and those whose files they read
(device and build always run; the kernels line then covers the paths that
ran). A line ``{"phase_seconds": ...}`` before the card's line gives each
phase's wall time:

1. ``device``: the card's name and power limit (nvidia-smi), torch and CUDA versions.
2. ``build``: compile every CUDA source in ``csrc/``, all at once.
3. ``check``: each kernel against its plain PyTorch version at the flagship
   shapes, in float32 (TF32 off) and bf16, with the weights laid out as the
   model hands them over; with ragged rows (one row short of a whole tile,
   1037, 1 and 0), the 4,096 rows of a serving step at batch 1, contiguous
   weights and a narrower shape for the feed-forward, the serving batch 1
   grid and odd, non-square and Nyquist-mode grids, strided and
   bf16 mode weights, line counts that are not a multiple of the kernel's
   10 lines a block, above one round of blocks and below one block, and the
   torus_kochkov shapes (32^2 to 256^2, 16 to 64 modes, in mode chunks), for
   the spectral mix and its adjoint; in float32 the structured-mesh shapes
   (the feed-forward at 135,110, 187,690 and 238,056 rows, and at width 32,
   hidden 128; the mix and its adjoint at x [10, 229, 59, 64] with M 32 on X
   and 16 on Y, at width 32 with M 24 / 12, and at [10, 137, 137, 64] M 16)
   and the point-cloud shapes (the feed-forward at 81,920 rows with hidden
   128 and at 32,000 rows at width 32, hidden 64; the mix and its adjoint
   at x [20, 64, 64, 64] M 16 and [20, 40, 40, 32] M 12); the parallel layers'
   shard shapes (``check_shards``): the feed-forward at 77,824 rows with H 128,
   64 and 32 (the hidden slice at tp 2, 4 and 8), the mix and its adjoint on a
   column shard of the weights (C_out 32) at the flagship, and one axis
   (``fused_mix_axis``, one launch) at [19, 32, 64, 64] along Y and [19, 64,
   32, 64] along X (the spatially split layer at sp 2);
   the feed-forward at H 96 (a whole 64-wide hidden chunk and a 32-wide
   one); the segment sum (MeshGraphNet's scatter) at ``cylinder_flow/
   baseline``'s edges and nodes and at two ragged shapes, equal to its plain
   version on a CPU copy to the bit; two runs of each kernel at the flagship
   bit-identical; and the whole
   backward of each autograd Function (dx, dW, db) against
   ``torch.autograd.grad`` through its plain forward.
   The ``sass`` lines count the tensor-core instructions (HMMA) of the
   forward and backward feed-forward kernels in the built library
   (``cuobjdump``), hold the wrappers' shared-memory formulas and the
   spectral kernel's mode chunks to the kernels' and give the spectral
   kernel's registers and spills.
4. ``generate``: the port's ``navier_stokes`` on the card at the flagship's
   grid (64x64, 20 records, li force, mu 1e-5, delta 1e-4, seed 23893,
   batch 50, t 20), cut to 100 trajectories (each cut printed against the
   protocol); the file's invariants (finite, zero-mean fields that change
   between records, enstrophy within the forcing's bound); the card's solve of two
   of its initial fields against the CPU's and against a float64 numpy
   Crank-Nicolson reference; the CUDA-graph solve against the eager one, to
   the bit; the solver's time per step at batch 50 and 1,200, eager and
   graph, beside its bound, and the projected time of the protocol dataset.
5. ``main`` (inference): the generated file (``train/u``), the normalizer
   pass, a checkpoint, then the port's ``infer`` on the flagship config (24
   layers, width 64) for a 10-step rollout at batch 19, with the launch
   counts read around it; ``valid_step`` on the same batch; and the model's
   kernel path against its plain path on a small input.
6. ``serve``: on the same file, the flagship after its normalizer pass and
   3 train steps, saved as a port checkpoint under ``trial-0-*`` and as a
   reference-style Lightning ``.ckpt``. ``export`` writes the 20-step
   rollout at batch 1 and at batch 19 (the export's seconds and file size
   printed); each artifact's graph holds 24 x 20 nodes of each forward
   operator and none of the backward ones; its call on a test trajectory's
   frame launches each forward kernel 24 x 20 times and agrees with the
   live serving module and with ``routine.rollout`` (1e-5); ms per rollout
   step of the artifact and of the eager rollout (median, min and max of 15
   calls). Then ``test`` through ``find_checkpoint`` and through the
   Lightning file (equal, finite logs), ``predict`` with the config and
   without (the DNS baseline, with and without the solver's per-call
   set-up, and the ratios to the model) and ``sample`` (the pickle's predictions
   ``[19, 64, 64, 10]``, finite).
7. ``train``: the port's ``train`` on the flagship config at full width on
   the same file through the Trainer's default device-resident epoch (the
   normalizer epoch, then one epoch of n // 19 = 18 steps of batch 19, the
   JAX package's count, a validation rollout and the test pass), with the
   launch counts read around it (24 of each backward kernel a step); the
   same fit replayed by hand through the per-batch loop over the epoch's
   own batches (``epoch_permutation``), its final weights, normalizer and
   AdamW state equal to the bit; wall and host CPU ms per step of a whole
   epoch of each loop, in turns, and each traced once (device time, idle
   share); exactly 24 launches of each kernel in one train
   step; one train step's loss and every parameter gradient on the kernel
   path against the plain path (a float32 CPU copy); the time of a train
   step, and its device time by kernel group from a profiler trace.
8. ``baseline``: the port's ``train`` on the FNO-4 config (width 20, 12
   modes, 4 layers, batch 20, 10-step unroll) on the same file for one
   epoch of 4 steps and the test pass; its time per train step; one train
   step's loss and every gradient on the card against a float32 CPU copy.
   No hand-written kernel lies on this path (torch.fft and matmuls).
9. ``mesh``: the structured-mesh slice. The Geo-FNO datasets are written at
   their shapes from the seed (airfoil X, Y [N, 221, 51] and Q [N, 5, 221,
   51]; pipe [N, 129, 129]; plasticity's input [N, 101] and output [N, 101,
   31, 20, 4] as a .mat), the splits cut as printed; ``train``, ``test`` and
   ``predict`` on ``airfoil/ffno/24_layers`` by registry name at full width
   (24 layers, width 64, M 32 / 16, batch 10), and 2 more of its steps;
   2 steps each of ``pipe/ffno/24_layers``, ``airfoil/ffno-small/24_layers``,
   ``plasticity/ffno/24_layers`` (batch 2), ``airfoil/geo-fno/4_layers`` and
   ``plasticity/geo-fno/4_layers`` held to a float32 CPU copy (Geo-FNO's
   parameters to a copy updated from the card's gradients: see
   ``hold_steps``; the pipe and plasticity F-FNO held at 4 layers, their
   24-layer steps run unheld); the launches of every configuration's 2 steps (24 of
   each kernel a step in the 2D F-FNO, of the feed-forward ones in the 3D
   F-FNO, none in Geo-FNO), its ms per train step and its device time by
   kernel group from a profiler trace.
10. ``context``: the torus_vis slice. ``navier_stokes`` writes
   ``torus_vis.h5`` and ``torus_vis_force.h5`` on the card (the JAX study's
   recipe: 64x64, t 20, 200 records, random force of 2 cycles, static or
   varying, mu in [1e-5, 1e-4], seeds 48396 / 48397), cut to one batch a
   split (19 / 4 / 4 trajectories), and their invariants are held.
   ``train`` on the registry names ``torus_vis/01_baseline`` and
   ``torus_vis_force/01_baseline`` at full width (24 layers, width 64, 5
   input channels; the normalizer pass, one device-resident epoch of every
   full batch of pairs, the 10-step validation rollouts fed the force, the
   test pass), then ``test`` on the checkpoint (the same logs); 2 more
   steps of each held to a float32 CPU copy of the same step (loss,
   gradients and parameters after it) and timed with the host CPU time
   beside it; 2 steps of the ablations ``with_velocity``,
   ``shuffle_xy_grid`` and ``no_factorization`` (FNO++) on the torus_li
   file held so at 4 layers, and run, counted and timed at 24. ``export``
   of ``torus_vis/02_no_mu`` at batch 1 and 20 steps: an artifact that
   takes a force, equal to the live serving module to the bit, launching A
   and B 24 x 20 times a call, timed beside the eager rollout. Every
   kernel must be launched on this path.
11. ``kolmogorov``: the Kolmogorov-flow slice. ``generate kolmogorov`` by
   registry name writes the protocol's initial conditions and trajectories
   of the three splits on the card, cut as printed (a 256^2 simulation at
   its own CFL step, the warm-up's 40 time units and the records' cadence
   kept, 4 / 2 / 2 trajectories, 800 records, outputs at 32-256), and their
   invariants are held (finite, zero-mean vorticity, the curl of the stored
   velocities, the enstrophy bound of the forced, damped flow); the card's
   CN-RK4 solve is held to the CPU's (20 steps), one step to a float64
   numpy CN-RK4 and the CUDA-graph run to the eager one (to the bit); the
   solver is timed at 256^2 and at the protocol's 2048^2 x 32, and the
   protocol's train data projected from it. ``train`` (one device-resident
   epoch over the virtual pairs, vorticity only on the card) and ``test`` on
   ``torus_kochkov/ffno/grid_sizes/64`` at full width (24 layers, width 64,
   5 channels, batch 32; the validation with the reduced 32^2 metrics), a
   rollout written by ``save_predictions`` and read back, 24 launches of
   each kernel in one step, 2 steps held to a float32 CPU copy and timed;
   ``grid_sizes/128`` (M 32, batch 8) and ``/256`` (M 64, batch 2): 2 steps
   each held at 4 layers, and 2 at 24 layers counted and timed; ``test`` of
   the 64^2 checkpoint at 256^2
   (``superresolution/train_with_x64/256``); ``train`` of
   ``multi_resolution/x32_x64`` on 32^2 and 64^2 batches in turn.
12. ``pointcloud``: the elasticity slice. The Geo-FNO elasticity files are
   written at their layouts from the seed (``rr [42, N]``, ``sigma [972,
   N]``, ``XY [972, 2, N]``: points scattered in the unit square, a stress
   smooth in them and in the 42 geometry parameters), the splits cut as
   printed; ``train``, ``test`` and ``predict`` on
   ``elasticity/ffno/24_layers`` by registry name at full width (24 layers,
   width 64, M 16, the 64^2 grid, batch 20, the IPhi deformation), and 2
   more of its steps; 2 steps each of ``elasticity/ffno/4_layers``,
   ``ffno-small/4_layers``, ``geo-fno/4_layers``, ``geo-fno-big/4_layers``
   and the fully-factorized model at the ffno widths held to a float32 CPU
   copy (Geo-FNO's parameters to a copy updated from the card's gradients:
   see ``hold_steps``); each configuration's launches, ms per train step and
   device time by kernel group.
13. ``cno``: the CNO slice. 2 steps each of ``airfoil/fcno/4_layers`` and
   ``plasticity/fcno/4_layers`` on phase mesh's files, held to a float32 CPU
   copy; ``train`` on ``torus_kochkov/fcno/grid_sizes/64`` by registry name
   at full width (24 layers, batch 32; one device-resident epoch) on phase
   kolmogorov's files, and 2
   of its steps at 4 layers held to a CPU copy; the launches (the
   feed-forward kernels only: the DCT branches are plain torch, as in JAX),
   each step's ms and device time, and the DCT branches' share of it (one
   layer's branches forward and backward at the step's shape, traced alone,
   times the layers).
14. ``projection``: the finite-volume (projection-method) solver. ``generate
   kolmogorov`` by registry name writes the 2D initial conditions
   (pseudo-spectral, simulated at 128^2 at its own CFL step, the warm-up's
   40 time units kept, 4 / 2 / 4 trajectories), then
   ``re_1000/learned_interpolation/control`` (64^2, Euler and van Leer;
   400 of its 2,441 records) and ``compare_methods/downsampling/
   projection_rk4/128`` (RK4 and linear advection, as configured) from them,
   and the 3D ``three_dimensions/{initial_conditions,trajectories}/test`` at
   64^3 (2 trajectories, 20 of 1,000 warm-up steps, 10 of 200 records); every
   stored field finite and the stored velocities' divergence at the
   simulated size at most 1e-4 of the largest speed; the card's solve held
   to the CPU's over 20 steps (1e-5) and the CUDA-graph run to the eager one
   (to the bit), in 2D and 3D; ms per solver step at 64^2, 128^2 (Euler and
   RK4) and 64^3 from a CUDA graph, its device time by group, and at the
   protocol's 512^3 eagerly from a random initial velocity (peak memory),
   with the protocol's projected generation time.
15. ``learned_interpolation``: the files ``torus_kochkov/learned_interpolation/
   rollout/x64`` reads, made by the pseudo-spectral generator from phase
   projection's initial conditions (128^2 at its own CFL step, 400 records,
   66 in train, outputs at 32 and 64); ``train`` (one device-resident epoch
   of 2 steps over the velocity dataset, the registry's
   ``limit_train_batches`` lifted) and ``test`` by name at full
   width (6 layers of 64 features, unroll 32, batch 4; 12 validation
   snapshots); 2 steps held to a float32 CPU copy; the step timed (at a
   learning rate of 1e-6: the registry's 1e-3 makes the loss grow) and
   traced, with the pressure solve traced alone, the validation's ms per
   model step; one x256 step (256^2, batch 4, unroll 32) held to the same
   step with cuDNN off, and its peak memory.
16. ``meshgraphnet``: synthetic cylinder_flow TFRecords from the seed (meshes
   of 1,800-1,920 nodes and 3,432-3,666 triangles, 52 of 600 steps, 4 / 2 /
   2 trajectories), ``convert cylinder-flow``, then ``cylinder_flow/baseline``
   through ``train`` (2 steps) and ``test`` (the 50-step rollout) by name at
   full width (15 layers, latent 128, batch 4), ``test``'s loss equal to
   the train pass's to the bit; 2 steps held to a float32 CPU copy, timed
   and traced; the rollout's ms per step; the segment sum's launches, 45 a
   train step (the scatter and two gathers' gradients a layer). Phases 14-16
   run none of the F-FNO's kernels (their torch work is what JAX computes
   in XLA): those launch counts must stay 0.
17. ``trainer``: the rest of ``train`` and the trainer at the flagship's full
   width on phase generate's file. ``train`` with ``routine.conv.remat=True``
   (the normalizer epoch and a device-resident epoch of 18 steps), then
   ``train`` with ``resume``: the
   resumed fit's starting weights, normalizer, AdamW moments, schedule and
   step equal the ``last.ckpt`` it read to the bit, and its ``global_step``
   restarts at 0 (as the reference's); the port's ``plot table`` over the
   two runs' directory, printed; ``checkpoint_path`` restores the same
   whole state; ``pretrained_path`` from that file and from a Lightning
   ``.ckpt`` (``save_lightning``) gives the file's weights, no optimizer
   moments and step 0. One step from one state without noise, remat against
   eager: the loss to the bit, every gradient within 1e-6, launches A 48, B
   48, A' 24, B' 24 (eager 24 each); each mode's ms per step and peak
   ``max_memory_allocated``, and the same on random batches of
   ``torus_kochkov/ffno/grid_sizes/256`` (batch 2 and 8),
   ``plasticity/ffno/24_layers`` and ``torus_li/zongyi/4_layers``: each peak in
   layer inputs a layer, and each model family's coefficient of the remat
   guard fitted to them. The low-pass mode: 2 steps held to a float32 CPU
   copy, launching A and A' 24 times a step and B, B' never. SWA from step 0
   over 2 epochs: the final weights equal the mean of the epoch-end weights.
   ``train --profile-dir`` through the CLI in a child process: the trace's
   events of ``ff_fwd_kernel``, ``ff_bwd_kernel`` and
   ``spectral_axis_kernel``, each at least 2 steps x 24. The remat guard's
   decision for the flagship and ``torus_kochkov/ffno/grid_sizes/256`` on
   the card's memory.
18. ``parallel``: the parallel trainer on NCCL, one process a card
   (``torch.multiprocessing``). With one card, a world of one rank: the
   flagship's fit (the normalizer epoch and one device-resident epoch) on an
   explicit ``data`` mesh equal to the fit with no mesh to the bit (weights,
   normalizer, AdamW moments, logs); the fit on ``{data 1, model 1}`` and on
   ``{data 1, spatial 1}`` (the tensor- and spatially parallel layer code:
   the collectives, the partial-sum feed-forward, kernel B on one axis) beside
   the per-batch fit with no mesh, and one step's loss and gradients of each
   within 1e-5 of the one-device step; ms per train step of each layout;
   the launches of each kernel, the one-axis ones (``fused_mix_axis``,
   ``fused_mix_axis_adjoint``, one launch a call) apart from ``fused_mix_2d``
   (two a call). Runs with several ranks need two or more cards: there,
   2-way data, tensor and spatial parallelism of the flagship against the
   one-rank fit (train loss within rtol 1e-4, valid loss within 1e-3) with
   ms per step. Then the five other routines on a ``data`` mesh, each
   config at its full width (the 24-layer ones at 4 layers), one epoch of 2
   steps and the validation on small sets the phase writes:
   ``torus_li/zongyi/4_layers`` on the generated file, ``airfoil/ffno`` and
   ``elasticity/ffno`` (A, A', B and B' launched on the mesh), ``rollout/x64``
   on synthetic velocity files (the device-resident epoch over ``(inputs,
   outputs)`` tuples) and ``cylinder_flow/baseline`` through ``convert
   cylinder-flow``: on one rank each fit equal to the fit with no mesh to the
   bit, MeshGraphNet and the learned interpolation too, with no cuDNN flag
   set by the phase (two separate fits that agree to the bit show that the
   steps repeat); with several ranks 2-way fits within the bounds above.
19. ``time`` (in a child process of this script, which starts with no CUDA
   graph and no profiler session behind it): each kernel, its plain version
   and a PyTorch yardstick the port
   never calls, by their device time in a profiler trace (and the kernel's
   wall time back to back, between CUDA events); the least time the card
   could take and the kernel's time over it; the spectral mix and its
   adjoint also at x [8, 128, 128, 64] M 32 and [2, 256, 256, 64] M 64, and
   in float32 every kernel at the airfoil's shapes (135,110 rows; x [10,
   229, 59, 64] M 32 / 16) and at the elasticity F-FNO's (81,920 rows, hidden
   128; x [20, 64, 64, 64] M 16), and in float32 at the parallel layers' shard
   shapes (``time_shards``, H 32 at tp 8 among them; the one-axis kernels
   ``fused_mix_axis`` and ``fused_mix_axis_adjoint`` in rows of their
   own); the segment sum at ``cylinder_flow/baseline``'s shapes. It
   runs last, so that no profiler session precedes the timed rollout and
   train steps.

Prints a JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; it
exits non-zero without printing a result when CUDA is unavailable.
"""

import argparse
import copy
import dataclasses
import json
import logging
import math
import os
import pickle
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fourierflow_tpu_torch.builders import load_array  # noqa: E402
from fourierflow_tpu_torch.builders.synthetic import (  # noqa: E402
    gaussian_random_field, solve_navier_stokes_2d)
from fourierflow_tpu_torch.builders.synthetic.ns_2d import li_force  # noqa: E402
from fourierflow_tpu_torch.commands import (  # noqa: E402
    export, infer, predict, sample, train)
from fourierflow_tpu_torch.commands import plot  # noqa: E402
from fourierflow_tpu_torch.commands import test as test_command  # noqa: E402
from fourierflow_tpu_torch.commands.generate import navier_stokes  # noqa: E402
from fourierflow_tpu_torch.commands.train import build_routine  # noqa: E402
from fourierflow_tpu_torch.config import instantiate, load_config  # noqa: E402
from fourierflow_tpu_torch.ops import (  # noqa: E402
    AXIS_KERNELS, GRAPH_KERNELS, _cuda, fused_ff, fused_ff_bwd, fused_mix_2d, launch_counts,
    reset_launch_counts, segment_csr, segment_sum)
from fourierflow_tpu_torch.ops.fused_ff import (  # noqa: E402
    _DTYPE_CODE, _bwd_smem_bytes, _fwd_smem_bytes, _lib, fused_ff_bwd_cuda, fused_ff_bwd_plain,
    fused_ff_cuda, fused_ff_plain)
from fourierflow_tpu_torch.ops.fused_spectral import (  # noqa: E402
    _lib as _spectral_lib, _mode_chunk as _mix_mode_chunk, _smem_bytes as _mix_smem_bytes,
    fused_mix_2d_adjoint_cuda, fused_mix_2d_adjoint_plain, fused_mix_2d_cuda, fused_mix_2d_plain,
    fused_mix_axis_adjoint_cuda, fused_mix_axis_adjoint_plain, fused_mix_axis_cuda,
    fused_mix_axis_plain)
from fourierflow_tpu_torch.ops.segment import segment_sum_cuda, segment_sum_plain  # noqa: E402
from fourierflow_tpu_torch.ops.spectral import dct_mix_axis  # noqa: E402
from fourierflow_tpu_torch.parallel import (  # noqa: E402
    gather_state, init_distributed, make_mesh, make_sp_mesh, make_tp_mesh, mesh_axis, mesh_shape,
    shard_batch, shard_state)
from fourierflow_tpu_torch.parallel.collectives import all_gather  # noqa: E402
from fourierflow_tpu_torch.trainers import (  # noqa: E402
    Callback, StochasticWeightAveraging, Trainer)
from fourierflow_tpu_torch.trainers.trainer import (  # noqa: E402
    REMAT_BUDGET, SAVED_INPUTS_PER_LAYER, _device_hbm_bytes, _estimate_activation_bytes,
    batch_count, epoch_permutation, make_scan_epoch, step_generator, to_device)
from fourierflow_tpu_torch.utils.equations import graph_repeated  # noqa: E402
from fourierflow_tpu_torch.utils.checkpoint import save_state  # noqa: E402
from fourierflow_tpu_torch.utils.serving import load_exported, make_rollout_fn  # noqa: E402

CONFIG = "configs/torus_li/markov/24_layers.yaml"
ZONGYI_CONFIG = "configs/torus_li/zongyi/4_layers.yaml"
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
SIMT_F32_PEAK = 67e12  # float32 on CUDA cores, outside the tensor cores (the segment sum's adds)
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
# The spectral kernel on one axis (the spatially split layer), on the kernels line apart from
# KERNELS, whose four every path checks: one launch a call, where a fused_mix_2d call is two;
# ``at`` is the shape of its own time (phase time).
AXIS_KERNEL_LINES = {
    "fused_mix_axis": dict(source="fourierflow_tpu_torch/csrc/fused_spectral.cu",
                           replaces="fourierflow_tpu/ops/pallas_spectral.py:58 (one _branch of "
                                    ":83)", path="parallel",
                           at=f"one axis (Y) on x [{B}, {N // 2}, {N}, {C}] M {M} (sp 2)"),
    "fused_mix_axis_adjoint": dict(source="fourierflow_tpu_torch/csrc/fused_spectral.cu",
                                   replaces="fourierflow_tpu/ops/pallas_spectral.py:58 (one "
                                            "_branch of _fused_mix_bwd :191)", path="parallel",
                                   at=f"one axis (Y) on x [{B}, {N // 2}, {N}, {C}] M {M} (sp 2)"),
}
# The segment sum (MeshGraphNet's scatter and its gathers' gradients): it replaces no TPU kernel
# (the JAX package's scatter is XLA's, meshgraphnet.py:108); on the kernels line apart from
# KERNELS, since only the meshgraphnet and parallel paths run it.
GRAPH_KERNEL_LINES = {
    "segment_sum": dict(source="fourierflow_tpu_torch/csrc/segment_sum.cu",
                        replaces="none: no TPU kernel (fourierflow_tpu/models/meshgraphnet.py:108 "
                                 "scatters with .at[].add in XLA); it replaces index_add_'s "
                                 "atomics", path="meshgraphnet",
                        at="cylinder_flow/baseline's receivers at batch 4 (7,680 nodes, 87,984 "
                           "edge slots), F 128"),
}
TRAIN_TOL = 1e-3  # train step, kernel path vs plain path: max |err| / max |ref|, per tensor
# The generate phase: the flagship's dataset call (scripts/torus_li_study.py: s 64, t 20,
# 20 records, li force, mu 1e-5, delta 1e-4, seed 23893, all trajectories in train) at
# the CLI's batch of 50, cut to two batches; the protocol beside it.
GEN = dict(n_train=100, n_valid=0, n_test=0, s=N, t=20.0, steps=20, mu=1e-5, mu_min=1e-5,
           mu_max=1e-5, seed=23893, delta=1e-4, batch_size=50, force="li")
PROTOCOL = dict(n_train=1200, t=20.0, delta=1e-4)
GEN_CHECK_STEPS = 300  # steps of the card-vs-CPU and float64-reference solves
GEN_TOL = 1e-5  # card vs CPU solve of the same w0: max |err| / max |CPU|
REF_TOL = 1e-4  # card vs the float64 numpy reference: max |err| / max |reference|
MEAN_TOL = 1e-3  # |spatial mean| of every field / max |u|
# Enstrophy: advection conserves it and viscosity dissipates it, so the RMS vorticity
# grows at most by the force's RMS per unit time: rms(u(t)) <= rms(a) + t rms(f). Held
# with this slack for the discretisation.
ENSTROPHY_SLACK = 1.1
STEP_BATCHES = (50, 1200)  # solver batches timed
TIMED_STEPS = (1000, 3000)  # time per step: the difference of these two runs
# The forward FF kernel's rows per block and round (8 warps of 32 bf16 rows; a
# multiple of the f32 warp's 16, and of the backward kernel's 64-row tile),
# and a narrower shape than the flagship's that both FF kernels take.
FF_TILE_ROWS = 256
FF_NARROW = dict(cin=32, hidden=128, cout=40)
# H 96: a whole 64-wide hidden chunk and one of 32, staged with zeros past H (both FF kernels).
FF_PART_CHUNK = dict(hidden=96)
# Spectral-mix grids (batch, X, Y, modes) and weight options checked on the
# card: the flagship (1,216 lines an axis launch: 122 blocks of 10 lines, one
# round on 132 SMs); odd, non-square and Nyquist-mode grids; strided weights
# (copied to contiguous runs by the wrapper); 1,472 lines, not a multiple of
# the kernel's 10 lines a block and more than one round; 7 and 9 lines, less
# than one block; 20 channels (bf16 rows of x then are not 16-byte pieces).
# The second case is the serving artifact's batch 1 (64 lines an axis launch,
# the last block partly filled).
MIX_CASES = (((B, N, N, M), {}), ((1, N, N, M), {}), ((2, 63, 65, M), {}),
             ((2, 32, 32, 17), {}), ((3, 48, 40, 12), dict(strided=True)), ((23, N, N, M), {}),
             ((1, 7, 9, 4), {}), ((2, 24, 20, 6), dict(c=20)))
# The torus_kochkov shapes: grid_sizes/64 and multi_resolution's 32^2 at batch 32,
# grid_sizes/128 (M 32, two mode chunks of 16), grid_sizes/256 (M 64, chunks of 12), the
# 256^2 super-resolution test (M 16, chunks of 8) and predictions/256 (M 32, chunks of 12).
KOL_MIX_CASES = (((32, N, N, M), {}), ((32, 32, 32, M), {}), ((8, 128, 128, 32), {}),
                 ((2, 256, 256, 64), {}), ((2, 256, 256, M), {}), ((12, 256, 256, 32), {}))
KOL_TIME_CASES = ((8, 128, 128, 32), (2, 256, 256, 64))
MIX_BF16_CASES = (((2, 40, 48, 12), dict(w_dtype=torch.bfloat16)),)
# The structured-mesh shapes, each grid padded by 8 on the high side of every axis:
# airfoil 221 x 51 -> 229 x 59 at batch 10 (ffno: M 32 on X, 16 on Y; ffno-small: width 32,
# M 24 / 12), pipe 129^2 -> 137^2 at batch 10 (M 16), plasticity 101 x 31 x 20 -> 109 x 39 x
# 28 at batch 2 (its three spectral branches are the plain version, as in JAX): the rows
# of the feed-forward and the spectral mix's x. Checked in float32.
AIRFOIL_ROWS, PIPE_ROWS, PLAS_ROWS = 10 * 229 * 59, 10 * 137 * 137, 2 * 109 * 39 * 28
MESH_SMALL = dict(cin=32, hidden=128, cout=32)
MESH_FF_CASES = ((AIRFOIL_ROWS, {}), (PIPE_ROWS, {}), (PLAS_ROWS, {}), (AIRFOIL_ROWS, MESH_SMALL))
MESH_MIX_CASES = (((10, 229, 59, 32), dict(modes_y=16)),
                  ((10, 229, 59, 24), dict(modes_y=12, c=32)), ((10, 137, 137, 16), {}))
# The point-cloud shapes (elasticity): the F-FNO's middle layers at batch 20 on its 64^2 grid
# (width 64, the feed-forward's factor 2: H 128; M 16 on both axes) and ffno-small's 40^2
# (width 32, H 64, M 12): the rows of the feed-forward and the spectral mix's x. Float32.
ELASTICITY_ROWS, ELASTICITY_SMALL_ROWS = 20 * 64 * 64, 20 * 40 * 40
POINT_FF_CASES = ((ELASTICITY_ROWS, dict(hidden=128)),
                  (ELASTICITY_SMALL_ROWS, dict(cin=32, hidden=64, cout=32)))
POINT_MIX_CASES = (((20, 64, 64, 16), {}), ((20, 40, 40, 12), dict(c=32)))
# The parallel layers' shard shapes at the flagship: the feed-forward's hidden slice under
# tensor parallelism (H 128 at tp 2, 64 at tp 4, 32 at tp 8), kernel B on a column shard of the
# Fourier weights (C_out 32 at tp 2), and the spatially split layer's one-axis launches at sp 2
# (Y on this rank's rows [19, 32, 64, 64], X after the all-to-all on [19, 64, 32, 64]).
SHARD_HIDDEN = (H // 2, H // 4, H // 8)
SHARD_C_OUT = C // 2
SHARD_AXIS_CASES = (((B, N // 2, N), 2), ((B, N, N // 2), 1))  # (x's [B, X, Y], axis)
# The serve phase: the exported rollout's steps and batches, and its tolerance against
# the live serving module and the eager rollout (max |err| / max |reference|, f32).
SERVE_STEPS = 20
SERVE_BATCHES = (1, B)
SERVE_TOL = 1e-5
SERVE_TRAIN_STEPS = 3
SERVE_CALLS = 15  # calls timed for ms per rollout step
# The context phase: the torus_vis recipe (scripts/torus_vis_study.py:50-63: s 64, t 20, 200
# records, delta 1e-4, random force of 2 cycles, mu in [1e-5, 1e-4]) cut to one batch a
# split, read at builder.ssr=1 as the study does (:123); the file's seed and whether its
# force varies; the registry names it trains, holds and times at full width.
VIS_GEN = dict(n_train=B, n_valid=4, n_test=4, s=N, t=20.0, steps=200, mu_min=1e-5,
               mu_max=1e-4, delta=1e-4, batch_size=50, force="random", cycles=2)
VIS_FILES = {"torus_vis.h5": (48396, False), "torus_vis_force.h5": (48397, True)}
VIS_CONFIGS = ("torus_vis/01_baseline", "torus_vis_force/01_baseline")
ABLATIONS = ("torus_li/ablation/with_velocity/24_layers",
             "torus_li/ablation/shuffle_xy_grid/24_layers",
             "torus_li/ablation/no_factorization/24_layers")
SERVE_CONFIG = "torus_vis/02_no_mu"
CONTEXT_STEPS = 2  # train steps of each configuration, each held to a CPU copy
# The kolmogorov phase: the protocol's data configs
# (data/kolmogorov/re_1000/{initial_conditions,trajectories}/{split}: a 2048^2 simulation, 32
# trajectories a split, a warm-up of 2,852 x 64 steps (40 time units), then a record every 16
# steps, 9,764 of them) cut to a 256^2 simulation at its own CFL step (8 times the 2048^2
# one), so that 8 and 2 steps keep the warm-up's and the records' simulated time; 4 / 2 / 2
# trajectories; 800 records (a 10-step rollout at k 20 of the "_4" files); outputs at 32, 64
# and 128 (k 4), and 256 in train and test (grid_sizes/256 trains on it, the super-resolution
# test reads it).
KOL_PROTOCOL = dict(sim=2048, n=32, ic_inner=64, warmup=2852, traj_inner=16, outer=9764)
KOL_SIM = 256
KOL_SPLITS = {"train": 4, "valid": 2, "test": 2}
KOL_IC_INNER, KOL_TRAJ_INNER, KOL_OUTER = 8, 2, 800
KOL_CHECK_STEPS = 20  # the card's solve against the CPU's, 20 steps of 0.00175
KOL_SOLVER_TOL = 1e-5  # card vs CPU solve: max |err| / max |CPU|
KOL_REF_TOL = 1e-5  # one step vs the float64 numpy CN-RK4: max |err| / max |reference|
KOL_TIMED_STEPS = (8, 24)  # time per solver step: the difference of these two runs
KOL_CONFIG = "torus_kochkov/ffno/grid_sizes/64"
KOL_GRIDS = ("torus_kochkov/ffno/grid_sizes/128", "torus_kochkov/ffno/grid_sizes/256")
KOL_SUPERRES = "torus_kochkov/ffno/superresolution/train_with_x64/256"
KOL_MULTI = "torus_kochkov/ffno/multi_resolution/x32_x64"
KOL_STEPS = 2  # train steps after the normalizer pass, and steps held to a CPU copy
KOL_GRID_STEPS = 2  # steps of grid_sizes/128 and /256 held to a CPU copy (the run's time)
# The mesh phase: the Geo-FNO datasets at their shapes (NACA_Cylinder_{X,Y} [N, 221, 51] and
# _Q [N, 5, 221, 51], of which the registry reads channel 4; Pipe_{X,Y} [N, 129, 129] and
# _Q [N, 1, 129, 129], channel 0 read; plas_N987_T20.mat's input [N, 101] and output [N,
# 101, 31, 20, 4]), made from the seed, with the splits cut from the registry's 1,000 / 200
# / 200 (airfoil, pipe) and 827 / 80 / 80 (plasticity); the configuration trained and tested
# by name at full width; the ones whose steps are held to a CPU copy and timed.
MESH_SPLITS = {"airfoil": (40, 10, 10), "pipe": (20, 10, 10), "plasticity": (40, 2, 2)}
MESH_REGISTRY_SPLITS = {"airfoil": (1000, 200, 200), "pipe": (1000, 200, 200),
                        "plasticity": (827, 80, 80)}
MESH_CONFIG = "airfoil/ffno/24_layers"
MESH_HELD = ("pipe/ffno/24_layers", "airfoil/ffno-small/24_layers", "plasticity/ffno/24_layers",
             "airfoil/geo-fno/4_layers", "plasticity/geo-fno/4_layers")
MESH_STEPS = 2  # train steps of each configuration held to a CPU copy
# Held at HELD_LAYERS layers: the configurations whose 24-layer float32 CPU copy takes 20-47 s a
# step on the card's host ("the CPU's step" in the log), which would take the run past its time
# limit; their 24-layer steps still run on the card, their launches counted and timed. The
# Kolmogorov grids 128^2 and 256^2 are held so too.
HELD_LAYERS = 4
MESH_HELD_CUT = ("pipe/ffno/24_layers", "plasticity/ffno/24_layers")
# The pointcloud phase: the elasticity files (Random_UnitCell_rr_10.npy [42, N],
# _sigma_10.npy [972, N], _XY_10.npy [972, 2, N]) made from the seed, the splits cut from the
# registry's 1,000 / 200 / 200; the configuration trained, tested and predicted by name at
# full width; the ones whose steps are held to a CPU copy and timed, the last the
# fully-factorized model (no registry name) at elasticity/ffno/4_layers's widths.
POINT_SPLITS, POINT_REGISTRY_SPLITS = (40, 10, 10), (1000, 200, 200)
POINT_N, POINT_CODE = 972, 42
POINT_CONFIG = "elasticity/ffno/24_layers"
POINT_PLUS, POINT_PLUS_CONFIG = "FNOFullyFactorizedMesh2D", "elasticity/ffno/4_layers"
POINT_HELD = ("elasticity/ffno/4_layers", "elasticity/ffno-small/4_layers",
              "elasticity/geo-fno/4_layers", "elasticity/geo-fno-big/4_layers", POINT_PLUS)
POINT_STEPS = 2  # train steps of each configuration held to a CPU copy
# The cno phase: the mesh CNOs held on phase mesh's files; the Kolmogorov CNO trained by
# name at full width on phase kolmogorov's files, its step held at 4 layers.
CNO_HELD = ("airfoil/fcno/4_layers", "plasticity/fcno/4_layers")
CNO_CONFIG = "torus_kochkov/fcno/grid_sizes/64"
CNO_STEPS = 2
# The projection phase (the finite-volume solver): the initial conditions of
# data/kolmogorov/re_1000/initial_conditions/{split} (the protocol's 2048^2, 32 a split)
# simulated at 128^2 at its own CFL step (16x the 2048^2 one: inner 4 of 64 keeps the
# warm-up's 40 time units), 4 / 2 / 4 trajectories, outputs at 64 and 128; the control (64^2,
# Euler and van Leer) and projection_rk4/128 (RK4, linear advection) through generate by name;
# the 3D initial conditions at the protocol's 512^3 for a few timed steps of one trajectory,
# then the 3D configs through generate at 64^3.
FV_IC_SIM, FV_IC_INNER = 128, 4
FV_SPLITS = {"train": 4, "valid": 2, "test": 4}
FV_CONTROL = "data/kolmogorov/re_1000/learned_interpolation/control"
FV_RK4 = "data/kolmogorov/compare_methods/downsampling/projection_rk4/128"
FV_CONTROL_OUTER = 400  # of the control's 2,441 records
FV_3D_IC = "data/kolmogorov/three_dimensions/initial_conditions/test"
FV_3D_TRAJ = "data/kolmogorov/three_dimensions/trajectories/test"
FV_3D_PROTOCOL = dict(sim=512, n=4, inner=64, warmup=1000, outer=200)
FV_3D_SIM, FV_3D_N, FV_3D_WARMUP, FV_3D_OUTER = 64, 2, 20, 10
FV_3D_TIMED_STEPS = (2, 6)  # 512^3 steps: the time per step is the difference of these runs
FV_TIMED_STEPS = (8, 24)
FV_CHECK_STEPS = 20  # the card's solve against the CPU's
FV_SOLVER_TOL = 1e-5  # card vs CPU solve: max |err| / max |CPU|
FV_DIV_TOL = 1e-4  # max |h div v| / max |v| of the stored velocities at the simulated size
# The learned_interpolation phase: the files torus_kochkov/learned_interpolation/rollout/x64
# reads (re_1000/trajectories/{split}_{64,32}_1 from the projection phase's initial
# conditions: the protocol's 2048^2 simulation at 128^2, inner 1 of 16 at its own CFL step;
# 400 records of 9,764), trained and tested by name at full width; 2 steps held to a CPU
# copy; one x256 step (256^2, batch 4, unroll 32, a batch made from the seed) held to the
# same step with cuDNN off (PyTorch's own im2col-and-GEMM convolutions).
LI_CONFIG = "torus_kochkov/learned_interpolation/rollout/x64"
LI_X256 = "torus_kochkov/learned_interpolation/rollout/x256"
LI_OUTER, LI_SPLITS = 400, {"train": 4, "valid": 2, "test": 4}
LI_STEPS = 2  # train steps of the train command, and steps held to a CPU copy
# The train split's records: the unroll's k L = 64 frames past each item's first, and enough
# first frames that the 4 trajectories give LI_STEPS full batches of 4, one device-resident
# epoch (the registry's limit_train_batches=4000 keeps the per-batch loop: train is run
# with it lifted).
LI_TRAIN_OUTER = 2 * 32 + LI_STEPS
# The registry's x64 (AdamW at 1e-3, no clipping) moves every weight by the learning rate in
# its first step, the zero-initialised out layer included, and its loss grows from there: the
# timed steps, 7 in a row, run at a learning rate of 1e-6, the same work.
LI_TIMED_LR = 1e-6
# The meshgraphnet phase: synthetic cylinder_flow TFRecords made from the seed (meshes of
# 45-48 x 40 points over [0, 1.6] x [0, 0.41]: 1,800-1,920 nodes, 3,432-3,666 triangles; 52
# steps of the dataset's 600, the 50-step rollout's), converted, then cylinder_flow/baseline
# trained and tested by name at full width (15 layers, latent 128, batch 4).
MGN_CONFIG = "cylinder_flow/baseline"
MGN_SPLITS, MGN_REGISTRY_SPLITS = {"train": 4, "valid": 2, "test": 2}, (1000, 100, 100)
MGN_NX, MGN_NY, MGN_T, MGN_REGISTRY_T = (48, 47, 46, 45), 40, 52, 600
MGN_STEPS = 2  # train steps of the train command, and steps held to a CPU copy
# The segment sum (MeshGraphNet's scatter and its gathers' gradients) checked against its plain
# version on a CPU copy, to the bit: the edges of the phase's four meshes at batch 4 (7,680 nodes,
# 87,984 edge slots) at latent width 128; 1,001 nodes (the last block of 256 threads part
# filled) and 20 features (a warp spans several nodes) on random indices.
MGN_LATENT = 128
SEGMENT_CASES = ((1001, 6000, MGN_LATENT), (37, 300, 20))  # (nodes, edges, features)
# The trainer phase: the remat step's gradients against the eager step's (max |err| / max
# |eager| per tensor); the train steps of the profiled CLI fit.
REMAT_GRAD_TOL = 1e-6
TRAINER_STEPS = 2
# The remat guard's coefficients (trainers/trainer.py::SAVED_INPUTS_PER_LAYER), beside the
# flagship's step: each model's step eager and with remat on random batches of its
# configuration's shapes (batch first).
_KOL_256 = lambda b: {k: (b, 256, 256, 1) for k in ("x", "y", "vx", "vy")}
REMAT_MEMORY_CASES = (("torus_kochkov/ffno/grid_sizes/256", _KOL_256(2)),
                      ("torus_kochkov/ffno/grid_sizes/256", _KOL_256(8)),
                      ("plasticity/ffno/24_layers", {"x": (2, 101, 31, 20, 1),
                                                     "y": (2, 101, 31, 20, 4)}),
                      ("torus_li/zongyi/4_layers", {"x": (20, 64, 64, 12), "y": (20, 64, 64, 10),
                                                    "times": (20, 10)}))


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


def mix_inputs(b, sx, sy, modes, dtype, dev, seed, w_dtype=torch.float32, strided=False, c=C,
               modes_y=None):
    """x, wy and wx: [C, C, M, 2] mode weights, M ``modes`` (``modes_y`` for
    wy where given), float32 parameters as the model holds them, or
    ``w_dtype``; ``strided`` makes them non-contiguous views."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, sx, sy, c, generator=g).to(dev, dtype)

    def w(m):
        scale = (2.0 / (2 * c * m * 2)) ** 0.5
        if strided:
            w = torch.randn(m, 2, c, c, generator=g) * scale
            return w.to(dev, w_dtype).permute(2, 3, 0, 1)
        return (torch.randn(c, c, m, 2, generator=g) * scale).to(dev, w_dtype)

    return x, w(modes_y or modes), w(modes)


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


def device_ms(fn, iters=20, warmup=3, attempts=5):
    """Device time per call of ``fn``, from a torch.profiler trace of
    ``iters`` calls: for each kernel or copy, its mean duration times the
    number of times a call runs it. A trace can lose an event or two (a
    kernel seen 19 times in 20 calls); the mean of the events it kept
    stands for the lost ones. A trace that lost more (none at all, seen in
    a long run after CUDA graphs and several traces; or a count more than a
    tenth of ``iters`` off a whole number of calls) is taken again, up to
    ``attempts`` traces in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durations = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
        per_call = {name: round(len(us) / iters) for name, us in durations.items()}
        if durations and all(n >= 1 and abs(len(durations[k]) / iters - n) <= 0.1
                             for k, n in per_call.items()):
            lost = {k[:40]: n * iters - len(durations[k]) for k, n in per_call.items()
                    if len(durations[k]) != n * iters}
            if lost:
                log(f"time: trace {attempt + 1} lost {lost} of {iters} calls' events; their "
                    f"kernels' mean durations stand for them")
            return sum(n * statistics.fmean(durations[k]) for k, n in per_call.items()) / 1e3
        log(f"time: trace {attempt + 1} of {attempts} lost device activity: "
            f"{ {k[:40]: len(us) for k, us in durations.items()} } in {iters} calls")
    raise AssertionError("time: the profiler saw no whole trace of the device's work")


def bound(flops, nbytes, dtype, peak=None):
    t_ops, t_mem = flops / (peak or PEAK[dtype]), nbytes / MEM_RATE
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


# --- phases ------------------------------------------------------------------
def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f"; host: torch uses {torch.get_num_threads()} threads on {len(os.sched_getaffinity(0))} "
        f"CPUs")
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
        for hidden, cout in ((H, C), (FF_NARROW["hidden"], FF_NARROW["cout"]),
                             (FF_PART_CHUNK["hidden"], C), *((h, C) for h in SHARD_HIDDEN),
                             *((w.get("hidden", H), w.get("cout", C)) for _, w in POINT_FF_CASES)):
            sizes = ((_fwd_smem_bytes(hidden, cout, dtype),
                      _lib().ff_fwd_smem_bytes(code, hidden, cout)),
                     (_bwd_smem_bytes(hidden, dtype), _lib().ff_bwd_smem_bytes(code, hidden)))
            for kernel, (got, want) in zip(("forward", "backward"), sizes):
                if got != want:
                    raise AssertionError(f"fused_ff {kernel}: the wrapper's shared-memory size for "
                                         f"{dtype}, H {hidden} is {got}, the kernel's {want}")
    wtypes = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16))
    chunks = {}
    # (x's shape and M, options, the output's channels): square, and the tensor-parallel
    # column shard's forward (C_in 64, C_out 32) and adjoint (C_in 32, C_out 64).
    cases = [(shape, opts, None) for shape, opts in (MIX_CASES + KOL_MIX_CASES + MIX_BF16_CASES
                                                     + MESH_MIX_CASES + POINT_MIX_CASES)]
    cases += [((B, N, N, M), {}, SHARD_C_OUT), ((B, N, N, M), dict(c=SHARD_C_OUT), C)]
    for (_, sx, sy, modes), opts, co in cases:
        c = opts.get("c", C)
        co = c if co is None else co
        for n, modes in ((sx, modes), (sy, opts.get("modes_y") or modes)):
            for xt, wt in wtypes:
                got = (_mix_smem_bytes(n, modes, c, xt, wt, co),
                       _mix_mode_chunk(n, modes, c, xt, wt, co))
                want = (_spectral_lib().spectral_axis_smem_bytes(
                    _DTYPE_CODE[xt], _DTYPE_CODE[wt], n, modes, c, co),
                    _spectral_lib().spectral_axis_mode_chunk(
                        _DTYPE_CODE[xt], _DTYPE_CODE[wt], n, modes, c, co))
                if got != want:
                    raise AssertionError(f"fused_mix_2d: the wrapper's (shared memory, mode chunk) "
                                         f"at n {n}, M {modes}, C {c} -> {co}, {xt}/{wt} is {got}, "
                                         f"the kernel's {want}")
                if xt == wt == torch.float32:
                    chunks[f"n {n}, M {modes}" + (f", C {c}" if c != C else "")
                           + (f" -> {co}" if co != c else "")] = got[1]
    log(f"sass fused_mix_2d: mode chunks (f32) {json.dumps(chunks)}")
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
        # N * N rows: one rollout step of the serving artifact at batch 1.
        for rows, model_layout, widths in ((ROWS, True, {}), (N * N, True, {}),
                                           (1000 + 37, False, {}),
                                           (FF_TILE_ROWS * 50 - 1, True, {}), (1, True, {}),
                                           (0, True, {}), (999, True, FF_NARROW),
                                           (999, True, FF_PART_CHUNK)):
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
                                           (0, True, {}), (999, True, FF_NARROW),
                                           (999, True, FF_PART_CHUNK)):
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
        if dtype == torch.float32:
            for rows, widths in MESH_FF_CASES + POINT_FF_CASES:
                what = f"[{tag}, rows {rows}{', ' + str(widths) if widths else ''}]"
                check(f"fused_ff{what}", fused_ff_cuda, fused_ff_plain,
                      ff_inputs(rows, dtype, dev, seed, **widths), dtype)
                check(f"fused_ff_bwd{what}", fused_ff_bwd_cuda, fused_ff_bwd_plain,
                      ff_bwd_inputs(rows, dtype, dev, seed, **widths), dtype)
        cases = MIX_CASES + KOL_MIX_CASES + (MIX_BF16_CASES if dtype == torch.bfloat16 else
                                             MESH_MIX_CASES + POINT_MIX_CASES)
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
        errs.update(check_shards(dev, seed, dtype, tag))
    errs[("segment_sum", torch.float32)] = check_segment_sum(dev, seed)
    return errs


def mgn_segments(dev, seed, features=MGN_LATENT):
    """The segment sum's inputs at ``cylinder_flow/baseline``'s shapes: the
    receivers of the meshgraphnet phase's four meshes as one batch (padded
    to the largest, 1,920 nodes and 3,666 triangles; unused edge slots -1)
    through the model's own ``incidence``, and edge values ``[E,
    features]`` from the seed, zero on the unused slots as the model's
    masked messages are."""
    from fourierflow_tpu_torch.models.meshgraphnet import incidence, triangles_to_edges

    meshes = [_mgn_mesh(nx, MGN_NY) for nx in MGN_NX]
    n_max, c_max = max(len(m[0]) for m in meshes), max(len(m[1]) for m in meshes)
    cells = np.full((len(meshes), c_max, 3), -1, np.int32)
    for i, (_, c, _) in enumerate(meshes):
        cells[i, :len(c)] = c
    receivers = torch.stack([triangles_to_edges(torch.from_numpy(c).to(dev))[1] for c in cells])
    inc = incidence(receivers, n_max)
    g = torch.Generator(device="cpu").manual_seed(seed)
    values = torch.randn(inc.index.shape[0], features, generator=g).to(dev)
    return values * (inc.index >= 0)[:, None], inc.index, inc.order, inc.offsets


def random_segments(n, rows, features, dev, seed):
    """Values ``[rows, features]`` and an index over ``n`` segments drawn
    from the seed, a share of the rows in no segment (-1, value 0)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    index = torch.randint(-1, n, (rows,), generator=g).to(dev)
    values = torch.randn(rows, features, generator=g).to(dev) * (index >= 0)[:, None]
    return (values, index, *segment_csr(index, n))


def check_segment_sum(dev, seed):
    """The segment-sum kernel against its plain version (``index_add_``) on
    a CPU copy of its inputs, to the bit: at ``cylinder_flow/baseline``'s
    edges and nodes (twice there: the runs equal to the bit) and at
    SEGMENT_CASES; one launch a call. Returns the largest max |err| (0)."""
    cases = [(f"cylinder_flow/baseline's receivers at batch 4, F {MGN_LATENT}",
              mgn_segments(dev, seed))]
    cases += [(f"{n} nodes, {rows} edges, F {f}", random_segments(n, rows, f, dev, seed))
              for n, rows, f in SEGMENT_CASES]
    for i, (what, args) in enumerate(cases):
        before = segment_sum.launches
        got = segment_sum_cuda(*args)
        torch.cuda.synchronize()
        want = segment_sum_plain(*(a.cpu() for a in args))
        same = torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
        n, used = args[3].shape[0] - 1, int(args[3][-1] - args[3][0])
        log(f"check segment_sum[float32, {what}: {n} segments, {used} of {args[1].shape[0]} "
            f"rows in one]: max_abs_err {(got.cpu() - want).abs().max().item():.3e}, "
            f"{'equal' if same else 'NOT equal'} to the plain version to the bit")
        if not same or segment_sum.launches - before != 1:
            raise AssertionError(f"segment_sum: {what}: differs from its plain version or "
                                 f"launched {segment_sum.launches - before} times")
        if i == 0:
            if not torch.equal(segment_sum_cuda(*args).view(torch.int32), got.view(torch.int32)):
                raise AssertionError("segment_sum: two runs on one input differ")
            log("check segment_sum[float32]: bit-identical in two runs")
    return 0.0


def shard_inputs(dev, seed, dtype):
    """The flagship's x, a [C, C/2, M, 2] column shard of its Y and X weights
    (contiguous, as ``shard_state`` leaves a parameter) and an output
    gradient of C/2 channels."""
    x, wy, wx = mix_inputs(B, N, N, M, dtype, dev, seed)
    g = torch.randn(B, N, N, SHARD_C_OUT, generator=torch.Generator().manual_seed(seed + 3))
    shard = lambda w: w[:, :SHARD_C_OUT].contiguous()
    return x, shard(wy), shard(wx), g.to(dev, dtype)


def axis_inputs(shape, dtype, dev, seed):
    """x ``[*shape, C]`` and one axis's [C, C, M, 2] weights."""
    x, w, _ = mix_inputs(*shape, M, dtype, dev, seed)
    return x, w


def check_shards(dev, seed, dtype, tag):
    """The parallel layers' shard shapes against the plain versions: A and A'
    on the hidden slices, B and B' on a column shard (C_out 32), and B and B'
    on one axis at the spatially split layer's shapes (one launch each, in
    float32 out). Returns the one-axis kernels' largest errors, by (name,
    dtype)."""
    for hidden in SHARD_HIDDEN:
        what = f"[{tag}, rows {ROWS}, H {hidden} (tensor-parallel slice)]"
        check(f"fused_ff{what}", fused_ff_cuda, fused_ff_plain,
              ff_inputs(ROWS, dtype, dev, seed, hidden=hidden), dtype)
        check(f"fused_ff_bwd{what}", fused_ff_bwd_cuda, fused_ff_bwd_plain,
              ff_bwd_inputs(ROWS, dtype, dev, seed, hidden=hidden), dtype)
    x, wy, wx, g = shard_inputs(dev, seed, dtype)
    what = f"[{tag}, {B}x{N}x{N}x{C} -> {SHARD_C_OUT} (column shard), M {M}]"
    check(f"fused_mix_2d{what}", fused_mix_2d_cuda, fused_mix_2d_plain, (x, wy, wx), dtype)
    check(f"fused_mix_2d_adjoint{what}", fused_mix_2d_adjoint_cuda, fused_mix_2d_adjoint_plain,
          (g, wy, wx), dtype)
    errs = {}
    for shape, axis in SHARD_AXIS_CASES:
        x, w = axis_inputs(shape, dtype, dev, seed)
        before = launch_counts(AXIS_KERNELS)
        what = f"[{tag}, {'x'.join(map(str, shape))}x{C}, axis {axis}, M {M}]"
        for name, fn, plain in (("fused_mix_axis", fused_mix_axis_cuda, fused_mix_axis_plain),
                                ("fused_mix_axis_adjoint", fused_mix_axis_adjoint_cuda,
                                 fused_mix_axis_adjoint_plain)):
            e = check(f"{name}{what}", fn, plain, (x, w, axis), dtype)
            errs[(name, dtype)] = max(e, errs.get((name, dtype), 0.0))
        launched = {k: v - before[k] for k, v in launch_counts(AXIS_KERNELS).items()}
        if set(launched.values()) != {1}:
            raise AssertionError(f"fused_mix_axis: {launched} launches, not one a call")
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


def mix_flops(b, sx, sy, modes, c, modes_y=None, c_out=None, axes=(1, 2)):
    """Operations of one spectral-mix call on x [b, sx, sy, c] with ``modes``
    along X (``modes_y`` along Y where given): along each axis of ``axes``,
    every line's forward truncated DFT (n x 2M x C_in products), its per-mode
    complex C_in x C_out mix (4 M C_in C_out products) and its inverse DFT
    (2M x n x C_out products), two operations a product."""
    co = c if c_out is None else c_out
    branches = {2: (sy, sx, modes_y or modes), 1: (sx, sy, modes)}
    return 2 * sum(b * lines * (2 * n * m * (c + co) + 4 * m * c * co)
                   for n, lines, m in (branches[a] for a in axes))


def _library_axis(x, w, axis):
    """One branch by rfft, a complex einsum and irfft (the yardstick of one
    launch)."""
    xf, cw = x.float(), torch.view_as_complex(w.float().contiguous())

    def run():
        s = torch.fft.rfft(xf, dim=axis, norm="ortho").narrow(axis, 0, w.shape[2])
        y = torch.einsum("...mi,iom->...mo", s.movedim(axis, -2), cw)
        return torch.fft.irfft(y, n=x.shape[axis], dim=-2, norm="ortho").movedim(-2, axis)

    return run


def _library_axis_adjoint(x, w, axis):
    """Autograd's gradient with respect to x through ``_library_axis``."""
    xg = x.detach().requires_grad_()
    y = _library_axis(xg, w, axis)()
    g = torch.randn_like(y)
    return lambda: torch.autograd.grad(y, xg, g, retain_graph=True)


def time_shards(dev, seed):
    """Float32 rows of the parallel layers' shard shapes (``check_shards``):
    A, A', B and B' labelled with their shapes; the one-axis kernels' own
    rows (Y) and the X case labelled."""
    rows, f32, isz = {}, torch.float32, 4
    for hidden in SHARD_HIDDEN:
        tail = (f"rows {ROWS}, H {hidden} (tensor-parallel slice, tp {H // hidden})",)
        args = ff_inputs(ROWS, f32, dev, seed, hidden=hidden)
        nbytes = (ROWS * 2 * C + 2 * C * hidden + hidden + C) * isz
        rows[("fused_ff", f32) + tail] = timed(
            lambda: fused_ff_cuda(*args), lambda: fused_ff_plain(*args), _library_ff(*args),
            2 * ROWS * 2 * C * hidden, nbytes, f32)
        bargs = ff_bwd_inputs(ROWS, f32, dev, seed, hidden=hidden)
        weights = 2 * C * hidden + hidden
        rows[("fused_ff_bwd", f32) + tail] = timed(
            lambda: fused_ff_bwd_cuda(*bargs), lambda: fused_ff_bwd_plain(*bargs),
            _library_ff_bwd(*bargs), 2 * ROWS * hidden * 5 * C,
            ROWS * 3 * C * isz + weights * isz + (weights + C) * 4, f32)
    x, wy, wx, g = shard_inputs(dev, seed, f32)
    tail = (f"x [{B}, {N}, {N}, {C}] -> {SHARD_C_OUT} (column shard, tp 2) M {M}",)
    flops = mix_flops(B, N, N, M, C, c_out=SHARD_C_OUT)
    nbytes = (x.numel() + g.numel() + wy.numel() + wx.numel()) * isz
    rows[("fused_mix_2d", f32) + tail] = timed(
        lambda: fused_mix_2d_cuda(x, wy, wx), lambda: fused_mix_2d_plain(x, wy, wx),
        _library_mix(x, wy, wx), flops, nbytes, f32)
    rows[("fused_mix_2d_adjoint", f32) + tail] = timed(
        lambda: fused_mix_2d_adjoint_cuda(g, wy, wx),
        lambda: fused_mix_2d_adjoint_plain(g, wy, wx), _library_mix_adjoint(x, wy, wx), flops,
        nbytes, f32)
    for shape, axis in SHARD_AXIS_CASES:
        x, w = axis_inputs(shape, f32, dev, seed)
        tail = (f"one axis ({'Y' if axis == 2 else 'X'}) on x "
                f"[{', '.join(map(str, shape))}, {C}] M {M} (spatial split, sp 2)",)
        flops = mix_flops(*shape, M, C, axes=(axis,))
        nbytes = (2 * x.numel() + w.numel()) * isz
        if axis == 2:  # the Y case is each one-axis kernel's own row (its ``at``)
            tail = ()
        rows[("fused_mix_axis", f32) + tail] = timed(
            lambda: fused_mix_axis_cuda(x, w, axis), lambda: fused_mix_axis_plain(x, w, axis),
            _library_axis(x, w, axis), flops, nbytes, f32)
        rows[("fused_mix_axis_adjoint", f32) + tail] = timed(
            lambda: fused_mix_axis_adjoint_cuda(x, w, axis),
            lambda: fused_mix_axis_adjoint_plain(x, w, axis), _library_axis_adjoint(x, w, axis),
            flops, nbytes, f32)
    return rows


def timed(kernel, plain, library, flops, nbytes, dtype, peak=None):
    """Device times of a kernel, its plain version and its library
    yardstick; the kernel's wall time back to back; the bound (operations
    at ``peak``, by default the dtype's tensor-core rate)."""
    return dict(ms=device_ms(kernel), wall_ms=cuda_ms(kernel), plain_ms=device_ms(plain),
                library_ms=device_ms(library), bound=bound(flops, nbytes, dtype, peak))


def time_segment_sum(dev, seed):
    """The segment sum at ``cylinder_flow/baseline``'s shapes (f32): the
    kernel, its plain version on the card (``index_add_``, atomics) and one
    ``torch.index_add`` call on the same rows; bound by the rows this index
    puts in a segment (each read once), the output written once, the order
    and offsets read once, and one add a value on CUDA cores."""
    args = mgn_segments(dev, seed)
    values, index, _, offsets = args
    n, f = offsets.shape[0] - 1, values.shape[1]
    used = int(offsets[-1] - offsets[0])
    zeros, rows = torch.zeros(n + 1, f, device=dev), torch.where(index < 0, n, index)
    return timed(lambda: segment_sum_cuda(*args), lambda: segment_sum_plain(*args),
                 lambda: torch.index_add(zeros, 0, rows, values), used * f,
                 (used * f + n * f) * 4 + used * 8 + (n + 1) * 8, torch.float32, SIMT_F32_PEAK)


def phase_time(dev, seed):
    """Rows keyed ``(name, dtype)`` at the flagship's shapes, and ``(name,
    dtype, label)`` at the other paths' shapes: the torus_kochkov grids (f32
    and bf16), the airfoil mesh and the elasticity point cloud (f32)."""
    rows = {}
    hid = 128  # the elasticity F-FNO's feed-forward (factor 2)
    for dtype in DTYPES:
        isz = torch.tensor([], dtype=dtype).element_size()
        f32 = dtype == torch.float32
        for n_rows, widths, tail in ((ROWS, {}, ()),) + ((
                (AIRFOIL_ROWS, {}, (f"rows {AIRFOIL_ROWS} (airfoil)",)),
                (ELASTICITY_ROWS, dict(hidden=hid),
                 (f"rows {ELASTICITY_ROWS}, H {hid} (elasticity)",))) if f32 else ()):
            cin, hidden, cout = (widths.get(k, d) for k, d in (("cin", C), ("hidden", H),
                                                                ("cout", C)))
            args = ff_inputs(n_rows, dtype, dev, seed, **widths)
            flops = 2 * n_rows * (cin * hidden + hidden * cout)
            nbytes = (n_rows * (cin + cout) + cin * hidden + hidden + hidden * cout + cout) * isz
            rows[("fused_ff", dtype) + tail] = timed(
                lambda: fused_ff_cuda(*args), lambda: fused_ff_plain(*args), _library_ff(*args),
                flops, nbytes, dtype)
            bargs = ff_bwd_inputs(n_rows, dtype, dev, seed, **widths)
            # Five products: pre, dh, dx, dW1 and dW2.
            flops = 2 * n_rows * hidden * (3 * cin + 2 * cout)
            weights = cin * hidden + hidden * cout + hidden
            nbytes = n_rows * (2 * cin + cout) * isz + weights * isz + (weights + cout) * 4
            rows[("fused_ff_bwd", dtype) + tail] = timed(
                lambda: fused_ff_bwd_cuda(*bargs), lambda: fused_ff_bwd_plain(*bargs),
                _library_ff_bwd(*bargs), flops, nbytes, dtype)
        # Operations and bytes as in mix_flops; the mode chunks do not enter the bound.
        label = lambda shape, opts, path: (
            f"x [{', '.join(map(str, shape[:3]))}, {C}] M {shape[3]}"
            + (f" / {opts['modes_y']}" if "modes_y" in opts else "") + f" ({path})")
        airfoil_shape, airfoil_opts = MESH_MIX_CASES[0]
        elasticity_shape = POINT_MIX_CASES[0][0]
        mix_cases = (((B, N, N, M), {}, ()),) + tuple(
            (shape, {}, (label(shape, {}, "torus_kochkov"),)) for shape in KOL_TIME_CASES) + ((
            (airfoil_shape, airfoil_opts, (label(airfoil_shape, airfoil_opts, "airfoil"),)),
            (elasticity_shape, {}, (label(elasticity_shape, {}, "elasticity"),))) if f32 else ())
        for shape, opts, tail in mix_cases:
            x, wy, wx = mix_inputs(*shape, dtype, dev, seed, **opts)
            flops = mix_flops(*shape, C, opts.get("modes_y"))
            nbytes = 2 * x.numel() * isz + (wy.numel() + wx.numel()) * wy.element_size()
            rows[("fused_mix_2d", dtype) + tail] = timed(
                lambda: fused_mix_2d_cuda(x, wy, wx), lambda: fused_mix_2d_plain(x, wy, wx),
                _library_mix(x, wy, wx), flops, nbytes, dtype)
            rows[("fused_mix_2d_adjoint", dtype) + tail] = timed(
                lambda: fused_mix_2d_adjoint_cuda(x, wy, wx),
                lambda: fused_mix_2d_adjoint_plain(x, wy, wx), _library_mix_adjoint(x, wy, wx),
                flops, nbytes, dtype)
    rows.update(time_shards(dev, seed))
    rows[("segment_sum", torch.float32)] = time_segment_sum(dev, seed)
    lines = {**AXIS_KERNEL_LINES, **GRAPH_KERNEL_LINES}
    for (name, dtype, *tail), r in rows.items():
        at = tail[0] if tail else lines.get(name, {}).get("at")
        at = f" at {at}" if at else ""
        log(f"time {name}[{str(dtype).replace('torch.', '')}]{at}: kernel {r['ms']:.4f} ms "
            f"(back to back {r['wall_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"ms/bound {r['ms'] / r['bound'][0]:.2f}")
    return rows


def reference_cn_steps(w0, visc, delta_t, n_steps, f):
    """Independent float64 numpy Crank-Nicolson steps with full fft2 (the
    math of the reference solver), for one field ``w0 [n, n]``."""
    n = w0.shape[-1]
    k1 = np.fft.fftfreq(n, d=1.0 / n)
    kx, ky = np.meshgrid(k1, k1, indexing="ij")
    lap = 4 * np.pi**2 * (kx**2 + ky**2)
    lap[0, 0] = 1.0
    k_max = n // 2
    dealias = (np.abs(ky) <= 2.0 / 3.0 * k_max) & (np.abs(kx) <= 2.0 / 3.0 * k_max)
    w_h = np.fft.fft2(w0)
    f_h = np.fft.fft2(f)
    for _ in range(n_steps):
        psi_h = w_h / lap
        q = np.real(np.fft.ifft2(2j * np.pi * ky * psi_h))
        v = np.real(np.fft.ifft2(-2j * np.pi * kx * psi_h))
        w_x = np.real(np.fft.ifft2(2j * np.pi * kx * w_h))
        w_y = np.real(np.fft.ifft2(2j * np.pi * ky * w_h))
        F_h = np.fft.fft2(q * w_x + v * w_y) * dealias
        factor = 0.5 * delta_t * visc * lap
        w_h = (-delta_t * F_h + delta_t * f_h + (1.0 - factor) * w_h) / (1.0 + factor)
    return np.real(np.fft.ifft2(w_h))


def solver_step_ms(dev, batch, graph_steps, seed):
    """Time per solver step (64x64, li, mu 1e-5, delta 1e-4) at ``batch``:
    the difference of two timed solves of TIMED_STEPS steps after a
    warm-up, so the fixed costs of a call (graph capture, transforms in and
    out) cancel."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w0 = gaussian_random_field(batch, N, alpha=2.5, tau=7.0, generator=gen, device=dev)
    run = lambda k: solve_navier_stokes_2d(w0, 1e-5, k * 1e-4, 1e-4, 1, graph_steps=graph_steps)
    run(200)
    wall = []
    for k in TIMED_STEPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(k)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    steps = [math.ceil(k * 1e-4 / 1e-4) for k in TIMED_STEPS]
    return (wall[1] - wall[0]) / (steps[1] - steps[0]) * 1e3


def phase_generate(dev, tmp, seed):
    """The port's ``navier_stokes`` on the card at the flagship's grid (cut
    as printed), the file's invariants, the card's solve against the CPU's
    and against the float64 reference, the CUDA-graph path against the
    eager one, and the solver's time per step."""
    phase_start = time.perf_counter()
    path = os.path.join(tmp, "ns_li_64.h5")
    log(f"generate: cut: {GEN['n_train']} trajectories against the protocol's "
        f"{PROTOCOL['n_train']:,}")
    if GEN["t"] != PROTOCOL["t"]:
        log(f"generate: cut: t {GEN['t']:g} against the protocol's {PROTOCOL['t']:g} (20 records "
            f"every {GEN['t'] / GEN['steps']:g} time units instead of every "
            f"{PROTOCOL['t'] / GEN['steps']:g})")
    log(f"generate: kept: t {GEN['t']:g}, delta {GEN['delta']:g}, s {GEN['s']}, {GEN['steps']} "
        f"records, force {GEN['force']}, mu {GEN['mu']:g}, seed {GEN['seed']}, batch "
        f"{GEN['batch_size']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    navier_stokes(path, device=dev, **GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    u, a = load_array(path, "train/u"), load_array(path, "train/a")
    mu = load_array(path, "train/mu")
    n_steps = math.ceil(GEN["t"] / GEN["delta"])
    log(f"generate: navier_stokes wrote {os.path.getsize(path):,} B in {wall:.3f} s "
        f"({n_steps:,} steps a batch, {GEN['n_train'] // GEN['batch_size']} batches); "
        f"u {u.shape}, a {a.shape}, mu {sorted(set(mu.tolist()))}")
    if u.shape != (GEN["n_train"], N, N, GEN["steps"]) or a.shape != (GEN["n_train"], N, N):
        raise AssertionError(f"generate: shapes u {u.shape}, a {a.shape}")
    if not (np.isfinite(u).all() and np.isfinite(a).all()):
        raise AssertionError("generate: non-finite fields")
    mean = float(np.abs(u.mean(axis=(1, 2))).max() / np.abs(u).max())
    change = float(np.abs(u[..., 1] - u[..., 0]).max())
    rms = lambda x: np.sqrt((x.astype(np.float64) ** 2).mean(axis=(1, 2)))
    times = np.arange(1, GEN["steps"] + 1) * (n_steps // GEN["steps"]) * GEN["delta"]
    bound = rms(a)[:, None] + times * rms(li_force(N)[None])
    growth = rms(u) / bound
    log(f"generate: invariants: max |spatial mean| / max |u| {mean:.3e} (tol {MEAN_TOL:g}); "
        f"max |u[..., 1] - u[..., 0]| {change:.4f}; enstrophy: rms(u) / (rms(a) + t rms(f)) "
        f"at most {growth.max():.4f} (bound {ENSTROPHY_SLACK:g}), rms(u) at t "
        f"{times[-1]:g} in [{rms(u[..., -1]).min():.4f}, {rms(u[..., -1]).max():.4f}] from "
        f"[{rms(a).min():.4f}, {rms(a).max():.4f}]; max |u| {np.abs(u).max():.4f}")
    if not (mean <= MEAN_TOL and change > 0 and growth.max() <= ENSTROPHY_SLACK):
        raise AssertionError("generate: an invariant does not hold")

    # The same w0 on the card and on the CPU, and against the float64 reference.
    w0 = torch.from_numpy(a[:2].copy())
    t_end = GEN_CHECK_STEPS * GEN["delta"]
    kw = dict(visc=GEN["mu"], t_end=t_end, delta_t=GEN["delta"], record_steps=3)
    card = solve_navier_stokes_2d(w0.to(dev), **kw)[0].cpu()
    cpu = solve_navier_stokes_2d(w0, **kw)[0]
    err, rel = rel_err(card, cpu)
    taken = 3 * (math.ceil(t_end / GEN["delta"]) // 3)
    log(f"generate: card vs CPU solve ({N}x{N}, li, mu {GEN['mu']:g}, delta {GEN['delta']:g}, "
        f"{taken} steps, 2 trajectories): max_abs_err {err:.3e} rel {rel:.3e} tol {GEN_TOL:g}")
    if not rel <= GEN_TOL:
        raise AssertionError(f"generate: the card's solve disagrees with the CPU's ({rel:.3e})")
    ref = np.stack([reference_cn_steps(a[i].astype(np.float64), GEN["mu"], GEN["delta"], taken,
                                       li_force(N).astype(np.float64)) for i in range(2)])
    err, rel = rel_err(card[..., -1], torch.from_numpy(ref))
    corr = float(np.corrcoef(card[..., -1].numpy().ravel(), ref.ravel())[0, 1])
    log(f"generate: card vs float64 numpy reference ({taken} steps): max_abs_err {err:.3e} "
        f"rel {rel:.3e} tol {REF_TOL:g}; correlation {corr:.9f}")
    if not (rel <= REF_TOL and corr > 0.999999):
        raise AssertionError("generate: the card's solve disagrees with the float64 reference")

    # The CUDA-graph path against the eager path, to the bit.
    wb = torch.from_numpy(a[:GEN["batch_size"]].copy()).to(dev)
    kw = dict(visc=GEN["mu"], t_end=527 * GEN["delta"], delta_t=GEN["delta"], record_steps=5)
    eager = solve_navier_stokes_2d(wb, graph_steps=0, **kw)[0]
    graph = solve_navier_stokes_2d(wb, **kw)[0]
    if not torch.equal(eager, graph):
        raise AssertionError("generate: the CUDA-graph solve differs from the eager one")
    log("generate: CUDA-graph solve equals the eager solve to the bit (batch 50, 5 records "
        "of 105 steps: 2 graph replays and 5 eager steps each)")

    step_ms = {}
    for batch in STEP_BATCHES:
        state_bytes = 2 * batch * N * (N // 2 + 1) * 8  # complex64 state, read and written
        bound_ms = state_bytes / MEM_RATE * 1e3
        for mode, graph_steps in (("eager", 0), ("graph", 50)):
            ms = solver_step_ms(dev, batch, graph_steps, seed)
            step_ms[(batch, mode)] = ms
            log(f"generate: solver step at batch {batch} ({mode}): {ms:.4f} ms; bound "
                f"{bound_ms:.5f} ms (the state read and written once, bytes); ms/bound "
                f"{ms / bound_ms:.1f}")
    protocol_steps = math.ceil(PROTOCOL["t"] / PROTOCOL["delta"])
    batches = PROTOCOL["n_train"] // GEN["batch_size"]
    for mode in ("eager", "graph"):
        proj = batches * protocol_steps * step_ms[(GEN["batch_size"], mode)] / 1e3
        log(f"generate: projected protocol dataset ({PROTOCOL['n_train']:,} trajectories, "
            f"{batches} batches of {GEN['batch_size']} x {protocol_steps:,} steps, {mode}): "
            f"{proj:.1f} s of solver steps")
    log(f"generate: phase took {time.perf_counter() - phase_start:.1f} s")
    return path, step_ms


def data_overrides(data_path):
    """The flagship's builder on the generated file: 19 trajectories to
    train on, the last 19 to test on."""
    return [f"builder.data_path={data_path}", "builder.key=train/u",
            f"builder.train_size={B}", f"builder.test_size={B}"]


def phase_main(dev, seed, data_path):
    with tempfile.TemporaryDirectory() as tmp:
        overrides = data_overrides(data_path)
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


def rollout_step_ms(fn, n_calls=SERVE_CALLS):
    """Wall time per rollout step of ``fn()`` (one rollout of SERVE_STEPS
    steps) in each of ``n_calls`` calls after one warm-up, each call ended
    by ``torch.cuda.synchronize()``: ``(median, min, max)``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / SERVE_STEPS * 1e3)
    return statistics.median(times), min(times), max(times)


def save_lightning(path, state):
    """The state's weights and normalizer as the reference's Lightning
    checkpoint holds them: the model under ``conv.``, the normalizer's
    buffers under ``normalizer.``."""
    sd = {f"conv.{k}": v.detach().cpu() for k, v in state.model.state_dict().items()}
    norm = state.normalizer
    for name in ("sum", "sum_squared", "count"):
        sd[f"normalizer.{name}"] = getattr(norm, name).detach().cpu()
    torch.save({"state_dict": sd, "epoch": 1}, path)


def phase_serve(dev, seed, data_path):
    """The serving path and the inference commands on the flagship at full
    width: export, the artifact against the live rollout, test through both
    checkpoint formats, predict and sample."""
    overrides = data_overrides(data_path)
    cfg = load_config(CONFIG, overrides)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    state = routine.init(7231, builder.sample_batch(), dev)  # the commands' seed, trial 0
    rng = np.random.default_rng(seed)
    for batch in builder.train_batches(rng):
        state = routine.accumulate_step(state, batch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _, batch in zip(range(SERVE_TRAIN_STEPS), builder.train_batches(rng)):
        state, _ = routine.train_step(state, batch, gen)
    routine.n_steps = SERVE_STEPS
    frames = torch.as_tensor(builder.test_data["data"][:B, ..., :1], device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "checkpoints", "trial-0-1", "last.ckpt")
        save_state(ckpt, state)
        lightning = os.path.join(tmp, "reference.ckpt")
        save_lightning(lightning, state)
        live = make_rollout_fn(routine, state, SERVE_STEPS)

        reset_launch_counts()
        for batch_size in SERVE_BATCHES:
            path = os.path.join(tmp, f"rollout-b{batch_size}.pt2")
            t0 = time.perf_counter()
            export.main(CONFIG, path, checkpoint_path=ckpt, overrides=overrides,
                        n_steps=SERVE_STEPS, batch_size=batch_size, size=N, device="cuda")
            seconds = time.perf_counter() - t0
            t0 = time.perf_counter()
            artifact = load_exported(path)
            load_s = time.perf_counter() - t0
            nodes = {}
            for node in artifact.program.graph.nodes:
                if node.op == "call_function" and "fourierflow_tpu_torch" in str(node.target):
                    name = str(node.target).split(".")[1]
                    nodes[name] = nodes.get(name, 0) + 1
            log(f"serve: export at batch {batch_size}: {seconds:.2f} s (restore, trace, save, "
                f"load back), file {os.path.getsize(path):,} B, "
                f"{len(artifact.program.graph.nodes)} graph nodes, operator nodes {nodes}; "
                f"load {load_s:.2f} s")
            want_nodes = {name: N_LAYERS * SERVE_STEPS for name in ("fused_mix_2d", "fused_ff")}
            if nodes != want_nodes:
                raise AssertionError(f"serve: the artifact's operator nodes {nodes}, expected "
                                     f"{want_nodes}")
            w0 = frames[:batch_size]
            before = launch_counts()
            got = artifact(w0)
            torch.cuda.synchronize()
            calls = {k: v - before[k] for k, v in launch_counts().items()}
            want_calls = {k: N_LAYERS * SERVE_STEPS if KERNELS[k]["path"] == "infer" else 0
                          for k in calls}
            log(f"serve: launches in one call of the artifact at batch {batch_size}: {calls}")
            if calls != want_calls:
                raise AssertionError(f"serve: the artifact launched {calls}, expected {want_calls}")
            if tuple(got.shape) != (batch_size, N, N, SERVE_STEPS):
                raise AssertionError(f"serve: artifact output {tuple(got.shape)}")
            data = torch.cat([w0, torch.zeros(batch_size, N, N, SERVE_STEPS, device=dev)], -1)
            eager = lambda: routine.rollout(state, {"data": data})[0]
            with torch.no_grad():
                compare(f"serve: artifact vs live module, batch {batch_size}", got, live(w0),
                        SERVE_TOL)
            compare(f"serve: artifact vs routine.rollout, batch {batch_size}", got, eager(),
                    SERVE_TOL)
            fmt = lambda t: f"{t[0]:.3f} ms/step (min {t[1]:.3f}, max {t[2]:.3f})"
            art_ms, eager_ms = rollout_step_ms(lambda: artifact(w0)), rollout_step_ms(eager)
            log(f"serve: rollout at batch {batch_size}: artifact {fmt(art_ms)}, eager "
                f"routine.rollout {fmt(eager_ms)} ({SERVE_STEPS} steps a call, median of "
                f"{SERVE_CALLS} calls after a warm-up)")

        logs = test_command.main(CONFIG, overrides=overrides, config_dir=tmp, device="cuda")
        ref_logs = test_command.main(CONFIG, overrides=overrides, torch_checkpoint=lightning,
                                     device="cuda")
        scalars = {k: float(v) for k, v in logs.items() if np.ndim(v) == 0}
        log(f"serve: test through find_checkpoint {json.dumps(scalars)}")
        if sorted(logs) != sorted(ref_logs) or not all(
                np.array_equal(logs[k], ref_logs[k]) for k in logs):
            raise AssertionError(f"serve: test logs differ between the port checkpoint and the "
                                 f"Lightning file: {scalars} vs {ref_logs}")
        if not all(np.isfinite(v).all() for v in logs.values()):
            raise AssertionError(f"serve: non-finite test logs {scalars}")
        log("serve: test through the Lightning checkpoint: logs equal")

        model_s = predict.main(CONFIG, ckpt, overrides=overrides, device="cuda")
        # The timed solve includes the solver's per-call set-up (its graph's
        # capture); twice the records less one run leaves it out. Each is the
        # faster of two solves: one outlier solve (0.66 s where it takes 0.09
        # s on an H100 80GB HBM3 at 700 W) once made the difference negative.
        dns_s = min(predict.main(None, device="cuda") for _ in range(2))
        dns_steady = 2 * min(predict.time_dns_baseline(steps=20, device="cuda")
                             for _ in range(2)) - dns_s
        if not (0 < model_s < math.inf and 0 < dns_s < math.inf and 0 < dns_steady < math.inf):
            raise AssertionError(f"serve: predict {model_s}, DNS baseline {dns_s}, steady "
                                 f"{dns_steady}")
        log(f"serve: predict: F-FNO {model_s:.6e} s/sample/sim-second over "
            f"{min(GEN['n_train'], 512)} trajectories; DNS "
            f"baseline {dns_s:.6e} (32 samples, 64x64, 1,000 steps of 1e-4, one solve with its "
            f"set-up, the faster of two); DNS / F-FNO {dns_s / model_s:.2f}; DNS without the "
            f"set-up {dns_steady:.6e} (2,000 steps less 1,000), DNS / F-FNO "
            f"{dns_steady / model_s:.2f}")

        pkl = sample.main(CONFIG, ckpt, overrides=overrides, out_path=os.path.join(tmp, "s.pkl"),
                          device="cuda")
        with open(pkl, "rb") as f:
            batch, preds = pickle.load(f)
        n_steps = cfg["routine"]["n_steps"]
        if preds.shape != (B, N, N, n_steps) or not np.isfinite(preds).all():
            raise AssertionError(f"serve: sample preds {preds.shape}")
        log(f"serve: sample wrote [batch {sorted(batch)}, preds {preds.shape}], finite")
        counts = launch_counts()
    log(f"serve: launches over the serve path {counts}")
    for name, meta in KERNELS.items():
        if meta["path"] == "infer" and counts[name] < 1:
            raise AssertionError(f"serve: {name} was never launched on the serve path")
    return counts


def _state_diff(a, b):
    """The tensors of two ``_snapshot``s that differ, and the largest
    difference of any over the largest |b| of its tensor."""
    pairs = [(f"model.{k}", v, b["model"][k]) for k, v in a["model"].items()]
    pairs += [(f"normalizer.{k}", v, b["normalizer"][k]) for k, v in a["normalizer"].items()]
    for i, moments in a["optimizer"]["state"].items():
        pairs += [(f"adamw.{i}.{k}", v, b["optimizer"]["state"][i][k]) for k, v in moments.items()]
    bad = [name for name, x, y in pairs if not torch.equal(x, y)]
    worst = max((rel_err(x.float(), y.float())[1] for _, x, y in pairs), default=0.0)
    return len(pairs), bad, worst


def hold_epoch_loops(routine, start, fast_state, builder, trainer, dev):
    """``train``'s fit replayed by hand from its initial state through the
    per-batch loop over ``epoch_permutation``'s batches, gathered on the
    host (the normalizer epoch, then each train epoch with the generators
    of its global steps): the weights, the normalizer, every AdamW moment
    and the step held to the device-resident epoch's, to the bit."""
    data, n_items = builder.train_data, len(builder.train_data["x"])
    state, step = start, 0
    for epoch in range(trainer.max_epochs):
        for idx in epoch_permutation(trainer.seed, epoch, n_items, B).numpy():
            batch = {k: v[idx] for k, v in data.items()}
            if epoch == 0:
                state = routine.accumulate_step(state, batch)
                continue
            state, _ = routine.train_step(state, batch, step_generator(trainer.seed, step, dev))
            step += 1
    torch.cuda.synchronize()
    n, bad, worst = _state_diff(_snapshot(fast_state), _snapshot(state))
    log(f"train: the device-resident fit against the per-batch loop over the same batches "
        f"({step} steps): {n - len(bad)} of {n} tensors equal to the bit, largest rel "
        f"difference {worst:.2e}; steps {fast_state.step} / {state.step}")
    if bad or fast_state.step != state.step:
        raise AssertionError(f"train: the two loops differ in {bad[:6]}")


def time_epoch_loops(routine, state, builder, trainer, dev, seed, rounds=2):
    """Wall and host CPU ms per step of a whole train epoch of each loop, in
    turns from ``train``'s final state: the device-resident epoch
    (``make_scan_epoch`` over the uploaded set, as ``fit`` runs it) and the
    Trainer's per-batch loop (``_batch_epoch``: host batches, each copied to
    the card by the step, the first step's loss fetched). Returns the state
    after them and each loop's (wall, CPU) ms per step, epoch by epoch."""
    n_batches = len(builder.train_data["x"]) // B
    data = to_device(builder.train_data, dev)
    epoch_fn = make_scan_epoch(routine, B, seed=trainer.seed)
    loop = Trainer(seed=trainer.seed, device=dev, fast_loop=False)
    rng = np.random.default_rng(seed)
    runs = {"device-resident epoch": lambda s: epoch_fn(s, data, 1, trainer.global_step)[0],
            "per-batch loop": lambda s: loop._batch_epoch(routine, builder, s, rng, 1, False)}
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for name, run in runs.items():
            torch.cuda.synchronize()
            t0, cpu0 = time.perf_counter(), time.process_time()
            state = run(state)
            torch.cuda.synchronize()
            times[name].append(((time.perf_counter() - t0) / n_batches * 1e3,
                                (time.process_time() - cpu0) / n_batches * 1e3))
    card = card_line()
    for name, runs_ms in times.items():
        log(f"train: {name}: " + ", ".join(f"{w:.3f} ms wall / {c:.3f} ms host CPU"
                                           for w, c in runs_ms)
            + f" per step ({n_batches} steps of batch {B} an epoch, f32, {rounds} epochs in "
              f"turns); {card}")
    return state, times


def phase_train(dev, seed, data_path):
    """The port's ``train`` on the flagship at full width through the
    device-resident epoch, held to the per-batch loop over the same batches;
    both loops timed; then one train step counted, checked against its plain
    path, and timed."""
    with tempfile.TemporaryDirectory() as tmp:
        overrides = data_overrides(data_path) + ["trainer.max_epochs=2"]
        reset_launch_counts()
        trainer, state = train.main(CONFIG, overrides, config_dir=tmp, device="cuda")
        counts = launch_counts()
        run_dir = next(os.scandir(os.path.join(tmp, "checkpoints"))).path
        written = sorted(os.listdir(run_dir))
        cfg = load_config(CONFIG, overrides)
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"], builder)
        start = routine.init(7231, builder.sample_batch(), dev)  # train.main's seed, trial 0
    logs = trainer.logs
    n_items = len(builder.train_data["x"])
    # The JAX package's default Trainer: the normalizer epoch, then n // batch full batches
    # an epoch (the device-resident epoch drops a partial batch; the per-batch loop's ceil(n /
    # batch) is the larger count where the batch does not divide the set).
    want_steps = (trainer.max_epochs - 1) * (n_items // B)
    log(f"train: {trainer.global_step} steps in {logs['epoch'] + 1} epochs on the device-resident "
        f"epoch ({n_items} pairs, batch {B}; want {want_steps}), wrote {written}, launches over "
        f"train {counts}")
    if (trainer.global_step != want_steps or "last.ckpt" not in written
            or "metrics.jsonl" not in written):
        raise AssertionError(f"train: {trainer.global_step} steps, files {written}")
    # The backward kernels run in train steps only, 24 a step; the forward ones in the
    # validation and test rollouts too.
    backward, forward = N_LAYERS * trainer.global_step, N_LAYERS * trainer.global_step
    if (counts["fused_ff_bwd"] != backward or counts["fused_mix_2d_adjoint"] != backward
            or min(counts["fused_ff"], counts["fused_mix_2d"]) < forward):
        raise AssertionError(f"train: launches {counts}, want {backward} of each backward kernel")
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
    hold_epoch_loops(routine, start, state, builder, trainer, dev)

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
    device_ms = profile_train_step(routine, state, batch, gen, step_ms)

    # One step from one state, on the kernel path and on the plain path (a
    # float32 CPU copy), without noise: loss and every parameter gradient.
    plain = cpu_copy(routine, state)
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

    # Last, as they move the state on by four epochs: the step above is held where it always
    # was, on train's final state plus 16 steps (max rel 4.7e-4 there); four epochs later the
    # same float32 comparison read 3e-4 to 1.1e-3 (scripts/probe_plain_check.py).
    _, loop_ms = time_epoch_loops(routine, state, builder, trainer, dev, seed)
    # Both loops launch the same kernels a step (whole epochs of each, traced: the same
    # device time a step within 0.2%), so one step's traced device time gives each loop's
    # idle share.
    for name, runs_ms in loop_ms.items():
        log(f"train: {name}: idle " + ", ".join(f"{max(0.0, 1 - device_ms / w):.1%}"
                                                for w, _ in runs_ms)
            + f" of its epochs' wall time per step ({device_ms:.3f} ms of device time a step)")
    return counts


def phase_baseline(dev, data_path):
    """The port's ``train`` on the FNO-4 baseline config at full width on the
    generated file (80 trajectories to train on in 4 steps of 20, the last
    20 to test on), then its time per train step and one step on the card
    against a float32 CPU copy."""
    overrides = [f"builder.data_path={data_path}", "builder.key=train/u",
                 "builder.train_size=80", "builder.test_size=20", "trainer.max_epochs=1"]
    with tempfile.TemporaryDirectory() as tmp:
        trainer, state = train.main(ZONGYI_CONFIG, overrides, config_dir=tmp, device=dev)
    logs = trainer.logs
    losses = {k: float(v) for k, v in logs.items() if "loss" in k and np.ndim(v) == 0}
    log(f"baseline: {trainer.global_step} steps, n_params {logs['n_params']:,}, "
        f"{json.dumps(losses)}, test time_until {logs['test_time_until']:g}, epoch_time "
        f"{logs['epoch_time']:.3f} s")
    if trainer.global_step != 4 or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"baseline: {trainer.global_step} steps, losses {losses}")

    cfg = load_config(ZONGYI_CONFIG, overrides)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    batch = builder.sample_batch()
    if batch["x"].shape != (20, N, N, 12) or batch["y"].shape != (20, N, N, 10):
        raise AssertionError(f"baseline: batch x {batch['x'].shape}, y {batch['y'].shape}")
    for _ in range(3):
        state, _ = routine.train_step(state, batch)
    torch.cuda.synchronize()
    t0, cpu0 = time.perf_counter(), time.process_time()
    for _ in range(10):
        state, metrics = routine.train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    cpu_ms = (time.process_time() - cpu0) / 10 * 1e3
    if not math.isfinite(float(metrics["train_loss"])):
        raise AssertionError("baseline: non-finite loss in the timed steps")
    log(f"baseline: {step_ms:.3f} ms per train step (batch 20, 10-step unroll, f32, mean of 10 "
        f"after 3 warm-ups); host CPU time {cpu_ms:.3f} ms per step")
    profile_train_step(routine, state, batch, None, step_ms, label="baseline",
                       groups=BASELINE_GROUPS, host_top=8)

    plain = cpu_copy(routine, state)
    loss, grads, _ = routine.loss_and_grads(state, batch)
    want_loss, want_grads, _ = routine.loss_and_grads(plain, batch)
    names = [n for n, _ in state.model.named_parameters()]
    rels = {n: rel_err(a, b)[1] for n, a, b in zip(names, grads, want_grads, strict=True)}
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    worst = max(rels, key=rels.get)
    log(f"baseline: step on the card vs a float32 CPU copy: loss {float(loss):.6f} vs "
        f"{float(want_loss):.6f} (rel {loss_rel:.2e}); gradients of {len(rels)} parameters, "
        f"largest rel {rels[worst]:.2e} ({worst}), tol {TRAIN_TOL:.0e}")
    if not (loss_rel <= TRAIN_TOL and rels[worst] <= TRAIN_TOL):
        raise AssertionError("baseline: the card disagrees with the CPU")
    return step_ms


def cpu_copy(routine, state, dtype=torch.float32):
    """A CPU copy of ``state`` in ``dtype`` (float32, or float64 for a
    reference): the model, the normalizer, and the optimizer and schedule
    with their state and step."""
    norm = state.normalizer
    cast = lambda t: t.cpu().to(dtype)
    copy_ = routine.make_train_state(
        copy.deepcopy(state.model).cpu().to(dtype), norm and dataclasses.replace(
            norm, sum=cast(norm.sum), sum_squared=cast(norm.sum_squared), count=cast(norm.count),
            n_accumulations=cast(norm.n_accumulations)))
    # A deep copy: load_state_dict keeps the tensors of a state already on the CPU.
    copy_.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    if state.scheduler is not None:
        copy_.scheduler.load_state_dict(state.scheduler.state_dict())
    return dataclasses.replace(copy_, step=state.step)


def hold_steps(label, routine, state, batches, phase="context", update_from_card=False):
    """Each of ``batches`` as one train step without noise on the card and
    on a CPU copy of the same state: the loss, the gradients the update used
    (``p.grad``) and the parameters after it, each tensor within TRAIN_TOL
    (max |err| / max |CPU|). Returns the card's state after the steps.

    With ``update_from_card`` the parameters are held to a second CPU copy
    updated from the card's gradients, and the first copy's parameters
    after its update from its own gradients are printed beside them, not
    held: AdamW divides each gradient by its own running RMS, so gradients
    that are zero in exact arithmetic turn their rounding, some 1e-7 of the
    largest gradient in any two float32 computations, into updates of up to
    lr in either direction. Geo-FNO's spectral weights, drawn from U(0,
    1/width^2), are the size of lr (1e-3), and its smooth inputs leave many
    of their gradients at rounding level."""
    quiet = copy.copy(routine)
    quiet.noise_std = 0.0
    names = [n for n, _ in state.model.named_parameters()]
    for i, batch in enumerate(batches):
        plain = cpu_copy(routine, state)
        fed = cpu_copy(routine, state) if update_from_card else plain
        state, metrics = quiet.train_step(state, batch)
        t0 = time.perf_counter()
        plain, want = quiet.train_step(plain, batch)
        cpu_s = time.perf_counter() - t0
        if update_from_card:
            fed = quiet.apply_grads(fed, [p.grad.cpu() for p in state.model.parameters()])
        loss, want_loss = float(metrics["train_loss"]), float(want["train_loss"])
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        rels, own = {}, {}
        for n, a, b, f in zip(names, state.model.parameters(), plain.model.parameters(),
                              fed.model.parameters(), strict=True):
            rels[n] = max(rel_err(a.grad, b.grad)[1], rel_err(a, f)[1])
            own[n] = rel_err(a, b)[1]
        worst, own_worst = max(rels, key=rels.get), max(own, key=own.get)
        what = ("gradients, and parameters after the CPU's update from the card's gradients"
                if update_from_card else "gradients and parameters after the step")
        log(f"{phase}: {label} step {i + 1} on the card vs a float32 CPU copy: loss {loss:.6f} "
            f"vs {want_loss:.6f} (rel {loss_rel:.2e}); {what} of {len(rels)} tensors, largest "
            f"rel {rels[worst]:.2e} ({worst}), tol {TRAIN_TOL:.0e}; the CPU's step {cpu_s:.1f} s"
            + (f"; parameters after the CPU's update from its own gradients (not held): largest "
               f"rel {own[own_worst]:.2e} ({own_worst})" if update_from_card else ""))
        if not (loss_rel <= TRAIN_TOL and rels[worst] <= TRAIN_TOL):
            raise AssertionError(f"{phase}: {label} step {i + 1} disagrees with its CPU copy")
    return state


def hold_at_cut_depth(name, cfg, builder, batches, dev, phase, accumulate=()):
    """``hold_steps`` of ``batches`` on the configuration ``cfg`` cut to
    HELD_LAYERS layers, from the commands' seed after the normalizer pass
    over ``accumulate``."""
    node = copy.deepcopy(cfg["routine"])
    node["model" if "model" in node else "conv"]["n_layers"] = HELD_LAYERS
    routine = build_routine(node, builder)
    state = routine.init(7231, builder.sample_batch(), dev)
    for batch in accumulate:
        state = routine.accumulate_step(state, batch)
    hold_steps(f"{name} at {HELD_LAYERS} layers", routine, state, batches, phase=phase)


def train_steps(routine, state, batches, dev):
    """``batches`` as train steps of ``state`` on the card, synchronized."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for batch in batches:
        state, _ = routine.train_step(state, batch, gen)
    torch.cuda.synchronize()
    return state


def time_steps(label, routine, state, batch, dev, steps=5, phase="context"):
    """ms per train step (mean of ``steps`` after 2 warm-ups, with noise)
    and the host CPU time per step. Returns the state after the steps and
    the ms per step."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        state, _ = routine.train_step(state, batch, gen)
    torch.cuda.synchronize()
    t0, cpu0 = time.perf_counter(), time.process_time()
    for _ in range(steps):
        state, metrics = routine.train_step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    cpu_ms = (time.process_time() - cpu0) / steps * 1e3
    if not math.isfinite(float(metrics["train_loss"])):
        raise AssertionError(f"{phase}: {label}: non-finite loss in the timed steps")
    log(f"{phase}: {label}: {step_ms:.3f} ms per train step (batch "
        f"{batch_count(batch)}, f32, mean "
        f"of {steps} after 2 warm-ups); host CPU time {cpu_ms:.3f} ms per step")
    return state, step_ms


def generate_vis(dev, tmp):
    """The torus_vis and torus_vis_force files on the card, and their
    invariants."""
    paths = {}
    for fname, (vis_seed, varying) in VIS_FILES.items():
        path = os.path.join(tmp, fname)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        navier_stokes(path, seed=vis_seed, varying_force=varying, device=dev, **VIS_GEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = VIS_GEN["n_train"] + VIS_GEN["n_valid"] + VIS_GEN["n_test"]
        for split, count in (("train", VIS_GEN["n_train"]), ("valid", VIS_GEN["n_valid"]),
                             ("test", VIS_GEN["n_test"])):
            u, f = load_array(path, f"{split}/u"), load_array(path, f"{split}/f")
            mu = load_array(path, f"{split}/mu")
            f_shape = (count, N, N, VIS_GEN["steps"]) if varying else (count, N, N)
            if u.shape != (count, N, N, VIS_GEN["steps"]) or f.shape != f_shape:
                raise AssertionError(f"context: {fname} {split}: u {u.shape}, f {f.shape}")
            if not (np.isfinite(u).all() and np.isfinite(f).all() and np.abs(f).max() > 0
                    and np.abs(u[..., 1] - u[..., 0]).max() > 0):
                raise AssertionError(f"context: {fname} {split}: fields not finite, force zero "
                                     "or trajectories constant")
            if not (VIS_GEN["mu_min"] <= mu.min() and mu.max() <= VIS_GEN["mu_max"]
                    and len(set(mu.tolist())) == count):
                raise AssertionError(f"context: {fname} {split}: mu {mu}")
        log(f"context: generate {fname} (seed {vis_seed}, {'varying' if varying else 'static'} "
            f"random force): {n} trajectories ({VIS_GEN['n_train']} / {VIS_GEN['n_valid']} / "
            f"{VIS_GEN['n_test']}, one batch a split, {math.ceil(VIS_GEN['t'] / VIS_GEN['delta']):,} "
            f"steps a batch, {VIS_GEN['steps']} records) in {wall:.3f} s, "
            f"{os.path.getsize(path):,} B; cut: the reference's 1,000 / 200 / 200 at 256^2 "
            f"(read at ssr 4)")
        paths[fname] = path
    return paths


def phase_context(dev, tmp, li_path):
    """The torus_vis slice at full width: generate its two files, train
    ``torus_vis/01_baseline`` and ``torus_vis_force/01_baseline`` through
    ``train`` (normalizer pass, CONTEXT_STEPS steps, the validation rollouts,
    the test pass) and ``test``, hold CONTEXT_STEPS further steps of each and
    of 3 ablations to a CPU copy, time them, and serve ``torus_vis/02_no_mu``
    through an artifact that takes a force."""
    phase_start = time.perf_counter()
    vis = generate_vis(dev, tmp)
    reset_launch_counts()
    for name in VIS_CONFIGS:
        path = vis["torus_vis.h5" if name.startswith("torus_vis/") else "torus_vis_force.h5"]
        overrides = [f"builder.data_path={path}", "builder.ssr=1", "trainer.max_epochs=2"]
        cfg = load_config(name, overrides)
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"], builder)
        # The device-resident epoch: every full batch of the (t, t + k) pairs once.
        want = len(builder.train_data["x"]) // builder.batch_size
        before = launch_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as run:
            trainer, state = train.main(name, overrides, config_dir=run, device="cuda")
            fit_s = time.perf_counter() - t0
            logs = test_command.main(name, overrides=overrides, config_dir=run, device="cuda")
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        scalars = {k: float(v) for k, v in logs.items() if np.ndim(v) == 0}
        log(f"context: {name}: train ({trainer.global_step} steps of the device-resident epoch "
            f"after the normalizer pass, want {want}; {fit_s:.1f} s with validation and test; "
            f"n_params {trainer.logs['n_params']:,}, input channels "
            f"{state.model.in_proj.in_features}), test {json.dumps(scalars)}; launches {launched}")
        if trainer.global_step != want or logs["test_correlations"].shape != (N_STEPS,):
            raise AssertionError(f"context: {name}: {trainer.global_step} steps, correlations "
                                 f"{logs['test_correlations'].shape}")
        if not all(np.isfinite(v).all() for v in logs.values()) or not all(
                np.array_equal(logs[k], trainer.logs[k]) for k in logs):
            raise AssertionError(f"context: {name}: test logs not finite or not train's {scalars}")
        if not all(n > 0 for n in launched.values()):
            raise AssertionError(f"context: {name}: a kernel was never launched {launched}")
        batches = list(zip(range(CONTEXT_STEPS), builder.train_batches(np.random.default_rng(0))))
        state = hold_steps(name, routine, state, [b for _, b in batches])
        time_steps(name, routine, state, batches[0][1], dev)

    for name in ABLATIONS:
        overrides = data_overrides(li_path)
        cfg = load_config(name, overrides)
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"], builder)
        state = routine.init(7231, builder.sample_batch(), dev)
        batches = [b for _, b in zip(range(2 * CONTEXT_STEPS),
                                     builder.train_batches(np.random.default_rng(0)))]
        for batch in batches[:CONTEXT_STEPS]:
            state = routine.accumulate_step(state, batch)
        hold_at_cut_depth(name, cfg, builder, batches[CONTEXT_STEPS:], dev, "context",
                          accumulate=batches[:CONTEXT_STEPS])
        before = launch_counts()
        state = train_steps(routine, state, batches[CONTEXT_STEPS:], dev)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        log(f"context: {name}: n_params {routine.n_params(state):,}, input channels "
            f"{state.model.in_proj.in_features}; launches in {CONTEXT_STEPS} steps {launched}")
        time_steps(name, routine, state, batches[0], dev)

    serve_context(dev, vis["torus_vis.h5"])
    counts = launch_counts()
    log(f"context: launches over the context path {counts}; phase took "
        f"{time.perf_counter() - phase_start:.1f} s")
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"context: {name} was never launched on the context path")
    return counts


def serve_context(dev, path):
    """``torus_vis/02_no_mu`` (force, no viscosity) after its normalizer
    pass, exported at batch 1 and SERVE_STEPS steps: the artifact against
    the live serving module to the bit, its launches, and its ms per step
    beside the eager rollout's, both fed the same static force."""
    overrides = [f"builder.data_path={path}", "builder.ssr=1"]
    cfg = load_config(SERVE_CONFIG, overrides)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    state = routine.init(7231, builder.sample_batch(), dev)  # the commands' seed, trial 0
    for _, batch in zip(range(CONTEXT_STEPS), builder.train_batches(np.random.default_rng(0))):
        state = routine.accumulate_step(state, batch)
    routine.n_steps = SERVE_STEPS
    test = builder.test_data
    w0 = torch.as_tensor(test["data"][:1, ..., :1], device=dev)
    force = torch.as_tensor(test["f"][:1], device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "last.ckpt")
        save_state(ckpt, state)
        art = os.path.join(tmp, "rollout-force.pt2")
        t0 = time.perf_counter()
        export.main(SERVE_CONFIG, art, checkpoint_path=ckpt, overrides=overrides,
                    n_steps=SERVE_STEPS, batch_size=1, size=N, device="cuda")
        seconds = time.perf_counter() - t0
        artifact = load_exported(art)
        size = os.path.getsize(art)
    if not artifact.takes_force:
        raise AssertionError("context: the artifact of a force-taking routine takes no force")
    before = launch_counts()
    got = artifact(w0, force)
    torch.cuda.synchronize()
    calls = {k: v - before[k] for k, v in launch_counts().items()}
    want_calls = {k: N_LAYERS * SERVE_STEPS if KERNELS[k]["path"] == "infer" else 0
                  for k in calls}
    log(f"context: serve {SERVE_CONFIG}: export {seconds:.2f} s, file {size:,} B; launches in one "
        f"call {calls}")
    if calls != want_calls:
        raise AssertionError(f"context: the artifact launched {calls}, expected {want_calls}")
    with torch.no_grad():
        live = make_rollout_fn(routine, state, SERVE_STEPS)(w0, force)
    if tuple(got.shape) != (1, N, N, SERVE_STEPS) or not torch.equal(got, live):
        raise AssertionError(f"context: the artifact {tuple(got.shape)} differs from the live "
                             f"module (max |err| {rel_err(got, live)[0]:.3e})")
    data = torch.cat([w0, torch.zeros(1, N, N, SERVE_STEPS, device=dev)], -1)
    eager = lambda: routine.rollout(state, {"data": data, "f": force})[0]
    compare("context: artifact vs routine.rollout with the force", got, eager(), SERVE_TOL)
    fmt = lambda t: f"{t[0]:.3f} ms/step (min {t[1]:.3f}, max {t[2]:.3f})"
    log(f"context: serve {SERVE_CONFIG}: the artifact equals the live module to the bit; rollout "
        f"at batch 1: artifact {fmt(rollout_step_ms(lambda: artifact(w0, force)))}, eager "
        f"routine.rollout {fmt(rollout_step_ms(eager))} ({SERVE_STEPS} steps a call, median of "
        f"{SERVE_CALLS} calls after a warm-up)")


# --- phase mesh ----------------------------------------------------------------------------
def write_mesh_data(root, seed, families=("airfoil", "pipe", "plasticity")):
    """The Geo-FNO datasets of ``families`` at their shapes under ``root``
    (the registry's ``${DATA_ROOT}`` layout), made from ``seed``: smooth,
    per-sample deformed coordinate fields X, Y and smooth target fields of
    them; the plasticity input a smooth boundary profile and the output
    smooth in space and time. Float64, as the published files."""
    rng = np.random.default_rng(seed)

    def coords(n, sx, sy):
        u, v = np.linspace(0, 1, sx)[None, :, None], np.linspace(0, 1, sy)[None, None, :]
        a, b = rng.uniform(0.8, 1.2, (2, n, 1, 1))
        ph = rng.uniform(0, 2 * np.pi, (n, 1, 1))
        return (a * (4 * u - 2) + 0.1 * np.sin(2 * np.pi * v + ph),
                b * (2 * v - 1) * (1 + 0.5 * u) + 0.1 * np.cos(2 * np.pi * u + ph))

    def targets(x, y, channels):
        k = rng.uniform(0.5, 2.0, (x.shape[0], channels, 1, 1))
        ph = rng.uniform(0, 2 * np.pi, (x.shape[0], channels, 1, 1))
        return np.sin(k * x[:, None] + ph) * np.cos(k * y[:, None])

    files = {}
    for family, folder, prefix, (sx, sy), channels in (
            ("airfoil", "geo-fno/airfoil/naca", "NACA_Cylinder_", (221, 51), 5),
            ("pipe", "geo-fno/pipe", "Pipe_", (129, 129), 1)):
        if family not in families:
            continue
        n = sum(MESH_SPLITS[family])
        x, y = coords(n, sx, sy)
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        for name, a in (("X", x), ("Y", y), ("Q", targets(x, y, channels))):
            path = os.path.join(root, folder, f"{prefix}{name}.npy")
            np.save(path, a)
            files[path] = a.shape
    if "plasticity" not in families:
        return files
    import scipy.io

    n = sum(MESH_SPLITS["plasticity"])
    s1 = np.linspace(0, 1, 101)[None]
    inp = 1 + rng.uniform(0.1, 0.5, (n, 1)) * np.sin(np.pi * rng.uniform(1, 3, (n, 1)) * s1)
    grid = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 31), np.linspace(0, 1, 20),
                       indexing="ij")
    out = np.stack([np.sin((c + 1) * grid[0] * inp[:, :, None, None] + grid[2][None])
                    * np.cos(np.pi * grid[1][None]) for c in range(4)], axis=-1)
    path = os.path.join(root, "geo-fno/plasticity/plas_N987_T20.mat")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    scipy.io.savemat(path, {"input": inp, "output": out})
    files[path] = {"input": inp.shape, "output": out.shape}
    return files


def _mesh_overrides(name):
    train_size, valid_size, test_size = MESH_SPLITS[name.split("/")[0]]
    return [f"builder.train_size={train_size}", f"builder.valid_size={valid_size}",
            f"builder.test_size={test_size}"]


def _layers(name):
    return int(name.rsplit("/", 1)[1].split("_")[0])


def _mesh_launches(name, steps):
    """Launches of each kernel in ``steps`` train steps of a mesh config:
    every kernel once a layer in the 2D F-FNO, the feed-forward ones in the
    3D F-FNO (its spectral branches are the plain version, as in JAX) and in
    the CNOs (their DCT branches are plain torch, as in JAX), none in
    Geo-FNO."""
    if "/geo-fno" in name:
        return dict.fromkeys(KERNELS, 0)
    ff_only = name.startswith("plasticity/") or "/fcno/" in name
    return {k: 0 if ff_only and k.startswith("fused_mix") else _layers(name) * steps
            for k in KERNELS}


def phase_mesh(dev, tmp, seed):
    """The structured-mesh slice: the datasets at their shapes, made from the
    seed; ``airfoil/ffno/24_layers`` at full width through ``train``,
    ``test`` and ``predict`` by registry name, and the launches of its next
    steps counted; the steps of MESH_HELD held to a float32 CPU copy; each
    configuration's steps timed and their device time traced."""
    phase_start = time.perf_counter()
    root = os.path.join(tmp, "mesh_data")
    os.environ["DATA_ROOT"] = root  # the registry's data paths
    t0 = time.perf_counter()
    files = write_mesh_data(root, seed)
    log(f"mesh: wrote {len(files)} files in {time.perf_counter() - t0:.1f} s: "
        f"{ {os.path.relpath(k, root): v for k, v in files.items()} }")
    for family, got in MESH_SPLITS.items():
        log(f"mesh: cut: {family} splits (train, valid, test) {got} against the registry's "
            f"{MESH_REGISTRY_SPLITS[family]}")
    reset_launch_counts()

    t0 = time.perf_counter()
    over = _mesh_overrides(MESH_CONFIG)
    with tempfile.TemporaryDirectory() as run:
        trainer, state = train.main(MESH_CONFIG, over + ["trainer.max_epochs=1"], config_dir=run,
                                    device="cuda")
        logs = test_command.main(MESH_CONFIG, overrides=over, config_dir=run, device="cuda")
        ckpt = os.path.join(next(os.scandir(os.path.join(run, "checkpoints"))).path, "last.ckpt")
        seconds = predict.main(MESH_CONFIG, ckpt, overrides=over, device="cuda")
    launched = launch_counts()
    scalars = {k: float(v) for k, v in logs.items()}
    log(f"mesh: {MESH_CONFIG}: train, test and predict took {time.perf_counter() - t0:.1f} s")
    log(f"mesh: {MESH_CONFIG}: train ({trainer.global_step} steps, n_params "
        f"{trainer.logs['n_params']:,}, train_loss {trainer.logs['train_loss']:.6f}, valid_loss "
        f"{trainer.logs['valid_loss']:.6f}), test {json.dumps(scalars)}, predict {seconds:.6e} s "
        f"a sample; launches {launched}")
    if trainer.global_step != MESH_SPLITS["airfoil"][0] // 10 or not all(
            math.isfinite(v) and v == trainer.logs[k] for k, v in scalars.items()):
        raise AssertionError(f"mesh: {MESH_CONFIG}: {trainer.global_step} steps, test logs "
                             f"{scalars} not finite or not train's")
    if not all(n > 0 for n in launched.values()):
        raise AssertionError(f"mesh: {MESH_CONFIG}: a kernel was never launched {launched}")

    for name in (MESH_CONFIG,) + MESH_HELD:
        t0 = time.perf_counter()
        cfg = load_config(name, _mesh_overrides(name))
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"], builder)
        batches = [b for _, b in zip(range(MESH_STEPS),
                                     builder.train_batches(np.random.default_rng(0)))]
        if name != MESH_CONFIG:  # MESH_CONFIG was trained above: its steps are counted, not held
            state = routine.init(7231, builder.sample_batch(), dev)  # the commands' seed
        if name in MESH_HELD_CUT:
            hold_at_cut_depth(name, cfg, builder, batches, dev, "mesh")
        before = launch_counts()
        if name == MESH_CONFIG or name in MESH_HELD_CUT:
            state = train_steps(routine, state, batches, dev)
        else:
            state = hold_steps(name, routine, state, batches, phase="mesh",
                               update_from_card="/geo-fno" in name)
        steps = {k: v - before[k] for k, v in launch_counts().items()}
        model = cfg["routine"]["model"]
        modes = [model[k] for k in ("modes_x", "modes_y", "modes_z", "modes1", "modes2", "modes3")
                 if k in model]
        log(f"mesh: {name}: n_params {routine.n_params(state):,}, x {batches[0]['x'].shape}, y "
            f"{batches[0]['y'].shape}, width {model['width']}, modes {modes}; launches in "
            f"{MESH_STEPS} steps {steps}")
        if steps != _mesh_launches(name, MESH_STEPS):
            raise AssertionError(f"mesh: {name}: launches {steps}, expected "
                                 f"{_mesh_launches(name, MESH_STEPS)}")
        state, step_ms = time_steps(name, routine, state, batches[0], dev, phase="mesh")
        profile_train_step(routine, state, batches[0], None, step_ms, label=f"mesh: {name}",
                           groups=BASELINE_GROUPS if "/geo-fno" in name else STEP_GROUPS)
        log(f"mesh: {name}: {time.perf_counter() - t0:.1f} s")
    counts = launch_counts()
    log(f"mesh: launches over the mesh path {counts}; phase took "
        f"{time.perf_counter() - phase_start:.1f} s")
    return counts


# --- phase kolmogorov ----------------------------------------------------------------------
def _kol_overrides(split, kind):
    """The cuts of the protocol's data config ``kind`` for ``split``."""
    ks = tuple(size for size in (32, 64, 128) if size < KOL_SIM) + (
        (KOL_SIM,) if split != "valid" or kind == "initial_conditions" else ())
    k = 1 if kind == "initial_conditions" else 4
    over = [f"sim_grid.shape=[{KOL_SIM},{KOL_SIM}]", f"n_trajectories={KOL_SPLITS[split]}",
            f"generation_batch={KOL_SPLITS[split]}",
            "out_sizes=" + json.dumps([{"size": size, "k": k} for size in ks])]
    if kind == "initial_conditions":
        return over + [f"inner_steps={KOL_IC_INNER}"]
    return over + [f"inner_steps={KOL_TRAJ_INNER}", f"outer_steps={KOL_OUTER}",
                   f"init_path=${{oc.env:DATA_ROOT}}/kolmogorov/re_1000/initial_conditions/"
                   f"{split}_{KOL_SIM}.nc"]


def reference_cnrk4_step(w, visc, drag, dt):
    """One float64 numpy CN-RK4 step of the Kolmogorov vorticity equation on
    [0, 2 pi)^2 (integer wavenumbers, full fft2, the circular 2/3 filter,
    forcing cos(4y) along x, viscosity and linear drag), for one field."""
    from fourierflow_tpu_torch.utils.equations import _CK_ALPHAS, _CK_BETAS, _CK_GAMMAS

    n = w.shape[-1]
    m = np.fft.fftfreq(n, d=1.0 / n)
    mx, my = np.meshgrid(m, m, indexing="ij")
    lap = -(mx ** 2 + my ** 2)
    lap_safe = np.where(lap == 0, 1.0, lap)
    filt = (mx ** 2 + my ** 2) <= (2.0 / 3.0 * (n // 2)) ** 2
    y = np.arange(n) * 2 * np.pi / n
    f_hat = np.fft.fft2(np.broadcast_to(np.cos(4 * y)[None, :], (n, n)))
    curl_f = 1j * (-my * f_hat)
    real = lambda a: np.real(np.fft.ifft2(a))
    linear = visc * lap - drag

    def explicit(w_hat):
        psi = -w_hat / lap_safe
        vx, vy = real(1j * my * psi), real(-1j * mx * psi)
        adv = np.fft.fft2(-(real(1j * mx * w_hat) * vx + real(1j * my * w_hat) * vy))
        return adv * filt + curl_f

    u = np.fft.fft2(w)
    h = np.zeros_like(u)
    for k in range(5):
        h = explicit(u) + _CK_BETAS[k] * h
        mu = 0.5 * dt * (_CK_ALPHAS[k + 1] - _CK_ALPHAS[k])
        u = (u + _CK_GAMMAS[k] * dt * h + mu * linear * u) / (1 - mu * linear)
    return real(u)


def generate_kolmogorov_data(dev, root):
    """The protocol's initial conditions and trajectories of the three splits
    through ``generate kolmogorov`` by registry name, cut as printed, and
    the files' invariants. Returns the seconds each call took."""
    from fourierflow_tpu_torch.commands.generate import kolmogorov as generate
    from fourierflow_tpu_torch.ops.fourier import irfft2
    from fourierflow_tpu_torch.utils.grids import Grid, rfft_mesh
    from fourierflow_tpu_torch.utils.spectral import velocity_to_vorticity_fd

    base = os.path.join(root, "kolmogorov", "re_1000")
    p = KOL_PROTOCOL
    scale = p["sim"] // KOL_SIM
    log(f"kolmogorov: cut: simulated at {KOL_SIM}^2 instead of {p['sim']}^2, at its own CFL "
        f"step ({scale}x the {p['sim']}^2 one): inner steps {KOL_IC_INNER} / {KOL_TRAJ_INNER} "
        f"for the protocol's {p['ic_inner']} / {p['traj_inner']} keep the simulated time "
        f"(warm-up {p['warmup']} outer steps, 40 time units)")
    log(f"kolmogorov: cut: {' / '.join(str(n) for n in KOL_SPLITS.values())} trajectories "
        f"(train / valid / test) instead of {p['n']} each; {KOL_OUTER} records instead of "
        f"{p['outer']:,}; outputs at 32, 64, 128 (k 4) and {KOL_SIM} (train, test) instead of "
        f"32-128 (k 1) and 32-256 (k 4)")
    seconds = {}
    for kind in ("initial_conditions", "trajectories"):
        for split in KOL_SPLITS:
            name = f"data/kolmogorov/re_1000/{kind}/{split}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths = generate(name, _kol_overrides(split, kind), device=dev,
                             out_dir=os.path.join(base, kind))
            seconds[(kind, split)] = time.perf_counter() - t0
            log(f"kolmogorov: generate {name}: {seconds[(kind, split)]:.2f} s, "
                f"{sum(os.path.getsize(q) for q in paths):,} B in {len(paths)} files")
    total = sum(e.stat().st_size for d in ("initial_conditions", "trajectories")
                for e in os.scandir(os.path.join(base, d)))
    log(f"kolmogorov: {total:,} B of data")

    # Invariants: finite, zero-mean vorticity, velocities whose finite-difference
    # curl is the stored vorticity (spectral at the simulation's own size), and the
    # enstrophy: d rms(w)/dt <= rms(curl f) - drag rms(w), so rms(w(t)) <= max(rms(w(0)),
    # rms(curl f) / drag) with rms(curl f) = 4 / sqrt(2) and drag 0.1.
    bound_rms = 4 / math.sqrt(2) / 0.1
    for split in KOL_SPLITS:
        w0 = load_array(os.path.join(base, "initial_conditions", f"{split}_{KOL_SIM}.h5"),
                        "vorticity")
        rms0 = np.sqrt((w0.astype(np.float64) ** 2).mean(axis=(1, 2))).max()
        for size in sorted({32, 64, 128, KOL_SIM}):
            path = os.path.join(base, "trajectories", f"{split}_{size}_4.h5")
            if not os.path.exists(path):
                continue
            w, vx, vy = (load_array(path, f) for f in ("vorticity", "vx", "vy"))
            shape = (KOL_SPLITS[split], KOL_OUTER // 4, size, size)
            if w.shape != shape or not all(np.isfinite(a).all() for a in (w, vx, vy)):
                raise AssertionError(f"kolmogorov: {path}: shape {w.shape}, or not finite")
            mean = float(np.abs(w.mean(axis=(2, 3))).max() / np.abs(w).max())
            if size < KOL_SIM:  # downsampled: the vorticity is the fd curl of the velocities
                grid = Grid((size, size), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
                curl = velocity_to_vorticity_fd(torch.from_numpy(vx), torch.from_numpy(vy), grid)
                how, tol = "fd", 1e-5
            else:  # the simulation's own fields: the spectral curl
                kx, ky = (torch.from_numpy(k) for k in rfft_mesh((size, size)))
                vx_hat, vy_hat = (torch.fft.rfft2(torch.from_numpy(v)) for v in (vx, vy))
                curl = irfft2(2j * np.pi * (kx * vy_hat - ky * vx_hat), (size, size))
                how, tol = "spectral", 1e-4
            curl_err = rel_err(curl, torch.from_numpy(w))[1]
            curl_ok, curl_txt = curl_err <= tol, f"{how} curl of (vx, vy) vs w: rel {curl_err:.2e} (tol {tol:g})"
            rms = np.sqrt((w.astype(np.float64) ** 2).mean(axis=(2, 3)))
            log(f"kolmogorov: {split}_{size}_4: {w.shape}, max |spatial mean| / max |w| "
                f"{mean:.2e} (tol {MEAN_TOL:g}); {curl_txt}; rms(w) in "
                f"[{rms.min():.4f}, {rms.max():.4f}] from rms(w0) <= {rms0:.4f}; "
                f"max |w| {np.abs(w).max():.3f}")
            enstrophy_ok = size < KOL_SIM or rms.max() <= ENSTROPHY_SLACK * max(rms0, bound_rms)
            if not (mean <= MEAN_TOL and curl_ok and enstrophy_ok
                    and np.abs(w[:, 1] - w[:, 0]).max() > 0):
                raise AssertionError(f"kolmogorov: an invariant of {path} does not hold")
    return seconds


def kolmogorov_solver_checks(dev, root):
    """The card's solve against the CPU's and against one float64 step, the
    CUDA-graph run against the eager one, and the solver's time per step."""
    from fourierflow_tpu_torch.ops.fourier import irfft2
    from fourierflow_tpu_torch.utils.equations import repeated

    name = "data/kolmogorov/re_1000/trajectories/test"
    grid = (KOL_SIM, KOL_SIM)
    cfg = load_config(name, [f"sim_grid.shape=[{KOL_SIM},{KOL_SIM}]"])
    dt = instantiate(cfg["time_step"])
    step = instantiate(cfg["step_fn"])
    eq = cfg["step_fn"]["equation"]
    w0 = load_array(os.path.join(root, "kolmogorov", "re_1000", "initial_conditions",
                                 f"test_{KOL_SIM}.h5"), "vorticity")
    state = torch.fft.rfft2(torch.from_numpy(w0))
    card = irfft2(repeated(step, KOL_CHECK_STEPS)(state.to(dev)), grid).cpu()
    cpu = irfft2(repeated(step, KOL_CHECK_STEPS)(state), grid)
    err, rel = rel_err(card, cpu)
    log(f"kolmogorov: card vs CPU solve ({KOL_SIM}^2, Re 1000, dt {dt:.6g}, {KOL_CHECK_STEPS} "
        f"steps, {len(w0)} fields): max_abs_err {err:.3e} rel {rel:.3e} tol {KOL_SOLVER_TOL:g}")
    if not rel <= KOL_SOLVER_TOL:
        raise AssertionError("kolmogorov: the card's solve disagrees with the CPU's")
    one = irfft2(step(state.to(dev)), grid).cpu()
    ref = np.stack([reference_cnrk4_step(w.astype(np.float64), eq["viscosity"], eq["drag"], dt)
                    for w in w0])
    err, rel = rel_err(one, torch.from_numpy(ref))
    log(f"kolmogorov: one step on the card vs a float64 numpy CN-RK4: max_abs_err {err:.3e} "
        f"rel {rel:.3e} tol {KOL_REF_TOL:g}")
    if not rel <= KOL_REF_TOL:
        raise AssertionError("kolmogorov: the card's step disagrees with the float64 reference")
    s = state.to(dev)
    eager = repeated(step, 21)(s)
    graph = graph_repeated(step, s, 8)(s, 21)
    if not torch.equal(eager, graph):
        raise AssertionError("kolmogorov: the CUDA-graph solve differs from the eager one")
    log("kolmogorov: CUDA-graph solve equals the eager solve to the bit (21 steps: 2 replays "
        "of an 8-step graph and 5 eager steps)")
    del eager, graph

    step_ms = {}
    for n, batch, graph_steps in ((KOL_SIM, KOL_SPLITS["train"], 8),
                                  (KOL_SIM, KOL_SPLITS["train"], 0),
                                  (KOL_PROTOCOL["sim"], KOL_PROTOCOL["n"], 0)):
        cfg = load_config(name, [f"sim_grid.shape=[{n},{n}]"])
        step = instantiate(cfg["step_fn"])
        x = torch.linspace(0, 2 * math.pi * (1 - 1 / n), n, device=dev)
        w = torch.sin(4 * x)[None, :, None] * torch.cos(3 * x)[None, None, :] + 0.1 * torch.randn(
            batch, n, n, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        s = torch.fft.rfft2(w)
        ms = timed_step_ms(step, s, graph_steps, KOL_TIMED_STEPS)
        step_ms[(n, batch, graph_steps)] = ms
        state_bytes = 2 * batch * n * (n // 2 + 1) * 8  # complex64 state, read and written
        log(f"kolmogorov: solver step at {n}^2, batch {batch} "
            f"({f'graph of {graph_steps}' if graph_steps else 'eager'}): {ms:.4f} ms; bound "
            f"{state_bytes / MEM_RATE * 1e3:.5f} ms (the state read and written once, bytes)")
        del step, s, w
        torch.cuda.empty_cache()
    p = KOL_PROTOCOL
    ms = step_ms[(p["sim"], p["n"], 0)]
    for kind, steps in (("initial_conditions", p["warmup"] * p["ic_inner"]),
                        ("trajectories", p["outer"] * p["traj_inner"])):
        log(f"kolmogorov: projected protocol data/kolmogorov/re_1000/{kind}/train ({p['n']} "
            f"trajectories in one batch at {p['sim']}^2, {steps:,} steps): {steps * ms / 1e3:.1f} s "
            f"of solver steps")
    return step_ms


def kolmogorov_train_64(dev, run):
    """``train`` of the grid_sizes/64 config at full width (normalizer pass,
    one device-resident epoch, the validation with the reduced metrics, the
    test pass),
    ``test`` on its checkpoint, a rollout saved by ``save_predictions`` and
    read back, 24 launches of each kernel in one step, KOL_STEPS steps held
    to a CPU copy and timed. Returns the checkpoint."""
    overrides = ["trainer.max_epochs=2"]
    cfg = load_config(KOL_CONFIG, overrides)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    # The device-resident epoch over the virtual (trajectory, time) pairs: full batches only.
    want = len(builder.train_dataset) // builder.batch_size
    t0 = time.perf_counter()
    trainer, state = train.main(KOL_CONFIG, overrides, config_dir=run, device="cuda")
    logs = trainer.logs
    scalars = lambda d: {k: round(float(v), 6) for k, v in d.items() if np.ndim(v) == 0}
    log(f"kolmogorov: {KOL_CONFIG}: train ({trainer.global_step} steps of the device-resident "
        f"epoch after the normalizer pass, want {want} ({len(builder.train_dataset)} pairs); "
        f"{time.perf_counter() - t0:.1f} s; n_params {logs['n_params']:,}, input channels "
        f"{state.model.in_proj.in_features}): valid_time_until {logs['valid_time_until']:g}, "
        f"valid_reduced_time_until {logs['valid_reduced_time_until']:g}, valid_corr "
        f"{logs['valid_corr']:.6f}, valid_reduced_corr {logs['valid_reduced_corr']:.6f}, "
        f"valid_loss {logs['valid_loss']:.6f}")
    test_logs = test_command.main(KOL_CONFIG, overrides=overrides, config_dir=run, device="cuda")
    log(f"kolmogorov: {KOL_CONFIG}: test {json.dumps(scalars(test_logs))}")
    if (trainer.global_step != want or state.model.in_proj.in_features != 5
            or test_logs["test_reduced_correlations"].shape != (N_STEPS,)
            or not all(np.isfinite(np.asarray(v, np.float64)).all() for v in test_logs.values())):
        raise AssertionError(f"kolmogorov: {KOL_CONFIG}: {trainer.global_step} steps, logs "
                             f"{scalars(test_logs)}")
    ckpt = os.path.join(next(os.scandir(os.path.join(run, "checkpoints"))).path, "last.ckpt")

    batch = next(builder.test_batches())
    preds = routine.rollout(state, batch)[0]
    path = routine.save_predictions(preds, times=batch["times"][0, -preds.shape[-1]:],
                                    path=os.path.join(run, "predictions.h5"))
    saved = {k: load_array(path, k) for k in ("vorticity", "vx", "vy", "time", "x", "y")}
    shapes = {k: v.shape for k, v in saved.items()}
    if (saved["vorticity"].shape != tuple(preds.shape) or saved["vx"].shape != tuple(preds.shape)
            or not np.array_equal(saved["vorticity"], preds.cpu().numpy())
            or saved["x"].shape != (N,)):
        raise AssertionError(f"kolmogorov: save_predictions wrote {shapes}")
    log(f"kolmogorov: save_predictions wrote {os.path.getsize(path):,} B, read back: {shapes}, "
        f"the vorticity equal to the rollout's")

    train_batches = [b for _, b in zip(range(KOL_STEPS), builder.train_batches(
        np.random.default_rng(0)))]
    before = launch_counts()
    state, _ = routine.train_step(state, train_batches[0], trainer.step_generator(dev))
    torch.cuda.synchronize()
    step_counts = {k: v - before[k] for k, v in launch_counts().items()}
    log(f"kolmogorov: launches in one train step {step_counts}")
    if any(n != N_LAYERS for n in step_counts.values()):
        raise AssertionError(f"kolmogorov: expected {N_LAYERS} launches of each kernel per step")
    state = hold_steps(KOL_CONFIG, routine, state, train_batches, phase="kolmogorov")
    time_steps(KOL_CONFIG, routine, state, train_batches[0], dev, phase="kolmogorov")
    return ckpt


def phase_kolmogorov(dev, tmp):
    """The Kolmogorov slice: its data on the card through ``generate
    kolmogorov`` by registry name, the solver held to the CPU, to a float64
    step and to its eager self, ``torus_kochkov/ffno/grid_sizes/64`` at full
    width through ``train`` and ``test`` with the reduced metrics and saved
    predictions, 128^2 and 256^2 steps held to CPU copies, the 256^2
    super-resolution test of the 64^2 checkpoint and multi-resolution
    training."""
    phase_start = time.perf_counter()
    root = os.path.join(tmp, "data")
    os.environ["DATA_ROOT"] = root  # the registry's data paths
    reset_launch_counts()
    generate_kolmogorov_data(dev, root)
    kolmogorov_solver_checks(dev, root)
    with tempfile.TemporaryDirectory() as run:
        ckpt = kolmogorov_train_64(dev, run)
        before = launch_counts()
        logs = test_command.main(KOL_SUPERRES, ckpt, device="cuda")
        launched = {k: v - before[k] for k, v in launch_counts().items()}
    log(f"kolmogorov: {KOL_SUPERRES}: test of the 64^2 checkpoint on the {KOL_SIM}^2 test "
        f"trajectories: test_time_until {logs['test_time_until']:g}, test_reduced_time_until "
        f"{logs['test_reduced_time_until']:g}, test_reduced_corr {logs['test_reduced_corr']:.6f}; "
        f"launches {launched}")
    if not (np.isfinite(logs["test_loss"]) and launched["fused_mix_2d"] == N_LAYERS * N_STEPS):
        raise AssertionError(f"kolmogorov: {KOL_SUPERRES}: {logs['test_loss']}, {launched}")

    for name in KOL_GRIDS:
        over = []
        if name.endswith(f"/{KOL_SIM}"):  # no valid file at this size: the test split stands in
            over = [f"builder.valid_dataset.{k}=${{oc.env:DATA_ROOT}}/kolmogorov/re_1000/{d}/test_"
                    f"{KOL_SIM}{suffix}.nc" for k, d, suffix in (
                        ("path", "trajectories", "_4"), ("init_path", "initial_conditions", ""))]
        cfg = load_config(name, over)
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"], builder)
        state = routine.init(7231, builder.sample_batch(), dev)
        batches = [b for _, b in zip(range(2 * KOL_GRID_STEPS),
                                     builder.train_batches(np.random.default_rng(0)))]
        for batch in batches[:KOL_GRID_STEPS]:
            state = routine.accumulate_step(state, batch)
        hold_at_cut_depth(name, cfg, builder, batches[KOL_GRID_STEPS:], dev, "kolmogorov",
                          accumulate=batches[:KOL_GRID_STEPS])
        before = launch_counts()
        state = train_steps(routine, state, batches[KOL_GRID_STEPS:], dev)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        log(f"kolmogorov: {name}: batch {len(batches[0]['x'])} of "
            f"{batches[0]['x'].shape[1]}^2, modes {cfg['routine']['conv']['modes']}; launches in "
            f"{KOL_GRID_STEPS} steps {launched}")
        if any(n != N_LAYERS * KOL_GRID_STEPS for n in launched.values()):
            raise AssertionError(f"kolmogorov: {name}: launches {launched}")
        time_steps(name, routine, state, batches[0], dev, phase="kolmogorov")

    overrides = ["trainer.max_epochs=2", "trainer.limit_train_batches=4"]
    cfg = load_config(KOL_MULTI, overrides)
    sizes = [b["x"].shape[1] for _, b in zip(range(4), instantiate(cfg["builder"]).train_batches(
        np.random.default_rng(0)))]
    with tempfile.TemporaryDirectory() as run:
        trainer, _ = train.main(KOL_MULTI, overrides, config_dir=run, device="cuda")
    log(f"kolmogorov: {KOL_MULTI}: {trainer.global_step} steps on batches of {sizes}^2 in turn, "
        f"valid_loss {trainer.logs['valid_loss']:.6f}, test_loss {trainer.logs['test_loss']:.6f}")
    if sizes != [32, 64, 32, 64] or trainer.global_step != 4 or not np.isfinite(
            trainer.logs["test_loss"]):
        raise AssertionError(f"kolmogorov: {KOL_MULTI}: sizes {sizes}, {trainer.global_step} steps")
    counts = launch_counts()
    log(f"kolmogorov: launches over the kolmogorov path {counts}; phase took "
        f"{time.perf_counter() - phase_start:.1f} s")
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"kolmogorov: {name} was never launched on the kolmogorov path")
    return counts


# --- phase pointcloud ----------------------------------------------------------------------
def write_elasticity_data(root, seed):
    """The elasticity files at their layouts under ``root`` (the registry's
    ``${DATA_ROOT}`` layout), made from ``seed``: 972 points a sample
    scattered in the unit square, 42 geometry parameters, and a stress smooth
    in the points and the parameters. Float64, as the published files."""
    rng = np.random.default_rng(seed)
    n = sum(POINT_SPLITS)
    xy = rng.uniform(0.0, 1.0, (n, POINT_N, 2))
    rr = rng.uniform(0.2, 0.4, (n, POINT_CODE))
    k, ph = rng.uniform(1.0, 3.0, (n, 1)), rng.uniform(0.0, 2 * np.pi, (n, 1))
    sigma = (1 + rr.mean(axis=1, keepdims=True)) * (
        1 + 0.5 * np.sin(2 * np.pi * k * xy[..., 0] + ph) * np.cos(np.pi * k * xy[..., 1]))
    folder = os.path.join(root, "geo-fno/elasticity/Meshes")
    os.makedirs(folder, exist_ok=True)
    files = {}
    for name, a in (("rr", rr.T), ("sigma", sigma.T), ("XY", xy.transpose(1, 2, 0))):
        path = os.path.join(folder, f"Random_UnitCell_{name}_10.npy")
        np.save(path, a)
        files[path] = a.shape
    return files


def _point_overrides(name):
    over = [f"builder.{k}_size={v}" for k, v in zip(("train", "valid", "test"), POINT_SPLITS)]
    if name == POINT_PLUS:  # no registry name: POINT_PLUS_CONFIG with this model
        over.append(f"routine.model._target_=fourierflow_tpu_torch.models.{POINT_PLUS}")
    return over


def _point_launches(name, steps):
    """Launches of each kernel in ``steps`` train steps: in the point-cloud
    F-FNO every kernel once a middle layer (``n_layers - 1``); in the
    fully-factorized model the feed-forwards of every layer but the last and
    the mixes of the middle layers; none in Geo-FNO."""
    if "/geo-fno" in name:
        return dict.fromkeys(KERNELS, 0)
    n = 4 if name == POINT_PLUS else _layers(name)
    ff = n if name == POINT_PLUS else n - 1
    return {k: (n - 1 if k.startswith("fused_mix") else ff) * steps for k in KERNELS}


def phase_pointcloud(dev, tmp, seed):
    """The point-cloud slice: the elasticity files at their layouts, made from
    the seed; ``elasticity/ffno/24_layers`` at full width through ``train``,
    ``test`` and ``predict`` by registry name, and the launches of its next
    steps counted; the steps of POINT_HELD held to a float32 CPU copy; each
    configuration's steps timed and their device time traced."""
    phase_start = time.perf_counter()
    root = os.path.join(tmp, "elasticity_data")
    os.environ["DATA_ROOT"] = root  # the registry's data paths
    files = write_elasticity_data(root, seed)
    log(f"pointcloud: wrote {len(files)} files: "
        f"{ {os.path.relpath(k, root): v for k, v in files.items()} }")
    log(f"pointcloud: cut: elasticity splits (train, valid, test) {POINT_SPLITS} against the "
        f"registry's {POINT_REGISTRY_SPLITS}")
    reset_launch_counts()

    t0 = time.perf_counter()
    over = _point_overrides(POINT_CONFIG)
    with tempfile.TemporaryDirectory() as run:
        trainer, state = train.main(POINT_CONFIG, over + ["trainer.max_epochs=1"],
                                    config_dir=run, device="cuda")
        logs = test_command.main(POINT_CONFIG, overrides=over, config_dir=run, device="cuda")
        ckpt = os.path.join(next(os.scandir(os.path.join(run, "checkpoints"))).path, "last.ckpt")
        seconds = predict.main(POINT_CONFIG, ckpt, overrides=over, device="cuda")
    launched = launch_counts()
    scalars = {k: float(v) for k, v in logs.items()}
    log(f"pointcloud: {POINT_CONFIG}: train, test and predict took "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"pointcloud: {POINT_CONFIG}: train ({trainer.global_step} steps, n_params "
        f"{trainer.logs['n_params']:,}, train_loss {trainer.logs['train_loss']:.6f}, "
        f"train_loss_reg {trainer.logs['train_loss_reg']:.6f}, valid_loss "
        f"{trainer.logs['valid_loss']:.6f}), test {json.dumps(scalars)}, predict {seconds:.6e} s "
        f"a sample; launches {launched}")
    if trainer.global_step != POINT_SPLITS[0] // 20 or not all(
            math.isfinite(v) and v == trainer.logs[k] for k, v in scalars.items()):
        raise AssertionError(f"pointcloud: {POINT_CONFIG}: {trainer.global_step} steps, test "
                             f"logs {scalars} not finite or not train's")
    if not all(n > 0 for n in launched.values()):
        raise AssertionError(f"pointcloud: {POINT_CONFIG}: a kernel was never launched {launched}")

    for name in (POINT_CONFIG,) + POINT_HELD:
        t0 = time.perf_counter()
        cfg = load_config(POINT_PLUS_CONFIG if name == POINT_PLUS else name,
                          _point_overrides(name))
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"], builder)
        batches = [b for _, b in zip(range(POINT_STEPS),
                                     builder.train_batches(np.random.default_rng(0)))]
        before = launch_counts()
        if name == POINT_CONFIG:  # trained above: its steps are counted, not held
            for batch in batches:
                state, _ = routine.train_step(state, batch)
            torch.cuda.synchronize()
        else:
            state = routine.init(7231, builder.sample_batch(), dev)  # the commands' seed
            state = hold_steps(name, routine, state, batches, phase="pointcloud",
                               update_from_card="/geo-fno" in name)
        steps = {k: v - before[k] for k, v in launch_counts().items()}
        model = cfg["routine"]["model"]
        log(f"pointcloud: {name}: n_params {routine.n_params(state):,}, xy "
            f"{batches[0]['xy'].shape}, rr {batches[0]['rr'].shape}, grid {model['s1']}^2, width "
            f"{model['width']}, modes {model['modes1']}; launches in {POINT_STEPS} steps {steps}")
        if steps != _point_launches(name, POINT_STEPS):
            raise AssertionError(f"pointcloud: {name}: launches {steps}, expected "
                                 f"{_point_launches(name, POINT_STEPS)}")
        gen = torch.Generator(device=dev).manual_seed(0)  # the IPhi term's samples
        state, step_ms = time_steps(name, routine, state, batches[0], dev, phase="pointcloud")
        profile_train_step(routine, state, batches[0], gen, step_ms, label=f"pointcloud: {name}",
                           groups=BASELINE_GROUPS if "/geo-fno" in name else STEP_GROUPS)
        log(f"pointcloud: {name}: {time.perf_counter() - t0:.1f} s")
    counts = launch_counts()
    log(f"pointcloud: launches over the pointcloud path {counts}; phase took "
        f"{time.perf_counter() - phase_start:.1f} s")
    return counts


# --- phase cno -----------------------------------------------------------------------------
def dct_branches_ms(x_shape, modes, n_layers, dev):
    """Device ms of the DCT branches of ``n_layers`` layers of a train step:
    one layer's branches (a ``dct_mix_axis`` on each spatial axis, summed)
    forward and backward (x and the weights) at the step's shape, alone,
    times ``n_layers``. Traced as ``profile_train_step`` traces the step
    (the sum of the device events over the calls), so that an event the
    profiler loses in this process, after the solvers' CUDA graphs, counts
    alike in both; CUDA events would time the host, which launches these
    small kernels slower than the card runs them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cpu").manual_seed(0)
    r = lambda *shape: torch.randn(*shape, generator=g).to(dev).requires_grad_()
    width = x_shape[-1]
    x, ws = r(*x_shape), [r(width, width, m) for m in modes]
    go = torch.randn(x_shape, generator=g).to(dev)

    def run():
        out = dct_mix_axis(x, ws[0], 1)
        for axis, w in enumerate(ws[1:], 2):
            out = out + dct_mix_axis(x, w, axis)
        torch.autograd.grad(out, [x, *ws], go)

    iters = 20
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return us / iters / 1e3 * n_layers


def _cno_step(label, routine, state, batch, dev, x_shape, modes, n_layers):
    """A CNO configuration's train step: its ms, its traced device time, and
    the DCT branches' share of that device time."""
    state, step_ms = time_steps(label, routine, state, batch, dev, phase="cno")
    gen = torch.Generator(device=dev).manual_seed(0)
    dev_ms = profile_train_step(routine, state, batch, gen, step_ms, label=f"cno: {label}")
    dct_ms = dct_branches_ms(x_shape, modes, n_layers, dev)
    log(f"cno: {label}: DCT branches (forward and backward, {n_layers} layers of x {x_shape}, "
        f"traced alone) {dct_ms:.3f} ms of the step's {dev_ms:.3f} ms of traced device time "
        f"({dct_ms / dev_ms:.1%})")
    return state


def phase_cno(dev, tmp):
    """The CNO slice: ``airfoil/fcno/4_layers`` and ``plasticity/fcno/4_layers``
    held to a float32 CPU copy on phase mesh's files; ``torus_kochkov/fcno/
    grid_sizes/64`` at full width through ``train`` by registry name on phase
    kolmogorov's files, its step at 4 layers held to a CPU copy; each step
    timed and traced, with the share of its device time in the DCT
    branches."""
    phase_start = time.perf_counter()
    reset_launch_counts()
    os.environ["DATA_ROOT"] = os.path.join(tmp, "mesh_data")  # phase mesh's files
    for name in CNO_HELD:
        t0 = time.perf_counter()
        cfg = load_config(name, _mesh_overrides(name))
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"], builder)
        batches = [b for _, b in zip(range(CNO_STEPS),
                                     builder.train_batches(np.random.default_rng(0)))]
        state = routine.init(7231, builder.sample_batch(), dev)
        before = launch_counts()
        state = hold_steps(name, routine, state, batches, phase="cno")
        steps = {k: v - before[k] for k, v in launch_counts().items()}
        model = cfg["routine"]["model"]
        modes = [model[k] for k in ("modes_x", "modes_y", "modes_z") if k in model]
        log(f"cno: {name}: n_params {routine.n_params(state):,}, x {batches[0]['x'].shape}, "
            f"width {model['width']}, modes {modes}; launches in {CNO_STEPS} steps {steps}")
        if steps != _mesh_launches(name, CNO_STEPS):
            raise AssertionError(f"cno: {name}: launches {steps}, expected "
                                 f"{_mesh_launches(name, CNO_STEPS)}")
        b, *spatial, _ = batches[0]["x"].shape  # the padding is 8 on the high side
        _cno_step(name, routine, state, batches[0], dev,
                  (b, *(n + 8 for n in spatial), model["width"]), modes, _layers(name))
        log(f"cno: {name}: {time.perf_counter() - t0:.1f} s")

    os.environ["DATA_ROOT"] = os.path.join(tmp, "data")  # phase kolmogorov's files
    t0 = time.perf_counter()
    overrides = ["trainer.max_epochs=2"]
    cfg = load_config(CNO_CONFIG, overrides)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    want = len(builder.train_dataset) // builder.batch_size  # the device-resident epoch's
    before = launch_counts()
    with tempfile.TemporaryDirectory() as run:
        trainer, state = train.main(CNO_CONFIG, overrides, config_dir=run, device="cuda")
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    logs = trainer.logs
    log(f"cno: {CNO_CONFIG}: train ({trainer.global_step} steps of the device-resident epoch "
        f"after the normalizer pass, want {want}; "
        f"n_params {logs['n_params']:,}): valid_time_until {logs['valid_time_until']:g}, "
        f"valid_loss {logs['valid_loss']:.6f}, test_loss {logs['test_loss']:.6f}; "
        f"launches {launched}; {time.perf_counter() - t0:.1f} s")
    if (trainer.global_step != want or not np.isfinite(logs["test_loss"])
            or launched["fused_ff_bwd"] != N_LAYERS * want or not launched["fused_ff"]):
        raise AssertionError(f"cno: {CNO_CONFIG}: {trainer.global_step} steps, launches "
                             f"{launched}, test_loss {logs['test_loss']}")
    batch = next(builder.train_batches(np.random.default_rng(0)))
    conv = cfg["routine"]["conv"]
    _cno_step(CNO_CONFIG, routine, state, batch, dev,
              (*batch["x"].shape[:-1], conv["width"]), [conv["modes"]] * 2, conv["n_layers"])

    name = f"{CNO_CONFIG} at 4 layers"
    cfg = load_config(CNO_CONFIG, ["routine.conv.n_layers=4"])
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    state = routine.init(7231, builder.sample_batch(), dev)
    batches = [b for _, b in zip(range(2 * CNO_STEPS),
                                 builder.train_batches(np.random.default_rng(0)))]
    for batch in batches[:CNO_STEPS]:
        state = routine.accumulate_step(state, batch)
    before = launch_counts()
    hold_steps(name, routine, state, batches[CNO_STEPS:], phase="cno")
    steps = {k: v - before[k] for k, v in launch_counts().items()}
    log(f"cno: {name}: launches in {CNO_STEPS} steps {steps}")
    if steps != {k: 0 if k.startswith("fused_mix") else 4 * CNO_STEPS for k in KERNELS}:
        raise AssertionError(f"cno: {name}: launches {steps}")
    counts = launch_counts()
    log(f"cno: launches over the cno path {counts}; phase took "
        f"{time.perf_counter() - phase_start:.1f} s")
    for k in ("fused_ff", "fused_ff_bwd"):
        if counts[k] < 1:
            raise AssertionError(f"cno: {k} was never launched on the cno path")
    return counts


# --- phase projection ----------------------------------------------------------------------
# Device-time groups of a projection solver step.
FV_GROUPS = (("cuFFT (the pressure solve)", ("fft",)), ("roll (periodic shifts)", ("roll",)))


def max_divergence(vel):
    """max |sum_i (v_i - v_i shifted one cell back along axis i)| over the
    last ``len(vel)`` axes: the cell size times the staggered grid's
    finite-difference divergence."""
    ndim = len(vel)
    div = sum(v.astype(np.float64) - np.roll(v, 1, axis=v.ndim - ndim + i)
              for i, v in enumerate(vel))
    return float(np.abs(div).max())


def check_velocity_file(path, ndim, own_size):
    """A projection file's invariants: every field finite, the velocities
    not all zero, and at the simulated size their divergence at most
    FV_DIV_TOL of the largest speed component."""
    names = ("vx", "vy", "vz")[:ndim]
    vel = [load_array(path, n) for n in names]
    fields = vel + ([load_array(path, "vorticity")] if ndim == 2 else [])
    vmax = max(float(np.abs(v).max()) for v in vel)
    div = max_divergence(vel) / vmax
    finite = all(np.isfinite(a).all() for a in fields)
    log(f"projection: {os.path.basename(path)}: {vel[0].shape}, finite {finite}, max |v| "
        f"{vmax:.4f}, max |h div v| / max |v| {div:.2e}"
        + (f" (tol {FV_DIV_TOL:g}, simulated size)" if own_size else " (downsampled)"))
    if not finite or vmax == 0 or (own_size and div > FV_DIV_TOL):
        raise AssertionError(f"projection: an invariant of {path} does not hold")


def timed_step_ms(step, state, graph_steps, timed):
    """ms per solver step: the difference of two timed runs of ``timed``
    steps (from a CUDA graph of ``graph_steps`` steps, or eagerly with 0),
    after a warm-up run."""
    run = graph_repeated(step, state, graph_steps)
    run(state, timed[0])
    wall = []
    for k in timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state, k)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return (wall[1] - wall[0]) / (timed[1] - timed[0]) * 1e3


def _fv_state(path, ndim, dev):
    return tuple(torch.from_numpy(load_array(path, n)).to(dev) for n in ("vx", "vy", "vz")[:ndim])


def generate_fv_data(dev, root):
    """The 2D initial conditions (pseudo-spectral, cut as printed), the
    control and projection_rk4/128 and the 3D configs at 64^3 through
    ``generate kolmogorov`` by registry name, and the files' invariants."""
    from fourierflow_tpu_torch.commands.generate import kolmogorov as generate

    base = os.path.join(root, "kolmogorov")
    log(f"projection: cut: initial conditions simulated at {FV_IC_SIM}^2 instead of 2048^2, at "
        f"its own CFL step (inner {FV_IC_INNER} of 64 keeps the warm-up's 40 time units), "
        f"{' / '.join(map(str, FV_SPLITS.values()))} trajectories instead of 32, outputs at 64 "
        f"and {FV_IC_SIM}")
    log(f"projection: cut: {FV_CONTROL}: {FV_CONTROL_OUTER} records of 2,441; {FV_RK4}: as "
        f"configured (200 records of 8 steps); both from the cut initial conditions")
    p = FV_3D_PROTOCOL
    log(f"projection: cut: {FV_3D_IC} / {FV_3D_TRAJ} through generate at {FV_3D_SIM}^3 "
        f"instead of {p['sim']}^3, {FV_3D_N} trajectories of {p['n']}, warm-up {FV_3D_WARMUP} "
        f"of {p['warmup']} outer steps, {FV_3D_OUTER} records of {p['outer']}")
    runs = [(f"data/kolmogorov/re_1000/initial_conditions/{split}",
             [f"sim_grid.shape=[{FV_IC_SIM},{FV_IC_SIM}]", f"n_trajectories={n}",
              f"generation_batch={n}", f"inner_steps={FV_IC_INNER}",
              "out_sizes=" + json.dumps([{"size": s, "k": 1} for s in sorted({64, FV_IC_SIM})])],
             os.path.join(base, "re_1000", "initial_conditions")) for split, n in FV_SPLITS.items()]
    sizes_3d = "out_sizes=" + json.dumps([{"size": s, "k": 1} for s in sorted({32, FV_3D_SIM})])
    runs += [
        (FV_CONTROL, ["generation_batch=4", f"outer_steps={FV_CONTROL_OUTER}"],
         os.path.join(base, "re_1000", "learned_interpolation")),
        (FV_RK4, [], os.path.join(base, "compare_methods", "downsampling", "projection_rk4")),
        (FV_3D_IC, [f"sim_grid.shape={[FV_3D_SIM] * 3}", f"n_trajectories={FV_3D_N}",
                    f"generation_batch={FV_3D_N}", f"warmup_steps={FV_3D_WARMUP}", sizes_3d],
         os.path.join(base, "three_dimensions", "initial_conditions")),
        (FV_3D_TRAJ, [f"sim_grid.shape={[FV_3D_SIM] * 3}", f"n_trajectories={FV_3D_N}",
                      f"generation_batch={FV_3D_N}", f"outer_steps={FV_3D_OUTER}", sizes_3d,
                      "init_path=${oc.env:DATA_ROOT}/kolmogorov/three_dimensions/"
                      f"initial_conditions/test_{FV_3D_SIM}.nc"],
         os.path.join(base, "three_dimensions", "trajectories"))]
    for name, over, out_dir in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = generate(name, over, device=dev, out_dir=out_dir)
        log(f"projection: generate {name}: {time.perf_counter() - t0:.2f} s, "
            f"{sum(os.path.getsize(q) for q in paths):,} B in {len(paths)} files")
    for rel, ndim, own in (("re_1000/learned_interpolation/control_64_1.h5", 2, True),
                           ("re_1000/learned_interpolation/control_32_1.h5", 2, False),
                           ("compare_methods/downsampling/projection_rk4/128_64_1.h5", 2, False),
                           (f"three_dimensions/initial_conditions/test_{FV_3D_SIM}.h5", 3, True),
                           (f"three_dimensions/trajectories/test_{FV_3D_SIM}_1.h5", 3, True),
                           ("three_dimensions/trajectories/test_32_1.h5", 3, FV_3D_SIM == 32)):
        check_velocity_file(os.path.join(base, rel), ndim, own)


def fv_solver_checks(dev, root):
    """The card's solve against the CPU's (FV_CHECK_STEPS steps) and the
    CUDA-graph run against the eager one, in 2D (the control at 64^2) and
    3D (64^3), from the generated initial velocities."""
    from fourierflow_tpu_torch.utils.equations import repeated

    base = os.path.join(root, "kolmogorov")
    for label, name, n, path in (
            ("2D", FV_CONTROL, 64, os.path.join(base, "re_1000/initial_conditions/test_64.h5")),
            ("3D", FV_3D_IC, FV_3D_SIM,
             os.path.join(base, f"three_dimensions/initial_conditions/test_{FV_3D_SIM}.h5"))):
        ndim = 2 if label == "2D" else 3
        step = instantiate(load_config(name, [f"sim_grid.shape={[n] * ndim}"])["step_fn"])
        state = _fv_state(path, ndim, "cpu")
        card = repeated(step, FV_CHECK_STEPS)(tuple(v.to(dev) for v in state))
        cpu = repeated(step, FV_CHECK_STEPS)(state)
        errs = [rel_err(a, b) for a, b in zip(card, cpu)]
        rel = max(r for _, r in errs)
        log(f"projection: card vs CPU solve ({label}, {n}^{ndim}, {len(state[0])} fields, "
            f"{FV_CHECK_STEPS} steps of {name}'s step): max_abs_err {max(e for e, _ in errs):.3e} "
            f"rel {rel:.3e} tol {FV_SOLVER_TOL:g}")
        if not rel <= FV_SOLVER_TOL:
            raise AssertionError(f"projection: the card's {label} solve disagrees with the CPU's")
        s = tuple(v.to(dev) for v in state)
        eager = repeated(step, 21)(s)
        graph = graph_repeated(step, s, 8)(s, 21)
        if not all(torch.equal(a, b) for a, b in zip(eager, graph)):
            raise AssertionError(f"projection: the {label} CUDA-graph solve differs from the eager")
        log(f"projection: {label} CUDA-graph solve equals the eager solve to the bit (21 steps: "
            f"2 replays of an 8-step graph and 5 eager steps)")


def fv_timings(dev, root, seed):
    """ms per solver step at 64^2, 128^2 (Euler and RK4) and 64^3 from a
    CUDA graph, and at the protocol's 512^3 eagerly (one trajectory from a
    random initial velocity, its peak memory), and the protocol's
    projected generation time."""
    from fourierflow_tpu_torch.utils.finite_volume import filtered_velocity_field_3d

    base = os.path.join(root, "kolmogorov")
    ic = f"re_1000/initial_conditions/test_{FV_IC_SIM}.h5"
    cases = (("64^2 Euler, van Leer", FV_CONTROL, 64, 2, "re_1000/initial_conditions/test_64.h5"),
             (f"{FV_IC_SIM}^2 Euler, van Leer", FV_CONTROL, FV_IC_SIM, 2, ic),
             (f"{FV_IC_SIM}^2 RK4, linear", FV_RK4, FV_IC_SIM, 2, ic),
             (f"{FV_3D_SIM}^3 Euler, van Leer", FV_3D_IC, FV_3D_SIM, 3,
              f"three_dimensions/initial_conditions/test_{FV_3D_SIM}.h5"))
    for label, name, n, ndim, rel in cases:
        step = instantiate(load_config(name, [f"sim_grid.shape={[n] * ndim}"])["step_fn"])
        state = _fv_state(os.path.join(base, rel), ndim, dev)
        ms = timed_step_ms(step, state, 8, FV_TIMED_STEPS)
        nbytes = 2 * sum(v.numel() for v in state) * 4
        log(f"projection: solver step at {label}, batch {len(state[0])} (graph of 8): {ms:.4f} ms; "
            f"bound {nbytes / MEM_RATE * 1e3:.5f} ms (the state read and written once, bytes)")
        profile_calls(lambda: step(state), ms, label=f"projection: {label}", groups=FV_GROUPS)
        del step, state

    p = FV_3D_PROTOCOL
    cfg = load_config(FV_3D_IC)
    grid = instantiate(cfg["sim_grid"])
    step = instantiate(cfg["step_fn"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = filtered_velocity_field_3d(grid, cfg["max_velocity"], cfg["peak_wavenumber"], 1,
                                       generator=torch.Generator(device=dev).manual_seed(seed),
                                       device=dev)
    torch.cuda.synchronize()
    ic_s = time.perf_counter() - t0
    ms = timed_step_ms(step, state, 0, FV_3D_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = all(torch.isfinite(v).all() for v in state)
    nbytes = 2 * sum(v.numel() for v in state) * 4
    log(f"projection: {FV_3D_IC} at the protocol's {p['sim']}^3 (dt "
        f"{instantiate(cfg['time_step']):.6g}), one trajectory: initial velocity "
        f"{ic_s:.2f} s; solver step (eager) {ms:.2f} ms, bound {nbytes / MEM_RATE * 1e3:.3f} ms "
        f"(bytes); peak memory {peak:.2f} GiB; finite {finite}")
    if not finite:
        raise AssertionError("projection: the 512^3 steps are not finite")
    ic_steps, traj_steps = p["warmup"] * p["inner"], p["outer"] * p["inner"]
    log(f"projection: projected protocol at {p['sim']}^3 ({p['n']} trajectories one at a time): "
        f"initial conditions {p['n']} x {ic_steps:,} steps = {p['n'] * ic_steps * ms / 3.6e6:.2f} "
        f"h, trajectories {p['n']} x {traj_steps:,} steps = "
        f"{p['n'] * traj_steps * ms / 3.6e6:.2f} h of solver steps a split")
    del state, step
    torch.cuda.empty_cache()


def phase_projection(dev, tmp, seed):
    """The projection method: its data on the card through ``generate
    kolmogorov`` by registry name (2D Euler and RK4, 3D), the files'
    invariants, the solver held to the CPU and to its eager self, and its
    time per step up to the protocol's 512^3. No hand-written kernel lies on
    this path (torch.fft, rolls and elementwise work, as JAX computes it in
    XLA)."""
    phase_start = time.perf_counter()
    root = os.path.join(tmp, "fv_data")
    os.environ["DATA_ROOT"] = root
    reset_launch_counts()
    generate_fv_data(dev, root)
    fv_solver_checks(dev, root)
    fv_timings(dev, root, seed)
    return _no_launches("projection", phase_start)


def _no_launches(phase, phase_start):
    """The launch counts of a phase whose path runs none of the F-FNO's
    kernels (``KERNELS``): all must be 0."""
    counts = launch_counts()
    log(f"{phase}: launches over the {phase} path {counts}; phase took "
        f"{time.perf_counter() - phase_start:.1f} s")
    if any(counts.values()):
        raise AssertionError(f"{phase}: a hand-written kernel was launched: {counts}")
    return counts


# --- phase learned_interpolation -----------------------------------------------------------
# Device-time groups of a learned-interpolation train step.
# cuDNN's FFT-based convolutions run DSE::* transforms, region_transform and a complex GEMM;
# cuFFT's own kernels (the pressure solve) are vector_fft and regular_fft without DSE::.
LI_GROUPS = (("cuDNN convolutions (implicit GEMM and FFT-based; forward, data and weight "
              "gradients)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit", "nhwc",
                             "Nhwc", "winograd", "DSE::", "region_transform", "cf32")),
             ("cuFFT (the pressure solve)", ("fft",)),
             ("cuBLAS GEMM", ("gemm", "gemv", "xmma")),
             ("gather / scatter / index", ("index", "gather", "scatter")),
             ("roll (periodic shifts)", ("roll",)))


def pressure_solve_ms(batch, n, dev):
    """Device ms of ``n`` pressure projections of the batch's velocities,
    forward and backward, traced alone (the learned interpolation's FFT
    work in a train step)."""
    from fourierflow_tpu_torch.models.learned_interpolation import pressure_projection

    u0, v0 = (torch.as_tensor(batch[0][k], device=dev).requires_grad_() for k in ("vx", "vy"))

    def run():
        u, v = u0, v0
        for _ in range(n):
            u, v = pressure_projection(u, v, 2 * math.pi / u0.shape[-1])
        torch.autograd.grad((u * u).sum() + (v * v).sum(), (u0, v0))

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return profile_calls(run, (time.perf_counter() - t0) * 1e3,
                         label="learned_interpolation: the pressure solve alone", groups=LI_GROUPS)


def li_x256_step(dev, seed):
    """One x256 train step at full width (256^2, batch 4, unroll 32) on a
    batch made from the seed: its loss and gradients held to the same step
    with cuDNN off, and its peak memory."""
    from fourierflow_tpu_torch.builders.kolmogorov import filtered_velocity_field
    from fourierflow_tpu_torch.utils.grids import TORUS, Grid

    cfg = load_config(LI_X256)
    routine = build_routine(cfg["routine"])
    state = routine.init(7231, None, dev)
    size, unroll = cfg["routine"]["size"], cfg["routine"]["unroll_length"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    vx, vy = filtered_velocity_field(Grid((size, size), domain=TORUS), 7.0, 4.0, 4,
                                     generator=gen, device=dev)
    drift = lambda v: v[..., None] + 0.01 * torch.randn(*v.shape, unroll, generator=gen,
                                                         device=dev)
    batch = ({"vx": vx, "vy": vy}, {"vx": drift(vx), "vy": drift(vy)})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = routine.loss_and_grads(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.backends.cudnn.enabled = False
    try:
        want_loss, want = routine.loss_and_grads(state, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.enabled = True
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    rels = {n: rel_err(a, b)[1] for (n, _), a, b in zip(state.model.named_parameters(), grads,
                                                         want, strict=True)}
    worst = max(rels, key=rels.get)
    log(f"learned_interpolation: {LI_X256}: one train step at full width ({size}^2, batch 4, "
        f"unroll {unroll}, {routine.n_params(state):,} parameters) vs the same step with cuDNN "
        f"off: loss {float(loss):.6f} vs {float(want_loss):.6f} (rel {loss_rel:.2e}); gradients "
        f"of {len(rels)} tensors, largest rel {rels[worst]:.2e} ({worst}), tol {TRAIN_TOL:.0e}; "
        f"{step_s * 1e3:.1f} ms (first call); peak memory {peak:.2f} GiB")
    if not (loss_rel <= TRAIN_TOL and rels[worst] <= TRAIN_TOL):
        raise AssertionError(f"learned_interpolation: {LI_X256}: the step disagrees with cuDNN off")


def phase_learned_interpolation(dev, tmp, seed):
    """The learned interpolation: the files of ``rollout/x64`` made by the
    pseudo-spectral generator from the projection phase's initial
    conditions, ``train`` (2 steps) and ``test`` by registry name at full
    width, 2 steps held to a CPU copy, the step timed and traced (and the
    pressure solve alone), the validation timed, and an x256 step held with
    cuDNN off."""
    from fourierflow_tpu_torch.commands.generate import kolmogorov as generate

    phase_start = time.perf_counter()
    root = os.path.join(tmp, "fv_data")  # the projection phase's initial conditions
    os.environ["DATA_ROOT"] = root
    reset_launch_counts()
    log(f"learned_interpolation: cut: re_1000/trajectories/{{split}} simulated at "
        f"{FV_IC_SIM}^2 instead of 2048^2 at its own CFL step (inner 1 of 16), "
        f"{' / '.join(map(str, LI_SPLITS.values()))} trajectories instead of 32, {LI_OUTER} "
        f"records of 9,764 ({LI_TRAIN_OUTER} in train), outputs at 32 and 64 (k 1)")
    for split, n in LI_SPLITS.items():
        name = f"data/kolmogorov/re_1000/trajectories/{split}"
        outer = LI_TRAIN_OUTER if split == "train" else LI_OUTER
        over = [f"sim_grid.shape=[{FV_IC_SIM},{FV_IC_SIM}]", f"n_trajectories={n}",
                f"generation_batch={n}", "inner_steps=1", f"outer_steps={outer}",
                "out_sizes=" + json.dumps([{"size": s, "k": 1} for s in (32, 64)]),
                "init_path=${oc.env:DATA_ROOT}/kolmogorov/re_1000/initial_conditions/"
                f"{split}_{FV_IC_SIM}.nc"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(name, over, device=dev,
                 out_dir=os.path.join(root, "kolmogorov", "re_1000", "trajectories"))
        log(f"learned_interpolation: generate {name}: {time.perf_counter() - t0:.2f} s")

    cfg = load_config(LI_CONFIG)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    n_snap = builder.valid_dataset.targets.shape[-1]
    log(f"learned_interpolation: cut: {LI_CONFIG}'s validation and test take {n_snap} snapshots "
        f"of {cfg['routine']['inner_steps']} model steps, of the configured "
        f"{cfg['routine']['outer_steps']}: all that {LI_OUTER} records hold")
    t0 = time.perf_counter()
    overrides = ["trainer.max_epochs=1", "trainer.limit_train_batches=None"]
    if len(builder.train_dataset) // builder.batch_size != LI_STEPS:
        raise AssertionError(f"learned_interpolation: {len(builder.train_dataset)} train items")
    with tempfile.TemporaryDirectory() as run:
        trainer, state = train.main(LI_CONFIG, overrides, config_dir=run, device="cuda")
        test_logs = test_command.main(LI_CONFIG, overrides=overrides, config_dir=run,
                                      device="cuda")
    logs = trainer.logs
    scalars = {k: round(float(v), 6) for k, v in test_logs.items() if np.ndim(v) == 0}
    log(f"learned_interpolation: {LI_CONFIG}: train ({trainer.global_step} steps of the "
        f"device-resident epoch over the velocity dataset's (inputs, outputs), n_params "
        f"{logs['n_params']:,}, train_loss {logs['train_loss']:.6f}): valid_rho "
        f"{logs['valid_rho']:.6f}, valid_reduced_time_until {logs['valid_reduced_time_until']:g}; "
        f"test {json.dumps(scalars)}; {time.perf_counter() - t0:.1f} s")
    if (trainer.global_step != LI_STEPS or test_logs["test_correlations"].shape != (n_snap,)
            or not all(np.isfinite(np.asarray(v, np.float64)).all() for v in test_logs.values())
            or not math.isfinite(logs["train_loss"])):
        raise AssertionError(f"learned_interpolation: {LI_CONFIG}: {trainer.global_step} "
                             f"steps, test logs {scalars}")

    batches = [b for _, b in zip(range(LI_STEPS), builder.train_batches(np.random.default_rng(0)))]
    # The out layer starts at zero, so the other layers' gradients are 0 in the
    # first step and AdamW's first update of them, in the second, is +-lr for
    # every element, rounding-level gradients included: the parameters are held
    # after the CPU's update from the card's gradients (as Geo-FNO's).
    hold_steps(LI_CONFIG, routine, routine.init(7231, builder.sample_batch(), dev), batches,
               phase="learned_interpolation", update_from_card=True)
    solve_ms = pressure_solve_ms(batches[0], cfg["routine"]["unroll_length"], dev)
    log(f"learned_interpolation: {LI_CONFIG}: the pressure solve alone "
        f"({cfg['routine']['unroll_length']} projections of [4, 64, 64], forward and "
        f"backward), traced: {solve_ms:.3f} ms")
    cfg = load_config(LI_CONFIG, [f"routine.optimizer.lr={LI_TIMED_LR}"])
    routine = build_routine(cfg["routine"], builder)
    state, step_ms = time_steps(f"{LI_CONFIG} at lr {LI_TIMED_LR:g}", routine,
                                routine.init(7231, None, dev), batches[0], dev,
                                phase="learned_interpolation")
    profile_train_step(routine, state, batches[0], None, step_ms,
                       label=f"learned_interpolation: {LI_CONFIG}", groups=LI_GROUPS)
    vbatch = next(builder.val_batches())
    routine.valid_step(state, vbatch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    routine.valid_step(state, vbatch)
    torch.cuda.synchronize()
    n_model = n_snap * routine.inner_steps
    log(f"learned_interpolation: {LI_CONFIG}: validation rollout of {n_model} model steps at "
        f"batch {batch_count(vbatch)}: {(time.perf_counter() - t0) / n_model * 1e3:.4f} ms per "
        f"model step")
    li_x256_step(dev, seed)
    return _no_launches("learned_interpolation", phase_start)


# --- phase meshgraphnet --------------------------------------------------------------------
# Device-time groups of a MeshGraphNet train step.
MGN_GROUPS = (("cuBLAS GEMM (the MLPs)", ("gemm", "gemv", "xmma", "cutlass")),
              ("segment sum kernel (the scatter, the gathers' gradients)", ("segment_sum",)),
              ("gather (index_select)", ("index", "gather", "scatter")),
              ("LayerNorm", ("layer_norm", "LayerNorm")),
              ("sort / unique (triangles_to_edges)", ("sort", "unique", "radix", "Radix", "cub")))


def _tf_varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _tf_field(num, payload):
    return _tf_varint((num << 3) | 2) + _tf_varint(len(payload)) + payload


def _tf_example(features):
    """``{name: bytes}`` as a ``tf.train.Example`` of BytesList features."""
    entries = b"".join(
        _tf_field(1, _tf_field(1, name.encode()) + _tf_field(2, _tf_field(1, _tf_field(1, v))))
        for name, v in features.items())
    return _tf_field(1, entries)


def _mgn_mesh(nx, ny):
    """A triangulated nx x ny grid over [0, 1.6] x [0, 0.41]: positions, cells
    and node types (inflow on the left, outflow on the right, walls above
    and below)."""
    x, y = np.linspace(0.0, 1.6, nx), np.linspace(0.0, 0.41, ny)
    pos = np.stack(np.meshgrid(x, y, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    idx = np.arange(nx * ny).reshape(nx, ny)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:], idx[1:, 1:]
    cells = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                            np.stack([a, d, c], -1).reshape(-1, 3)]).astype(np.int32)
    node_type = np.zeros((nx, ny), np.int32)
    node_type[:, 0] = node_type[:, -1] = 6  # WALL_BOUNDARY
    node_type[0, :], node_type[-1, :] = 4, 5  # INFLOW, OUTFLOW
    return pos, cells, node_type.reshape(-1)


def write_cylinder_flow(root, seed):
    """meta.json and {train,valid,test}.tfrecord at the cylinder_flow layout,
    made from ``seed``: the meshes of MGN_NX x MGN_NY points in turn, a
    parabolic inflow profile that oscillates in time, and noise."""
    rng = np.random.default_rng(seed)
    meta = {"trajectory_length": MGN_T,
            "field_names": ["cells", "mesh_pos", "node_type", "velocity", "pressure"],
            "features": {
                "cells": {"type": "static", "shape": [1, -1, 3], "dtype": "int32"},
                "mesh_pos": {"type": "static", "shape": [1, -1, 2], "dtype": "float32"},
                "node_type": {"type": "static", "shape": [1, -1, 1], "dtype": "int32"},
                "velocity": {"type": "dynamic", "shape": [MGN_T, -1, 2], "dtype": "float32"},
                "pressure": {"type": "dynamic", "shape": [MGN_T, -1, 1], "dtype": "float32"}}}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    t = np.arange(MGN_T)[:, None] / MGN_T
    i = 0
    for split, n in MGN_SPLITS.items():
        with open(os.path.join(root, f"{split}.tfrecord"), "wb") as f:
            for _ in range(n):
                pos, cells, node_type = _mgn_mesh(MGN_NX[i % len(MGN_NX)], MGN_NY)
                i += 1
                k, ph = rng.uniform(1.0, 4.0), rng.uniform(0.0, 2 * np.pi)
                profile = 4 * pos[:, 1] * (0.41 - pos[:, 1]) / 0.41 ** 2
                u = profile * (1 + 0.1 * np.sin(2 * np.pi * t + k * pos[:, 0] + ph))
                v = 0.1 * np.sin(np.pi * pos[:, 0] / 1.6) * np.sin(2 * np.pi * t + ph)
                vel = np.stack([u, v], -1) + 0.01 * rng.standard_normal((MGN_T, len(pos), 2))
                pressure = rng.standard_normal((MGN_T, len(pos), 1))
                p = _tf_example({
                    "cells": cells[None].tobytes(), "mesh_pos": pos[None].tobytes(),
                    "node_type": node_type[None, :, None].tobytes(),
                    "velocity": vel.astype(np.float32).tobytes(),
                    "pressure": pressure.astype(np.float32).tobytes()})
                f.write(struct.pack("<Q", len(p)) + b"\0" * 4 + p + b"\0" * 4)


def phase_meshgraphnet(dev, tmp, seed):
    """MeshGraphNet: synthetic cylinder_flow TFRecords from the seed through
    ``convert cylinder-flow``, ``cylinder_flow/baseline`` through ``train``
    and ``test`` (the 50-step rollout) by registry name at full width, 2
    steps held to a CPU copy, timed and traced, and the rollout timed."""
    from fourierflow_tpu_torch.commands.convert import cylinder_flow as convert

    phase_start = time.perf_counter()
    root = os.path.join(tmp, "mgn_data")
    os.environ["DATA_ROOT"] = root
    reset_launch_counts()
    records = os.path.join(root, "meshgraphnets", "cylinder_flow")
    write_cylinder_flow(records, seed)
    nodes = [nx * MGN_NY for nx in MGN_NX]
    log(f"meshgraphnet: cut: {' / '.join(map(str, MGN_SPLITS.values()))} trajectories "
        f"(train / valid / test) of the dataset's {' / '.join(map(str, MGN_REGISTRY_SPLITS))}, "
        f"{MGN_T} steps of {MGN_REGISTRY_T}; meshes of {min(nodes):,}-{max(nodes):,} nodes and "
        f"{2 * (min(MGN_NX) - 1) * (MGN_NY - 1):,}-{2 * (max(MGN_NX) - 1) * (MGN_NY - 1):,} "
        f"triangles, made from the seed")
    t0 = time.perf_counter()
    path = convert(records, os.path.join(records, "cylinder_flow.h5"))
    log(f"meshgraphnet: convert cylinder-flow: {time.perf_counter() - t0:.2f} s, "
        f"{os.path.getsize(path):,} B; train velocity {load_array(path, 'train/velocity').shape}")

    t0 = time.perf_counter()
    overrides = ["trainer.max_epochs=1", f"trainer.limit_train_batches={MGN_STEPS}"]
    with tempfile.TemporaryDirectory() as run:
        trainer, state = train.main(MGN_CONFIG, overrides, config_dir=run, device="cuda")
        test_logs = test_command.main(MGN_CONFIG, overrides=overrides, config_dir=run,
                                      device="cuda")
    logs = trainer.logs
    log(f"meshgraphnet: {MGN_CONFIG}: train ({trainer.global_step} steps, n_params "
        f"{logs['n_params']:,}, train_loss {logs['train_loss']:.6f}): valid_loss "
        f"{logs['valid_loss']:.6f} (50-step rollout); test_loss {test_logs['test_loss']!r}, "
        f"train's test pass {logs['test_loss']!r} (held equal to the bit); "
        f"{time.perf_counter() - t0:.1f} s")
    if (trainer.global_step != MGN_STEPS or not math.isfinite(test_logs["test_loss"])
            or test_logs["test_loss"] != logs["test_loss"]):
        raise AssertionError(f"meshgraphnet: {MGN_CONFIG}: {trainer.global_step} steps, test "
                             f"{test_logs}, train's test {logs['test_loss']}")

    cfg = load_config(MGN_CONFIG)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    state = routine.init(7231, builder.sample_batch(), dev)
    batches = [b for _, b in zip(range(MGN_STEPS),
                                 builder.train_batches(np.random.default_rng(0)))]
    # AdamW's second update turns the rounding of near-zero gradients into
    # steps of up to lr (as Geo-FNO's in phase mesh): the parameters are held
    # after the CPU's update from the card's gradients.
    state = hold_steps(MGN_CONFIG, routine, state, batches, phase="meshgraphnet",
                       update_from_card=True)
    state, step_ms = time_steps(MGN_CONFIG, routine, state, batches[0], dev, phase="meshgraphnet")
    profile_train_step(routine, state, batches[0], None, step_ms,
                       label=f"meshgraphnet: {MGN_CONFIG}", groups=MGN_GROUPS)
    vbatch = next(builder.val_batches())
    routine.valid_step(state, vbatch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    routine.valid_step(state, vbatch)
    torch.cuda.synchronize()
    log(f"meshgraphnet: {MGN_CONFIG}: rollout of {routine.rollout_steps} steps at batch "
        f"{batch_count(vbatch)}: {(time.perf_counter() - t0) / routine.rollout_steps * 1e3:.3f} "
        f"ms per step")
    before = segment_sum.launches
    routine.train_step(state, batches[0])
    torch.cuda.synchronize()
    per_step, n_layers = segment_sum.launches - before, len(routine.model.graph_layers)
    log(f"meshgraphnet: {MGN_CONFIG}: {per_step} segment sum launches in one train step (the "
        f"scatter and the two gathers' gradients of each of {n_layers} layers)")
    if per_step != 3 * n_layers:
        raise AssertionError(f"meshgraphnet: {per_step} segment sum launches in a train step")
    return {**_no_launches("meshgraphnet", phase_start), **launch_counts(GRAPH_KERNELS)}


# Device-time groups of a train step, by kernel name.
STEP_GROUPS = (("spectral kernel (forward + adjoint)", ("spectral_axis_kernel",)),
               ("FF backward kernel", ("ff_bwd",)), ("FF forward kernel", ("ff_fwd_kernel",)),
               ("cuBLAS GEMM (weight gradients, projections)", ("gemm", "gemv", "xmma")))


# Device-time groups of an FNO-4 train step.
BASELINE_GROUPS = (("cuFFT", ("fft",)),
                   ("cuBLAS GEMM (mode mixing, linear layers)", ("gemm", "gemv", "xmma")))


def profile_train_step(routine, state, batch, gen, step_ms, steps=2, label="train",
                       groups=STEP_GROUPS, host_top=0):
    """Device time of a train step by kernel group, from a torch.profiler
    trace of ``steps`` steps; the idle share is taken against the untraced
    step time. ``host_top`` > 0 also lists the operators with the most
    host (self CPU) time. Returns the device ms per step."""
    def run():
        nonlocal state
        state, _ = routine.train_step(state, batch, gen)

    return profile_calls(run, step_ms, steps, label, groups, host_top)


def profile_calls(fn, step_ms, steps=2, label="train", groups=STEP_GROUPS, host_top=0):
    """Device time of a call of ``fn`` by kernel group, from a
    torch.profiler trace of ``steps`` calls, against the untraced
    ``step_ms``. Returns the device ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    totals = {name: 0.0 for name, _ in groups}
    other, by_name = "other (elementwise, reductions, copies, AdamW)", {}
    totals[other] = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us() / steps, n + 1)
    for name, (us, _) in by_name.items():
        totals[next((g for g, keys in groups if any(k in name for k in keys)), other)] += us
    device_ms = sum(totals.values()) / 1e3
    launches = sum(n for _, n in by_name.values()) // steps
    log(f"{label}: traced device time {device_ms:.3f} ms per step in {launches} device "
        f"operations; idle {max(0.0, 1 - device_ms / step_ms):.1%} of the {step_ms:.3f} ms step")
    for name, us in totals.items():
        log(f"{label}:   {us / 1e3:8.3f} ms  {name}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"{label}:   top {us / 1e3:8.3f} ms  {n // steps:4d}x  {name[:90]}")
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:host_top]
        for a in ops:
            log(f"{label}:   host {a.self_cpu_time_total / steps / 1e3:8.3f} ms  "
                f"{a.count // steps:5d}x  {a.key[:80]}")
    return device_ms


# --- phase parallel --------------------------------------------------------------------------
# A model or spatial mesh of one rank: its one step vs the one-device step, max |err| / max |ref|
# of the loss and of each gradient (held to the bit as well: on one rank every sum keeps its order).
PARALLEL_STEP_TOL = 1e-5
# Several cards: a parallel fit against the one-rank fit (JAX's bounds, tests/test_training.py).
PARALLEL_FIT_RTOL = {"train_loss": 1e-4, "valid_loss": 1e-3}
PARALLEL_TIMED_STEPS = 5


def _parallel_fit(cfg, dev, seed, mesh=None, fast_loop=True, data_parallel=False):
    """A config's fit (the flagship's: the normalizer epoch and one train
    epoch) through the Trainer on ``mesh`` (none: one device), with the
    config's epochs and batch limits; its trainer, routine, state, builder
    and the launches it made."""
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    tcfg = cfg["trainer"]
    trainer = Trainer(max_epochs=tcfg["max_epochs"],
                      limit_train_batches=tcfg.get("limit_train_batches"),
                      limit_val_batches=tcfg.get("limit_val_batches"), seed=seed, device=dev,
                      mesh=mesh, fast_loop=fast_loop, data_parallel=data_parallel)
    counts = lambda: {**launch_counts(), **launch_counts(GRAPH_KERNELS)}
    before = counts()
    state = trainer.fit(routine, builder)
    torch.cuda.synchronize(dev)
    launched = {k: v - before[k] for k, v in counts().items()}
    return trainer, routine, state, builder, launched


def _split_copy(cfg, builder, state, mesh, dev):
    """A copy of a one-device state (weights, normalizer) laid out on ``mesh``."""
    routine = build_routine(cfg["routine"], builder)
    copy_ = routine.init(0, builder.sample_batch(), dev)
    copy_.model.load_state_dict(state.model.state_dict())
    return routine, shard_state(dataclasses.replace(copy_, normalizer=state.normalizer), mesh)


def _whole_grads(state, grads):
    """The gradients of a split state with each split one gathered whole."""
    tp = mesh_axis(state.mesh, "model")
    return [all_gather(g, tp, p.tp_dim) if getattr(p, "tp_dim", None) is not None else g
            for p, g in zip(state.model.parameters(), grads, strict=True)]


def _step_ms(routine, state, batch, dev, seed):
    """Wall ms per train step (noise on), the mean of PARALLEL_TIMED_STEPS
    after 2 warm-ups; returns the state after them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(2):
        state, _ = routine.train_step(state, batch, gen)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(PARALLEL_TIMED_STEPS):
        state, _ = routine.train_step(state, batch, gen)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / PARALLEL_TIMED_STEPS * 1e3, state


def _world_of_one(cfg, dev, seed):
    """One rank over NCCL: the flagship's fit with no mesh against the same
    fit on an explicit data mesh, then on ``{data 1, model 1}`` and ``{data
    1, spatial 1}`` meshes (the tensor- and spatially parallel layer code)
    against the per-batch fit with no mesh, each to the bit (every
    collective of one rank is the identity, and the split layers sum in the
    unsplit ones' order: the weight norm and the loss take the square root
    of a sum of squares on every path, the spatially split mix sums its
    branches in one Function); and one step's loss and gradients of the
    model and spatial layouts within PARALLEL_STEP_TOL of the one-device
    step (and to the bit)."""
    out = {}
    t_ref, _, s_ref, builder, out["launches_none"] = _parallel_fit(cfg, dev, seed)
    dp_mesh = make_mesh()
    t_dp, _, s_dp, _, out["launches_data"] = _parallel_fit(cfg, dev, seed, dp_mesh)
    n, bad, worst = _state_diff(_snapshot(s_dp), _snapshot(s_ref))
    log(f"parallel: the fit on a data mesh of one rank ({t_dp.global_step} steps of the "
        f"device-resident epoch) against the fit with no mesh: {n - len(bad)} of {n} tensors "
        f"(weights, normalizer, AdamW moments) equal to the bit, largest rel difference "
        f"{worst:.2e}; train_loss {t_dp.logs['train_loss']!r} / {t_ref.logs['train_loss']!r}")
    if bad or t_dp.global_step != t_ref.global_step or any(
            t_dp.logs[k] != t_ref.logs[k] for k in ("train_loss", "valid_loss")):
        raise AssertionError(f"parallel: the data mesh's fit differs from the one-device fit in "
                             f"{bad[:6]}")
    t_loop, _, s_loop, _, _ = _parallel_fit(cfg, dev, seed, fast_loop=False)
    batch = next(builder.train_batches(np.random.default_rng(seed)))
    routine = build_routine(cfg["routine"], builder)
    quiet = copy.copy(routine)
    quiet.noise_std = 0.0
    want_loss, want_grads, _ = quiet.loss_and_grads(s_ref, batch)
    names = [n for n, _ in s_ref.model.named_parameters()]
    # (state, its batch) of each layout, timed last.
    layouts = {"none": (s_ref, batch), "data": (s_dp, shard_batch(batch, dp_mesh, "data"))}
    for name, make, spatial in (("model", lambda: make_tp_mesh(1), None),
                                ("spatial", lambda: make_sp_mesh(1), "spatial")):
        mesh = make()
        t_m, _, s_m, _, out[f"launches_{name}"] = _parallel_fit(cfg, dev, seed, mesh,
                                                                fast_loop=False)
        n, bad, worst = _state_diff(_snapshot(gather_state(s_m)), _snapshot(s_loop))
        log(f"parallel: the fit on {mesh_shape(mesh)} (per-batch loop, {t_m.global_step} steps) "
            f"against the per-batch fit with no mesh: {n - len(bad)} of {n} tensors equal to the "
            f"bit, largest rel difference {worst:.2e}; train_loss {t_m.logs['train_loss']!r} / "
            f"{t_loop.logs['train_loss']!r}, valid_loss {t_m.logs['valid_loss']!r} / "
            f"{t_loop.logs['valid_loss']!r}; launches {out[f'launches_{name}']}")
        if bad or any(t_m.logs[k] != t_loop.logs[k] for k in ("train_loss", "valid_loss")):
            raise AssertionError(f"parallel: the fit on {mesh_shape(mesh)} differs from the "
                                 f"one-device fit in {bad[:6]}")
        split_routine, split = _split_copy(cfg, builder, s_ref, mesh, dev)
        quiet_split = copy.copy(split_routine)
        quiet_split.noise_std = 0.0
        local = shard_batch(batch, mesh, "data", spatial)
        loss, grads, _ = quiet_split.loss_and_grads(split, local)
        grads = _whole_grads(split, grads)
        rels = {n: rel_err(a, b)[1] for n, a, b in zip(names, grads, want_grads, strict=True)}
        equal = sum(torch.equal(a, b) for a, b in zip(grads, want_grads))
        loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        w = max(rels, key=rels.get)
        log(f"parallel: one step on {mesh_shape(mesh)} against the one-device step: loss "
            f"{float(loss)!r} vs {float(want_loss)!r} (rel {loss_rel:.2e}); gradients of "
            f"{len(rels)} parameters, {equal} equal to the bit, largest rel {rels[w]:.2e} ({w}); "
            f"tol {PARALLEL_STEP_TOL:.0e} and to the bit")
        if not (loss_rel <= PARALLEL_STEP_TOL and rels[w] <= PARALLEL_STEP_TOL) or (
                equal != len(rels) or loss_rel != 0):
            raise AssertionError(f"parallel: the step on {mesh_shape(mesh)} disagrees")
        layouts[name] = (split, local)
        out[f"step_rel_{name}"] = max(loss_rel, rels[w])
    card = card_line()
    for name, (state, local) in layouts.items():
        ms, _ = _step_ms(routine, state, local, dev, seed)
        out[f"ms_{name}"] = ms
        log(f"parallel: {ms:.3f} ms per train step, {'no mesh' if name == 'none' else name + ' mesh'}"
            f" of one rank (batch {batch_count(batch)}, f32, mean of {PARALLEL_TIMED_STEPS} "
            f"after 2 warm-ups); "
            f"{card}")
    return out


def _several_ranks(cfg, dev, seed, world):
    """2-way data, tensor and spatial parallelism of the flagship (the per-batch
    loop: its batch of 19 does not divide a data axis of 2, so it is replicated
    there) against the one-rank per-batch fit, which every rank runs alone."""
    out = {}
    t_ref, *_ = _parallel_fit(cfg, dev, seed, fast_loop=False)
    for name, make in (("data", make_mesh), ("model", lambda: make_tp_mesh(2)),
                       ("spatial", lambda: make_sp_mesh(2))):
        mesh = make()
        t0 = time.perf_counter()
        t_m, routine, s_m, builder, launched = _parallel_fit(cfg, dev, seed, mesh,
                                                             fast_loop=False)
        fit_s = time.perf_counter() - t0
        out[f"launches_{name}"] = launched
        got = {k: t_m.logs[k] for k in PARALLEL_FIT_RTOL}
        want = {k: t_ref.logs[k] for k in PARALLEL_FIT_RTOL}
        log(f"parallel: {world} ranks on {mesh_shape(mesh)}: {got} against one rank's {want} "
            f"({t_m.global_step} steps, {fit_s:.1f} s with validation); launches {launched}")
        for k, rtol in PARALLEL_FIT_RTOL.items():
            if not abs(got[k] - want[k]) <= rtol * abs(want[k]):
                raise AssertionError(f"parallel: {k} on {mesh_shape(mesh)} off by more than "
                                     f"{rtol:.0e}")
        batch = shard_batch(next(builder.train_batches(np.random.default_rng(seed))), mesh,
                            "data", "spatial" if name == "spatial" else None)
        out[f"ms_{name}"], _ = _step_ms(routine, s_m, batch, dev, seed)
        log(f"parallel: {out[f'ms_{name}']:.3f} ms per train step on {mesh_shape(mesh)} "
            f"({world} ranks)")
    return out


# The five other routines' fits on a data mesh: each config at its full width, the 24-layer
# ones cut to PARALLEL_FAMILY_LAYERS layers, one epoch of 2 train steps and the validation on
# the small sets that phase parallel writes (the flagship's generated file for the FNO-4).
PARALLEL_FAMILY_LAYERS = 4
LI_PARALLEL = dict(size=64, train=4, frames=66, eval=2, records=64)


def write_li_velocity(root, seed):
    """Small files of ``rollout/x64``'s layout under ``root``, made from
    ``seed``: LI_PARALLEL["train"] trajectories of smooth periodic staggered
    velocities at 64^2, drifting in time, ``frames`` frames (2 items each at
    k 2 and an unroll of 32); initial conditions and 32^2 vorticity records
    to validate and test on (``records`` frames: 2 snapshots of 16 model
    steps)."""
    from fourierflow_tpu_torch.utils.hdf5 import H5Writer

    rng = np.random.default_rng(seed)

    def fields(lead, n):
        g = 2 * np.pi * np.arange(n) / n
        xx, yy = np.meshgrid(g, g, indexing="ij")
        out = np.zeros(lead + (n, n))
        for kx, ky in ((1, 0), (0, 1), (1, 1), (2, 1), (1, 3)):
            a = rng.standard_normal(lead + (1, 1))
            ph = rng.uniform(0, 2 * np.pi, lead + (1, 1))
            out += 2 * a * np.sin(kx * xx + ky * yy + ph) / np.hypot(kx, ky)
        return out.astype(np.float32)

    base, n, p = os.path.join(root, "kolmogorov", "re_1000"), LI_PARALLEL["size"], LI_PARALLEL
    drift = 0.01 * np.arange(p["frames"], dtype=np.float32)[None, :, None, None]
    arrays = {"trajectories/train_64_1.h5": {
        c: fields((p["train"],), n)[:, None] + drift * fields((p["train"],), n)[:, None]
        for c in ("vx", "vy")}}
    for split in ("valid", "test"):
        arrays[f"initial_conditions/{split}_64.h5"] = {c: fields((p["eval"],), n)
                                                       for c in ("vx", "vy")}
        arrays[f"trajectories/{split}_32_1.h5"] = {
            "vorticity": fields((p["eval"], p["records"]), 32),
            "time": np.arange(1, p["records"] + 1, dtype=np.float32)}
    files = {}
    for rel, data in arrays.items():
        path = os.path.join(base, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with H5Writer(path, {k: (v.shape, v.dtype) for k, v in data.items()}) as w:
            for k, v in data.items():
                w.write(k, 0, v)
        files[path] = {k: v.shape for k, v in data.items()}
    return files


def write_parallel_data(root, seed):
    """The sets of the five routines' fits under ``root``: the airfoil files
    (phase mesh's writer), the elasticity files (phase pointcloud's),
    ``rollout/x64``'s (``write_li_velocity``) and cylinder_flow's TFRecords
    through ``convert cylinder-flow`` (phase meshgraphnet's)."""
    from fourierflow_tpu_torch.commands.convert import cylinder_flow as convert

    files = {**write_mesh_data(root, seed, families=("airfoil",)),
             **write_elasticity_data(root, seed), **write_li_velocity(root, seed)}
    records = os.path.join(root, "meshgraphnets", "cylinder_flow")
    write_cylinder_flow(records, seed)
    path = convert(records, os.path.join(records, "cylinder_flow.h5"))
    files[path] = load_array(path, "train/velocity").shape
    return files


def parallel_families(data_path):
    """``[(routine's family, config, overrides)]`` of the five fits."""
    cut, one = f"routine.model.n_layers={PARALLEL_FAMILY_LAYERS}", "trainer.max_epochs=1"
    return [("rollout", ZONGYI_CONFIG, [f"builder.data_path={data_path}", "builder.key=train/u",
                                        "builder.train_size=40", "builder.test_size=20", one]),
            ("mesh", MESH_CONFIG, ["builder.train_size=20", "builder.valid_size=10",
                                   "builder.test_size=10", cut, one]),
            ("pointcloud", POINT_CONFIG, _point_overrides(POINT_CONFIG) + [cut, one]),
            ("learned_interpolation", LI_CONFIG, ["trainer.limit_train_batches=None", one]),
            ("meshgraphnet", MGN_CONFIG, ["trainer.limit_train_batches=2", one])]


def _fit_difference(a, b):
    """``(largest relative difference of train_loss and valid_loss, the
    tensors that differ, the largest max |diff| / max |b| of a tensor, and
    of a weight alone)`` of two ``_parallel_fit``s."""
    losses = max(abs(a[0].logs[k] - b[0].logs[k]) / abs(b[0].logs[k])
                 for k in ("train_loss", "valid_loss"))
    snap_a, snap_b = _snapshot(a[2]), _snapshot(b[2])
    _, bad, worst = _state_diff(snap_a, snap_b)
    weights = max(rel_err(v.float(), snap_b["model"][k].float())[1]
                  for k, v in snap_a["model"].items())
    return losses, bad, worst, weights


def _family_fits(families, dev, seed, world):
    """Each family's fit on a data mesh over the world's ranks against the
    same fit with no mesh. One rank: to the bit (weights, AdamW moments,
    losses and steps; the phase sets no cuDNN flag: the learned
    interpolation's convolutions pick deterministic algorithms themselves,
    and MeshGraphNet sums with the segment-sum kernel); several ranks:
    within PARALLEL_FIT_RTOL. Returns the launches of the data-mesh fits."""
    launched = {**dict.fromkeys(KERNELS, 0), **dict.fromkeys(GRAPH_KERNELS, 0)}
    for family, name, over in families:
        cfg = load_config(name, over)
        t0 = time.perf_counter()
        ref = _parallel_fit(cfg, dev, seed)
        t1 = time.perf_counter()
        got = _parallel_fit(cfg, dev, seed, make_mesh())
        seconds = (t1 - t0, time.perf_counter() - t1)
        launched = {k: launched[k] + got[4][k] for k in launched}
        losses, bad, worst, weights = _fit_difference(got, ref)
        log(f"parallel: {family} ({name}, n_params {ref[0].logs['n_params']:,}): a fit on "
            f"{mesh_shape(got[0].mesh)} ({got[0].global_step} steps, {seconds[1]:.1f} s with "
            f"validation) against no mesh ({ref[0].global_step}, {seconds[0]:.1f} s): train_loss "
            f"{got[0].logs['train_loss']!r} / {ref[0].logs['train_loss']!r}, valid_loss "
            f"{got[0].logs['valid_loss']!r} / {ref[0].logs['valid_loss']!r}; {len(bad)} tensors "
            f"differ, largest rel difference {worst:.2e} ({weights:.2e} in a weight); launches "
            f"{got[4]}")
        if got[0].global_step != ref[0].global_step or got[0].global_step < 1:
            raise AssertionError(f"parallel: {family}: {got[0].global_step} steps on the mesh, "
                                 f"{ref[0].global_step} without")
        if world > 1:
            for k, rtol in PARALLEL_FIT_RTOL.items():
                if not abs(got[0].logs[k] - ref[0].logs[k]) <= rtol * abs(ref[0].logs[k]):
                    raise AssertionError(f"parallel: {family}: {k} off by more than {rtol:.0e}")
        elif bad or losses != 0:
            raise AssertionError(f"parallel: {family}: the data mesh's fit differs from the fit "
                                 f"with no mesh in {bad[:6]}")
    return launched


def _parallel_rank(rank, world, store, data_path, data_root, seed, out_path):
    """One rank of phase parallel: joins the NCCL world on card ``rank`` and
    runs its cases; rank 0 writes the results."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rank:  # rank 0 reports for all
        sys.stdout = open(os.devnull, "w")
    os.environ["DATA_ROOT"] = data_root  # the registry's data paths
    dev = init_distributed(torch.device("cuda", rank), f"file://{store}", rank, world)
    try:
        cfg = load_config(CONFIG, data_overrides(data_path) + ["trainer.max_epochs=2"])
        reset_launch_counts()
        out = (_world_of_one if world == 1 else lambda *a: _several_ranks(*a, world))(
            cfg, dev, 7231)
        out["launches_families"] = _family_fits(parallel_families(data_path), dev, 7231, world)
        out["launches"] = {**launch_counts(), **launch_counts(AXIS_KERNELS),
                           **launch_counts(GRAPH_KERNELS)}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def phase_parallel(seed, data_path):
    """The parallel trainer on the card(s): one process a card, started by
    ``torch.multiprocessing``, over NCCL. With one card a world of one rank
    (``_world_of_one``); with two or more, 2-way data, tensor and spatial
    parallelism (``_several_ranks``); then the five other routines' fits on
    a data mesh (``_family_fits``) on the sets ``write_parallel_data``
    writes. Returns the launches of the phase's main path."""
    cards = torch.cuda.device_count()
    world = 2 if cards >= 2 else 1
    log(f"parallel: {cards} card(s): a world of {world} rank(s) over NCCL"
        + ("; runs with several ranks need two or more cards" if world == 1 else ""))
    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        files = write_parallel_data(data_root, seed)
        log(f"parallel: wrote the five routines' sets in {time.perf_counter() - t0:.1f} s: "
            f"{ {os.path.relpath(k, data_root): v for k, v in files.items()} }; cut: airfoil "
            f"20 / 10 / 10 and elasticity {' / '.join(map(str, POINT_SPLITS))} samples, "
            f"F-FNOs at {PARALLEL_FAMILY_LAYERS} of 24 layers, rollout/x64 "
            f"{LI_PARALLEL['train']} trajectories of {LI_PARALLEL['frames']} frames, "
            f"cylinder_flow 2 train batches; one epoch each")
        out_path = os.path.join(tmp, "parallel.json")
        sys.stdout.flush()
        torch.multiprocessing.start_processes(
            _parallel_rank, args=(world, os.path.join(tmp, "store"), data_path, data_root, seed,
                                  out_path),
            nprocs=world, start_method="spawn")
        with open(out_path) as f:
            out = json.load(f)
    counts, families = out["launches"], out["launches_families"]
    log(f"parallel: launches over the phase {counts} (a fused_mix_2d call is two launches of the "
        f"spectral kernel, a fused_mix_axis call one); in the five routines' data-mesh fits "
        f"{families}")
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"parallel: {name} was never launched on the parallel path")
    for name, n in families.items():
        if n < 1:
            raise AssertionError(f"parallel: {name} was never launched in the routines' "
                                 "data-mesh fits")
    return counts


# --- phase trainer ---------------------------------------------------------------------------
def _snapshot(state):
    """A copy of a train state's tensors and counters, on the CPU."""
    norm = state.normalizer
    return {"model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "normalizer": {} if norm is None else {
                f: getattr(norm, f).detach().cpu().clone()
                for f in ("sum", "sum_squared", "count", "n_accumulations")},
            "optimizer": copy.deepcopy(state.optimizer.state_dict()),
            "scheduler": None if state.scheduler is None else state.scheduler.state_dict(),
            "step": state.step}


class _RecordFitStarts:
    """While entered, ``Trainer.fit`` records a snapshot of the state each
    fit starts from (None for a fresh one) in ``starts``."""

    def __enter__(self):
        self.starts, self._fit = [], Trainer.fit

        def recording_fit(trainer, routine, builder, state=None):
            self.starts.append(None if state is None else _snapshot(state))
            return self._fit(trainer, routine, builder, state)

        Trainer.fit = recording_fit
        return self.starts

    def __exit__(self, *exc):
        Trainer.fit = self._fit


def _hold_start(label, start, weights, blob=None):
    """A fit's starting snapshot against a checkpoint: the weights (``weights``,
    by name), and, for the port's own file ``blob``, the normalizer, the
    AdamW moments, the schedule and the step, each to the bit. Without
    ``blob`` the optimizer must hold no moments and the step be 0."""
    bad = [k for k, v in start["model"].items() if not torch.equal(v, weights[k])]
    moments = start["optimizer"]["state"]
    if blob is not None:
        bad += [f for f, v in blob["normalizer"].items() if not torch.equal(start["normalizer"][f], v)]
        want = blob["optimizer"]["state"]
        if moments.keys() != want.keys():
            bad.append("optimizer state keys")
        bad += [f"moment {i}.{name}" for i, m in want.items() for name, v in m.items()
                if not torch.equal(moments[i][name].cpu(), v)]
        if start["scheduler"] != blob["scheduler"] or start["step"] != blob["step"]:
            bad.append(f"schedule {start['scheduler']} / step {start['step']}")
        what = (f"{len(weights)} weights, normalizer, {sum(len(m) for m in want.values())} "
                f"AdamW moment tensors, schedule at step {blob['step']}")
    else:
        if moments or start["step"] != 0:
            bad.append(f"{len(moments)} optimizer moments, step {start['step']}")
        what = f"{len(weights)} weights; no optimizer moments, step 0"
    log(f"trainer: {label}: the fit's starting state against the file: {what}: "
        + ("equal to the bit" if not bad else f"differ in {bad[:6]}"))
    if bad:
        raise AssertionError(f"trainer: {label}: the starting state differs from the file")


def remat_vs_eager_step(routine, state, batch):
    """One step's loss and gradients from one state and batch without noise,
    eager and with remat: the loss to the bit, every gradient within
    REMAT_GRAD_TOL, and the launches of each. Leaves remat on."""
    quiet = copy.copy(routine)
    quiet.noise_std = 0.0
    runs = {}
    for remat in (False, True):
        state.model.remat = remat
        reset_launch_counts()
        loss, grads, _ = quiet.loss_and_grads(state, batch)
        torch.cuda.synchronize()
        runs[remat] = (loss, grads, launch_counts())
    (loss, grads, eager_counts), (rloss, rgrads, remat_counts) = runs[False], runs[True]
    names = [n for n, _ in state.model.named_parameters()]
    rels = {n: rel_err(a, b)[1] for n, a, b in zip(names, rgrads, grads, strict=True)}
    worst = max(rels, key=rels.get)
    log(f"trainer: one step from one state without noise, remat vs eager: loss {float(rloss):.9g} "
        f"vs {float(loss):.9g} ({'equal to the bit' if torch.equal(rloss, loss) else 'differ'}); "
        f"gradients of {len(rels)} parameters, largest rel {rels[worst]:.3e} ({worst}), "
        f"tol {REMAT_GRAD_TOL:.0e}; launches remat {remat_counts}, eager {eager_counts}")
    if not (torch.equal(rloss, loss) and rels[worst] <= REMAT_GRAD_TOL):
        raise AssertionError("trainer: the remat step disagrees with the eager step")
    want = {"fused_ff": 2 * N_LAYERS, "fused_mix_2d": 2 * N_LAYERS, "fused_ff_bwd": N_LAYERS,
            "fused_mix_2d_adjoint": N_LAYERS}
    if remat_counts != want or any(n != N_LAYERS for n in eager_counts.values()):
        raise AssertionError(f"trainer: launches remat {remat_counts} (want {want}), eager "
                             f"{eager_counts} (want {N_LAYERS} each)")


def step_memory(label, routine, state, batch, dev, steps=10):
    """ms per train step (``time_steps``) and one step's peak
    ``max_memory_allocated`` above the memory held before it."""
    state, ms = time_steps(label, routine, state, batch, dev, steps=steps, phase="trainer")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state, _ = routine.train_step(state, batch, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"trainer: {label}: peak max_memory_allocated {peak / 2**30:.4f} GiB, "
        f"{(peak - held) / 2**30:.4f} GiB above the {held / 2**30:.4f} GiB held before the step")
    return state, ms, peak - held


def layer_inputs(model, batch):
    """The bytes of one float32 layer input a layer: ``n_layers * batch *
    cells * width * 4``, the cells those of the batch's ``x``."""
    x = batch["x"]
    return model.n_layers * x.shape[0] * math.prod(x.shape[1:-1]) * model.width * 4


def remat_memory(dev, seed, flagship):
    """Each of REMAT_MEMORY_CASES' train step, eager and with remat, on
    random batches from ``seed`` (their values change no step's work or
    memory): the normalizer pass where the routine has one, then
    ``step_memory`` at 3 timed steps; each peak in layer inputs a layer.
    ``flagship`` is the flagship's eager (unit bytes, peak above the held
    memory). Prints each model family's coefficient: the least-squares fit
    through the origin of its eager steps, beside the Trainer's."""
    rng = np.random.default_rng(seed)
    eager = {"FNOFactorized2DBlock": [flagship]}
    for name, shapes in REMAT_MEMORY_CASES:
        routine = build_routine(load_config(name)["routine"])
        batch = {k: rng.standard_normal(shape, dtype=np.float32) for k, shape in shapes.items()}
        state = routine.accumulate_step(routine.init(seed, batch, dev), batch)
        model, unit = routine.model, layer_inputs(routine.model, batch)
        family = type(model).__name__
        peaks = {}
        for remat in (False, True):
            model.remat = remat
            label = f"{name} batch {len(batch['x'])} remat={remat}"
            state, ms, peaks[remat] = step_memory(label, routine, state, batch, dev, steps=3)
        log(f"trainer: {name} batch {len(batch['x'])} ({family}): peak above the held memory "
            f"eager {peaks[False] / unit:.3f}, remat {peaks[True] / unit:.3f} layer inputs a "
            f"layer (one is {unit / 2**30:.4f} GiB); remat / eager {peaks[True] / peaks[False]:.3f}")
        eager.setdefault(family, []).append((unit, peaks[False]))
        del routine, model, state
        torch.cuda.empty_cache()
    fits = {family: sum(u * p for u, p in pairs) / sum(u * u for u, _ in pairs)
            for family, pairs in eager.items()}
    log(f"trainer: saved layer inputs a layer of the eager step, least squares through the "
        f"origin: {', '.join(f'{f} {c:.4f}' for f, c in fits.items())}; the Trainer holds "
        f"{SAVED_INPUTS_PER_LAYER}")


def profiled_cli_fit(tmp, data_path):
    """``train --profile-dir`` through the CLI in a child process (a trace in
    this long process loses kernel events after CUDA graphs): the trace's
    events of each hand-written kernel, each at least the steps x 24."""
    trace_dir, run_dir = os.path.join(tmp, "trace"), os.path.join(tmp, "cli")
    cmd = [sys.executable, "-m", "fourierflow_tpu_torch.commands", "train", CONFIG,
           *data_overrides(data_path), "trainer.max_epochs=2",
           f"trainer.limit_train_batches={TRAINER_STEPS}", "trainer.check_val_every_n_epoch=3",
           "--profile-dir", trace_dir, "--no-test", "--config-dir", run_dir]
    sys.stdout.flush()
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, timeout=600, stdout=subprocess.DEVNULL)
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(traces) != 1:
        raise AssertionError(f"trainer: profiled CLI fit wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(1 for name in kernels if f"{k}_kernel" in name)
              for k in ("ff_fwd", "ff_bwd", "spectral_axis")}
    want = TRAINER_STEPS * N_LAYERS
    log(f"trainer: train --profile-dir in a child process: {time.perf_counter() - t0:.1f} s, "
        f"trace {os.path.getsize(traces[0]) / 2**20:.1f} MiB with {len(kernels)} kernel "
        f"events; ff_fwd_kernel {counts['ff_fwd']}, ff_bwd_kernel {counts['ff_bwd']}, "
        f"spectral_axis_kernel {counts['spectral_axis']} (each at least {TRAINER_STEPS} steps "
        f"x {N_LAYERS} = {want})")
    if any(n < want for n in counts.values()):
        raise AssertionError("trainer: the trace lacks the hand-written kernels' events")


def guard_decisions(dev, data_path):
    """The Trainer's remat guard on the card's real memory, for the flagship
    and for torus_kochkov/ffno/grid_sizes/256 at its batch."""
    budget = REMAT_BUDGET * _device_hbm_bytes(dev)
    cfg = load_config(CONFIG, data_overrides(data_path))
    kol = load_config(KOL_GRIDS[-1])
    cases = ((CONFIG, cfg, instantiate(cfg["builder"]).sample_batch()),
             (KOL_GRIDS[-1], kol, {"x": np.empty((kol["builder"]["batch_size"], 256, 256, 1),
                                                 np.float32)}))
    for name, c, sample in cases:
        model = instantiate(c["routine"]["conv"])
        est = _estimate_activation_bytes(model, sample)
        log(f"trainer: remat guard at {name} (batch {len(sample['x'])}): estimate "
            f"{est / 2**30:.3f} GiB ({SAVED_INPUTS_PER_LAYER[type(model).__name__]} layer "
            f"inputs a layer) against "
            f"{REMAT_BUDGET:.0%} of {_device_hbm_bytes(dev) / 2**30:.2f} GiB = "
            f"{budget / 2**30:.2f} GiB: {'remat' if est > budget else 'eager'}")


def phase_trainer(dev, seed, data_path):
    """The rest of ``train`` and the trainer at the flagship's full width:
    train with remat, resume, ``checkpoint_path``, ``pretrained_path`` (the
    port's file and a Lightning one), a remat step against an eager step,
    the low-pass mode, SWA, ``--profile-dir`` through the CLI and the remat
    guard's decision. Returns the launch counts of train and resume."""
    phase_start = time.perf_counter()
    remat_overrides = data_overrides(data_path) + ["trainer.max_epochs=2",
                                                   "routine.conv.remat=True"]
    once = data_overrides(data_path) + ["trainer.max_epochs=1",
                                        "trainer.check_val_every_n_epoch=2"]
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        with _RecordFitStarts() as starts:
            trainer, state = train.main(CONFIG, remat_overrides, config_dir=tmp, no_test=True,
                                        device="cuda")
            (last,) = [os.path.join(d.path, "last.ckpt")
                       for d in os.scandir(os.path.join(tmp, "checkpoints"))]
            resumed_trainer, resumed = train.main(CONFIG, remat_overrides, config_dir=tmp,
                                                  no_test=True, resume=True, device="cuda")
        counts = launch_counts()
        blob = torch.load(last, map_location="cpu", weights_only=True)
        log(f"trainer: train with remat, {trainer.global_step} steps, then resume from "
            f"{os.path.relpath(last, tmp)}: {resumed_trainer.global_step} steps (global_step "
            f"from 0, as the reference), state step {blob['step']} -> {resumed.step}; "
            f"launches over both {counts}")
        _hold_start("resume", starts[-1], blob["model"], blob)
        # The port's plot command over the run directory (train and resume, two trials).
        log("trainer: the port's plot table over the run directory (train, then resume):")
        table = plot.table(tmp, keys=["train_loss", "valid_loss", "n_params", "epoch"])
        if table.count("| checkpoints/trial-0-") != 2 or "—" in table:
            raise AssertionError("trainer: plot table lacks the two runs' final metrics")
        steps = trainer.global_step
        if not (state.model.remat is True and resumed_trainer.global_step == steps > 0
                and resumed.step == 2 * steps):
            raise AssertionError("trainer: train / resume counted other steps")
        want = 2 * steps * N_LAYERS
        if counts["fused_ff_bwd"] != want or counts["fused_mix_2d_adjoint"] != want or min(
                counts["fused_ff"], counts["fused_mix_2d"]) < 2 * want:
            raise AssertionError(f"trainer: remat launches {counts}: want {want} backward, at "
                                 f"least {2 * want} forward")

        with _RecordFitStarts() as starts:
            train.main(CONFIG, once, config_dir=tmp, no_test=True, checkpoint_path=last,
                       device="cuda")
            _hold_start("checkpoint_path", starts[-1], blob["model"], blob)
            lightning = os.path.join(tmp, "reference.ckpt")
            save_lightning(lightning, resumed)
            ref = {k[len("conv."):]: v for k, v in torch.load(
                lightning, weights_only=True)["state_dict"].items() if k.startswith("conv.")}
            for kind, path, weights in (("port checkpoint", last, blob["model"]),
                                        ("Lightning .ckpt", lightning, ref)):
                train.main(CONFIG, once + [f"pretrained_path={path}"],
                           config_dir=os.path.join(tmp, kind.split()[0]), no_test=True,
                           device="cuda")
                _hold_start(f"pretrained_path ({kind})", starts[-1], weights)

        cfg = load_config(CONFIG, data_overrides(data_path))
        builder = instantiate(cfg["builder"])
        routine = build_routine(cfg["routine"])
        batches = builder.train_batches(np.random.default_rng(seed))
        batch = next(batches)
        remat_vs_eager_step(routine, resumed, batch)
        timings = {}
        for remat in (False, True):
            resumed.model.remat = remat
            resumed, ms, peak = step_memory(f"remat={remat}", routine, resumed, batch, dev)
            timings[remat] = (ms, peak)
        log(f"trainer: remat / eager: {timings[True][0] / timings[False][0]:.3f}x the time, "
            f"{timings[True][1] / timings[False][1]:.3f}x the peak above the held memory")
        remat_memory(dev, seed, (layer_inputs(resumed.model, batch), timings[False][1]))

        lp_cfg = load_config(CONFIG, data_overrides(data_path) + ["routine.conv.mode=low-pass"])
        lp_routine = build_routine(lp_cfg["routine"])
        lp_state = lp_routine.init(7231, builder.sample_batch(), dev)
        if any("fourier_weight" in k for k in lp_state.model.state_dict()):
            raise AssertionError("trainer: the low-pass model has Fourier weights")
        for b in builder.train_batches(np.random.default_rng(seed)):
            lp_state = lp_routine.accumulate_step(lp_state, b)
        reset_launch_counts()
        lp_state = hold_steps("low-pass", lp_routine, lp_state, [batch, next(batches)],
                              phase="trainer")
        lp_counts = launch_counts()
        lp_want = {"fused_ff": 2 * N_LAYERS, "fused_ff_bwd": 2 * N_LAYERS, "fused_mix_2d": 0,
                   "fused_mix_2d_adjoint": 0}
        log(f"trainer: low-pass, launches in 2 steps {lp_counts}")
        if lp_counts != lp_want:
            raise AssertionError(f"trainer: low-pass launches {lp_counts}, want {lp_want}")

        class EpochEnds(Callback):
            def __init__(self):
                self.weights = []

            def on_epoch_end(self, trainer, routine, state):
                self.weights.append({k: p.detach().clone()
                                     for k, p in state.model.named_parameters()})

        ends = EpochEnds()
        swa_routine = build_routine(cfg["routine"], builder)
        swa_trainer = Trainer(max_epochs=2, limit_train_batches=3, check_val_every_n_epoch=3,
                              callbacks=[ends, StochasticWeightAveraging(swa_step_start=0)],
                              seed=7231, device=dev)
        swa_state = swa_trainer.fit(swa_routine, builder)
        bad = [k for k, p in swa_state.model.named_parameters()
               if not torch.equal(p.detach(), (ends.weights[0][k] + ends.weights[1][k]) / 2)]
        log(f"trainer: SWA from step 0 over {swa_trainer.global_step} steps in 2 epochs: the "
            f"final weights {'equal' if not bad else 'differ from'} the mean of the "
            f"{len(ends.weights)} epoch-end weights ({len(ends.weights[0])} tensors)")
        if bad or len(ends.weights) != 2:
            raise AssertionError(f"trainer: SWA's weights differ in {bad[:6]}")

        profiled_cli_fit(tmp, data_path)
    guard_decisions(dev, data_path)
    log(f"trainer: phase took {time.perf_counter() - phase_start:.1f} s")
    return counts


def phase_time_apart(seed):
    """Phase ``time`` in a child process of this script, which starts with
    no CUDA graph and no earlier profiler session (in the parent, after the
    solver's graphs of phases generate and context, traces lost device
    activity); its rows come back through a JSON file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "time.json")
        sys.stdout.flush()
        subprocess.run([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                        "--time-json", path], check=True, timeout=900)
        with open(path) as f:
            rows = json.load(f)
    return {(r["name"], getattr(torch, r["dtype"])) + tuple(r["at"]):
            dict(r["row"], bound=tuple(r["row"]["bound"])) for r in rows}


# The phases in the order a run goes through them, and the phases whose files each reads.
PHASES = ("sass", "check", "generate", "main", "serve", "train", "baseline", "mesh", "context",
          "kolmogorov", "pointcloud", "cno", "projection", "learned_interpolation",
          "meshgraphnet", "trainer", "parallel", "time")
PHASE_NEEDS = {"main": ("generate",), "serve": ("generate",), "train": ("generate",),
               "baseline": ("generate",), "context": ("generate",), "trainer": ("generate",),
               "parallel": ("generate",), "cno": ("mesh", "kolmogorov"),
               "learned_interpolation": ("projection",)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", nargs="+", choices=PHASES, default=PHASES, metavar="PHASE",
                        help="run these phases only (and those whose files they read); device "
                             f"and build always run. One or more of {', '.join(PHASES)}. "
                             "Default: every phase")
    # Internal: run phase time alone and write its rows to this JSON file.
    parser.add_argument("--time-json", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    # The export's own line: its trace time, file size and node count.
    logging.basicConfig(level=logging.WARNING, stream=sys.stdout, format="%(message)s")
    logging.getLogger("fourierflow_tpu_torch.utils.serving").setLevel(logging.INFO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.time_json:
        rows = phase_time(dev, args.seed)
        with open(args.time_json, "w") as f:
            json.dump([{"name": name, "dtype": str(dtype).replace("torch.", ""), "at": tail,
                        "row": row} for (name, dtype, *tail), row in rows.items()], f)
        return

    run = set(args.phases)
    for name in args.phases:
        run.update(PHASE_NEEDS.get(name, ()))
    seconds = {}

    def phase(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    card = phase_device()
    phase("build", phase_build)
    if "sass" in run:
        phase("sass", phase_sass)
    errs = phase("check", phase_check, dev, args.seed) if "check" in run else {}
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_path = (phase("generate", phase_generate, dev, tmp, args.seed)[0]
                     if "generate" in run else None)
        # (phase, the path its launch counts stand for, the call)
        paths = (("main", "infer", lambda: phase_main(dev, args.seed, data_path)),
                 ("serve", "serve", lambda: phase_serve(dev, args.seed, data_path)),
                 ("train", "train", lambda: phase_train(dev, args.seed, data_path)),
                 ("baseline", None, lambda: phase_baseline(dev, data_path)),
                 ("mesh", "mesh", lambda: phase_mesh(dev, tmp, args.seed)),
                 ("context", "context", lambda: phase_context(dev, tmp, data_path)),
                 ("kolmogorov", "kolmogorov", lambda: phase_kolmogorov(dev, tmp)),
                 ("pointcloud", "pointcloud", lambda: phase_pointcloud(dev, tmp, args.seed)),
                 ("cno", "cno", lambda: phase_cno(dev, tmp)),
                 ("projection", "projection", lambda: phase_projection(dev, tmp, args.seed)),
                 ("learned_interpolation", "learned_interpolation",
                  lambda: phase_learned_interpolation(dev, tmp, args.seed)),
                 ("meshgraphnet", "meshgraphnet", lambda: phase_meshgraphnet(dev, tmp, args.seed)),
                 ("trainer", "trainer", lambda: phase_trainer(dev, args.seed, data_path)),
                 ("parallel", "parallel", lambda: phase_parallel(args.seed, data_path)))
        for name, path, call in paths:
            if name in run:
                out = phase(name, call)
                if path is not None:  # the one-axis and graph kernels' counts where the
                    # phase had none
                    counts[path] = {**launch_counts(AXIS_KERNELS),
                                    **launch_counts(GRAPH_KERNELS), **out}
    times = phase("time", phase_time_apart, args.seed) if "time" in run else {}

    kernels = []
    for name, meta in {**KERNELS, **AXIS_KERNEL_LINES, **GRAPH_KERNEL_LINES}.items():
        t = times.get((name, torch.float32), {})
        entry = {"name": name, "route": "cuda", "source": meta["source"],
                 "replaces": meta["replaces"], "launches": counts.get(meta["path"], {}).get(name),
                 **({"at": meta["at"]} if "at" in meta else {}),
                 "launches_by_path": {p: c[name] for p, c in counts.items()},
                 "max_abs_err": errs.get((name, torch.float32)),
                 "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
                 "bound_ms": t["bound"][0] if t else None,
                 "bound_by": t["bound"][1] if t else None, "library_ms": t.get("library_ms")}
        shapes = [{"at": tail[0], "dtype": "float32", "ms": r["ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                   "library_ms": r["library_ms"]}
                  for (n, dtype, *tail), r in times.items()
                  if n == name and dtype == torch.float32 and tail]
        if shapes:
            entry["shapes"] = shapes
        kernels.append(entry)
    log(json.dumps({"phase_seconds": seconds}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
