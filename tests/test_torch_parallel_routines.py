"""The five routines other than the Markov one on the parallel trainer's
``data`` mesh (``Routine.mean_over_data``), against the JAX package's
unsharded steps and the port's own, on the CPU.

One ``gloo`` world of 4 processes (``torch.multiprocessing``, a ``file://``
store under ``tmp_path``, one thread a rank) runs every case once for the
module and writes what each rank found; the JAX side runs in this process
on its 8 virtual devices (``tests/conftest.py``). The families, each tiny:
the FNO-4 rollout (``Grid2DRolloutRoutine``, width 8, 2 layers, 3 target
steps), the 2D mesh F-FNO (``StructuredMeshRoutine``, width 16, 2 layers,
``loss_scale`` 20), the point-cloud F-FNO with its IPhi
(``PointCloudRoutine``, width 8, 2 layers), the learned interpolation at
32^2 (8 features, 2 layers, an unroll of 2) and MeshGraphNet (latent 16, 2
layers, padded meshes, gradients clipped by global norm 0.1). What is held:

- (a) two train steps on ``data`` 4 (batch 4, one sample a rank): each
  step's loss within rtol 1e-5 of JAX's ``train_step``, the first step's
  gradients within 1e-5 of each tensor's largest value of JAX's own (the
  routine's ``jax.value_and_grad``, MeshGraphNet's clipped), and the
  parameters after the second step within rtol 1e-4, atol 1e-6 of JAX's.
  AdamW runs on the cosine schedule with a warm-up (JAX's bounds and
  schedule, ``tests/test_torch_parallel.py``): the first step at learning
  rate 0 fills the moments, the second moves every parameter at 1e-4, and
  its update is the sign of a gradient equal on both steps. (Two steps at a
  learning rate above 0 make the second update a ratio of two different
  gradients, which turns a gradient's float32 rounding of 1e-8 of its
  tensor's largest value into 4e-6 on a parameter whose gradient is 1e-5 of
  it: the port's one-process step and JAX's differ so.) The MeshGraphNet
  batch gives the ranks 5, 9, 7 and 6 valid nodes and its clip acts;
- (b) a batch of 2, which the axis does not divide, so every rank holds
  all of it: the same steps against the port's one-process steps, by the
  same bounds (the gradients averaged over the ranks, not summed);
- (c) the point cloud with ``reg_weight`` 0.5: each rank draws the IPhi
  points of the whole batch from the step's generator and keeps its own,
  so the steps equal the port's one-process steps with the same generator;
- (d) ``valid_step`` on a batch split over ``data``: every metric within
  rtol 1e-5 of the one-process ``valid_step``;
- (e) a fit through ``build_trainer`` for each family (the device-resident
  epoch where the builder has one, the per-batch loop for MeshGraphNet)
  against the same fit in one process: train loss rtol 1e-4, valid loss
  1e-3 (JAX's bounds), the same number of steps;
- (f) ``train`` of ``airfoil/ffno/24_layers`` (shrunk, on tiny files) on
  the world's ranks: rank 0's run directory with ``last.ckpt`` and
  ``metrics.jsonl``, every rank's test loss the same;
- (g) a ``spatial`` mesh with each of the five routines raises the
  ``NotImplementedError`` that names the routine and the axis, and so does
  a ``model`` mesh with a model that has leaves to split and no split form
  (the 3D mesh F-FNO), naming the model.

The same routines on ``data x model`` (``make_tp_mesh``), where the mesh and
point-cloud F-FNOs and the FNO-4 split their Fourier weights by output
channel and their feed-forwards Megatron-style, and the learned
interpolation, MeshGraphNet and Geo-FNO-4 run whole on every ``model``
rank (JAX's ``_tp_spec`` splits none of their leaves):

- (a') two train steps on ``{data 2, model 2}`` against JAX's unsharded
  ``train_step`` at (a)'s bounds, the split gradients and parameters
  gathered whole; every ``model`` rank of a data row holds the same
  parameters to the bit after them, the point cloud's with ``reg_weight``
  0.5 and the step's IPhi draws too (held to the one-process steps);
  the mesh F-FNO on ``{data 1, model 4}`` (width 16: 4 output channels a
  rank) and Geo-FNO-4 (``FNOMesh2D`` under ``StructuredMeshRoutine``) on
  ``model`` 2 and the mesh CNO (its feed-forwards split, its DCT weights
  whole) against JAX at the same bounds; the rollout with Fourier
  positions (``FourierPositionNet``) against the one-process steps; each
  family's split form on
  ``{data 1, model 1}`` (rank 0 alone) equal to the one-process step to
  the bit, as phase ``parallel`` holds it on the card;
- the parameters that ``tp_param_specs`` splits at ``model`` 2, family by
  family, are the leaves that JAX's ``tp_state_shardings`` splits, mapped
  through ``CONVERT``;
- (d') ``valid_step`` and (e') a fit through
  ``build_trainer(tensor_parallel=2)`` (the per-batch loop, as in JAX)
  against one process, at (d)'s and (e)'s bounds;
- (f') ``train`` of the shrunk airfoil on ``trainer.tensor_parallel=2``:
  rank 0's ``last.ckpt`` holds the whole state (its test loss in one
  process is the split run's), and ``--resume`` takes it back onto the
  same mesh, split, for a fit equal to one process's from that
  checkpoint.

The models that split on ``model`` beside those (``MESH_3D_AND_PLUS``): the
3D mesh F-FNO and FCNO under ``StructuredMeshRoutine`` (width 8, 2 layers, a 6 x 5
x 4 grid padded by 2, the plasticity layout) and the fully-factorized
point-cloud model under ``PointCloudRoutine`` (width 8, 2 layers, its IPhi)
take (a'), (d'), (e'), the bit-equal ranks and ``{data 1, model 1}``, and
``tp_param_specs`` against JAX; the 3D F-FNO also on ``{data 1, model 4}``
against JAX and with ``remat`` on ``model`` 2, equal to the eager split
step to the bit. The FCNO splits its feed-forwards only (its DCT weights
are rank 3), the fully-factorized model every layer's Fourier weights and
feed-forwards. (g) holds its guard with a stand-in model (``_NoSplitForm``):
a rank-4 Fourier weight and no split form.
"""

import copy
import glob
import json
import os
import pickle
import traceback

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
import torch.multiprocessing as mp

from fourierflow_tpu import models as jax_models
from fourierflow_tpu.routines import Grid2DRolloutRoutine as JaxRollout
from fourierflow_tpu.routines import LearnedInterpolatorRoutine as JaxLI
from fourierflow_tpu.routines import MeshGraphNetRoutine as JaxMGN
from fourierflow_tpu.routines import PointCloudRoutine as JaxCloud
from fourierflow_tpu.routines import StructuredMeshRoutine as JaxMesh
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu.schedulers import cosine_with_warmup as jax_cosine
from fourierflow_tpu_torch import models
from fourierflow_tpu_torch.builders import (CylinderFlowBuilder, ElasticityBuilder,
                                            NSZongyiBuilder, PlasticityBuilder,
                                            StructuredMesh2DBuilder)
from fourierflow_tpu_torch.builders import kolmogorov as kol
from fourierflow_tpu_torch.commands import train
from fourierflow_tpu_torch.commands.train import build_trainer
from fourierflow_tpu.parallel.mesh import make_tp_mesh as jax_make_tp_mesh
from fourierflow_tpu.parallel.mesh import tp_state_shardings
from fourierflow_tpu_torch.commands.train import build_routine
from fourierflow_tpu_torch.config import instantiate, load_config
from fourierflow_tpu_torch.parallel import (gather_state, init_distributed, make_mesh,
                                            make_sp_mesh, make_tp_mesh, mesh_axis, mesh_shape,
                                            shard_batch, shard_state, split_dims, tp_param_specs)
from fourierflow_tpu_torch.parallel.collectives import all_gather
from fourierflow_tpu_torch.routines import (Grid2DRolloutRoutine, LearnedInterpolatorRoutine,
                                            MeshGraphNetRoutine, PointCloudRoutine,
                                            StructuredMeshRoutine)
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.schedulers import cosine_with_warmup
from fourierflow_tpu_torch.trainers import Trainer
from fourierflow_tpu_torch.trainers.trainer import step_generator
from fourierflow_tpu_torch.utils.checkpoint import load_state
from fourierflow_tpu_torch.utils.hdf5 import H5Writer
from fourierflow_tpu_torch.utils.weights import (cno_state_dict_from_flax, geo_state_dict_from_flax,
                                                 learned_interpolation_state_dict_from_flax,
                                                 mesh_state_dict_from_flax,
                                                 meshgraphnet_state_dict_from_flax,
                                                 point_cloud_state_dict_from_flax,
                                                 zongyi_state_dict_from_flax)

WORLD = 4
FAMILIES = ("rollout", "mesh", "cloud", "li", "mgn")
GRAD_RTOL = 1e-5  # max |err| <= GRAD_RTOL * max |JAX's|, per tensor
ROLLOUT = dict(modes1=4, modes2=4, width=8, n_layers=2, input_dim=5)
MESH = dict(modes_x=6, modes_y=4, width=16, input_dim=4, n_layers=2)
GRID_2D = (20, 12)
CLOUD = dict(modes1=3, modes2=3, width=8, in_channels=2, out_channels=1, s1=12, s2=10,
             n_layers=2)
LI = dict(size=32, dt=0.014024967203525862, unroll_length=2, inner_steps=1, outer_steps=2,
          features=8, n_cnn_layers=2)
MGN = dict(n_layers=2, latent_size=16, clip_val=0.1, rollout_steps=3)
MGN_NODES = (5, 9, 7, 6)  # valid nodes of each sample of the batch of 4 (of 9)
IPHI_N = 16
# Geo-FNO-4 (FNOMesh2D) under StructuredMeshRoutine: no leaf JAX splits, whole on every model rank.
GEO = dict(modes1=4, modes2=4, width=8, n_layers=2)
# The families held on data x model: the five, the Geo-FNO-4 step and the mesh CNO (its real DCT
# weights [C, C, M] stay whole under JAX's rule; its feed-forwards split).
JAX_FAMILIES = FAMILIES + ("geo", "cno")
# The rollout with Fourier positions: FourierPositionNet passes the axes on to its conv, whose
# input is the 2 (2 x 8 + 1) position features.
FOURIER_POSITION = dict(ROLLOUT, input_dim=34)
# The models whose split forms came after those: the 3D mesh F-FNO and FCNO (plasticity's layout:
# x [b, *GRID_3D, 1], 4 outputs) and the fully-factorized point-cloud model (its y branch's modes
# apart from the x branch's).
MESH_3D = dict(modes_x=3, modes_y=3, modes_z=2, width=8, input_dim=4, output_dim=4, n_layers=2,
               padding=2)
GRID_3D = (6, 5, 4)
PLUS = dict(CLOUD, modes2=4)
MESH_3D_AND_PLUS = ("mesh3d", "cno3d", "plus")
JAX_FAMILIES += MESH_3D_AND_PLUS
# The families held on data x model, step for step.
TENSOR_FAMILIES = FAMILIES + MESH_3D_AND_PLUS


def _opt(jax_side=False, clip=None):
    """AdamW on the cosine schedule with a warm-up of 10 steps from 1e-3:
    step 0 at learning rate 0 (the moments only), step 1 at 1e-4."""
    make, cosine = (jax_make_optimizer, jax_cosine) if jax_side else (make_optimizer,
                                                                       cosine_with_warmup)
    return make(schedule=cosine(1e-3, 10, 500), weight_decay=1e-4, clip_val=clip)


def _port_routine(family, reg_weight=0.0, remat=False):
    if family == "rollout":
        return Grid2DRolloutRoutine(model=models.FNOZongyi2DBlock(**ROLLOUT), optimizer=_opt())
    if family == "mesh":
        return StructuredMeshRoutine(conv=models.FNOFactorizedMesh2D(**MESH), loss_scale=20,
                                     optimizer=_opt())
    if family == "geo":
        return StructuredMeshRoutine(conv=models.FNOMesh2D(**GEO), loss_scale=20,
                                     optimizer=_opt())
    if family == "cno":
        return StructuredMeshRoutine(conv=models.CNOFactorizedMesh2D(**MESH), loss_scale=20,
                                     optimizer=_opt())
    if family == "mesh3d":
        return StructuredMeshRoutine(conv=models.FNOFactorizedMesh3D(**MESH_3D, remat=remat),
                                     loss_scale=20, optimizer=_opt())
    if family == "cno3d":
        return StructuredMeshRoutine(conv=models.CNOFactorizedMesh3D(**MESH_3D), loss_scale=20,
                                     optimizer=_opt())
    if family == "plus":
        return PointCloudRoutine(model=models.FNOFullyFactorizedMesh2D(
            **PLUS, iphi=models.IPhi(8)), N=IPHI_N, reg_weight=reg_weight, optimizer=_opt())
    if family == "fourier_position":
        return Grid2DRolloutRoutine(model=models.FNOZongyi2DBlock(**FOURIER_POSITION),
                                    use_fourier_position=True, optimizer=_opt())
    if family == "cloud":
        return PointCloudRoutine(model=models.FNOFactorizedPointCloud2D(
            **CLOUD, iphi=models.IPhi(8)), N=IPHI_N, reg_weight=reg_weight, optimizer=_opt())
    if family == "li":
        return LearnedInterpolatorRoutine(optimizer=_opt(), **LI)
    return MeshGraphNetRoutine(optimizer=_opt(clip=0.1), **MGN)


def _jax_routine(family):
    if family == "rollout":
        kw = {k: v for k, v in ROLLOUT.items() if k != "input_dim"}
        return JaxRollout(model=jax_models.FNOZongyi2DBlock(**kw), optimizer=_opt(True))
    if family == "mesh":
        return JaxMesh(model=jax_models.FNOFactorizedMesh2D(**MESH), loss_scale=20,
                       optimizer=_opt(True))
    if family == "geo":
        return JaxMesh(model=jax_models.FNOMesh2D(**GEO), loss_scale=20, optimizer=_opt(True))
    if family == "cno":
        return JaxMesh(model=jax_models.CNOFactorizedMesh2D(**MESH), loss_scale=20,
                       optimizer=_opt(True))
    if family == "cloud":
        return JaxCloud(model=jax_models.FNOFactorizedPointCloud2D(
            **CLOUD, iphi=jax_models.IPhi(width=8)), N=IPHI_N, optimizer=_opt(True))
    if family in ("mesh3d", "cno3d"):
        model = (jax_models.FNOFactorizedMesh3D if family == "mesh3d" else
                 jax_models.CNOFactorizedMesh3D)(**MESH_3D)
        return JaxMesh(model=model, loss_scale=20, optimizer=_opt(True))
    if family == "plus":
        return JaxCloud(model=jax_models.FNOFullyFactorizedMesh2D(
            **PLUS, iphi=jax_models.IPhi(width=8)), N=IPHI_N, optimizer=_opt(True))
    if family == "li":
        return JaxLI(optimizer=_opt(True), **LI)
    return JaxMGN(optimizer=_opt(True, clip=0.1), **MGN)


CONVERT = {"rollout": zongyi_state_dict_from_flax,
           "mesh": lambda p: mesh_state_dict_from_flax(p, MESH["n_layers"]),
           "cloud": lambda p: point_cloud_state_dict_from_flax(p, CLOUD["n_layers"]),
           "li": learned_interpolation_state_dict_from_flax,
           "mgn": meshgraphnet_state_dict_from_flax,
           "geo": geo_state_dict_from_flax,
           "cno": lambda p: cno_state_dict_from_flax(p, MESH["n_layers"]),
           "mesh3d": lambda p: mesh_state_dict_from_flax(p, MESH_3D["n_layers"]),
           "cno3d": lambda p: cno_state_dict_from_flax(p, MESH_3D["n_layers"]),
           "plus": lambda p: point_cloud_state_dict_from_flax(p, PLUS["n_layers"])}


# --- the batches -------------------------------------------------------------------------
def _li_velocity(b, seed):
    """Smooth periodic velocities ``([b, 32, 32], [b, 32, 32])``: a few low
    Fourier modes of random phase, speeds of a few units (numpy only, so
    that the world's ranks make them without JAX)."""
    rng = np.random.RandomState(seed)
    x = 2 * np.pi * np.arange(32) / 32
    xx, yy = np.meshgrid(x, x, indexing="ij")
    out = []
    for _ in range(2):
        field = np.zeros((b, 32, 32))
        for kx, ky in ((1, 0), (0, 1), (1, 1), (2, 1), (1, 3)):
            amp, phase = rng.randn(b, 1, 1), rng.rand(b, 1, 1) * 2 * np.pi
            field += 2.0 * amp * np.sin(kx * xx + ky * yy + phase) / np.hypot(kx, ky)
        out.append(field.astype(np.float32))
    return tuple(out)


def _mgn_batch(nodes, seed, t_len=None):
    """Padded samples of ``nodes`` valid nodes each (of 9; cells 7): NaN node
    arrays and -1 cells and types where padded; with ``t_len`` the
    velocities have a time axis."""
    rng = np.random.RandomState(seed)
    b, n_max, c_max = len(nodes), 9, 7
    shape = (b, n_max, 2) if t_len is None else (b, t_len, n_max, 2)
    batch = {"cells": np.full((b, c_max, 3), -1, np.int32),
             "mesh_pos": np.full((b, n_max, 2), np.nan, np.float32),
             "node_type": np.full((b, n_max), -1, np.int32),
             "velocity": np.full(shape, np.nan, np.float32),
             "target_velocity": np.full(shape, np.nan, np.float32)}
    for i, n in enumerate(nodes):
        c = n - 2
        cells = np.stack([rng.permutation(n)[:3] for _ in range(c)]).astype(np.int32)
        cells[: n // 3] = np.arange(n // 3 * 3).reshape(-1, 3)
        batch["cells"][i, :c] = cells
        batch["mesh_pos"][i, :n] = rng.rand(n, 2)
        batch["node_type"][i, :n] = rng.randint(0, 7, n)
        vel = rng.randn(*(shape[1:-2] + (n, 2))).astype(np.float32)
        batch["velocity"][i, ..., :n, :] = vel
        batch["target_velocity"][i, ..., :n, :] = vel + 0.3 * rng.randn(*vel.shape)
    return batch


def _batch(family, b, seed=0):
    """A train batch of ``b`` samples of the family."""
    rng = np.random.RandomState(seed)
    if family in ("rollout", "fourier_position"):
        return {"x": rng.randn(b, 16, 16, 5).astype(np.float32),
                "y": rng.randn(b, 16, 16, 3).astype(np.float32)}
    if family in ("mesh", "geo", "cno"):
        return {"x": rng.randn(b, *GRID_2D, 2).astype(np.float32),
                "y": rng.randn(b, *GRID_2D).astype(np.float32)}
    if family in ("mesh3d", "cno3d"):
        return {"x": rng.randn(b, *GRID_3D, 1).astype(np.float32),
                "y": rng.randn(b, *GRID_3D, 4).astype(np.float32)}
    if family in ("cloud", "plus"):
        return {"xy": rng.rand(b, 40, 2).astype(np.float32),
                "rr": rng.randn(b, 42).astype(np.float32),
                "sigma": rng.randn(b, 40, 1).astype(np.float32)}
    if family == "li":
        u, v = _li_velocity(b, seed)
        noise = lambda a: (a[..., None] + 0.1 * rng.randn(*a.shape, 2)).astype(np.float32)
        return ({"vx": u, "vy": v}, {"vx": noise(u), "vy": noise(v)})
    return _mgn_batch(MGN_NODES[:b] if b <= 4 else MGN_NODES * 2, seed)


def _valid_batch(family, seed=1):
    """A validation batch of 4."""
    if family == "li":
        (inputs, _), rng = _batch("li", 4, seed), np.random.RandomState(seed)
        return {"vx": inputs["vx"], "vy": inputs["vy"],
                "targets": rng.randn(4, 32, 32, 2).astype(np.float32),
                "times": np.tile(np.array([1.0, 2.0], np.float32), (4, 1))}
    if family == "mgn":
        return _mgn_batch(MGN_NODES, seed, t_len=4)
    return _batch(family, 4, seed)


# --- the fits' files ----------------------------------------------------------------------
def _write_files(root):
    rng = np.random.RandomState(11)
    t = np.arange(6)[None, None, None, :]
    np.save(os.path.join(root, "ns.npy"), (rng.randn(12, 16, 16, 1) + 0.1 * t
                                           * rng.randn(12, 16, 16, 1)).astype(np.float32))
    for name, shape in (("X", (16, *GRID_2D)), ("Y", (16, *GRID_2D)), ("Q", (16, 5, *GRID_2D))):
        np.save(os.path.join(root, f"mesh_{name}.npy"), rng.randn(*shape))
    for name, shape in (("rr", (42, 16)), ("sigma", (40, 16)), ("XY", (40, 2, 16))):
        np.save(os.path.join(root, f"cloud_{name}.npy"), rng.rand(*shape))
    u, v = _li_velocity(4, 5)
    with h5py.File(os.path.join(root, "li_train.h5"), "w") as f:
        f["vx"] = (u[:2, None] + 0.01 * rng.randn(2, 6, 32, 32)).astype(np.float32)
        f["vy"] = (v[:2, None] + 0.01 * rng.randn(2, 6, 32, 32)).astype(np.float32)
    with h5py.File(os.path.join(root, "li_init.h5"), "w") as f:
        f["vx"], f["vy"] = u, v
    with h5py.File(os.path.join(root, "li_corr.h5"), "w") as f:
        f["vorticity"] = rng.randn(4, 4, 32, 32).astype(np.float32)
        f["time"] = np.arange(1, 5, dtype=np.float32)
    train, valid = _mgn_batch(MGN_NODES[:2], 6, t_len=4), _mgn_batch(MGN_NODES, 7, t_len=4)
    arrays = {f"{split}/{k}": v for split, b in (("train", train), ("valid", valid),
                                                 ("test", valid)) for k, v in b.items()}
    with H5Writer(os.path.join(root, "mgn.h5"), {k: (v.shape, v.dtype)
                                                 for k, v in arrays.items()}) as w:
        for k, v in arrays.items():
            w.write(k, 0, v)
    data = os.path.join(root, "data")
    naca = os.path.join(data, "geo-fno", "airfoil", "naca")
    os.makedirs(naca)
    for name, shape in (("X", (16, *GRID_2D)), ("Y", (16, *GRID_2D)), ("Q", (16, 5, *GRID_2D))):
        np.save(os.path.join(naca, f"NACA_Cylinder_{name}.npy"), rng.randn(*shape))
    scipy.io.savemat(os.path.join(root, "plas.mat"), {"input": rng.randn(16, GRID_3D[0]),
                                                      "output": rng.randn(16, *GRID_3D, 4)})


def _builder(family, root):
    p = lambda name: os.path.join(root, name)
    if family == "rollout":
        return NSZongyiBuilder(p("ns.npy"), train_size=8, test_size=4, n_steps=3, batch_size=4)
    if family == "mesh":
        return StructuredMesh2DBuilder(p("mesh_X.npy"), p("mesh_Y.npy"), p("mesh_Q.npy"),
                                       output_dim=4, train_size=8, valid_size=4, test_size=4,
                                       batch_size=4)
    if family in ("mesh3d", "cno3d"):
        return PlasticityBuilder(p("plas.mat"), train_size=8, valid_size=4, test_size=4,
                                 s1=GRID_3D[0], s2=GRID_3D[1], t=GRID_3D[2], batch_size=4)
    if family in ("cloud", "plus"):
        return ElasticityBuilder(p("cloud_sigma.npy"), p("cloud_XY.npy"), p("cloud_rr.npy"),
                                 train_size=8, valid_size=4, test_size=4, batch_size=4)
    if family == "li":
        traj = dict(init_path=p("li_init.h5"), corr_path=p("li_corr.h5"), k=1, inner_steps=1,
                    outer_steps=2)
        return kol.KolmogorovBuilder(kol.KolmogorovVelocityDataset(p("li_train.h5"), k=1,
                                                                   unroll_length=2),
                                     kol.KolmogorovVelocityTrajectoryDataset(**traj),
                                     kol.KolmogorovVelocityTrajectoryDataset(**traj),
                                     batch_size=4)
    return CylinderFlowBuilder(p("mgn.h5"), batch_size=4)


# Registry overrides of the train command's run: airfoil shrunk, 8 / 4 / 4 samples, batch 4.
AIRFOIL = ["builder.train_size=8", "builder.valid_size=4", "builder.test_size=4",
           "builder.batch_size=4", "routine.model.n_layers=2", "routine.model.width=8",
           "routine.model.modes_x=5", "routine.model.modes_y=4", "trainer.max_epochs=2"]


# --- the world's cases ---------------------------------------------------------------------
def _loaded(family, weights, reg_weight=0.0, remat=False):
    routine = _port_routine(family, reg_weight, remat)
    batch = _batch(family, 4)
    state = routine.init(0, batch, "cpu")
    state.model.load_state_dict(weights[family])
    return routine, state


def _steps(routine, state, batch, gens=(None, None)):
    """The first step's gradients, the two steps' losses and the parameters
    after them; on a ``model`` axis the split ones gathered whole."""
    _, grads = _loss_and_grads(routine, state, batch, gens[0])
    tp = mesh_axis(state.mesh, "model")
    grads = [all_gather(g, tp, p.tp_dim) if getattr(p, "tp_dim", None) is not None else g
             for p, g in zip(state.model.parameters(), grads, strict=True)]
    losses = []
    for gen in gens:
        state, metrics = routine.train_step(state, batch, gen)
        losses.append(float(metrics["train_loss"]))
    names = [n for n, _ in state.model.named_parameters()]
    whole = gather_state(state).model
    return {"losses": losses,
            "grads": {n: g.detach().clone() for n, g in zip(names, grads, strict=True)},
            "params": {k: v.detach().clone() for k, v in whole.state_dict().items()}}


def _loss_and_grads(routine, state, batch, gen=None):
    out = routine.loss_and_grads(state, batch, gen)
    if isinstance(routine, PointCloudRoutine):
        return out[0], out[2]
    return out[0], out[1]


def _case_steps(root, rank):
    weights = torch.load(os.path.join(root, "weights.pt"))
    mesh = make_mesh()
    out = {}
    for family in FAMILIES:
        for layout, b in (("split", 4), ("replicated", 2)):
            routine, state = _loaded(family, weights)
            state = shard_state(state, mesh)
            out[(family, layout)] = _steps(routine, state, shard_batch(_batch(family, b), mesh))
        routine, state = _loaded(family, weights)
        state = shard_state(state, mesh)
        metrics = routine.valid_step(state, shard_batch(_valid_batch(family), mesh))
        out[(family, "valid")] = {k: np.asarray(v) for k, v in metrics.items()}
    routine, state = _loaded("cloud", weights, reg_weight=0.5)
    gens = [step_generator(0, s, "cpu") for s in (1, 2)]
    out[("cloud", "iphi")] = _steps(routine, shard_state(state, mesh),
                                    shard_batch(_batch("cloud", 4), mesh), gens)
    return out


class _NoSplitForm(torch.nn.Module):
    """A stand-in model with a leaf that JAX's ``_tp_spec`` splits (a rank-4
    ``fourier_weight``) and no ``set_parallel``."""

    def __init__(self):
        super().__init__()
        self.fourier_weight = torch.nn.Parameter(torch.zeros(8, 8, 3, 2))

    def reset_parameters(self, generator=None):
        pass

    def forward(self, x, **kwargs):
        return x


def _case_raises(root, rank):
    out = {}
    mesh = make_sp_mesh(2)
    for family in FAMILIES:
        try:
            Trainer(mesh=mesh, device="cpu").fit(_port_routine(family), None)
            out[(family, "spatial")] = None
        except NotImplementedError as err:
            out[(family, "spatial")] = str(err)
    # A model with a leaf that JAX splits and no split form.
    routine = StructuredMeshRoutine(conv=_NoSplitForm(), optimizer=_opt())
    try:
        shard_state(routine.init(0, None, "cpu"), make_tp_mesh(2))
        out["unsplit_model"] = None
    except NotImplementedError as err:
        out["unsplit_model"] = str(err)
    return out


def _case_tensor(root, rank):
    """(a'), (d'), (e') and the split parameters on ``{data 2, model 2}``;
    the mesh F-FNOs on ``{data 1, model 4}``; Geo-FNO-4 on ``model`` 2; the 3D
    mesh F-FNO under remat on ``model`` 2."""
    weights = torch.load(os.path.join(root, "weights.pt"))
    mesh = make_tp_mesh(2)
    out = {"specs": {}, "split": {}}
    for family in TENSOR_FAMILIES:
        routine, state = _loaded(family, weights)
        out["specs"][family] = tp_param_specs(state.model, mesh)
        state = shard_state(state, mesh)
        out["split"][family] = {k: tuple(p.shape) for k, p in state.model.named_parameters()
                                if k in split_dims(state.model)}
        out[(family, "split")] = _steps(routine, state, shard_batch(_batch(family, 4), mesh))
        routine, state = _loaded(family, weights)
        metrics = routine.valid_step(shard_state(state, mesh),
                                     shard_batch(_valid_batch(family), mesh))
        out[(family, "valid")] = {k: np.asarray(v) for k, v in metrics.items()}
    routine, state = _loaded("cloud", weights, reg_weight=0.5)
    gens = [step_generator(0, s, "cpu") for s in (1, 2)]
    out[("cloud", "iphi")] = _steps(routine, shard_state(state, mesh),
                                    shard_batch(_batch("cloud", 4), mesh), gens)
    for family in ("geo", "cno"):
        routine, state = _loaded(family, weights)
        out["specs"][family] = tp_param_specs(state.model, mesh)
        state = shard_state(state, mesh)
        out["split"][family] = split_dims(state.model)
        out[(family, "split")] = _steps(routine, state, shard_batch(_batch(family, 4), mesh))
    routine = _port_routine("fourier_position")  # the port's own initial weights, from seed 0
    state = shard_state(routine.init(0, _batch("fourier_position", 4), "cpu"), mesh)
    out["split"]["fourier_position"] = split_dims(state.model)
    out[("fourier_position", "split")] = _steps(routine, state,
                                                shard_batch(_batch("fourier_position", 4), mesh))
    routine, state = _loaded("mesh3d", weights, remat=True)
    out[("mesh3d", "remat")] = _steps(routine, shard_state(state, mesh),
                                      shard_batch(_batch("mesh3d", 4), mesh))
    mesh4 = make_tp_mesh(4)
    for family in ("mesh", "mesh3d"):
        routine, state = _loaded(family, weights)
        state = shard_state(state, mesh4)
        out["split"][f"{family}_model4"] = {k: tuple(p.shape)
                                            for k, p in state.model.named_parameters()
                                            if k in split_dims(state.model)}
        out[(family, "model4")] = _steps(routine, state, shard_batch(_batch(family, 4), mesh4))
    mesh1 = make_tp_mesh(1, n_devices=1)  # {data 1, model 1} of rank 0; the others drop out
    if rank == 0:  # and the same steps with no mesh in this process (its threads' sums)
        for family in TENSOR_FAMILIES:
            routine, state = _loaded(family, weights)
            out[(family, "one")] = _steps(routine, shard_state(state, mesh1),
                                          shard_batch(_batch(family, 4), mesh1))
            routine, state = _loaded(family, weights)
            out[(family, "none")] = _steps(routine, state, _batch(family, 4))
    for family in TENSOR_FAMILIES:
        trainer = build_trainer({"max_epochs": 2, "tensor_parallel": 2}, device="cpu")
        trainer.fit(_port_routine(family), _builder(family, root))
        out[(family, "fit")] = {"mesh": mesh_shape(trainer.mesh),
                                "train_loss": trainer.logs["train_loss"],
                                "valid_loss": trainer.logs["valid_loss"],
                                "global_step": trainer.global_step}
    return out


def _case_train_tensor(root, rank):
    """``train`` of the shrunk airfoil on ``{data 2, model 2}``, then
    ``--resume`` from rank 0's ``last.ckpt``."""
    os.environ["DATA_ROOT"] = os.path.join(root, "data")
    run = os.path.join(root, "run_tp")
    over = AIRFOIL + ["trainer.tensor_parallel=2"]
    out = {}
    for name, resume in (("first", False), ("resumed", True)):
        trainer, state = train.main("airfoil/ffno/24_layers", over, config_dir=run, device="cpu",
                                    resume=resume)
        w = state.model.spectral_layers[0].fourier_weight[0]
        out[name] = {"mesh": mesh_shape(trainer.mesh), "test_loss": trainer.logs["test_loss"],
                     "train_loss": trainer.logs["train_loss"],
                     "global_step": trainer.global_step, "local_weight": tuple(w.shape),
                     "tp_dim": getattr(w, "tp_dim", None)}
    return out


def _case_fits(root, rank):
    out = {}
    for family in FAMILIES:
        trainer = build_trainer({"max_epochs": 2}, device="cpu")
        trainer.fit(_port_routine(family), _builder(family, root))
        out[family] = {"mesh": dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape)),
                       "train_loss": trainer.logs["train_loss"],
                       "valid_loss": trainer.logs["valid_loss"],
                       "global_step": trainer.global_step}
    return out


def _case_train_command(root, rank):
    os.environ["DATA_ROOT"] = os.path.join(root, "data")
    trainer, _ = train.main("airfoil/ffno/24_layers", AIRFOIL,
                            config_dir=os.path.join(root, "run"), device="cpu")
    return {"test_loss": trainer.logs["test_loss"], "global_step": trainer.global_step}


CASES = {"steps": _case_steps, "raises": _case_raises, "fits": _case_fits,
         "train": _case_train_command, "tensor": _case_tensor, "train_tp": _case_train_tensor}


def _worker(rank, root):
    torch.set_num_threads(1)
    try:
        init_distributed("cpu", f"file://{os.path.join(root, 'store')}", rank, WORLD)
        out = {name: case(root, rank) for name, case in CASES.items()}
    except BaseException:
        # Every rank's own traceback: the world reports only the first rank that exited.
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# --- the JAX side and the world ------------------------------------------------------------
def _jax_init(family, jr):
    """JAX's initial state; the learned interpolation's out layer (zero at
    init, which would leave the other layers without gradients) drawn from
    a normal."""
    js = jr.init(jax.random.PRNGKey(0), _batch(family, 4))
    if family != "li":
        return js
    params = jax.tree.map(np.asarray, js.params)
    out = params["params"]["coeff_net"]["out"]
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    out["kernel"] = np.asarray(0.05 * jax.random.normal(k1, out["kernel"].shape))
    out["bias"] = np.asarray(0.05 * jax.random.normal(k2, out["bias"].shape))
    params = jax.tree.map(jnp.asarray, params)
    return js.replace(params=params, opt_state=jr.optimizer.init(params))


def _jax_grads(jr, state, batch):
    """JAX's gradients of one train step (the routine's own ``train_step``,
    its update replaced by handing the gradients back as the parameters)."""
    grads_of = copy.copy(jr)
    grads_of.apply_grads = lambda s, grads: s.replace(params=grads)
    return jax.jit(grads_of.train_step)(state, batch, None)[0].params


def _jax_split_dims(family, params):
    """``{port name: dim}`` of the leaves that JAX's ``tp_state_shardings``
    splits on ``model`` 2: each leaf marked along its split dim, mapped
    through ``CONVERT``, and the dim along which a port tensor varies."""
    params = jax.tree.map(np.asarray, params)
    shardings = tp_state_shardings(params, jax_make_tp_mesh(2))
    leaves, tree = jax.tree_util.tree_flatten(params)
    marked = []
    for leaf, sharding in zip(leaves, jax.tree.leaves(shardings), strict=True):
        shape, spec = np.shape(leaf), tuple(sharding.spec)
        mark = np.zeros(shape, np.float32)
        if "model" in spec:
            d = spec.index("model")
            mark = mark + np.arange(shape[d], dtype=np.float32).reshape(
                [-1 if i == d else 1 for i in range(len(shape))])
        marked.append(mark)
    dims = {}
    for name, t in CONVERT[family](jax.tree_util.tree_unflatten(tree, marked)).items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1 and
                   not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        if varying:
            dims[name] = varying[0]
    return dims


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results (a list by rank), the directory, and JAX's
    steps of each family: losses, first gradients and parameters after
    two steps, as the port's state dicts."""
    root = str(tmp_path_factory.mktemp("world"))
    _write_files(root)
    jax_states = {}
    for family in JAX_FAMILIES:
        jr = _jax_routine(family)
        jax_states[family] = (jr, _jax_init(family, jr))
    torch.save({f: CONVERT[f](jax.tree.map(np.asarray, s.params))
                for f, (_, s) in jax_states.items()}, os.path.join(root, "weights.pt"))
    procs = mp.start_processes(_worker, args=(root,), nprocs=WORLD, start_method="spawn",
                               join=False)
    steps, specs = {}, {}
    for family, (jr, s0) in jax_states.items():
        specs[family] = _jax_split_dims(family, s0.params)
        batch = jax.tree.map(jnp.asarray, _batch(family, 4))
        step = jax.jit(jr.train_step)
        s1, m1 = step(s0, batch, None)
        s2, m2 = step(s1, batch, None)
        to_port = lambda tree: CONVERT[family](jax.tree.map(np.asarray, tree))
        steps[family] = {"losses": [float(m1["train_loss"]), float(m2["train_loss"])],
                         "grads": to_port(_jax_grads(jr, s0, batch)), "params": to_port(s2.params)}
    try:
        while not procs.join():
            pass
    except mp.ProcessRaisedException as err:
        tracebacks = []
        for path in sorted(glob.glob(os.path.join(root, "rank*.err"))):
            with open(path) as f:
                tracebacks.append(f"{os.path.basename(path)}:\n{f.read()}")
        raise RuntimeError("the world's ranks failed:\n" + "\n".join(tracebacks)) from err
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:  # written by the world above
            ranks.append(pickle.load(f))
    return ranks, root, steps, specs


def _one_process(root, family, b=4, reg_weight=0.0, gens=(None, None)):
    """The port's steps in this process, from the world's weights."""
    weights = torch.load(os.path.join(root, "weights.pt"))
    routine, state = _loaded(family, weights, reg_weight)
    return _steps(routine, state, _batch(family, b), gens)


def _assert_steps(got, want, what):
    """Losses rtol 1e-5, first gradients within GRAD_RTOL of each tensor's
    largest value, parameters after two steps rtol 1e-4, atol 1e-6."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, err_msg=what)
    assert set(got["grads"]) == set(want["grads"]), what
    for name, w in want["grads"].items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got["grads"][name]), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=f"{what}: {name}")
    assert set(got["params"]) == set(want["params"]), what
    for name, w in want["params"].items():
        np.testing.assert_allclose(np.asarray(got["params"][name]), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{what}: {name}")


# --- (a) split steps against JAX ----------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_data_mesh_steps_match_jax(world, family):
    for rank, r in enumerate(world[0]):
        _assert_steps(r["steps"][(family, "split")], world[2][family], f"rank {rank}")
    # The second step's update is compared: it moved every parameter.
    start = torch.load(os.path.join(world[1], "weights.pt"))[family]
    moved = [not torch.equal(world[0][0]["steps"][(family, "split")]["params"][k], v)
             for k, v in start.items()]
    assert all(moved), [k for k, m in zip(start, moved) if not m]


def test_meshgraphnet_ranks_hold_uneven_valid_nodes_and_the_clip_acts(world):
    batch = _batch("mgn", 4)
    valid = (~np.isnan(batch["target_velocity"] - batch["velocity"])).any(-1).sum(-1)
    assert list(valid) == list(MGN_NODES)
    grads = world[2]["mgn"]["grads"]
    norm = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum() for g in grads.values()))
    assert norm == pytest.approx(MGN["clip_val"], rel=1e-4)  # clipped down to 0.1


# --- (b) replicated batches against the port's one-process steps --------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_replicated_batch_steps_match_one_process(world, family):
    want = _one_process(world[1], family, b=2)
    for rank, r in enumerate(world[0]):
        _assert_steps(r["steps"][(family, "replicated")], want, f"rank {rank}")


# --- (c) the IPhi draws -------------------------------------------------------------------
def test_iphi_draws_match_one_process(world):
    gens = [step_generator(0, s, "cpu") for s in (1, 2)]
    want = _one_process(world[1], "cloud", reg_weight=0.5, gens=gens)
    for rank, r in enumerate(world[0]):
        _assert_steps(r["steps"][("cloud", "iphi")], want, f"rank {rank}")
    weights = torch.load(os.path.join(world[1], "weights.pt"))
    routine, state = _loaded("cloud", weights, reg_weight=0.5)
    _, loss_reg, _ = routine.loss_and_grads(state, _batch("cloud", 4), step_generator(0, 1, "cpu"))
    assert float(loss_reg) > 0


# --- (d) validation -----------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_valid_step_on_the_mesh_matches_one_process(world, family):
    weights = torch.load(os.path.join(world[1], "weights.pt"))
    routine, state = _loaded(family, weights)
    want = {k: np.asarray(v) for k, v in routine.valid_step(state, _valid_batch(family)).items()}
    for rank, r in enumerate(world[0]):
        got = r["steps"][(family, "valid")]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=f"rank {rank}: {k}")
    if "weight" in want:
        assert float(want["weight"]) == 4


# --- (e) whole fits -----------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_data_mesh_fit_matches_one_process(world, family):
    got = world[0][0]["fits"][family]
    trainer = Trainer(max_epochs=2, device="cpu")
    trainer.fit(_port_routine(family), _builder(family, world[1]))
    assert got["mesh"] == {"data": WORLD}
    assert got["global_step"] == trainer.global_step > 0
    np.testing.assert_allclose(got["train_loss"], trainer.logs["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["valid_loss"], trainer.logs["valid_loss"], rtol=1e-3)
    for r in world[0][1:]:  # every rank logged the same
        assert r["fits"][family]["train_loss"] == got["train_loss"]


# --- (f) the train command ----------------------------------------------------------------
def test_train_command_on_the_ranks_writes_rank0s_run(world):
    runs = glob.glob(os.path.join(world[1], "run", "checkpoints", "trial-0-*"))
    assert len(runs) == 1
    assert os.path.exists(os.path.join(runs[0], "last.ckpt"))
    with open(os.path.join(runs[0], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert np.isfinite(rows[0]["train_loss"]) and rows[-1]["test_loss"] > 0
    got = [r["train"] for r in world[0]]
    assert all(g == got[0] for g in got) and got[0]["global_step"] == 4
    assert rows[-1]["test_loss"] == pytest.approx(got[0]["test_loss"], rel=1e-6)


# --- (a') data x model against JAX --------------------------------------------------------
# The families whose models JAX splits.
SPLIT_FAMILIES = ("rollout", "mesh", "cloud") + MESH_3D_AND_PLUS


@pytest.mark.parametrize("family", TENSOR_FAMILIES)
def test_model_mesh_steps_match_jax(world, family):
    for rank, r in enumerate(world[0]):
        _assert_steps(r["tensor"][(family, "split")], world[2][family], f"rank {rank}")
    split = world[0][0]["tensor"]["split"][family]
    assert bool(split) == (family in SPLIT_FAMILIES), split


@pytest.mark.parametrize("family", TENSOR_FAMILIES)
def test_model_mesh_of_one_rank_equals_one_process_to_the_bit(world, family):
    got, want = (world[0][0]["tensor"][(family, layout)] for layout in ("one", "none"))
    assert got["losses"] == want["losses"]
    for key in ("grads", "params"):
        assert set(got[key]) == set(want[key])
        unequal = [k for k, v in want[key].items() if not torch.equal(got[key][k], v)]
        assert not unequal, (key, unequal)


@pytest.mark.parametrize("case", [(f, "split") for f in TENSOR_FAMILIES] + [
    ("cloud", "iphi"), ("mesh3d", "remat")], ids=lambda c: "-".join(c))
def test_model_ranks_of_a_data_row_hold_the_same_parameters(world, case):
    for row in (world[0][:2], world[0][2:]):  # make_tp_mesh(2): data rows (0, 1) and (2, 3)
        a, b = (r["tensor"][case]["params"] for r in row)
        assert set(a) == set(b)
        unequal = [k for k in a if not torch.equal(a[k], b[k])]
        assert not unequal, unequal


def test_model_mesh_iphi_draws_match_one_process(world):
    gens = [step_generator(0, s, "cpu") for s in (1, 2)]
    want = _one_process(world[1], "cloud", reg_weight=0.5, gens=gens)
    for rank, r in enumerate(world[0]):
        _assert_steps(r["tensor"][("cloud", "iphi")], want, f"rank {rank}")


@pytest.mark.parametrize("family,modes,width", [("mesh", MESH["modes_x"], MESH["width"]),
                                                 ("mesh3d", MESH_3D["modes_x"], MESH_3D["width"])])
def test_mesh_ffno_on_model_4_matches_jax(world, family, modes, width):
    split = world[0][0]["tensor"]["split"][f"{family}_model4"]
    assert split["spectral_layers.0.fourier_weight.0"] == (width, width // 4, modes, 2)
    assert split["spectral_layers.0.backcast_ff.layers.0.0.weight_v"] == (width, width)
    for rank, r in enumerate(world[0]):
        _assert_steps(r["tensor"][(family, "model4")], world[2][family], f"rank {rank}")


def test_mesh_3d_ffno_under_remat_equals_the_eager_split_step_to_the_bit(world):
    """The collectives run inside the checkpointed layer: the remat step on
    ``model`` 2 gives every loss, gradient and parameter of the eager one."""
    for rank, r in enumerate(world[0]):
        got, want = r["tensor"][("mesh3d", "remat")], r["tensor"][("mesh3d", "split")]
        assert got["losses"] == want["losses"], rank
        for key in ("grads", "params"):
            unequal = [k for k, v in want[key].items() if not torch.equal(got[key][k], v)]
            assert not unequal, (rank, key, unequal)


def test_3d_and_fully_factorized_models_split_the_leaves_jax_splits(world):
    """The 3D FCNO splits its feed-forwards only (its DCT weights ``[C, C,
    M]`` stay whole); the 3D F-FNO its three Fourier weights too; the
    fully-factorized model every layer's Fourier weights (the NUDFT ones
    included) and feed-forwards, and no head, bias layer or IPhi leaf."""
    split = world[0][0]["tensor"]["split"]
    n = MESH_3D["n_layers"]
    # Width 8: the expansion [32, 8] split by row, the contraction [8, 32] by column.
    ffs = {f"spectral_layers.{i}.backcast_ff.layers.{j}.0.weight_v": (16, 8) if j == 0 else (8, 16)
           for i in range(n) for j in (0, 1)}
    assert split["cno3d"] == ffs
    assert split["mesh3d"] == {**ffs, **{
        f"spectral_layers.{i}.fourier_weight.{k}": (8, 4, m, 2) for i in range(n)
        for k, m in enumerate((MESH_3D["modes_x"], MESH_3D["modes_y"], MESH_3D["modes_z"]))}}
    ffs = {f"spectral_layers.{i}.backcast_ff.layers.{j}.0.weight_v": (8, 8)  # factor 2
           for i in range(PLUS["n_layers"]) for j in (0, 1)}
    assert split["plus"] == {**ffs, **{
        f"spectral_layers.{i}.fourier_weight.{k}": (8, 4, m, 2)
        for i in range(PLUS["n_layers"] + 1)
        for k, m in enumerate((PLUS["modes2"], PLUS["modes1"]))}}


def test_geo_fno_runs_whole_on_the_model_ranks_and_matches_jax(world):
    assert world[0][0]["tensor"]["split"]["geo"] == {} and world[3]["geo"] == {}
    for rank, r in enumerate(world[0]):
        _assert_steps(r["tensor"][("geo", "split")], world[2]["geo"], f"rank {rank}")


def test_mesh_cno_splits_its_feed_forwards_only_and_matches_jax(world):
    specs = world[0][0]["tensor"]["specs"]["cno"]
    got = {k: d for k, d in specs.items() if d is not None}
    assert got == world[3]["cno"] and got
    assert all("backcast_ff" in k for k in got)  # the DCT weights [C, C, M] stay whole
    assert specs["spectral_layers.0.fourier_weight.0"] is None
    for rank, r in enumerate(world[0]):
        _assert_steps(r["tensor"][("cno", "split")], world[2]["cno"], f"rank {rank}")


def test_fourier_position_rollout_on_a_model_mesh_matches_one_process(world):
    split = world[0][0]["tensor"]["split"]["fourier_position"]
    assert split and all(k.startswith("conv.") for k in split)  # in_proj stays whole
    routine = _port_routine("fourier_position")
    want = _steps(routine, routine.init(0, _batch("fourier_position", 4), "cpu"),
                  _batch("fourier_position", 4))
    for rank, r in enumerate(world[0]):
        _assert_steps(r["tensor"][("fourier_position", "split")], want, f"rank {rank}")


@pytest.mark.parametrize("family", TENSOR_FAMILIES)
def test_tp_param_specs_split_the_leaves_jax_splits(world, family):
    got = {k: d for k, d in world[0][0]["tensor"]["specs"][family].items() if d is not None}
    assert got == world[3][family]
    assert bool(got) == (family in SPLIT_FAMILIES)


# --- (d'), (e') validation and fits on data x model ---------------------------------------
@pytest.mark.parametrize("family", TENSOR_FAMILIES)
def test_model_mesh_valid_step_matches_one_process(world, family):
    weights = torch.load(os.path.join(world[1], "weights.pt"))
    routine, state = _loaded(family, weights)
    want = {k: np.asarray(v) for k, v in routine.valid_step(state, _valid_batch(family)).items()}
    for rank, r in enumerate(world[0]):
        got = r["tensor"][(family, "valid")]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=f"rank {rank}: {k}")


@pytest.mark.parametrize("family", TENSOR_FAMILIES)
def test_model_mesh_fit_matches_one_process(world, family):
    got = world[0][0]["tensor"][(family, "fit")]
    trainer = Trainer(max_epochs=2, device="cpu", fast_loop=False)  # JAX's loop on a tp mesh
    trainer.fit(_port_routine(family), _builder(family, world[1]))
    assert got["mesh"] == {"data": 2, "model": 2}
    assert got["global_step"] == trainer.global_step > 0
    np.testing.assert_allclose(got["train_loss"], trainer.logs["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["valid_loss"], trainer.logs["valid_loss"], rtol=1e-3)
    for r in world[0][1:]:  # every rank logged the same
        assert r["tensor"][(family, "fit")]["train_loss"] == got["train_loss"]


# --- (f') the train command on data x model, and --resume -------------------------------------
def test_train_command_on_a_model_mesh_checkpoints_whole_and_resumes_split(world, monkeypatch):
    got = [r["train_tp"] for r in world[0]]
    assert all(g == got[0] for g in got)
    first, resumed = got[0]["first"], got[0]["resumed"]
    assert first["mesh"] == resumed["mesh"] == {"data": 2, "model": 2}
    # Width 8 on model 2: each rank's Fourier weight is a column shard.
    assert resumed["local_weight"] == (8, 4, 5, 2) and resumed["tp_dim"] == 1
    assert first["global_step"] == resumed["global_step"] == 4
    runs = sorted(glob.glob(os.path.join(world[1], "run_tp", "checkpoints", "trial-0-*")))
    assert len(runs) == 2
    monkeypatch.setenv("DATA_ROOT", os.path.join(world[1], "data"))
    cfg = load_config("airfoil/ffno/24_layers", AIRFOIL)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    state = load_state(os.path.join(runs[0], "last.ckpt"),
                       routine.init(7231, builder.sample_batch(), "cpu"))
    assert split_dims(state.model) == {}  # rank 0 wrote the whole state
    np.testing.assert_allclose(Trainer(device="cpu").test(routine, builder, state)["test_loss"],
                               first["test_loss"], rtol=1e-5)
    trainer = Trainer(max_epochs=2, seed=7231, device="cpu", fast_loop=False)
    state = trainer.fit(routine, builder, state)
    np.testing.assert_allclose(resumed["train_loss"], trainer.logs["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(resumed["test_loss"],
                               trainer.test(routine, builder, state)["test_loss"], rtol=1e-3)


# --- (g) spatial meshes -------------------------------------------------------------------
ROUTINE_NAMES = {"rollout": "Grid2DRolloutRoutine", "mesh": "StructuredMeshRoutine",
                 "cloud": "PointCloudRoutine", "li": "LearnedInterpolatorRoutine",
                 "mgn": "MeshGraphNetRoutine"}


@pytest.mark.parametrize("axis", ["spatial"])
@pytest.mark.parametrize("family", FAMILIES)
def test_model_and_spatial_meshes_raise(world, family, axis):
    for r in world[0]:
        msg = r["raises"][(family, axis)]
        assert msg is not None and ROUTINE_NAMES[family] in msg and f"'{axis}' axis" in msg


def test_a_model_with_leaves_to_split_and_no_split_form_raises(world):
    for r in world[0]:
        msg = r["raises"]["unsplit_model"]
        assert msg is not None and "_NoSplitForm" in msg and "tensor-parallel" in msg


SPLIT_MODELS = {"FNOFactorizedMesh3D": lambda: models.FNOFactorizedMesh3D(**MESH_3D),
                "CNOFactorizedMesh3D": lambda: models.CNOFactorizedMesh3D(**MESH_3D),
                "FNOFullyFactorizedMesh2D": lambda: models.FNOFullyFactorizedMesh2D(**PLUS)}


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_split_models_have_no_spatial_form(name):
    """Each mesh or point-cloud model with a split form on ``model`` refuses
    ``spatial``, naming itself (the axis is refused before it is read).
    FNO++ has a spatial form (``tests/test_torch_parallel.py``)."""
    with pytest.raises(NotImplementedError, match=f"{name} has no spatially split form"):
        SPLIT_MODELS[name]().set_parallel(spatial=object())
