"""The port's parallel trainer (``fourierflow_tpu_torch/parallel``) against
the JAX package's meshes, on the CPU.

One ``gloo`` world of 4 processes (``torch.multiprocessing``, a
``file://`` store under ``tmp_path``, one thread a rank) runs every case
that needs ranks once, for the whole module, and writes what it found; the
JAX side runs in this process on its 8 virtual devices
(``tests/conftest.py``). What is held:

- (a) two train steps of the tiny F-FNO of ``tests/test_training.py``
  (width 16, factor 4, unshared weights, batch ``[4, 32, 32, 1]``, JAX's
  initial weights carried by ``state_dict_from_flax``) on a 2x2 ``data x
  model`` and a 2x2 ``data x spatial`` mesh, gathered, against JAX's
  unsharded ``train_step``: each step's loss within rtol 1e-5, the
  parameters after the second step within rtol 1e-4, atol 1e-6 (JAX's own
  bounds; the first step runs at the warm-up's learning rate 0, so only
  the second moves them); the first step's gradients, gathered, against
  JAX's (``jax.grad`` of the step's own loss) within GRAD_RTOL of each
  tensor's largest value, also with shared Fourier weights and per-layer
  remat, and against the port's unsplit step within 1e-5 of it; the
  spatially split ``valid_step`` loss within rtol 1e-5 of JAX's; the same
  steps and gradients at width 32 on ``{data 1, model 4}``, whose
  feed-forward slices are 32 wide (the flagship's at tp 8);
- (b) the FNO's dense Fourier weights split by output channel: the same
  two steps' losses, parameters and first gradients against JAX's; and so
  FNO++'s (``FNOPlus2DBlock``, the ``no_factorization`` ablations), with
  shared forks, backcast and forecast, on their hidden slices;
- (b') every other model the Markov routine trains, on the 2x2 ``data x
  spatial`` mesh (``SPATIAL_CASES``): FNO-4 and FNO++ (the dense
  convolution's truncated spectrum gathered over X), the grid CNO block,
  the F-FNO's low-pass and no-Fourier modes, and the F-FNO with the shuffled
  grid; the same two steps' losses, parameters and first gradients against
  JAX's unsharded steps, at (a)'s bounds; and each of them, and the full
  F-FNO, on rank 0's ``{data 1, spatial 1}`` equal to the same steps with
  no mesh in the same process, to the bit;
- (c) ``tp_param_specs`` against JAX's ``tp_state_shardings``, name for name
  (width 16 on ``model`` 2; widths 12 and 10 on ``model`` 4, the latter's
  Fourier weights replicated as the axis does not divide them), and
  ``shard_batch``'s placements against JAX's;
- (d) ``make_tp_mesh(3)`` drops one rank with the warning, ``make_tp_mesh(5)``
  raises, tensor with spatial parallelism raises, and
  ``build_trainer({"tensor_parallel": 2})`` makes ``{data 2, model 2}``;
- (e) fits through ``build_trainer``: data-parallel with the device-resident
  epoch, tensor- and spatially parallel with the per-batch loop, each
  against the same fit in one process (train loss within rtol 1e-4, valid
  loss within 1e-3, JAX's bounds); the tensor-parallel state stays split;
- (f) the checkpoint of the tensor-parallel fit (the whole state, written
  by rank 0) restored into an unsplit state gives the sharded fit's test
  logs (rtol 1e-5), and restored into a split state each rank's blocks to
  the bit;
- the collectives' round trips and the kernel-B shard shapes of the plain
  versions (a column shard's mix is the full mix's columns; its adjoint
  summed over the shards is the full adjoint).
"""

import copy
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from fourierflow_tpu.models import CNOFactorized2DBlock as JaxCNO
from fourierflow_tpu.models import FNOFactorized2DBlock as JaxBlock
from fourierflow_tpu.models import FNOPlus2DBlock as JaxPlus
from fourierflow_tpu.models import FNOZongyi2DBlock as JaxZongyi
from fourierflow_tpu.ops.spectral import spectral_mix_axis as jax_mix_axis
from fourierflow_tpu.parallel.mesh import make_sp_mesh as jax_make_sp_mesh
from fourierflow_tpu.parallel.mesh import make_tp_mesh as jax_make_tp_mesh
from fourierflow_tpu.parallel.mesh import shard_batch as jax_shard_batch
from fourierflow_tpu.parallel.mesh import tp_state_shardings
from fourierflow_tpu.routines import Grid2DMarkovRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu.schedulers import cosine_with_warmup as jax_cosine
from fourierflow_tpu_torch.builders import NSMarkovBuilder
from fourierflow_tpu_torch.commands.train import build_trainer
from fourierflow_tpu_torch.device import resolve_device
from fourierflow_tpu_torch.models import (CNOFactorized2DBlock, FNOFactorized2DBlock,
                                          FNOPlus2DBlock, FNOZongyi2DBlock)
from fourierflow_tpu_torch.ops.fused_spectral import (fused_mix_2d, fused_mix_2d_adjoint,
                                                      fused_mix_axis, fused_mix_axis_adjoint)
from fourierflow_tpu_torch.parallel import (gather_state, init_distributed, make_mesh,
                                            make_sp_mesh, make_tp_mesh, mesh_axis, mesh_shape,
                                            placement, shard_batch, shard_state, tp_param_specs)
from fourierflow_tpu_torch.parallel.collectives import (all_gather, gather, scatter, x_split,
                                                        y_split)
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.schedulers import cosine_with_warmup
from fourierflow_tpu_torch.trainers import ModelCheckpoint, Trainer
from fourierflow_tpu_torch.trainers.trainer import step_generator
from fourierflow_tpu_torch.utils.checkpoint import load_state
from fourierflow_tpu_torch.utils.weights import (cno_state_dict_from_flax,
                                                 plus_state_dict_from_flax, state_dict_from_flax,
                                                 zongyi_state_dict_from_flax)

WORLD = 4
MARKOV = dict(modes=5, width=16, input_dim=3, n_layers=2, factor=4, ff_weight_norm=True,
              share_weight=False)
# The same model with its Fourier weights shared by the layers and per-layer remat on.
SHARED_REMAT = dict(MARKOV, share_weight=True, remat=True)
ZONGYI = dict(modes1=4, modes2=4, width=16, input_dim=3, n_layers=2)
# FNO++ with both forks, shared by the layers: every feed-forward splits (hidden 32 -> 16 a rank).
PLUS = dict(modes=4, width=16, input_dim=3, n_layers=2, factor=2, ff_weight_norm=True, gain=0.1,
            share_fork=True, use_fork=True)
# Width 32 on ``{data 1, model 4}``: the feed-forward's hidden layer of 128 in slices of 32, the
# flagship's slice (256 / 8) at tensor parallelism 8.
MARKOV_W32 = dict(MARKOV, width=32)
# The grid CNO block (the FCNO) and the F-FNO's ablation modes, tiny.
CNO = dict(modes=5, width=16, input_dim=3, n_layers=2, factor=4, ff_weight_norm=True)
LOW_PASS = dict(MARKOV, mode="low-pass")
NO_FOURIER = dict(MARKOV, mode="no-fourier")
# The shuffled-grid ablation's grid (the routine's permutations of it).
SHUFFLE_GRID = 32
# The models beside the full F-FNO on data x spatial: case -> (port model, JAX model, whether
# the routine shuffles the grid, its gradient clip: FNO-4's configurations clip nothing).
SPATIAL_CASES = {
    "zongyi": (lambda: FNOZongyi2DBlock(**ZONGYI), lambda: JaxZongyi(**ZONGYI), False, None),
    "plus": (lambda: FNOPlus2DBlock(**PLUS), lambda: JaxPlus(**PLUS), False, 0.1),
    "cno": (lambda: CNOFactorized2DBlock(**CNO), lambda: JaxCNO(**CNO), False, 0.1),
    "low_pass": (lambda: FNOFactorized2DBlock(**LOW_PASS), lambda: JaxBlock(**LOW_PASS), False,
                 0.1),
    "no_fourier": (lambda: FNOFactorized2DBlock(**NO_FOURIER), lambda: JaxBlock(**NO_FOURIER),
                   False, 0.1),
    "shuffle": (lambda: FNOFactorized2DBlock(**MARKOV), lambda: JaxBlock(**MARKOV), True, 0.1),
}
# A split step's gathered gradients against JAX's: max |err| <= GRAD_RTOL * max |JAX's|, per tensor.
GRAD_RTOL = 1e-5
# The same at width 32, where the port's own one-process step is 1.6e-5 of out.1.weight_g's
# gradient from JAX's: a [1, 1] weight-norm scale whose gradient is a dot product of 128 terms
# that cancel. So the split step is held to the one-process step at GRAD_RTOL (it adds no
# error of its own) and to JAX's at the one-process step's bound (tests/test_torch_training.py).
W32_JAX_GRAD_RTOL = 1e-4
# The fits: 16 trajectories of 24 records on a 32^2 grid, batch 8.
FIT = dict(train_size=16, test_size=4, ssr=1, batch_size=8)
SPEC_MODEL = dict(modes=3, input_dim=3, n_layers=1, share_weight=True, factor=4,
                  ff_weight_norm=True)
PLACEMENT_SHAPES = {"x": (8, 16, 16, 1), "mu": (8, 3), "meta": (3,), "big": (3, 16, 16, 1),
                    "flat": (8, 4)}


# --- inputs, made in this process and read by every rank -----------------------------------------
def _step_batch():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(4, 32, 32, 1).astype(np.float32),
            "y": rng.randn(4, 32, 32, 1).astype(np.float32)}


def _valid_data():
    return np.random.RandomState(1).randn(4, 32, 32, 6).astype(np.float32)


def _port_markov(model=None, lr=1e-3, noise_std=0.0, clip=0.1, shuffle=False):
    model = model if model is not None else FNOFactorized2DBlock(**MARKOV)
    opt = make_optimizer(schedule=cosine_with_warmup(lr, 10, 500), weight_decay=1e-4,
                         clip_val=clip)
    return Grid2DMarkovRoutine(model, n_steps=4, max_accumulations=100, noise_std=noise_std,
                               shuffle_grid=shuffle, grid_size=SHUFFLE_GRID, optimizer=opt)


def _jax_markov(model, clip=0.1, shuffle=False):
    opt = jax_make_optimizer(schedule=jax_cosine(1e-3, 10, 500), weight_decay=1e-4,
                             clip_val=clip)
    return JaxRoutine(model, n_steps=4, max_accumulations=100, noise_std=0.0,
                      shuffle_grid=shuffle, grid_size=SHUFFLE_GRID, optimizer=opt)


def _port_spatial_case(case):
    make, _, shuffle, clip = SPATIAL_CASES[case]
    return _port_markov(make(), clip=clip, shuffle=shuffle)


# JAX's parameters (or gradients, the same linear map) as the port's state dict, by case.
CONVERT = {"markov": lambda p: state_dict_from_flax(p, MARKOV["n_layers"]),
           "shared": lambda p: state_dict_from_flax(p, SHARED_REMAT["n_layers"]),
           "w32": lambda p: state_dict_from_flax(p, MARKOV_W32["n_layers"]),
           "zongyi": zongyi_state_dict_from_flax,
           "plus": lambda p: plus_state_dict_from_flax(p, PLUS["n_layers"]),
           "cno": lambda p: cno_state_dict_from_flax(p, CNO["n_layers"], grid=True),
           "low_pass": lambda p: state_dict_from_flax(p, LOW_PASS["n_layers"]),
           "no_fourier": lambda p: state_dict_from_flax(p, NO_FOURIER["n_layers"]),
           "shuffle": lambda p: state_dict_from_flax(p, MARKOV["n_layers"])}


def _fit_builder(root):
    return NSMarkovBuilder(os.path.join(root, "traj.npy"), **FIT)


def _fit_routine():
    return _port_markov(lr=3e-3, noise_std=0.01)


# --- the world's cases -------------------------------------------------------------------------
def _gathered_grads(state, grads):
    """Each gradient of a split parameter gathered whole (its name: tensor)."""
    tp = mesh_axis(state.mesh, "model")
    out = {}
    for (name, p), g in zip(state.model.named_parameters(), grads, strict=True):
        dim = getattr(p, "tp_dim", None)
        out[name] = (all_gather(g, tp, dim) if dim is not None else g).detach().clone()
    return out


def _split_step(routine, weights, mesh, batch, spatial):
    """One accumulate and two train steps on ``mesh`` (None: no mesh) from
    ``weights``: the steps' losses, the gathered parameters after them and
    the gathered gradients of the first."""
    state = routine.init(0, batch, "cpu")
    state.model.load_state_dict(weights)
    local = batch
    if mesh is not None:
        state = shard_state(state, mesh)
        local = shard_batch(batch, mesh, "data", "spatial" if spatial else None)
    state = routine.accumulate_step(state, local)
    _, grads, _ = routine.loss_and_grads(state, local, step_generator(0, 1, "cpu"))
    grads = _gathered_grads(state, grads)
    losses = []
    for step in range(2):
        state, metrics = routine.train_step(state, local, step_generator(0, step + 1, "cpu"))
        losses.append(float(metrics["train_loss"]))
    whole = gather_state(state)
    params = {k: v.detach().clone() for k, v in whole.model.state_dict().items()}
    return state, {"losses": losses, "params": params, "grads": grads}


def _case_steps(root, rank):
    inputs = torch.load(os.path.join(root, "inputs.pt"))
    batch = _step_batch()
    out = {}
    for name, mesh, spatial in (("tp", make_tp_mesh(2), False), ("sp", make_sp_mesh(2), True)):
        state, out[name] = _split_step(_port_markov(), inputs["markov"], mesh, batch, spatial)
        if spatial:
            valid = shard_batch({"data": _valid_data()}, mesh, None, "spatial")
            out[name]["valid_loss"] = float(_port_markov().valid_step(state, valid)["loss"])
    for name, mesh, spatial in (("tp_shared_remat", make_tp_mesh(2), False),
                                ("sp_shared_remat", make_sp_mesh(2), True)):
        routine = _port_markov(FNOFactorized2DBlock(**SHARED_REMAT))
        _, out[name] = _split_step(routine, inputs["shared"], mesh, batch, spatial)
    _, out["tp4_w32"] = _split_step(_port_markov(FNOFactorized2DBlock(**MARKOV_W32)),
                                    inputs["w32"], make_tp_mesh(4), batch, False)
    zongyi = _port_markov(FNOZongyi2DBlock(**ZONGYI), clip=None)
    state, out["zongyi"] = _split_step(zongyi, inputs["zongyi"], make_tp_mesh(2), batch, False)
    out["zongyi"]["n_split"] = sum(getattr(p, "tp_dim", None) is not None
                                   for p in state.model.parameters())
    state, out["plus"] = _split_step(_port_markov(FNOPlus2DBlock(**PLUS)), inputs["plus"],
                                     make_tp_mesh(2), batch, False)
    out["plus"]["split"] = {n: tuple(p.shape) for n, p in state.model.named_parameters()
                            if getattr(p, "tp_dim", None) is not None}
    sp2 = make_sp_mesh(2)
    for case in SPATIAL_CASES:
        _, out[f"sp_{case}"] = _split_step(_port_spatial_case(case), inputs[case], sp2, batch, True)
    # {data 1, spatial 1} of rank 0 (the others drop out) against no mesh, in one process.
    sp1 = make_sp_mesh(1, n_devices=1)
    if rank == 0:
        for case in ("markov",) + tuple(SPATIAL_CASES):
            routine = lambda: _port_markov() if case == "markov" else _port_spatial_case(case)
            for layout, mesh in (("one", sp1), ("none", None)):
                _, out[(case, layout)] = _split_step(routine(), inputs[case], mesh, batch, True)
    return out


def _case_specs(root, rank):
    out = {"w16": tp_param_specs(FNOFactorized2DBlock(**MARKOV), make_tp_mesh(2)),
           "zongyi": tp_param_specs(FNOZongyi2DBlock(**ZONGYI), make_tp_mesh(2)),
           "plus": tp_param_specs(FNOPlus2DBlock(**PLUS), make_tp_mesh(2))}
    mesh4 = make_tp_mesh(4)
    for width in (12, 10):
        out[f"w{width}"] = tp_param_specs(FNOFactorized2DBlock(width=width, **SPEC_MODEL), mesh4)
    sp = make_sp_mesh(2)
    out["placements"] = {k: placement(s, sp, "data", "spatial")
                         for k, s in PLACEMENT_SHAPES.items()}
    local = shard_batch({k: np.zeros(s, np.float32) for k, s in PLACEMENT_SHAPES.items()}, sp,
                        "data", "spatial")
    out["local_shapes"] = {k: tuple(v.shape) for k, v in local.items()}
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _case_meshes(root, rank):
    records = _Records()
    logging.getLogger("fourierflow_tpu_torch.parallel.mesh").addHandler(records)
    mesh3 = make_tp_mesh(3)
    out = {"tp3_in_mesh": mesh3.get_coordinate() is not None,
           "tp3_warning": [m for m in records.messages if "dropping" in m]}
    if mesh3.get_coordinate() is not None:
        out["tp3_shape"] = mesh_shape(mesh3)
    for key, make in (("tp5", lambda: make_tp_mesh(5)),
                      ("tp_sp", lambda: Trainer(tensor_parallel=2, spatial_parallel=2,
                                                device="cpu"))):
        try:
            make()
            out[key] = None
        except ValueError as err:
            out[key] = str(err)
    out["build_trainer_tp2"] = mesh_shape(build_trainer({"tensor_parallel": 2}, device="cpu").mesh)
    # The collectives' round trips, on this rank's own numbers.
    sp = mesh_axis(make_sp_mesh(4), "spatial")
    x = torch.arange(2 * 4 * 8 * 3, dtype=torch.float32).reshape(2, 4, 8, 3) + 1000 * rank
    y = y_split(x, sp)
    whole_x = all_gather(x, sp, 1)
    out["a2a"] = (tuple(y.shape), torch.equal(x_split(y, sp), x),
                  torch.equal(y, whole_x[:, :, 2 * sp.rank:2 * sp.rank + 2]))
    out["scatter_gather"] = torch.equal(gather(scatter(whole_x, sp, 1), sp, 1), whole_x)
    return out


def _case_fits(root, rank):
    out = {}
    for name, cfg in (("dp", {}), ("tp", {"tensor_parallel": 2}), ("sp", {"spatial_parallel": 2})):
        callbacks = ([ModelCheckpoint(os.path.join(root, "ckpt_tp"), monitor=None)]
                     if name == "tp" else [])
        trainer = build_trainer(dict(cfg, max_epochs=2), callbacks, device="cpu")
        trainer.fast_loop = name == "dp"
        routine, builder = _fit_routine(), _fit_builder(root)
        state = trainer.fit(routine, builder)
        res = {"mesh": mesh_shape(trainer.mesh), "train_loss": trainer.logs["train_loss"],
               "valid_loss": trainer.logs["valid_loss"], "global_step": trainer.global_step}
        if name == "tp":
            params = dict(state.model.named_parameters())
            w1 = params["spectral_layers.0.backcast_ff.layers.0.0.weight_v"]
            res["local_shapes"] = {
                "ff": tuple(w1.shape), "fourier": tuple(params[
                    "spectral_layers.0.fourier_weight.0"].shape),
                "moment": tuple(state.optimizer.state[w1]["exp_avg"].shape)}
            res["test"] = trainer.test(routine, builder, state)
            # The written checkpoint back into a split state: this rank's blocks.
            fresh = shard_state(_fit_routine().init(0, builder.sample_batch(), "cpu"),
                                trainer.mesh)
            fresh = load_state(os.path.join(root, "ckpt_tp", "last.ckpt"), fresh)
            res["reload_equal"] = all(
                torch.equal(a, b) for a, b in zip(fresh.model.parameters(),
                                                  state.model.parameters(), strict=True))
            res["reload_moments_equal"] = all(
                torch.equal(fresh.optimizer.state[a]["exp_avg"], state.optimizer.state[b]["exp_avg"])
                for a, b in zip(fresh.model.parameters(), state.model.parameters(), strict=True))
        out[name] = res
    return out


CASES = {"steps": _case_steps, "specs": _case_specs, "meshes": _case_meshes, "fits": _case_fits}


def _worker(rank, root):
    torch.set_num_threads(1)
    init_distributed("cpu", f"file://{os.path.join(root, 'store')}", rank, WORLD)
    out = {}
    for name, case in CASES.items():
        out[name] = case(root, rank)
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# --- the world ---------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of every case (a list by rank) and the directory;
    JAX's steps, computed while the world runs."""
    root = str(tmp_path_factory.mktemp("world"))
    rng = np.random.RandomState(3)
    t = np.arange(24)[None, None, None, :]
    np.save(os.path.join(root, "traj.npy"),
            (rng.randn(20, 32, 32, 1) + 0.05 * t * rng.randn(20, 32, 32, 1)).astype(np.float32))
    batch = _step_batch()
    jax_states = {}
    # The zongyi and plus steps serve both the model and the spatial mesh.
    models = {"markov": (JaxBlock(**MARKOV), False, 0.1),
              "shared": (JaxBlock(**SHARED_REMAT), False, 0.1),
              "w32": (JaxBlock(**MARKOV_W32), False, 0.1),
              **{case: (make(), shuffle, clip)
                 for case, (_, make, shuffle, clip) in SPATIAL_CASES.items()}}
    for name, (model, shuffle, clip) in models.items():
        routine = _jax_markov(model, clip=clip, shuffle=shuffle)
        jax_states[name] = (routine, routine.accumulate_step(
            routine.init(jax.random.PRNGKey(0), batch), batch))
    torch.save({name: CONVERT[name](jax.tree.map(np.asarray, s0.params))
                for name, (_, s0) in jax_states.items()}, os.path.join(root, "inputs.pt"))
    procs = mp.start_processes(_worker, args=(root,), nprocs=WORLD, start_method="spawn",
                               join=False)
    steps = {}
    for name, (routine, s0) in jax_states.items():
        step = jax.jit(routine.train_step)
        s1, m1 = step(s0, batch, jax.random.PRNGKey(1))
        s2, m2 = step(s1, batch, jax.random.PRNGKey(2))
        steps[name] = {"losses": [float(m1["train_loss"]), float(m2["train_loss"])],
                       "state": s2, "grads": _jax_grads(routine, s0, batch)}
    steps["valid_loss"] = float(jax.jit(jax_states["markov"][0].valid_step)(
        steps["markov"]["state"], {"data": _valid_data()})["loss"])
    while not procs.join():
        pass
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:  # written by the world above
            ranks.append(pickle.load(f))
    return ranks, root, steps


def _jax_grads(routine, state, batch):
    """JAX's gradients of one train step's loss: the routine's own
    ``train_step`` (its ``jax.value_and_grad``), with the update that
    follows replaced by handing the gradients back as the parameters."""
    grads_of = copy.copy(routine)
    grads_of.apply_grads = lambda s, grads: s.replace(params=grads)
    return jax.jit(grads_of.train_step)(state, batch, jax.random.PRNGKey(1))[0].params


@pytest.fixture(scope="module")
def jax_steps(world):
    return world[2]


def _single_fit(root, fast_loop):
    trainer = Trainer(max_epochs=2, seed=0, device="cpu", fast_loop=fast_loop)
    state = trainer.fit(_fit_routine(), _fit_builder(root))
    return trainer, state


def _jax_as_port(tree, case):
    return CONVERT[case](jax.tree.map(np.asarray, tree))


def _assert_steps_match_jax(got, want, case):
    """Both steps' losses (rtol 1e-5) and the parameters after the second
    (rtol 1e-4, atol 1e-6), gathered, against JAX's unsplit steps."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    params = _jax_as_port(want["state"].params, case)
    assert set(got["params"]) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# --- (a) the split train steps against JAX ---------------------------------------------------------
@pytest.mark.parametrize("mesh", ["tp", "sp"])
def test_split_train_step_matches_jax(world, jax_steps, mesh):
    for r in world[0]:
        _assert_steps_match_jax(r["steps"][mesh], jax_steps["markov"], "markov")


@pytest.mark.parametrize("mesh,case", [("tp", "markov"), ("sp", "markov"),
                                       ("tp_shared_remat", "shared"),
                                       ("sp_shared_remat", "shared"), ("zongyi", "zongyi"),
                                       ("plus", "plus")])
def test_split_gradients_match_jax(world, jax_steps, mesh, case):
    """The first step's gradients of every split layout, the model axis's
    blocks gathered, against JAX's gradients of the same loss on the same
    weights and batch: the tensor-parallel feed-forward (W2's norm summed
    over ``model``, b2 on one rank, x's gradient summed), the column-split
    spectral mix and its channel gather, the spatially split mix's
    all-to-alls and their adjoints, shared Fourier weights under remat, and
    the FNO's dense weights split by output channel."""
    want = _jax_as_port(jax_steps[case]["grads"], case)
    for rank, r in enumerate(world[0]):
        for name, g in r["steps"][mesh]["grads"].items():
            w = want[name].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=f"rank {rank}: {name}")


@pytest.mark.parametrize("mesh,model", [("tp", MARKOV), ("sp", MARKOV),
                                        ("tp_shared_remat", SHARED_REMAT),
                                        ("sp_shared_remat", SHARED_REMAT),
                                        ("tp4_w32", MARKOV_W32)])
def test_split_gradients_match_unsplit(world, mesh, model):
    """The gathered gradients of the split step against the port's step in
    one process from the same weights; also with shared Fourier weights and
    per-layer remat."""
    got = world[0][0]["steps"][mesh]["grads"]
    inputs = torch.load(os.path.join(world[1], "inputs.pt"))[
        {"tp_shared_remat": "shared", "sp_shared_remat": "shared", "tp4_w32": "w32"}.get(
            mesh, "markov")]
    routine = _port_markov(FNOFactorized2DBlock(**model))
    state = routine.init(0, _step_batch(), "cpu")
    state.model.load_state_dict(inputs)
    state = routine.accumulate_step(state, _step_batch())
    _, grads, _ = routine.loss_and_grads(state, _step_batch(), step_generator(0, 1, "cpu"))
    for (name, _), g in zip(state.model.named_parameters(), grads, strict=True):
        scale = g.abs().max().item()
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_hidden_slice_of_32_steps_match_jax(world, jax_steps):
    """``{data 1, model 4}`` at width 32, each rank's feed-forward slice 32
    wide (the flagship's at tp 8), on every rank: both steps' losses and the
    parameters after the second, gathered, against JAX's unsplit steps, and
    the first step's gradients within W32_JAX_GRAD_RTOL of each tensor's
    largest value (``test_split_gradients_match_unsplit`` holds them to the
    port's one-process step at GRAD_RTOL)."""
    want = _jax_as_port(jax_steps["w32"]["grads"], "w32")
    for rank, r in enumerate(world[0]):
        _assert_steps_match_jax(r["steps"]["tp4_w32"], jax_steps["w32"], "w32")
        for name, g in r["steps"]["tp4_w32"]["grads"].items():
            w = want[name].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=W32_JAX_GRAD_RTOL * np.abs(w).max(),
                                       err_msg=f"rank {rank}: {name}")


def test_spatial_valid_step_matches_jax(world, jax_steps):
    np.testing.assert_allclose(world[0][0]["steps"]["sp"]["valid_loss"], jax_steps["valid_loss"],
                               rtol=1e-5)


# --- (b) the FNO's dense weights --------------------------------------------------------------------
def test_tensor_parallel_zongyi_dense_weights(world, jax_steps):
    for r in world[0]:
        got = r["steps"]["zongyi"]
        assert got["n_split"] == 4  # two layers' two Fourier weights; their moments follow them
        _assert_steps_match_jax(got, jax_steps["zongyi"], "zongyi")


def test_tensor_parallel_fno_plus_dense_weights_and_forks(world, jax_steps):
    """FNO++ on ``{data 2, model 2}``: its dense weights ``[16, 16, 4, 4, 2]``
    by output channel and both shared forks' hidden slices (block level,
    each cut once for every layer), the two steps against JAX's."""
    for r in world[0]:
        got = r["steps"]["plus"]
        ffs = {f"{fork}.layers.{j}.0.weight_v": (16, 16) for fork in ("backcast_ff", "forecast_ff")
               for j in (0, 1)}
        weights = {f"spectral_layers.{i}.fourier_weight.{k}": (16, 8, 4, 4, 2)
                   for i in range(PLUS["n_layers"]) for k in (0, 1)}
        assert got["split"] == {**ffs, **weights}
        _assert_steps_match_jax(got, jax_steps["plus"], "plus")


def test_fno_plus_on_a_spatial_mesh_matches_jax(world, jax_steps):
    """FNO++ with both shared forks on ``{data 2, spatial 2}``: every rank's
    two steps against JAX's unsplit steps (the model mesh's ``plus`` steps),
    its dense weights whole."""
    for r in world[0]:
        got = r["steps"]["sp_plus"]
        assert got["params"]["spectral_layers.0.fourier_weight.0"].shape == (16, 16, 4, 4, 2)
        _assert_steps_match_jax(got, jax_steps["plus"], "plus")


# --- (b') the other models of the Markov routine on data x spatial -------------------------------
@pytest.mark.parametrize("case", sorted(SPATIAL_CASES))
def test_spatial_steps_match_jax(world, jax_steps, case):
    """Each model's two steps on ``{data 2, spatial 2}``, every rank, against
    JAX's unsplit steps: the losses, the parameters after the second step,
    and the first step's gradients (each rank's part summed over
    ``spatial``) within GRAD_RTOL of each tensor's largest value."""
    want = _jax_as_port(jax_steps[case]["grads"], case)
    for rank, r in enumerate(world[0]):
        got = r["steps"][f"sp_{case}"]
        _assert_steps_match_jax(got, jax_steps[case], case)
        assert got["grads"] and set(got["grads"]) <= set(want)
        for name, g in got["grads"].items():
            w = want[name].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=f"rank {rank}: {name}")


@pytest.mark.parametrize("case", ("markov",) + tuple(sorted(SPATIAL_CASES)))
def test_spatial_mesh_of_one_rank_equals_one_process_to_the_bit(world, case):
    """Rank 0's ``{data 1, spatial 1}`` steps equal the same steps with no
    mesh in the same process, to the bit: losses, first gradients and
    parameters (every collective of one rank is the identity, and each split
    form sums its branches in the unsplit form's order)."""
    got, want = (world[0][0]["steps"][(case, layout)] for layout in ("one", "none"))
    assert got["losses"] == want["losses"]
    for key in ("grads", "params"):
        assert set(got[key]) == set(want[key])
        unequal = [k for k, v in want[key].items() if not torch.equal(got[key][k], v)]
        assert not unequal, (key, unequal)


def test_split_fno_plus_refuses_dropout():
    for kw in (dict(dropout=0.1), dict(in_dropout=0.1)):
        with pytest.raises(NotImplementedError, match="dropout has no parallel form"):
            FNOPlus2DBlock(**PLUS, **kw).set_parallel(tensor=object())
    with pytest.raises(ValueError, match="cannot be combined"):
        FNOPlus2DBlock(**PLUS).set_parallel(tensor=object(), spatial=object())


# --- (c) specs and placements ----------------------------------------------------------------------
def _jax_split_dims(model, convert, tp):
    """{port name: split dim} of JAX's ``tp_state_shardings`` on a model's
    parameters, carried through the weight converter by marking each split
    leaf with its index along the split dim."""
    params = model.init(jax.random.PRNGKey(0), jnp.ones((2, 16, 16, 3)))
    specs = tp_state_shardings(params, jax_make_tp_mesh(tp))
    leaves, tree = jax.tree_util.tree_flatten(params)
    marked = []
    for leaf, sharding in zip(leaves, jax.tree.leaves(specs), strict=True):
        shape, spec = np.shape(leaf), tuple(sharding.spec)
        mark = np.zeros(shape, np.float32)
        if "model" in spec:
            d = spec.index("model")
            mark = mark + np.arange(shape[d], dtype=np.float32).reshape(
                [-1 if i == d else 1 for i in range(len(shape))])
        marked.append(mark)
    port = convert(jax.tree_util.tree_unflatten(tree, marked))
    dims = {}
    for name, t in port.items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1 and
                   not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        dims[name] = varying[0] if varying else None
    return dims


@pytest.mark.parametrize("case,model,convert,tp", [
    ("w16", lambda: JaxBlock(**MARKOV), lambda p: state_dict_from_flax(p, MARKOV["n_layers"]), 2),
    ("w12", lambda: JaxBlock(width=12, **SPEC_MODEL), lambda p: state_dict_from_flax(p, 1), 4),
    ("w10", lambda: JaxBlock(width=10, **SPEC_MODEL), lambda p: state_dict_from_flax(p, 1), 4),
    ("zongyi", lambda: JaxZongyi(**ZONGYI), zongyi_state_dict_from_flax, 2),
    ("plus", lambda: JaxPlus(**PLUS), CONVERT["plus"], 2)])
def test_tp_param_specs_match_jax(world, case, model, convert, tp):
    got = world[0][0]["specs"][case]
    assert got == _jax_split_dims(model(), convert, tp)
    if case == "w10":  # 10 channels on 4 ranks: the Fourier weights stay whole, H 40 splits
        assert got["fourier_weight.0"] is None
        assert got["spectral_layers.0.backcast_ff.layers.0.0.weight_v"] == 0
    assert any(d is not None for d in got.values())


@pytest.mark.parametrize("key", sorted(PLACEMENT_SHAPES))
def test_shard_batch_placements_match_jax(world, key):
    mesh = jax_make_sp_mesh(2)  # 8 devices: data 4 x spatial 2 (the world: data 2 x spatial 2)
    arr = jax_shard_batch({key: np.zeros(PLACEMENT_SHAPES[key], np.float32)}, mesh,
                          spatial_axis="spatial")[key]
    specs = world[0][0]["specs"]
    assert specs["placements"][key] == tuple(arr.sharding.spec)
    split = {"data": 2, "spatial": 2}
    want = tuple(n // split[a] if a else n for n, a in
                 zip(PLACEMENT_SHAPES[key], specs["placements"][key] + (None,) * 4))
    assert specs["local_shapes"][key] == want


# --- (d) meshes -------------------------------------------------------------------------------------
def test_make_tp_mesh_drops_a_rank(world):
    meshes = [r["meshes"] for r in world[0]]
    assert [m["tp3_in_mesh"] for m in meshes] == [True, True, True, False]
    assert all(m["tp3_shape"] == {"data": 1, "model": 3} for m in meshes[:3])
    assert all(m["tp3_warning"] == ["make_tp_mesh: dropping 1 of 4 devices (not divisible by "
                                    "tensor_parallel=3)"] for m in meshes)


def test_mesh_edge_cases_raise(world):
    meshes = world[0][0]["meshes"]
    assert "tensor_parallel=5 needs at least that many devices; have 4" in meshes["tp5"]
    assert "cannot be combined" in meshes["tp_sp"]


def test_parallel_trainer_keys_build_mesh(world):
    assert world[0][0]["meshes"]["build_trainer_tp2"] == {"data": 2, "model": 2}


def test_spatial_all_to_all_round_trip(world):
    for r in world[0]:
        assert r["meshes"]["a2a"] == ((2, 16, 2, 3), True, True)
        assert r["meshes"]["scatter_gather"]


# --- (e) fits ----------------------------------------------------------------------------------------
@pytest.mark.parametrize("name,fast_loop,mesh", [
    ("dp", True, {"data": 4}), ("tp", False, {"data": 2, "model": 2}),
    ("sp", False, {"data": 2, "spatial": 2})])
def test_parallel_fit_matches_one_process(world, name, fast_loop, mesh):
    got = world[0][0]["fits"][name]
    trainer, _ = _single_fit(world[1], fast_loop)
    assert got["mesh"] == mesh
    assert got["global_step"] == trainer.global_step
    np.testing.assert_allclose(got["train_loss"], trainer.logs["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["valid_loss"], trainer.logs["valid_loss"], rtol=1e-3)
    for r in world[0][1:]:  # every rank logged the same
        assert r["fits"][name]["train_loss"] == got["train_loss"]


def test_tensor_parallel_state_stays_split(world):
    got = world[0][0]["fits"]["tp"]["local_shapes"]
    assert got == {"ff": (32, 16), "fourier": (16, 8, 5, 2), "moment": (32, 16)}


# --- (f) the checkpoint ------------------------------------------------------------------------------
def test_split_checkpoint_loads_unsplit(world):
    got = world[0][0]["fits"]["tp"]["test"]
    routine, builder = _fit_routine(), _fit_builder(world[1])
    state = load_state(os.path.join(world[1], "ckpt_tp", "last.ckpt"),
                       routine.init(0, builder.sample_batch(), "cpu"))
    logs = Trainer(device="cpu").test(routine, builder, state)
    assert set(logs) == set(got)
    for k, v in logs.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_checkpoint_loads_into_split_state(world):
    for r in world[0]:
        assert r["fits"]["tp"]["reload_equal"] and r["fits"]["tp"]["reload_moments_equal"]


# --- one process ----------------------------------------------------------------------------------
def test_tp8_hidden_slices_of_16_and_32_are_taken():
    """At tensor parallelism 8 the flagship's hidden slice is 256 / 8 = 32
    and elasticity's 128 / 8 = 16: kernels A and A' take both, and H 48 and
    80 (each stages H rounded up to its 64-wide chunks, zeros past H, so H 16
    needs H 64's shared memory), and a slice that is not a multiple of 16
    raises and names H, on what they would launch on the card."""
    from fourierflow_tpu_torch.ops.fused_ff import _bwd_smem_bytes, _check_args, _fwd_smem_bytes

    x, b2 = torch.zeros(8, 64), torch.zeros(64)
    weights = lambda h: (torch.zeros(64, h), torch.zeros(h), torch.zeros(h, 64))
    for hidden in (16, 32, 48, 64, 80, 128):  # 16 and 32: tp 8 of elasticity and the flagship
        _check_args(x, *weights(hidden), b2)
        _check_args(x, *weights(hidden), g=torch.zeros(8, 64))
    for hidden in (24, 40):
        w1, b1, w2 = weights(hidden)
        with pytest.raises(ValueError, match=f"H a multiple of 16, got {hidden}"):
            _check_args(x, w1, b1, w2, b2)
        with pytest.raises(ValueError, match=f"H a multiple of 16, got {hidden}"):
            _check_args(x, w1, b1, w2, g=torch.zeros(8, 64))
    for dtype in (torch.float32, torch.bfloat16):
        for hidden, staged in ((16, 64), (32, 64), (48, 64), (80, 128), (96, 128)):
            assert _fwd_smem_bytes(hidden, 64, dtype) == _fwd_smem_bytes(staged, 64, dtype)
            assert _bwd_smem_bytes(hidden, dtype) == _bwd_smem_bytes(staged, dtype)


def test_rank_device_is_local_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device() == torch.device("cuda", 3)
    assert resolve_device("cpu") == torch.device("cpu")


def test_meshes_need_the_ranks_in_one_process():
    with pytest.raises(ValueError, match="needs at least that many devices; have 1"):
        make_sp_mesh(2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh()


def test_column_shard_mix_is_the_full_mix_columns():
    """Kernel B's shard shapes through its plain versions: a column shard of
    the weights gives those columns of the full mix (two axes and one), and
    the adjoints of the shards summed give the full adjoint."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 12, 10, 8).astype(np.float32))
    wy, wx = (torch.from_numpy(rng.randn(8, 8, 4, 2).astype(np.float32) * 0.1) for _ in range(2))
    g = torch.from_numpy(rng.randn(2, 12, 10, 8).astype(np.float32))
    full, adj = fused_mix_2d(x, wy, wx), fused_mix_2d_adjoint(g, wy, wx)
    parts = []
    for s in (slice(0, 4), slice(4, 8)):
        shard = fused_mix_2d(x, wy[:, s], wx[:, s])
        torch.testing.assert_close(shard, full[..., s], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(fused_mix_axis(x, wy[:, s], 2) + fused_mix_axis(x, wx[:, s], 1),
                                   full[..., s], rtol=1e-6, atol=1e-6)
        parts.append(fused_mix_2d_adjoint(g[..., s].contiguous(), wy[:, s], wx[:, s]))
    torch.testing.assert_close(parts[0] + parts[1], adj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [1, 2])
def test_fused_mix_axis_matches_jax_branch(axis):
    """One branch with C_out = C_in / 2 against the JAX package's
    ``spectral_mix_axis`` on the same column shard (float32, 1e-5)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 12, 8).astype(np.float32)
    w = (rng.randn(8, 4, 5, 2) * 0.2).astype(np.float32)
    got = fused_mix_axis(torch.from_numpy(x), torch.from_numpy(w), axis)
    want = np.asarray(jax_mix_axis(jnp.asarray(x), jnp.asarray(w), axis))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 12, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [1, 2])
def test_fused_mix_axis_adjoint_is_the_adjoint(axis):
    """``fused_mix_axis_adjoint`` on a column shard (C_out = C_in / 2) is the
    adjoint of ``fused_mix_axis``: <A x, g> = <x, A* g> (float64 sums of
    float32 results, rel 1e-5)."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 10, 12, 8).astype(np.float32))
    w = torch.from_numpy((rng.randn(8, 4, 3, 2) * 0.2).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 10, 12, 4).astype(np.float32))
    lhs = (fused_mix_axis(x, w, axis).double() * g.double()).sum()
    rhs = (x.double() * fused_mix_axis_adjoint(g, w, axis).double()).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)
