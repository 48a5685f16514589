"""The training loop (counterpart of ``fourierflow_tpu/trainers/trainer.py``
on one device).

``fit`` runs ``max_epochs`` epochs. When the routine normalizes, epoch 0
only gathers normalizer statistics; every later batch is one
``train_step``. After each epoch the train metrics are checked for NaN,
validation runs every ``check_val_every_n_epoch`` epochs, and the
callbacks' ``on_epoch_end`` hooks run. The noise of each step comes from a
generator on the state's device seeded from the trainer's seed and the
global step (``step_generator``).

An epoch takes one of two paths, chosen as the JAX package chooses them:

- the device-resident epoch (the default: ``fast_loop`` set, no
  ``limit_train_batches``, and a builder with ``train_data`` or
  ``device_train_data``): the train set goes to the device once a fit,
  each epoch draws ``epoch_permutation`` on the CPU, copies it to the
  device once, gathers each batch there with ``sample_fn(data, idx)`` and
  drops the trailing partial batch (``make_scan_epoch_indexed``); the
  step metrics stay on the device and their unweighted mean is fetched
  once an epoch;
- the per-batch loop (``fast_loop=False``, a limit, ``fast_dev_run``, or a
  builder without either, such as the multi-resolution Kolmogorov
  dataset): the builder's shuffled host batches, the last one partial,
  metrics merged by batch size and the first step's loss logged.

With ``fast_loop`` a dict of numpy arrays as the ``valid_data`` or
``test_data`` of a builder is uploaded once and sliced on the device
(``evaluate``).

With ``auto_remat`` (the default) ``fit`` first estimates the train step's
saved activations from the model's layers and width and the sample batch's
shape, and turns the model's per-layer remat on when they would take more
than 60% of the device's memory (``_maybe_enable_remat``; on a mesh the
estimate is divided by the ``data`` and ``spatial`` axes).

Parallel fits, as the JAX package's Trainer builds them: one process a
device (``parallel.init_distributed``), and a mesh (``parallel/mesh.py``):
``tensor_parallel`` > 1 makes ``data x model``, ``spatial_parallel`` > 1
``data x spatial`` (not both), and otherwise a world of more than one rank
a ``data`` mesh (``data_parallel``); a ``mesh`` may also be passed, whose
axes then say which forms run. The state goes through
``parallel.shard_state`` (the model's parallel forms, the tensor-parallel
split of its weights and AdamW moments) and each batch through
``parallel.shard_batch``. On a ``data`` mesh whose axis divides the batch
the device-resident epoch stays: every rank holds the train set, draws the
same ``epoch_permutation`` and gathers its block of each batch (unless the
train set would take more than 60% of the device's memory: then the
per-batch loop, with a warning); on a ``model`` or ``spatial`` mesh the
per-batch loop runs. Every routine trains on ``data`` and ``data x model``
meshes (a model that has no leaf to split runs whole on every ``model``
rank, ``parallel.shard_state``); only ``Grid2DMarkovRoutine`` on
``spatial`` ones (the others raise there). Evaluation batches (the evaluation set cached per rank) are split
over ``data`` for a routine whose ``valid_step`` reduces its metrics over
it (``Routine.splits_eval_batches``) and whole on every data row for the
Markov routine, split over ``spatial`` where the mesh has it, and merged by
the size of the whole batch. Only rank 0 logs and runs the callbacks that write files
(``Callback.writes_files``), with the state gathered whole
(``parallel.gather_state``); every rank of the mesh then waits for it. A
rank that the mesh dropped takes no part: ``fit`` returns its state as it
is. The JAX package's dispatch chunking is not ported.
"""

import inspect
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..parallel import (ShardedBatch, gather_state, in_mesh, is_rank0, make_mesh, make_sp_mesh,
                        make_tp_mesh, mesh_axis, mesh_shape, shard_batch, shard_state,
                        shard_tensor, world_size)
from ..parallel.collectives import all_reduce
from ..routines.base import Routine, State

logger = logging.getLogger(__name__)

__all__ = ["Trainer", "epoch_permutation", "gather", "make_scan_epoch", "make_scan_epoch_indexed",
           "step_generator", "to_device"]

# Saved activations of an unremat train step, in layer-input-sized tensors a
# layer (``n_layers * batch * cells * width``, the cells those of the batch's
# ``x``), by model: the step's peak ``torch.cuda.max_memory_allocated()`` above
# the memory held before it, measured by ``chip_smoke.py`` phase ``trainer`` on
# an NVIDIA H100 80GB HBM3 at 700.00 W. FNOFactorized2DBlock: the least-squares
# fit through the origin (2.226-2.228) of 2.35-2.44 at torus_li/markov/24_layers
# batch 19 and 2.35 and 2.22 at torus_kochkov/ffno/grid_sizes/256 batch 2 and 8.
# FNOFactorizedMesh3D: 5.73 at plasticity/ffno/24_layers batch 2 (the padded
# grid has 1.90x the batch's cells). FNOZongyi2DBlock: 45.45-45.51 at
# torus_li/zongyi/4_layers batch 20, whose step unrolls the model 10 times, so
# it overstates a one-step routine's. The guard leaves a model not listed here
# alone.
SAVED_INPUTS_PER_LAYER = {"FNOFactorized2DBlock": 2.23, "FNOFactorizedMesh3D": 5.73,
                          "FNOZongyi2DBlock": 45.5}
# The share of the device's memory the estimate may take before remat turns on.
REMAT_BUDGET = 0.6


def batch_count(batch) -> int:
    """The number of samples of a batch: a dict of arrays, an ``(inputs,
    outputs)`` tuple (the learned-interpolation model's) or an array."""
    if isinstance(batch, dict):
        return batch_count(next(iter(batch.values())))
    if isinstance(batch, (tuple, list)):
        return batch_count(batch[0])
    return len(batch)


def _weighted_merge(metric_list):
    """Mean of each metric over the batches, weighted by batch size."""
    if not metric_list:
        return {}
    total = sum(w for _, w in metric_list)
    return {key: sum(np.asarray(m[key]) * w for m, w in metric_list) / total
            for key in metric_list[0][0]}


def _numpy(metrics) -> dict:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in metrics.items()}


def step_generator(seed: int, global_step: int, device) -> torch.Generator:
    """The noise generator of a train step: on ``device``, seeded from the
    trainer's seed and the step's global index."""
    s = np.random.SeedSequence([seed, global_step]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def epoch_permutation(seed: int, epoch: int, n_items: int, batch_size: int) -> torch.Tensor:
    """The items of an epoch's batches, ``[n_items // batch_size,
    batch_size]`` int64 on the CPU: a permutation of ``range(n_items)``
    drawn from a CPU generator seeded from ``(seed, epoch)``, the trailing
    partial batch dropped. It is drawn on the CPU because ``torch.randperm``
    orders differ between CPU and CUDA generators: so the card and a CPU
    copy see the same batches."""
    s = np.random.SeedSequence([seed, epoch]).generate_state(1)[0]
    perm = torch.randperm(n_items, generator=torch.Generator().manual_seed(int(s)))
    n_batches = n_items // batch_size
    return perm[:n_batches * batch_size].reshape(n_batches, batch_size)


def gather(data, idx):
    """A batch of a dict of aligned arrays: the rows ``idx`` of each."""
    return {k: v[idx] for k, v in data.items()}


def to_device(tree, device):
    """A dict, tuple or list of numpy arrays or tensors as tensors on
    ``device``, each dtype kept (a read-only array is copied first)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    a = np.asarray(tree)
    return torch.as_tensor(a if a.flags.writeable else a.copy(), device=device)


def _on_data(local):
    """A rank's block of a batch (a dict, or a tuple of dicts) as a
    ``ShardedBatch`` split on ``data``."""
    if isinstance(local, (tuple, list)):
        return type(local)(_on_data(b) for b in local)
    return ShardedBatch(local, dict.fromkeys(local, ("data",)))


def make_scan_epoch(routine: Routine, batch_size: int, accumulate: bool = False, seed: int = 0,
                    mesh=None):
    """The device-resident epoch over a dict of aligned tensors (the
    identity gather of ``make_scan_epoch_indexed``)."""
    return make_scan_epoch_indexed(routine, batch_size, None, gather, accumulate, seed, mesh)


def make_scan_epoch_indexed(routine: Routine, batch_size: int, n_items: Optional[int],
                            sample_fn, accumulate: bool = False, seed: int = 0, mesh=None):
    """A whole epoch over a train set that already lives on the state's
    device: ``epoch_fn(state, data, epoch, first_step=0) -> (state,
    metrics)``.

    ``data`` is whatever ``sample_fn(data, idx)`` gathers a batch from on the
    device (``idx`` a row of ``epoch_permutation(seed, epoch, n_items,
    batch_size)``); ``n_items`` None is the length of ``data``'s first
    array. Each batch is one ``routine.train_step`` with the generator of
    global step ``first_step + i`` (``step_generator``), or with
    ``accumulate`` one ``accumulate_step``. ``metrics`` is the unweighted
    mean of the steps' metrics as floats, fetched once (empty with
    ``accumulate``).

    With ``mesh`` (a ``data`` mesh whose axis divides ``batch_size``) every
    rank holds all of ``data`` and gathers its block of each batch's items:
    a ``ShardedBatch`` split on ``data`` (a tuple of them where ``sample_fn``
    gives a tuple of dicts)."""
    data_axis = mesh_axis(mesh, "data")

    def epoch_fn(state, data, epoch: int, first_step: int = 0):
        n = n_items if n_items is not None else len(next(iter(data.values())))
        device = state.device
        perm = epoch_permutation(seed, epoch, n, batch_size).to(device)
        steps = []
        for i, idx in enumerate(perm):
            if data_axis is None:
                batch = sample_fn(data, idx)
            else:
                batch = _on_data(sample_fn(data, shard_tensor(idx, 0, data_axis)))
            if accumulate:
                state = routine.accumulate_step(state, batch)
                continue
            state, metrics = routine.train_step(state, batch,
                                                step_generator(seed, first_step + i, device))
            steps.append(metrics)
        if not steps:
            return state, {}
        keys = list(steps[0])
        means = torch.stack([torch.stack([torch.as_tensor(m[k], device=device) for m in steps])
                             .float().mean() for k in keys])
        return state, dict(zip(keys, means.tolist()))

    return epoch_fn


def _estimate_activation_bytes(model, sample_batch) -> Optional[int]:
    """The saved activations of an unremat train step of a model with
    per-layer remat: ``n_layers * batch * cells * width * itemsize`` (2
    bytes with a compute dtype, else 4) times the model's
    ``SAVED_INPUTS_PER_LAYER``. None for a model not listed there or
    without ``n_layers`` and ``width``, or a batch without an ``x`` of at
    least three dims."""
    coefficient = SAVED_INPUTS_PER_LAYER.get(type(model).__name__)
    n_layers = getattr(model, "n_layers", None)
    width = getattr(model, "width", None)
    if not (coefficient and n_layers and width):
        return None
    x = sample_batch.get("x") if hasattr(sample_batch, "get") else None
    if x is None or getattr(x, "ndim", 0) < 3:
        return None
    batch = int(x.shape[0])
    cells = int(np.prod(x.shape[1:-1]))
    itemsize = 2 if getattr(model, "dtype", None) is not None else 4
    return int(int(n_layers) * batch * cells * int(width) * coefficient * itemsize)


def _device_hbm_bytes(device) -> float:
    """The memory of a CUDA device; unbounded on the CPU, where the guard
    never fires."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return float("inf")


def _tree_nbytes(tree) -> int:
    """Bytes of the arrays and tensors of a dict, tuple or list."""
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))


class Trainer:
    def __init__(self, max_epochs: int = 1, limit_train_batches: Optional[int] = None,
                 limit_val_batches: Optional[int] = None, callbacks: Sequence = (), seed: int = 0,
                 log_every_n_steps: int = 100, check_val_every_n_epoch: int = 1, device=None,
                 auto_remat: bool = True, fast_loop: bool = True, data_parallel: bool = True,
                 tensor_parallel: int = 1, spatial_parallel: int = 1, mesh=None):
        self.max_epochs = max_epochs
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.callbacks = list(callbacks)
        self.seed = seed
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.device = resolve_device(device)
        self.auto_remat = auto_remat
        self.fast_loop = fast_loop
        if tensor_parallel > 1 and spatial_parallel > 1:
            raise ValueError("tensor_parallel and spatial_parallel cannot be combined; pick one "
                             "(each already composes with the data axis)")
        if mesh is None and tensor_parallel > 1:
            mesh = make_tp_mesh(tensor_parallel)
        elif mesh is None and spatial_parallel > 1:
            mesh = make_sp_mesh(spatial_parallel)
        elif mesh is None and data_parallel and world_size() > 1:
            mesh = make_mesh()
        self.mesh = mesh
        self._eval_cache = {}  # (builder, split) -> its evaluation set on the device
        self.logs = {}
        self.current_epoch = 0
        self.global_step = 0

    @property
    def active(self) -> bool:
        """Whether this rank takes part in the fit (one device, or a rank of the mesh)."""
        return self.mesh is None or in_mesh(self.mesh)

    def _info(self, *args) -> None:
        if is_rank0():
            logger.info(*args)

    def _hook(self, name, routine, state, allow_replace=False):
        """Each callback's ``name`` hook. On a mesh the callbacks that write
        files run on rank 0 only, with the state gathered whole, and every
        rank of the mesh waits for them."""
        whole, wrote = None, False
        for cb in self.callbacks:
            if self.mesh is not None and getattr(cb, "writes_files", False):
                if whole is None:
                    whole = gather_state(state)
                if is_rank0():
                    getattr(cb, name)(self, routine, whole)
                wrote = True
                continue
            ret = getattr(cb, name)(self, routine, state)
            if allow_replace and ret is not None:
                state = ret
        if wrote:
            self._barrier(state.device)
        return state

    def _barrier(self, device) -> None:
        """Every rank of the mesh waits for the others (an all-reduce over
        each axis in turn reaches them all)."""
        token = torch.zeros(1, device=device)
        for name in self.mesh.mesh_dim_names:
            all_reduce(token, mesh_axis(self.mesh, name))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step_generator(self, device) -> torch.Generator:
        """The noise generator of the current global step."""
        return step_generator(self.seed, self.global_step, device)

    @staticmethod
    def _device_protocol(routine: Routine, builder):
        """``builder.device_train_data()`` -> ``(data, sample_fn, n_items)``,
        given the routine's ``device_data_fields`` where it takes ``fields``
        (read from its signature, so that a TypeError raised inside is not
        taken for a missing argument); None for a builder without it or
        whose train set raises AttributeError (the multi-resolution
        dataset)."""
        proto_fn = getattr(builder, "device_train_data", None)
        if proto_fn is None:
            return None
        fields = getattr(routine, "device_data_fields", None)
        takes_fields = False
        if fields:
            try:
                takes_fields = any(p.name == "fields" or p.kind is inspect.Parameter.VAR_KEYWORD
                                   for p in inspect.signature(proto_fn).parameters.values())
            except (TypeError, ValueError):
                pass
        try:
            return proto_fn(fields=fields) if takes_fields else proto_fn()
        except AttributeError:
            return None

    def _maybe_enable_remat(self, routine: Routine, builder) -> None:
        """Turn the model's per-layer remat on (the same parameters) when the
        estimated saved activations exceed ``REMAT_BUDGET`` of the device's
        memory. A model whose ``remat`` is already on, or that has none, is
        left alone."""
        model = getattr(routine, "model", None)
        if model is None or getattr(model, "remat", None) is not False:
            return
        est = _estimate_activation_bytes(model, builder.sample_batch())
        if est is None:
            return
        if self.mesh is not None:  # activations split with the batch and the grid
            sizes = mesh_shape(self.mesh)
            est //= sizes.get("data", 1) * sizes.get("spatial", 1)
        budget = REMAT_BUDGET * _device_hbm_bytes(self.device)
        if est > budget:
            logger.warning(
                "estimated saved activations ~%.1f GB exceed ~%.1f GB of the device's memory "
                "budget: turning per-layer rematerialization on (the same parameters; set "
                "Trainer(auto_remat=False) or the model's remat explicitly to override)",
                est / 2**30, budget / 2**30)
            model.remat = True

    def _n_params(self, routine: Routine, state: State) -> int:
        """The parameters of the whole model (a tensor-parallel state holds a
        block of some)."""
        tp = mesh_axis(state.mesh, "model")
        if tp is None:
            return routine.n_params(state)
        return sum(p.numel() * (tp.size if getattr(p, "tp_dim", None) is not None else 1)
                   for p in state.model.parameters())

    def fit(self, routine: Routine, builder, state: Optional[State] = None) -> State:
        """``max_epochs`` epochs from epoch 0 and global step 0, from
        ``state`` where given (a resumed run too, as in the reference: a
        normalizing routine's epoch 0 then adds statistics to the restored
        ones). A rank that the mesh dropped returns ``state`` at once."""
        if not self.active:
            logger.warning("this rank is not in the mesh %s: it takes no part in the fit",
                           mesh_shape(self.mesh))
            return state
        if self.mesh is not None:
            routine.check_mesh(self.mesh)
        rng = np.random.default_rng(self.seed)
        if self.auto_remat:
            self._maybe_enable_remat(routine, builder)
        if state is None:
            state = routine.init(self.seed, builder.sample_batch(), self.device)
        if self.mesh is not None and state.mesh is None:
            state = shard_state(state, self.mesh)
        self.logs["n_params"] = self._n_params(routine, state)
        self._info("n_params = %d", self.logs["n_params"])
        self._hook("on_fit_start", routine, state)
        normalizes = getattr(routine, "should_normalize", False)

        # On a mesh the device-resident epoch needs a pure data mesh whose axis
        # divides the batch (as in the JAX package); model and spatial meshes
        # take the per-batch loop.
        fast = self.fast_loop and self.limit_train_batches is None
        if self.mesh is not None:
            fast = fast and (tuple(self.mesh.mesh_dim_names) == ("data",) and
                             builder.batch_size % mesh_shape(self.mesh)["data"] == 0)
        proto = self._device_protocol(routine, builder) if fast else None
        fast = fast and (proto is not None or hasattr(builder, "train_data"))
        if fast:
            data, sample_fn, n_items = proto if proto is not None else (
                builder.train_data, gather, len(next(iter(builder.train_data.values()))))
            est, budget = _tree_nbytes(data), REMAT_BUDGET * _device_hbm_bytes(self.device)
            if self.mesh is not None and est > budget:
                # Every rank would hold the whole train set.
                logger.warning("the train set (~%.1f GB) exceeds the per-device replication "
                               "budget (~%.1f GB): streaming batches through the per-batch loop "
                               "instead (set fast_loop=False to silence this)", est / 2**30,
                               budget / 2**30)
                fast = False
        if fast:
            data = to_device(data, state.device)
            train_epoch, acc_epoch = (
                make_scan_epoch_indexed(routine, builder.batch_size, n_items, sample_fn,
                                        accumulate=acc, seed=self.seed, mesh=self.mesh)
                for acc in (False, True))
            n_batches = n_items // builder.batch_size

        for epoch in range(self.max_epochs):
            self.current_epoch = epoch
            t0 = time.time()
            if fast:
                if epoch == 0 and normalizes:
                    state, _ = acc_epoch(state, data, epoch)
                else:
                    state, scalars = train_epoch(state, data, epoch, self.global_step)
                    self.global_step += n_batches
                    self._check_nan(scalars, epoch)
                    self.logs.update(scalars)
                    self._info("epoch %d: %d steps on the device (global %d): %s", epoch,
                               n_batches, self.global_step,
                               ", ".join(f"{k} {v:.4f}" for k, v in scalars.items()))
            else:
                state = self._batch_epoch(routine, builder, state, rng, epoch, normalizes)

            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                self.logs.update(self.evaluate(routine, builder, state, split="valid"))
                self.logs["valid_epoch"] = epoch

            self.logs["epoch"] = epoch
            self.logs["epoch_time"] = time.time() - t0
            state = self._hook("on_epoch_end", routine, state, allow_replace=True)

        return self._hook("on_fit_end", routine, state, allow_replace=True)

    def _shard(self, batch, split_batch: bool = True):
        """A batch as this rank holds it on the mesh (``shard_batch``): its
        batch dim split on ``data`` where ``split_batch``, a grid's X on
        ``spatial`` where the mesh has that axis."""
        if self.mesh is None:
            return batch
        spatial = "spatial" if "spatial" in self.mesh.mesh_dim_names else None
        return shard_batch(batch, self.mesh, "data" if split_batch else None, spatial)

    def _global_count(self, batch) -> int:
        """The samples of the whole batch of which ``batch`` (a dict, or a
        tuple of dicts) is a rank's slice."""
        n = batch_count(batch)
        first = batch[0] if isinstance(batch, (tuple, list)) else batch
        specs = getattr(first, "specs", None)
        if specs and tuple(specs[next(iter(first))][:1]) == ("data",):
            n *= mesh_shape(self.mesh)["data"]
        return n

    def _batch_epoch(self, routine: Routine, builder, state: State, rng, epoch: int,
                     normalizes: bool) -> State:
        """One epoch of the per-batch loop over ``builder.train_batches(rng)``."""
        train_metrics = []
        for i, batch in enumerate(builder.train_batches(rng)):
            if self.limit_train_batches and i >= self.limit_train_batches:
                break
            batch = self._shard(batch)
            if epoch == 0 and normalizes:
                state = routine.accumulate_step(state, batch)
                continue
            state, metrics = routine.train_step(state, batch, self.step_generator(state.device))
            self.global_step += 1
            train_metrics.append((metrics, self._global_count(batch)))
            if self.global_step == 1 or (i + 1) % self.log_every_n_steps == 0:
                self._info("epoch %d step %d (global %d): loss %.4f", epoch, i + 1,
                           self.global_step, float(metrics["train_loss"]))
        if train_metrics:
            merged = _weighted_merge([(_numpy(m), w) for m, w in train_metrics])
            scalars = {k: float(v) for k, v in merged.items()}
            self._check_nan(scalars, epoch)
            self.logs.update(scalars)
        return state

    def _check_nan(self, scalars: dict, epoch: int) -> None:
        for k, v in scalars.items():
            if v != v:
                raise FloatingPointError(f"{k} is NaN at epoch {epoch} (step {self.global_step})")

    def _eval_batches(self, routine: Routine, builder, split: str, device):
        """The split's batches: with ``fast_loop``, a ``{split}_data`` dict of
        numpy arrays uploaded once (cached by builder and split) and sliced on
        the device; else ``val_batches()`` / ``test_batches()``. On a mesh
        each is split over ``data`` where the routine's ``valid_step``
        reduces over it (``splits_eval_batches``), else whole on every data
        row, and split over ``spatial`` where the mesh has that axis."""
        data = getattr(builder, f"{split}_data", None)
        if not (self.fast_loop and isinstance(data, dict) and data
                and all(isinstance(v, np.ndarray) for v in data.values())):
            batches = builder.val_batches() if split == "valid" else builder.test_batches()
        else:
            key = (builder, split)
            if key not in self._eval_cache:
                self._eval_cache[key] = to_device(data, device)
            resident = self._eval_cache[key]
            n, bs = len(next(iter(resident.values()))), builder.batch_size
            batches = (gather(resident, slice(s, s + bs)) for s in range(0, n, bs))
        split_batch = routine.splits_eval_batches
        return batches if self.mesh is None else (self._shard(b, split_batch) for b in batches)

    def evaluate(self, routine: Routine, builder, state: State, split: str = "valid") -> dict:
        """``valid_step`` over the split's batches (``_eval_batches``), merged
        by the size of the whole batch, as ``{f"{split}_{metric}": value}``
        (empty on a rank that the mesh dropped)."""
        if not self.active:
            return {}
        batches = self._eval_batches(routine, builder, split, state.device)
        metric_list = []
        for i, batch in enumerate(batches):
            if self.limit_val_batches and i >= self.limit_val_batches:
                break
            metric_list.append((_numpy(routine.valid_step(state, batch)),
                                self._global_count(batch)))
        return {f"{split}_{k}": float(v) if np.ndim(v) == 0 else v
                for k, v in _weighted_merge(metric_list).items()}

    def test(self, routine: Routine, builder, state: State) -> dict:
        if not self.active:
            return {}
        logs = self.evaluate(routine, builder, state, split="test")
        self.logs.update(logs)
        self._hook("on_test_end", routine, state)
        return logs
