"""Routine base: the train state, the optimizer and the routine contract
(counterpart of ``fourierflow_tpu/routines/base.py``).

A routine owns a model (an ``nn.Module``) and implements the steps:

- ``init(seed, sample_batch, device) -> State``
- ``train_step(state, batch, rng) -> (State, metrics)``
- ``accumulate_step(state, batch) -> State``   (normalizer warm-up)
- ``valid_step(state, batch) -> metrics``

Unlike the JAX package's pure steps, ``apply_grads`` updates the model's
parameters and the optimizer's moments in place (torch's optimizers work
so, and it keeps one copy of each); the returned ``State`` carries the
same objects with the step count advanced.

A state on a device mesh (``state.mesh``, set by ``parallel.shard_state``)
reduces each step's gradients and loss over the mesh: the JAX package's
GSPMD does this inside its jitted step. ``reduce_over_mesh`` serves the
Markov routine on any of its meshes; ``mean_over_data`` serves the other
five routines, on ``data`` and ``data x model`` meshes (``mesh_axes``),
whose losses and metrics are global ratios (a sum over the samples or the
valid nodes of the whole batch, divided by their count).
"""

from dataclasses import dataclass, replace
from functools import reduce
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn as nn

from ..layers import NormalizerState
from ..parallel.collectives import all_reduce, mesh_axis

__all__ = ["State", "Routine", "OptimizerSpec", "make_optimizer", "correlations", "time_until",
           "rho_time_until", "nan_to_9999"]


@dataclass
class State:
    """The model (its parameters live in it, on the run's device), the
    normalizer statistics, the optimizer with its schedule, the number of
    train steps taken, and the device mesh of a parallel fit (a
    ``torch.distributed`` ``DeviceMesh``; None on one device)."""

    model: nn.Module
    normalizer: Optional[NormalizerState]
    optimizer: Optional[torch.optim.Optimizer] = None
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    step: int = 0
    mesh: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


@dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` chose; ``build`` makes the optimizer and its
    scheduler for a set of parameters."""

    lr: float = 1e-3
    weight_decay: float = 1e-4
    schedule: Optional[Callable[[int], float]] = None
    clip_val: Optional[float] = None
    accumulate_grad_batches: int = 1

    def build(self, params):
        optimizer = torch.optim.AdamW(params, lr=self.lr, weight_decay=self.weight_decay)
        scheduler = None
        if self.schedule is not None:
            if self.lr <= 0:
                raise ValueError("a schedule needs a positive base learning rate")
            schedule, lr = self.schedule, self.lr
            scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: schedule(s) / lr)
        return optimizer, scheduler


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-4,
                   schedule: Optional[Callable[[int], float]] = None,
                   clip_val: Optional[float] = None,
                   accumulate_grad_batches: int = 1) -> OptimizerSpec:
    """AdamW with an optional per-step LR schedule (absolute rates, step 0
    first), gradient clipping by value before the update, and gradient
    accumulation: the mean of ``accumulate_grad_batches`` steps' gradients
    makes one update (optax's ``MultiSteps``; the steps between change
    nothing)."""
    return OptimizerSpec(lr, weight_decay, schedule, clip_val, int(accumulate_grad_batches))


def correlations(preds: torch.Tensor, yy: torch.Tensor) -> torch.Tensor:
    """Each sample's vorticity correlation of ``preds`` and ``yy [b, X, Y,
    T]`` at each time: ``[b, T]``."""
    pn = torch.linalg.vector_norm(preds, dim=(1, 2), keepdim=True)
    yn = torch.linalg.vector_norm(yy, dim=(1, 2), keepdim=True)
    return ((preds / pn) * (yy / yn)).sum(dim=(1, 2))


def time_until(p: torch.Tensor, step_size: float) -> torch.Tensor:
    """The time (``step_size`` per step) until the correlation ``p [T]``
    first drops below 0.95 (all of T when it never does)."""
    diverged = p < 0.95
    t = torch.where(diverged.any(), torch.argmax(diverged.int()),
                    torch.tensor(p.shape[0], device=p.device))
    return t * step_size


def rho_time_until(preds: torch.Tensor, yy: torch.Tensor, step_size: float):
    """Vorticity correlation rho(t) of ``preds`` and ``yy [b, X, Y, T]``,
    averaged over the batch, and the time until it first drops below 0.95
    (``time_until``)."""
    p = correlations(preds, yy).mean(dim=0)
    return p, time_until(p, step_size)


def nan_to_9999(v: torch.Tensor) -> torch.Tensor:
    """A loss that is NaN reads 9999.9, as the reference logs it."""
    return torch.where(torch.isnan(v), torch.full_like(v, 9999.9), v)


def _params(model: nn.Module):
    return list(model.parameters())  # shared parameters appear once


class Routine:
    # The mesh axes whose layouts the steps know; ``Trainer.fit`` raises for a
    # mesh with any other.
    mesh_axes: Sequence[str] = ()
    # ``valid_step`` reduces its metrics over ``data``, so the Trainer hands
    # each data row its block of an evaluation batch (else the whole batch).
    splits_eval_batches = False

    def __init__(self, optimizer: Optional[OptimizerSpec] = None, track_grad_norm: bool = False):
        self.optimizer = optimizer if optimizer is not None else make_optimizer()
        # When on, train steps add the global gradient L2 norm to their metrics.
        self.track_grad_norm = track_grad_norm

    @staticmethod
    def grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Global L2 norm over a list of gradients."""
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))

    def with_grad_norm(self, metrics: dict, grads) -> dict:
        """Attach the global gradient norm when ``track_grad_norm`` is on."""
        if self.track_grad_norm:
            metrics = dict(metrics, grad_norm=self.grad_norm(grads))
        return metrics

    # --- contract -------------------------------------------------------
    def init(self, seed: int, sample_batch, device) -> State:
        raise NotImplementedError

    def train_step(self, state: State, batch, rng: Optional[torch.Generator] = None):
        raise NotImplementedError

    def accumulate_step(self, state: State, batch) -> State:
        """Normalizer statistics warm-up (epoch 0). Default: no-op."""
        return state

    def valid_step(self, state: State, batch):
        raise NotImplementedError

    # --- helpers --------------------------------------------------------
    def n_params(self, state: State) -> int:
        return sum(p.numel() for p in _params(state.model))

    @staticmethod
    def reduce_over_mesh(state: State, grads: Sequence[torch.Tensor], loss: torch.Tensor,
                         spec=()):
        """The gradients and the loss of the whole step from this rank's, on
        ``state.mesh`` (as they are without one), for a batch whose leading
        dims lie on the mesh axes ``spec`` (``parallel.placement``).

        The gradients are summed over ``data`` and ``spatial`` in one flat
        buffer and divided by the ranks that computed the same samples'
        gradients: ``data`` (each data row's are the mean over its samples,
        or all rows computed the same batch), times ``spatial`` where the
        grid was not split (else each spatial rank's are its rows' part of a
        loss that the spatial ranks share). ``model`` needs nothing: its
        ranks' gradients are whole, by the layers' collectives. The loss,
        the same on the spatial ranks, is averaged over both."""
        if state.mesh is None:
            return grads, loss
        data, spatial = mesh_axis(state.mesh, "data"), mesh_axis(state.mesh, "spatial")
        grid_split = tuple(spec[1:2]) == ("spatial",)
        n_sp = spatial.size if spatial is not None else 1
        grad_div = data.size * (1 if grid_split else n_sp)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [(loss.detach() * (grad_div / (data.size * n_sp))).reshape(1)
                            .to(grads[0].dtype)])
        for axis in (data, spatial):
            if axis is not None:
                flat = all_reduce(flat, axis)
        flat = flat / grad_div
        parts = flat.split([g.numel() for g in grads] + [1])
        return [p.view_as(g) for p, g in zip(parts, grads)], parts[-1].reshape(()).to(loss.dtype)

    def check_mesh(self, mesh) -> None:
        """NotImplementedError, naming the routine and the axis, for a mesh
        with an axis that the steps do not know (``mesh_axes``)."""
        for name in mesh.mesh_dim_names:
            if name not in self.mesh_axes:
                raise NotImplementedError(
                    f"{type(self).__name__} has no form on the '{name}' axis of a device mesh "
                    f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: it trains on the axes "
                    f"{tuple(self.mesh_axes)} only")

    def _data_axis(self, state: State):
        """The ``data`` axis of ``state.mesh`` (``check_mesh`` first)."""
        self.check_mesh(state.mesh)
        return mesh_axis(state.mesh, "data")

    def data_block(self, state: State, batch, key: str):
        """The ``data`` axis where ``batch[key]`` is this rank's block of a
        batch split over it (``parallel.shard_batch``); None where the batch
        is whole (no mesh, or a batch dim the axis does not divide, which
        every rank holds whole)."""
        specs = getattr(batch, "specs", None)
        if state.mesh is None or not specs or tuple(specs.get(key, ()))[:1] != ("data",):
            return None
        return self._data_axis(state)

    def global_count(self, state: State, batch, key: str) -> int:
        """The samples of the whole batch of which ``batch[key]`` holds this
        rank's."""
        data = self.data_block(state, batch, key)
        return batch[key].shape[0] * (data.size if data is not None else 1)

    def mean_over_data(self, state: State, tensors: Sequence[torch.Tensor],
                       weight) -> List[torch.Tensor]:
        """Each tensor's mean over the ranks of ``data``, the ranks weighted
        by ``weight``: ``sum_r w_r t_r / sum_r w_r``, in one all-reduce after
        that of the weights. Where ``t_r`` is a rank's ratio (a loss, a
        metric or their gradients: a sum over its samples or valid nodes
        divided by ``w_r``, their count), this is the ratio of the whole
        batch, the sums and the counts taken over all ranks. A rank that
        holds a whole batch (replicated: the axis does not divide it) counts
        it whole, as every rank does, so the ranks are averaged, never
        summed. Without a mesh, and on a mesh of one rank (``w / w`` is 1),
        the tensors come back as they are.

        On a ``data x model`` mesh every ``model`` rank of a data row holds
        the same samples and computes the same loss and the same whole
        gradients (of a split parameter, its block of them: the split
        layers' collectives make them whole), so the reduction runs over
        ``data`` alone and never divides by the size of ``model``."""
        if state.mesh is None:
            return [t.detach() for t in tensors]
        data = self._data_axis(state)
        dtype = reduce(torch.promote_types, (t.dtype for t in tensors))
        w = torch.as_tensor(weight, device=tensors[0].device).to(dtype).reshape(1)
        total = all_reduce(w, data)
        w = w / torch.where(total > 0, total, torch.ones_like(total))
        flat = all_reduce(torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors]) * w,
                          data)
        parts = flat.split([t.numel() for t in tensors])
        return [p.view_as(t).to(t.dtype) for p, t in zip(parts, tensors)]

    def make_train_state(self, model: nn.Module, normalizer=None) -> State:
        optimizer, scheduler = self.optimizer.build(_params(model))
        return State(model, normalizer, optimizer, scheduler, 0)

    def apply_grads(self, state: State, grads: Sequence[torch.Tensor]) -> State:
        """Feed one step's gradients (in ``model.parameters()`` order) to the
        optimizer. They are summed into ``p.grad`` over an accumulation
        window; its last step averages, clips, updates and advances the
        schedule. ``p.grad`` keeps what the update used until the next
        window starts."""
        spec = self.optimizer
        k = spec.accumulate_grad_batches
        first, last = state.step % k == 0, state.step % k == k - 1
        params = _params(state.model)
        with torch.no_grad():
            for p, g in zip(params, grads, strict=True):
                if first:
                    # A buffer with p's strides, as the optimizer's multi-tensor
                    # path needs them; the caller's gradients stay untouched.
                    if p.grad is None:
                        p.grad = torch.empty_like(p)
                    p.grad.copy_(g)
                else:
                    p.grad.add_(g)
            if last:
                if k > 1:
                    for p in params:
                        p.grad.div_(k)
                if spec.clip_val is not None:
                    torch.nn.utils.clip_grad_value_(params, spec.clip_val)
                state.optimizer.step()
                if state.scheduler is not None:
                    state.scheduler.step()
        return replace(state, step=state.step + 1)
