"""The learned-interpolation routine (Kochkov et al. 2021), the counterpart
of ``fourierflow_tpu/routines/learned_interpolator.py``.

One model application advances a whole coarse step ``dt`` (about 32 times
the DNS step of its grid). Training unrolls ``unroll_length`` steps from a
true velocity against the true velocities after each; validation unrolls
``n`` snapshots of ``inner_steps`` model steps each, downsamples each to
the 32^2 reference grid, and scores the vorticity correlation rho(t) and
the time until rho < 0.95.

Batches: training ``(inputs, outputs)`` with ``inputs = {"vx", "vy"}``
``[b, X, Y]`` and ``outputs = {"vx", "vy"}`` ``[b, X, Y, L]``
(``builders.KolmogorovVelocityDataset``); validation ``{"vx", "vy",
"targets" [b, 32, 32, n], "times"}``
(``builders.KolmogorovVelocityTrajectoryDataset``).

On a ``data`` mesh the loss and its gradients, and the validation's
correlations, are means over the whole batch (``Routine.mean_over_data``);
the time until rho < 0.95 is read off the whole batch's mean, ``times`` is
the whole batch's first row and ``weight`` its size. On ``data x model``
the model runs whole on every ``model`` rank (JAX splits none of its
leaves), each rank of a data row computing the same step.
"""

from typing import Optional

import numpy as np
import torch

from ..models.learned_interpolation import LearnedInterpolationStep
from ..utils.grids import Grid
from ..utils.spectral import (downsample_staggered_velocity, grid_correlation,
                              velocity_to_vorticity_fd)
from ..parallel.collectives import all_reduce
from .base import Routine, State, time_until

__all__ = ["LearnedInterpolatorRoutine"]

TWO_PI = 2 * np.pi


class LearnedInterpolatorRoutine(Routine):
    should_normalize = False
    mesh_axes = ("data", "model")
    splits_eval_batches = True

    def __init__(self, size: int, dt: float = 0.007012483601762931, inner_steps: int = 16,
                 outer_steps: int = 100, unroll_length: int = 32, density: float = 1.0,
                 viscosity: float = 1e-3, forcing_wavenumber: int = 4, forcing_scale: float = 1.0,
                 drag: float = 0.1, features: int = 64, n_cnn_layers: int = 6, optimizer=None,
                 track_grad_norm: bool = False, **kwargs):
        super().__init__(optimizer, track_grad_norm)
        self.size = size
        self.inner_steps = inner_steps
        self.outer_steps = outer_steps
        self.unroll_length = unroll_length
        self.step_size = dt * inner_steps  # simulated time between validation snapshots
        self.sim_grid = Grid((size, size), domain=((0, TWO_PI), (0, TWO_PI)))
        self.out_grid = Grid((32, 32), domain=((0, TWO_PI), (0, TWO_PI)))
        self.model = LearnedInterpolationStep(
            size=size, dt=dt, density=density, viscosity=viscosity,
            forcing_wavenumber=forcing_wavenumber, forcing_scale=forcing_scale, drag=drag,
            features=features, n_cnn_layers=n_cnn_layers)

    def init(self, seed: int, sample_batch, device) -> State:
        """Initialise the model from ``seed`` on ``device`` (``sample_batch``,
        an ``(inputs, outputs)`` tuple or a dict, is not needed: the model's
        shapes come from the config) and the optimizer."""
        self.model.cpu().reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(device).train()
        return self.make_train_state(self.model)

    # --- training ------------------------------------------------------------------
    def _loss(self, model, inputs, outputs, device) -> torch.Tensor:
        """The sum over the unroll, X and Y of the batch mean of ``0.5 (pred
        - true)^2``, for both components."""
        u = torch.as_tensor(inputs["vx"], device=device)
        v = torch.as_tensor(inputs["vy"], device=device)
        vx_t = torch.as_tensor(outputs["vx"], device=device)
        vy_t = torch.as_tensor(outputs["vy"], device=device)
        loss = 0.0
        for t in range(self.unroll_length):
            u, v = model(u, v)
            loss = loss + (0.5 * (u - vx_t[..., t]) ** 2).mean(0).sum()
            loss = loss + (0.5 * (v - vy_t[..., t]) ** 2).mean(0).sum()
        return loss

    @staticmethod
    def _split(batch):
        return batch if isinstance(batch, tuple) else (batch["inputs"], batch["outputs"])

    def loss_and_grads(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """One batch's loss and its gradients, in ``model.parameters()``
        order: ``(loss, grads)``, of the whole batch on a mesh."""
        inputs, outputs = self._split(batch)
        loss = self._loss(state.model, inputs, outputs, state.device)
        grads = torch.autograd.grad(loss, list(state.model.parameters()))
        loss, *grads = self.mean_over_data(state, [loss, *grads], len(inputs["vx"]))
        return loss, grads

    def train_step(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """One optimizer step; returns ``(state, {"train_loss"[, "grad_norm"]})``."""
        loss, grads = self.loss_and_grads(state, batch)
        metrics = self.with_grad_norm({"train_loss": loss}, grads)
        return self.apply_grads(state, grads), metrics

    # --- validation ----------------------------------------------------------------
    def _vorticity_32(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The finite-difference vorticity at 32^2 (the velocities
        downsampled first where the grid is larger)."""
        if self.size > 32:
            u, v = downsample_staggered_velocity(self.sim_grid, self.out_grid, (u, v))
        return velocity_to_vorticity_fd(u, v, self.out_grid)

    @torch.no_grad()
    def valid_step(self, state: State, batch):
        """The rollout of ``n`` snapshots (``n`` the targets' last axis) of
        ``inner_steps`` model steps: the batch-mean correlation with the
        targets at each (NaN read as 0), its mean (``rho``, and ``loss`` =
        -rho), and the time until it first drops below 0.95
        (``reduced_time_until``; all of the rollout when it never does)."""
        dev = state.device
        u = torch.as_tensor(batch["vx"], device=dev)
        v = torch.as_tensor(batch["vy"], device=dev)
        targets = torch.as_tensor(batch["targets"], device=dev)  # [b, 32, 32, n]
        preds = []
        for _ in range(targets.shape[-1]):
            for _ in range(self.inner_steps):
                u, v = state.model(u, v)
            preds.append(self._vorticity_32(u, v))
        preds = torch.stack(preds, -1)  # [b, 32, 32, n]
        rho = torch.nan_to_num(grid_correlation(preds, targets, dims=(1, 2))).mean(0)  # [n]
        rho, = self.mean_over_data(state, [rho], u.shape[0])
        times = batch["times"][0]
        times = (times.float() if isinstance(times, torch.Tensor)
                 else torch.from_numpy(np.array(times, np.float32)))
        data = self.data_block(state, batch, "times")
        if data is not None:  # the whole batch's first row: data rank 0's
            times = all_reduce(times.to(dev) * (data.rank == 0), data).cpu()
        return {"loss": -rho.mean(), "rho": rho.mean(),
                "reduced_time_until": time_until(rho, self.step_size), "correlations": rho,
                "times": times,
                "weight": torch.tensor(float(self.global_count(state, batch, "vx")))}
