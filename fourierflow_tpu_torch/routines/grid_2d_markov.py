"""Markov (one-step) routine for 2D torus Navier-Stokes, the main F-FNO
experiment and the torus_vis ones (counterpart of
``fourierflow_tpu/routines/grid_2d_markov.py``).

Feature building (vorticity, the velocity recovered from it spectrally,
position channels, the force and the viscosity), the epoch-0 normalizer
pass, the one-step training step (normalizer accumulating up to its cap,
Gaussian input noise, the shuffled-grid ablation, relative-L2 loss), the
autoregressive rollout as a Python loop with a static or a time-varying
force, and the rollout metrics (N-MSE, vorticity correlation rho(t), time
until rho < 0.95). A batch with ``corr_data`` (the Kolmogorov protocol's
independently made reference at a reduced resolution, 32^2) adds the
reduced metrics: the predictions are downsampled spectrally to its grid and
correlated with it. ``save_predictions`` writes a rollout's vorticity and
velocities (downsampled to 64^2 when larger) to an HDF5 file. The rollout
runs at the grid of the data it is given, so a model trained at one
resolution is evaluated at another (super-resolution) as it is.

On a device mesh (``state.mesh``) a batch is this rank's slice
(``parallel.shard_batch``, whose ``specs`` say which dims are split): the
normalizer's sums, squares and count are summed over the split axes
(``data``, ``spatial``); the noise is drawn for the whole batch and grid
from the step's generator and each rank takes its block, so a split fit
sees the noise of the unsplit one; the features of a grid split over
``spatial`` are built on the whole grid (its vorticity and force
all-gathered: the velocity is spectral) and cut back to the rank's rows,
which gives the positions of those rows; the relative L2 loss sums each
sample's squares over ``spatial`` before the ratio; the shuffled grid is
permuted whole (the features gathered, the forecast through
``gather_rows``) and each rank keeps its rows; the gradients and the loss
are reduced over the mesh (``Routine.reduce_over_mesh``). A validation
batch split over ``spatial`` rolls out on the rows and gathers the
predictions for the metrics.
"""

import logging
import os
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..layers import (
    WNLinear,
    encode_positions,
    lp_loss_rel,
    normalizer_accumulate,
    normalizer_apply,
    normalizer_init,
    normalizer_inverse,
)
from ..ops.fourier import irfft2
from ..parallel.collectives import all_gather, all_reduce, gather_rows, mesh_axis, reduce_from
from ..parallel.mesh import shard_tensor
from ..utils.grids import TORUS, Grid, velocity_from_vorticity
from ..utils.hdf5 import H5Writer
from ..utils.spectral import (downsample_vorticity, downsample_vorticity_hat,
                              vorticity_to_velocity_solve)
from .base import Routine, State, nan_to_9999, rho_time_until

logger = logging.getLogger(__name__)

__all__ = ["Grid2DMarkovRoutine"]


def _spec(batch, key: str):
    """The mesh axes of ``batch[key]``'s leading dims (``()`` where the
    batch carries none: a whole batch)."""
    specs = getattr(batch, "specs", None)
    return tuple(specs.get(key, ())) if specs else ()


def _rel_l2(pred: torch.Tensor, target: torch.Tensor, sp) -> torch.Tensor:
    """``lp_loss_rel`` of ``[b, ...]`` arrays; with the ``spatial`` axis ``sp``
    each sample's squares are summed over the axis's ranks first (its
    gradient flows to each rank's own rows)."""
    b = pred.shape[0]
    if sp is None:
        return lp_loss_rel(pred.reshape(b, -1), target.reshape(b, -1))
    t = target.reshape(b, -1)
    d = pred.reshape(b, -1) - t
    sq = reduce_from(torch.stack([d.square().sum(dim=1), t.square().sum(dim=1)]), sp)
    return (torch.sqrt(sq[0]) / torch.sqrt(sq[1])).mean()


class Grid2DMarkovRoutine(Routine):
    # Trains on a device mesh (Trainer(data_parallel / tensor_parallel /
    # spatial_parallel)).
    mesh_axes = ("data", "model", "spatial")

    def __init__(self, model=None, n_steps=None, num_freq_bands: int = 8, freq_base: float = 2.0,
                 low: float = 0.0, high: float = 1.0, use_position: bool = True,
                 append_force: bool = False, append_mu: bool = False,
                 max_accumulations: float = 1e6, should_normalize: bool = True,
                 use_fourier_position: bool = False, noise_std: float = 0.0,
                 use_velocity: bool = False, learn_difference: bool = False,
                 step_size: float = 1.0, k_max: int = 32,
                 domain=TORUS, shuffle_grid: bool = False,
                 grid_size=(64,), pred_path=None, conv=None, optimizer=None,
                 track_grad_norm: bool = False):
        super().__init__(optimizer, track_grad_norm)
        self.pred_path = pred_path
        # `conv` is the reference's name for the model argument.
        self.model = model if model is not None else conv
        self.n_steps = n_steps
        self.num_freq_bands, self.freq_base = num_freq_bands, freq_base
        self.low, self.high = low, high
        self.use_position = use_position
        self.append_force, self.append_mu = append_force, append_mu
        self.max_accumulations = max_accumulations
        self.should_normalize = should_normalize
        self.use_fourier_position = use_fourier_position
        self.noise_std = noise_std
        self.use_velocity = use_velocity
        self.learn_difference = learn_difference
        self.step_size = step_size
        self.k_max = k_max
        self.domain = domain
        # Everything the routine reads is built from the vorticity (the
        # velocity recovered in build_features), so the Trainer's
        # device-resident epoch uploads only "w".
        self.device_data_fields = ("w",)
        # The shuffled-grid ablation: one fixed permutation of each axis,
        # applied to the model's input in training and undone on its output.
        self.shuffle_grid = shuffle_grid
        if shuffle_grid:
            if isinstance(grid_size, int):
                grid_size = (grid_size,)
            if len(grid_size) != 1:
                raise ValueError("shuffle_grid takes one grid size")
            rs = np.random.RandomState(0)
            self.x_idx = torch.from_numpy(rs.permutation(grid_size[0]))
            self.y_idx = torch.from_numpy(rs.permutation(grid_size[0]))
            self.x_inv, self.y_inv = torch.argsort(self.x_idx), torch.argsort(self.y_idx)
            self._on_device = {}  # the four permutations by device, copied there once

    # --- features -----------------------------------------------------------
    def build_features(self, w: torch.Tensor, force: Optional[torch.Tensor] = None,
                       mu: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``w [b, X, Y, 1]`` raw vorticity -> ``[b, X, Y, input_dim]``,
        before normalisation: w, then the velocity (u, v), the positions,
        the force (``[b, X, Y]``, or ``[b, X, Y, c]`` as it is) and the
        viscosity ``mu [b]`` broadcast over the grid."""
        b, sx, sy, _ = w.shape
        feats = [w]
        if self.use_velocity:
            u, v = velocity_from_vorticity(w[..., 0], self.domain)
            feats += [u[..., None], v[..., None]]
        if self.use_position:
            pos = encode_positions([sx, sy], self.low, self.high,
                                   fourier=self.use_fourier_position, max_freq=self.k_max,
                                   num_bands=self.num_freq_bands, base=self.freq_base,
                                   dtype=w.dtype, device=w.device, exact=True)
            feats.append(pos[None].expand(b, *pos.shape))
        if self.append_force:
            force = torch.as_tensor(force, device=w.device)
            feats.append(force if force.dim() == 4 else force[..., None])
        if self.append_mu:
            mu = torch.as_tensor(mu, device=w.device, dtype=w.dtype)
            feats.append(mu[:, None, None, None].expand(b, sx, sy, 1))
        return torch.cat(feats, dim=-1)

    def _batch_features(self, batch, device) -> torch.Tensor:
        """The features of a batch of training pairs (``x``, ``f``, ``mu``)."""
        return self.build_features(torch.as_tensor(batch["x"], device=device), batch.get("f"),
                                   batch.get("mu"))

    def _fit_input_layer(self, n_feats: int) -> None:
        """Size the model's input layer to the routine's features, as flax
        infers it from the data: a configured ``input_dim`` that differs is
        replaced (and logged)."""
        old = getattr(self.model, "in_proj", None)
        if not isinstance(old, WNLinear) or old.in_features == n_feats:
            return
        logger.info("%s input_dim %d -> %d, the routine's feature channels",
                    type(self.model).__name__, old.in_features, n_feats)
        self.model.in_proj = WNLinear(n_feats, old.out_features, wnorm=old.wnorm,
                                      use_bias=old.bias is not None, dtype=old.dtype)

    # --- contract -------------------------------------------------------------
    def init(self, seed: int, sample_batch, device) -> State:
        """Initialise the model from ``seed`` on ``device`` (in train mode),
        its input layer sized to the features of ``sample_batch``, a fresh
        normalizer and the optimizer."""
        if "x" in sample_batch:
            w, f = sample_batch["x"][:1], sample_batch.get("f")
        else:  # whole trajectories: the first frame, and its force
            w, f = sample_batch["data"][:1, ..., :1], sample_batch.get("f")
            if f is not None and np.ndim(f) == 4:
                f = f[..., 0]
        mu = sample_batch.get("mu")
        n_feats = self.build_features(torch.as_tensor(w), None if f is None else f[:1],
                                      None if mu is None else mu[:1]).shape[-1]
        self._fit_input_layer(n_feats)
        self.model.cpu().reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(device).train()
        normalizer = (normalizer_init(n_feats, self.max_accumulations, device=device)
                      if self.should_normalize else None)
        return self.make_train_state(self.model, normalizer)

    def _mesh_features(self, state: State, batch, sp) -> torch.Tensor:
        """The features of a batch on a mesh: where ``sp`` (the ``spatial``
        axis) splits its grid, built on the whole grid and cut back to this
        rank's rows."""
        dev = state.device
        if sp is None:
            return self._batch_features(batch, dev)
        whole = lambda k: (None if batch.get(k) is None else
                           all_gather(torch.as_tensor(batch[k], device=dev), sp, 1)
                           if _spec(batch, k)[1:2] == ("spatial",) else batch[k])
        return shard_tensor(self.build_features(whole("x"), whole("f"), batch.get("mu")), 1, sp)

    def _accumulate(self, state: State, norm, x, spec):
        """``normalizer_accumulate`` with the batch's statistics summed over
        the mesh axes that split it."""
        axes = [a for a in self._split_axes(state, spec) if a is not None]
        if not axes:
            return normalizer_accumulate(norm, x)

        def reduce(t):
            for axis in axes:
                t = all_reduce(t, axis)
            return t
        return normalizer_accumulate(norm, x, all_reduce=reduce)

    def _split_axes(self, state: State, spec):
        """The ``data`` and ``spatial`` axes that split a batch of ``spec``
        (None where the axis does not split it)."""
        data = mesh_axis(state.mesh, "data") if spec[:1] == ("data",) else None
        sp = mesh_axis(state.mesh, "spatial") if spec[1:2] == ("spatial",) else None
        return data, sp

    @torch.no_grad()
    def accumulate_step(self, state: State, batch) -> State:
        """Epoch-0 pass: gather normalizer statistics only."""
        if not self.should_normalize:
            return state
        spec = _spec(batch, "x")
        x = self._mesh_features(state, batch, self._split_axes(state, spec)[1])
        return replace(state, normalizer=self._accumulate(state, state.normalizer, x, spec))

    def _permutations(self, device):
        """``(x_idx, y_idx, x_inv, y_inv)`` on ``device``."""
        if device not in self._on_device:
            self._on_device[device] = tuple(
                t.to(device) for t in (self.x_idx, self.y_idx, self.x_inv, self.y_inv))
        return self._on_device[device]

    def loss_and_grads(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """The training loss of one batch of (x, y) pairs and its gradients
        in ``model.parameters()`` order. Returns ``(loss, grads,
        normalizer)``: the statistics keep accumulating up to their cap
        before they are applied, as in the reference's training mode. The
        noise ``noise_std * N(0, 1)`` on the normalized features is drawn
        from ``rng``, a generator on the state's device. With
        ``shuffle_grid`` the model sees the grid permuted (after the noise)
        and its output is permuted back before the normalizer's inverse."""
        dev = state.device
        spec = _spec(batch, "x")
        data, sp = self._split_axes(state, spec)
        x = self._mesh_features(state, batch, sp)
        norm = state.normalizer
        if self.should_normalize:
            norm = self._accumulate(state, norm, x, spec)
            x = normalizer_apply(norm, x)
        if self.noise_std > 0.0:
            if rng is None:
                raise ValueError("noise_std > 0 needs a generator (rng) on the state's device")
            # Drawn for the whole batch and grid; this rank's block of it.
            shape = list(x.shape)
            for dim, axis in ((0, data), (1, sp)):
                if axis is not None:
                    shape[dim] *= axis.size
            noise = torch.randn(shape, generator=rng, device=dev, dtype=x.dtype)
            x = x + self.noise_std * shard_tensor(shard_tensor(noise, 0, data), 1, sp)
        if self.shuffle_grid:
            # On a split grid the permutations act on the whole of it: the
            # features (no gradient) gathered and this rank's rows of them
            # taken, the forecast gathered by gather_rows (its gradient summed
            # over the axis) and this rank's rows of it taken.
            x_idx, y_idx, x_inv, y_inv = self._permutations(dev)
            whole = x if sp is None else all_gather(x, sp, 1)
            x = shard_tensor(whole[:, x_idx][:, :, y_idx], 1, sp)
        if self.learn_difference and "dy" not in batch:
            # The JAX routine reads batch["dy"] too, and raises KeyError: 'dy'.
            raise ValueError("learn_difference trains on the batch's 'dy' (the change over each "
                             "pair), which this builder does not give (it gives "
                             f"{sorted(batch)})")
        targets = torch.as_tensor(batch["dy" if self.learn_difference else "y"], device=dev)
        im = state.model(x)["forecast"]
        if self.shuffle_grid:
            whole = im if sp is None else gather_rows(im, sp)
            im = shard_tensor(whole[:, :, y_inv][:, x_inv], 1, sp)
        if self.should_normalize:
            im = normalizer_inverse(norm, im, channel=0)
        loss = _rel_l2(im, targets, sp)
        grads = torch.autograd.grad(loss, list(state.model.parameters()))
        grads, loss = self.reduce_over_mesh(state, grads, loss.detach(), spec)
        return loss, grads, norm

    def train_step(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """One optimizer step on one batch; returns ``(state, {"train_loss"})``."""
        loss, grads, norm = self.loss_and_grads(state, batch, rng)
        metrics = self.with_grad_norm({"train_loss": loss}, grads)
        return self.apply_grads(replace(state, normalizer=norm), grads), metrics

    def rollout(self, state: State, batch):
        """Autoregressive rollout over the trailing ``n_steps`` of
        ``batch["data"] [b, X, Y, T]``, re-building features from each
        prediction, with the batch's force (``f``: static ``[b, X, Y]``, or
        ``[b, X, Y, T]`` of which step t takes ``f[..., T - n_steps + t]``)
        and viscosity (``mu [b]``). Returns ``(preds [b, X, Y, n],
        step_losses [n], yy)``. The model runs in eval mode and is put back
        in the mode it was in. The grid is not shuffled, as in the
        reference."""
        training = state.model.training
        state.model.eval()
        try:
            return self._rollout(state, batch)
        finally:
            state.model.train(training)

    def rollout_step(self, model, norm, im: torch.Tensor, force: Optional[torch.Tensor] = None,
                     mu: Optional[torch.Tensor] = None, sp=None):
        """One step of the rollout from ``im [b, X, Y, 1]`` with this step's
        force and viscosity: its features, normalized by ``norm`` (anything
        with the normalizer's ``mean`` and ``std``) where the routine
        normalizes, the model, denormalized. Returns ``(out, next im)``;
        with ``learn_difference`` the model's output is added to ``im``.
        With the ``spatial`` axis ``sp``, ``im`` and ``force`` are this rank's
        rows of the grid, whose features are built from it all."""
        if sp is None:
            x = self.build_features(im, force, mu)
        else:
            whole = lambda t: None if t is None else all_gather(t, sp, 1)
            x = shard_tensor(self.build_features(whole(im), whole(force), mu), 1, sp)
        if self.should_normalize:
            x = normalizer_apply(norm, x)
        out = model(x)["forecast"]
        if self.should_normalize:
            out = normalizer_inverse(norm, out, channel=0)
        return out, (im + out if self.learn_difference else out)

    @torch.no_grad()
    def _rollout(self, state: State, batch):
        dev = state.device
        sp = self._split_axes(state, _spec(batch, "data"))[1]
        data = torch.as_tensor(batch["data"], device=dev)
        b, t_total = data.shape[0], data.shape[-1]
        # Clamp to the available horizon.
        n_steps = min(self.n_steps or t_total - 1, t_total - 1)
        w0 = data[..., -n_steps - 1, None]
        yy = data[..., -n_steps:]
        force = batch.get("f") if self.append_force else None
        if force is not None:
            force = torch.as_tensor(force, device=dev)
        mu = batch.get("mu") if self.append_mu else None
        im = w0
        preds, step_losses = [], []
        for t in range(n_steps):
            f_t = force
            if force is not None and force.dim() == 4:
                f_t = force[..., force.shape[-1] - n_steps + t]
            out, im = self.rollout_step(state.model, state.normalizer, im, f_t, mu, sp)
            if self.learn_difference:
                # The true previous state at t=0, the previous target after.
                prev = w0[..., 0] if t == 0 else yy[..., t - 1]
                target = yy[..., t] - prev
            else:
                target = yy[..., t]
            step_losses.append(_rel_l2(out, target, sp))
            preds.append(im[..., 0])
        return torch.stack(preds, dim=-1), torch.stack(step_losses), yy

    def compute_losses(self, preds, step_losses, yy, corr_yy=None):
        """Mean step loss, full-field N-MSE (NaN reads 9999.9), rho(t) and
        the time until rho < 0.95. With ``corr_yy [b, cX, cY, n]``, a
        reference at a reduced resolution, the predictions are downsampled
        spectrally to its grid (``utils.spectral.downsample_vorticity``)
        and give ``reduced_correlations``, their mean ``reduced_corr`` and
        ``reduced_time_until``."""
        b = preds.shape[0]
        loss = step_losses.mean()
        loss_full = lp_loss_rel(preds.reshape(b, -1), yy.reshape(b, -1))
        p, time_until = rho_time_until(preds, yy, self.step_size)
        metrics = {
            "loss_avg": nan_to_9999(loss),
            "loss": nan_to_9999(loss_full),
            "time_until": time_until,
            "corr": p.mean(),
            "correlations": p,
            "step_losses": step_losses,
        }
        if corr_yy is not None:
            corr_yy = torch.as_tensor(corr_yy, device=preds.device)
            size = corr_yy.shape[1]
            preds_2 = (downsample_vorticity(preds, size, self.domain) if preds.shape[1] != size
                       else preds)
            p_2, reduced_time_until = rho_time_until(preds_2, corr_yy, self.step_size)
            metrics.update(reduced_time_until=reduced_time_until, reduced_corr=p_2.mean(),
                           reduced_correlations=p_2)
        return metrics

    def valid_step(self, state: State, batch):
        preds, step_losses, yy = self.rollout(state, batch)
        corr_yy = None
        if "corr_data" in batch:  # the same trailing horizon as the rollout's targets
            corr_yy = batch["corr_data"][..., -preds.shape[-1]:]
        sp = self._split_axes(state, _spec(batch, "data"))[1]
        if sp is not None:  # the metrics of the whole grid
            preds, yy = all_gather(preds, sp, 1), all_gather(yy, sp, 1)
            if corr_yy is not None and _spec(batch, "corr_data")[1:2] == ("spatial",):
                corr_yy = all_gather(torch.as_tensor(corr_yy, device=preds.device), sp, 1)
        return self.compute_losses(preds, step_losses, yy, corr_yy)

    @torch.no_grad()
    def save_predictions(self, preds, times=None, path=None) -> str:
        """Write rollout predictions ``preds [b, X, Y, T]`` to the HDF5 file
        ``path`` (``pred_path`` by default): ``vorticity``, ``vx`` and ``vy``
        ``[sample, x, y, time]`` (the velocities recovered spectrally; all
        three downsampled to 64^2 through the velocity when the grid is
        larger), ``time`` where given, and the cell centres ``x`` and ``y``
        of the written grid. Returns the path."""
        path = path or self.pred_path
        preds = torch.as_tensor(preds, dtype=torch.float32)
        b, sx, sy, t = preds.shape
        sim_grid = Grid((sx, sy), domain=self.domain)
        out_size = min(sx, 64)
        out_grid = Grid((out_size, out_size), domain=self.domain)
        solve = vorticity_to_velocity_solve(sim_grid)
        w_hat = torch.fft.rfft2(preds.movedim(-1, 1))  # [b, T, X, Y//2+1]
        if sx > 64:
            out = downsample_vorticity_hat(w_hat, solve, sim_grid, out_grid)
            vx, vy, w = out["vx"], out["vy"], out["vorticity"]
        else:
            vx, vy = irfft2(torch.stack(solve(w_hat)), (sx, sy))
            w = preds.movedim(-1, 1)
        fields = {name: a.movedim(1, -1).cpu().numpy()
                  for name, a in (("vorticity", w), ("vx", vx), ("vy", vy))}
        xs, ys = out_grid.axes()
        extra = {"x": xs, "y": ys}
        if times is not None:
            extra["time"] = np.asarray(times)
        layout = {name: (a.shape, a.dtype) for name, a in {**fields, **extra}.items()}
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with H5Writer(path, layout, atomic=True) as f:
            for name, a in {**fields, **extra}.items():
                f.write(name, 0, a)
        return path
