"""Markov (one-step) routine for 2D torus Navier-Stokes, the main F-FNO
experiment (counterpart of ``fourierflow_tpu/routines/grid_2d_markov.py``).

Feature building (vorticity plus position channels), the epoch-0
normalizer pass, the one-step training step (normalizer accumulating up to
its cap, Gaussian input noise, relative-L2 loss), the autoregressive
rollout as a Python loop, and the rollout metrics (N-MSE, vorticity
correlation rho(t), time until rho < 0.95). Velocity, force and viscosity
channels and the shuffled-grid ablation raise NotImplementedError.
"""

from dataclasses import replace
from typing import Optional

import torch

from ..layers import (
    encode_positions,
    lp_loss_rel,
    normalizer_accumulate,
    normalizer_apply,
    normalizer_init,
    normalizer_inverse,
)
from .base import Routine, State, nan_to_9999, rho_time_until

__all__ = ["Grid2DMarkovRoutine"]


class Grid2DMarkovRoutine(Routine):
    def __init__(self, model=None, n_steps=None, num_freq_bands: int = 8, freq_base: float = 2.0,
                 low: float = 0.0, high: float = 1.0, use_position: bool = True,
                 append_force: bool = False, append_mu: bool = False,
                 max_accumulations: float = 1e6, should_normalize: bool = True,
                 use_fourier_position: bool = False, noise_std: float = 0.0,
                 use_velocity: bool = False, learn_difference: bool = False,
                 step_size: float = 1.0, k_max: int = 32, shuffle_grid: bool = False,
                 conv=None, optimizer=None, track_grad_norm: bool = False):
        super().__init__(optimizer, track_grad_norm)
        for name, on in (("use_velocity", use_velocity), ("append_force", append_force),
                         ("append_mu", append_mu), ("shuffle_grid", shuffle_grid)):
            if on:
                raise NotImplementedError(f"Grid2DMarkovRoutine {name} is not ported yet")
        # `conv` is the reference's name for the model argument.
        self.model = model if model is not None else conv
        self.n_steps = n_steps
        self.num_freq_bands, self.freq_base = num_freq_bands, freq_base
        self.low, self.high = low, high
        self.use_position = use_position
        self.max_accumulations = max_accumulations
        self.should_normalize = should_normalize
        self.use_fourier_position = use_fourier_position
        self.noise_std = noise_std
        self.learn_difference = learn_difference
        self.step_size = step_size
        self.k_max = k_max

    # --- features -----------------------------------------------------------
    def build_features(self, w: torch.Tensor) -> torch.Tensor:
        """``w [b, X, Y, 1]`` raw vorticity -> ``[b, X, Y, input_dim]``,
        before normalisation."""
        b, sx, sy, _ = w.shape
        feats = [w]
        if self.use_position:
            pos = encode_positions([sx, sy], self.low, self.high,
                                   fourier=self.use_fourier_position, max_freq=self.k_max,
                                   num_bands=self.num_freq_bands, base=self.freq_base,
                                   dtype=w.dtype, device=w.device)
            feats.append(pos[None].expand(b, *pos.shape))
        return torch.cat(feats, dim=-1)

    # --- contract -------------------------------------------------------------
    def init(self, seed: int, sample_batch, device) -> State:
        """Initialise the model from ``seed`` on ``device`` (in train mode),
        a fresh normalizer sized from ``sample_batch``, and the optimizer."""
        w = sample_batch["x"] if "x" in sample_batch else sample_batch["data"][..., :1]
        n_feats = self.build_features(torch.as_tensor(w[:1])).shape[-1]
        self.model.cpu().reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(device).train()
        normalizer = (normalizer_init(n_feats, self.max_accumulations, device=device)
                      if self.should_normalize else None)
        return self.make_train_state(self.model, normalizer)

    @torch.no_grad()
    def accumulate_step(self, state: State, batch) -> State:
        """Epoch-0 pass: gather normalizer statistics only."""
        if not self.should_normalize:
            return state
        x = self.build_features(torch.as_tensor(batch["x"], device=state.device))
        return replace(state, normalizer=normalizer_accumulate(state.normalizer, x))

    def loss_and_grads(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """The training loss of one batch of (x, y) pairs and its gradients
        in ``model.parameters()`` order. Returns ``(loss, grads,
        normalizer)``: the statistics keep accumulating up to their cap
        before they are applied, as in the reference's training mode. The
        noise ``noise_std * N(0, 1)`` on the normalized features is drawn
        from ``rng``, a generator on the state's device."""
        dev = state.device
        x = self.build_features(torch.as_tensor(batch["x"], device=dev))
        norm = state.normalizer
        if self.should_normalize:
            norm = normalizer_accumulate(norm, x)
            x = normalizer_apply(norm, x)
        if self.noise_std > 0.0:
            if rng is None:
                raise ValueError("noise_std > 0 needs a generator (rng) on the state's device")
            x = x + self.noise_std * torch.randn(x.shape, generator=rng, device=dev, dtype=x.dtype)
        targets = torch.as_tensor(batch["dy" if self.learn_difference else "y"], device=dev)
        b = x.shape[0]
        im = state.model(x)["forecast"]
        if self.should_normalize:
            im = normalizer_inverse(norm, im, channel=0)
        loss = lp_loss_rel(im.reshape(b, -1), targets.reshape(b, -1))
        grads = torch.autograd.grad(loss, list(state.model.parameters()))
        return loss.detach(), grads, norm

    def train_step(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """One optimizer step on one batch; returns ``(state, {"train_loss"})``."""
        loss, grads, norm = self.loss_and_grads(state, batch, rng)
        metrics = self.with_grad_norm({"train_loss": loss}, grads)
        return self.apply_grads(replace(state, normalizer=norm), grads), metrics

    def rollout(self, state: State, batch):
        """Autoregressive rollout over the trailing ``n_steps`` of
        ``batch["data"] [b, X, Y, T]``, re-building features from each
        prediction. Returns ``(preds [b, X, Y, n], step_losses [n], yy)``.
        The model runs in eval mode and is put back in the mode it was in."""
        training = state.model.training
        state.model.eval()
        try:
            return self._rollout(state, batch)
        finally:
            state.model.train(training)

    def rollout_step(self, model, norm, im: torch.Tensor):
        """One step of the rollout from ``im [b, X, Y, 1]``: its features,
        normalized by ``norm`` (anything with the normalizer's ``mean`` and
        ``std``) where the routine normalizes, the model, denormalized.
        Returns ``(out, next im)``; with ``learn_difference`` the model's
        output is added to ``im``."""
        x = self.build_features(im)
        if self.should_normalize:
            x = normalizer_apply(norm, x)
        out = model(x)["forecast"]
        if self.should_normalize:
            out = normalizer_inverse(norm, out, channel=0)
        return out, (im + out if self.learn_difference else out)

    @torch.no_grad()
    def _rollout(self, state: State, batch):
        data = torch.as_tensor(batch["data"], device=state.device)
        b, t_total = data.shape[0], data.shape[-1]
        # Clamp to the available horizon.
        n_steps = min(self.n_steps or t_total - 1, t_total - 1)
        w0 = data[..., -n_steps - 1, None]
        yy = data[..., -n_steps:]
        im = w0
        preds, step_losses = [], []
        for t in range(n_steps):
            out, im = self.rollout_step(state.model, state.normalizer, im)
            if self.learn_difference:
                # The true previous state at t=0, the previous target after.
                prev = w0[..., 0] if t == 0 else yy[..., t - 1]
                target = yy[..., t] - prev
            else:
                target = yy[..., t]
            step_losses.append(lp_loss_rel(out.reshape(b, -1), target.reshape(b, -1)))
            preds.append(im[..., 0])
        return torch.stack(preds, dim=-1), torch.stack(step_losses), yy

    def compute_losses(self, preds, step_losses, yy):
        """Mean step loss, full-field N-MSE (NaN reads 9999.9), rho(t) and
        the time until rho < 0.95."""
        b = preds.shape[0]
        loss = step_losses.mean()
        loss_full = lp_loss_rel(preds.reshape(b, -1), yy.reshape(b, -1))
        p, time_until = rho_time_until(preds, yy, self.step_size)
        return {
            "loss_avg": nan_to_9999(loss),
            "loss": nan_to_9999(loss_full),
            "time_until": time_until,
            "corr": p.mean(),
            "correlations": p,
            "step_losses": step_losses,
        }

    def valid_step(self, state: State, batch):
        preds, step_losses, yy = self.rollout(state, batch)
        return self.compute_losses(preds, step_losses, yy)
