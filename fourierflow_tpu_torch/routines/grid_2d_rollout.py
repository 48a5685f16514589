"""Full-rollout routine, the Li et al. reproduction (counterpart of
``fourierflow_tpu/routines/grid_2d_rollout.py``): a 10-step input window,
unrolled autoregressively over the target steps with a shifted window, as
a Python loop; training backpropagates through the whole unroll.

The window is ``x [b, X, Y, window (+2 position channels)]``: each step
drops the oldest field and appends the prediction (the target instead,
under ``teacher_forcing`` in training), keeping the position channels
last. With ``use_fourier_position`` the raw window goes through a learned
linear layer into the Fourier position features, to which the fixed
encodings are added; the state's model is then ``conv`` and ``in_proj``
together (``FourierPositionNet``).

On a ``data`` mesh (``Trainer(data_parallel)``) each rank unrolls its block
of the batch; the losses, the gradients and the validation's per-step
losses and correlations are means over the whole batch
(``Routine.mean_over_data``), and the time until rho < 0.95 is read off the
whole batch's mean correlation. On ``data x model`` (``Trainer(tensor_parallel)``)
the ``model`` ranks of a data row unroll the same block with the model's
split form (``set_parallel``; ``FourierPositionNet`` passes it on to
``conv``), whose collectives make the loss and the gradients whole.
"""

from typing import Optional

import torch
import torch.nn as nn

from ..layers import WNLinear, encode_positions, lp_loss_rel
from .base import Routine, State, correlations, nan_to_9999, time_until

__all__ = ["Grid2DRolloutRoutine", "FourierPositionNet"]


class FourierPositionNet(nn.Module):
    """The model of the Fourier-position variant: ``in_proj`` (window ->
    position features, torch's default init) and the operator ``conv``."""

    def __init__(self, conv: nn.Module, window: int, pos_size: int):
        super().__init__()
        self.in_proj = WNLinear(window, pos_size)
        self.conv = conv

    def reset_parameters(self, generator=None) -> None:
        self.in_proj.reset_parameters(generator)
        self.conv.reset_parameters(generator)

    def set_parallel(self, tensor=None, spatial=None) -> None:
        """``conv``'s parallel axes (``in_proj`` stays whole on every rank);
        a ``conv`` without a parallel form raises the ``NotImplementedError``
        that names it."""
        if not hasattr(self.conv, "set_parallel"):
            raise NotImplementedError(f"{type(self.conv).__name__} has no tensor- or "
                                      "spatial-parallel form")
        self.conv.set_parallel(tensor=tensor, spatial=spatial)


class Grid2DRolloutRoutine(Routine):
    # No normalizer: every epoch trains.
    should_normalize = False
    mesh_axes = ("data", "model")
    splits_eval_batches = True

    def __init__(self, model=None, n_steps: int = 10, k_max: int = 32, num_freq_bands: int = 8,
                 freq_base: float = 2.0, use_fourier_position: bool = False,
                 append_pos: bool = True, teacher_forcing: bool = False, step_size: float = 1.0,
                 optimizer=None, conv=None, track_grad_norm: bool = False, **kwargs):
        super().__init__(optimizer, track_grad_norm)
        # `conv` is the reference's name for the model argument.
        self.model = model if model is not None else conv
        self.n_steps = n_steps
        self.k_max = k_max
        self.num_freq_bands = num_freq_bands
        self.freq_base = freq_base
        self.use_fourier_position = use_fourier_position
        self.append_pos = append_pos
        self.teacher_forcing = teacher_forcing
        self.step_size = step_size
        self.pos_size = 2 * (2 * num_freq_bands + 1)

    def init(self, seed: int, sample_batch, device) -> State:
        """Initialise the model (with ``in_proj`` for Fourier positions, its
        window the input channels less the builder's two position channels)
        from ``seed`` on ``device``, in train mode, and the optimizer."""
        net = self.model
        if self.use_fourier_position:
            window = sample_batch["x"].shape[-1] - (2 if self.append_pos else 0)
            net = FourierPositionNet(self.model, window, self.pos_size)
        net.cpu().reset_parameters(torch.Generator().manual_seed(seed))
        net.to(device).train()
        return self.make_train_state(net)

    def _unroll(self, net: nn.Module, xx: torch.Tensor, yy: torch.Tensor, training: bool):
        """``xx [b, X, Y, window (+2)]``, ``yy [b, X, Y, T]``. Returns the
        batch means (loss, loss_full, step_losses [T], rho [T]) and the
        predictions."""
        b, sx, sy, _ = xx.shape
        p_chan = 2 if self.append_pos else 0
        if self.use_fourier_position:
            conv = net.conv
            pos_feats = encode_positions([sx, sy], fourier=True, max_freq=self.k_max,
                                         num_bands=self.num_freq_bands, base=self.freq_base,
                                         dtype=xx.dtype, device=xx.device)
            carry = xx[..., :-2] if self.append_pos else xx  # the builder's linspace channels
        else:
            conv = net
            ticks = torch.linspace(0, 1, sx, dtype=xx.dtype, device=xx.device)
            pos_feats = torch.cat([ticks[None, :, None, None].expand(b, sx, sy, 1),
                                   ticks[None, None, :, None].expand(b, sx, sy, 1)], dim=-1)
            carry = xx

        preds, step_losses = [], []
        for t in range(yy.shape[-1]):
            y_t = yy[..., t]
            embeds = net.in_proj(carry) + pos_feats if self.use_fourier_position else carry
            out = conv(embeds)["forecast"]
            step_losses.append(lp_loss_rel(out.reshape(b, -1), y_t.reshape(b, -1)))
            im = y_t[..., None] if self.teacher_forcing and training else out
            if self.use_fourier_position or not self.append_pos:
                carry = torch.cat([carry[..., 1:], im], dim=-1)
            else:
                carry = torch.cat([carry[..., 1:-p_chan], im, pos_feats], dim=-1)
            preds.append(out[..., 0])
        preds, step_losses = torch.stack(preds, dim=-1), torch.stack(step_losses)

        loss = step_losses.mean()
        loss_full = lp_loss_rel(preds.reshape(b, -1), yy.reshape(b, -1))
        return loss, loss_full, step_losses, correlations(preds, yy).mean(dim=0), preds

    def _batch(self, state: State, batch):
        dev = state.device
        return (torch.as_tensor(batch["x"], device=dev), torch.as_tensor(batch["y"], device=dev))

    def loss_and_grads(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """The mean step loss of one batch's unroll, its gradients in
        ``model.parameters()`` order, and the full-field loss: ``(loss,
        grads, loss_full)``, of the whole batch on a mesh."""
        xx, yy = self._batch(state, batch)
        loss, loss_full, *_ = self._unroll(state.model, xx, yy, training=True)
        grads = torch.autograd.grad(loss, list(state.model.parameters()))
        loss, loss_full, *grads = self.mean_over_data(state, [loss, loss_full, *grads],
                                                      xx.shape[0])
        return loss, grads, loss_full

    def train_step(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """One optimizer step; returns ``(state, {"train_loss", "train_loss_full"})``."""
        loss, grads, loss_full = self.loss_and_grads(state, batch)
        metrics = self.with_grad_norm({"train_loss": loss, "train_loss_full": loss_full}, grads)
        return self.apply_grads(state, grads), metrics

    @torch.no_grad()
    def valid_step(self, state: State, batch):
        xx, yy = self._batch(state, batch)
        loss, loss_full, step_losses, p, _ = self._unroll(state.model, xx, yy, training=False)
        loss, loss_full, step_losses, p = self.mean_over_data(
            state, [loss, loss_full, step_losses, p], xx.shape[0])
        return {
            "loss_avg": nan_to_9999(loss),
            "loss": nan_to_9999(loss_full),
            "time_until": time_until(p, self.step_size),
            "corr": p.mean(),
            "correlations": p,
            "step_losses": step_losses,
        }
