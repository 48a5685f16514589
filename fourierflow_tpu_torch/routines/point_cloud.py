"""Point-cloud routine, elasticity (counterpart of
``fourierflow_tpu/routines/point_cloud.py``): the relative L2 error of
``model(xy, code=rr)`` against ``sigma``, each sample flattened. With a
generator, a train step also computes the IPhi regularisation: the
deformation of ``N`` points drawn uniformly from ``[-1, 2)^2`` held to the
identity by the same relative error, logged as ``train_loss_reg`` and added
to the loss with weight ``reg_weight`` (0 in the registry). No normalizer:
every epoch trains.

On a ``data`` mesh each rank draws the IPhi points of the whole batch from
the step's generator and keeps its block's, so that the step is the one of
one process for any ``reg_weight``; the losses and the gradients are means
over the whole batch (``Routine.mean_over_data``). On ``data x model`` the
``model`` ranks of a data row draw the same points (the generator is the
step's, seeded from the trainer's seed and the step, not the rank) and the
F-FNO runs its split form, the Geo-FNOs whole.
"""

from typing import Optional

import torch

from ..layers import lp_loss_rel
from .base import Routine, State

__all__ = ["PointCloudRoutine"]


class PointCloudRoutine(Routine):
    should_normalize = False
    mesh_axes = ("data", "model")
    splits_eval_batches = True

    def __init__(self, model=None, iphi=None, N: int = 1000, reg_weight: float = 0.0,
                 optimizer=None, track_grad_norm: bool = False, **kwargs):
        super().__init__(optimizer, track_grad_norm)
        self.model = model
        if iphi is not None and self.model.iphi is None:
            self.model.iphi = iphi
        self.N = N
        self.reg_weight = reg_weight

    def init(self, seed: int, sample_batch, device) -> State:
        """Initialise the model (and its IPhi) from ``seed`` on ``device``, in
        train mode, and the optimizer."""
        self.model.cpu().reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(device).train()
        return self.make_train_state(self.model)

    def _loss(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """``(loss, loss_data, loss_reg)`` of this rank's samples;
        ``loss_reg`` is 0 without ``rng`` or without an IPhi."""
        model, device = state.model, state.device
        xy, rr, sigma = (torch.as_tensor(batch[k], device=device) for k in ("xy", "rr", "sigma"))
        b = rr.shape[0]
        loss_data = lp_loss_rel(model(xy, code=rr).reshape(b, -1), sigma.reshape(b, -1))
        loss_reg = torch.zeros((), device=device)
        if rng is not None and model.iphi is not None:
            data = self.data_block(state, batch, "rr")
            n = b * (data.size if data is not None else 1)
            samples_x = torch.rand(n, self.N, 2, generator=rng, device=device) * 3 - 1
            if data is not None:
                samples_x = samples_x[data.rank * b:(data.rank + 1) * b]
            loss_reg = lp_loss_rel(model.iphi(samples_x, rr), samples_x)
        return loss_data + self.reg_weight * loss_reg, loss_data, loss_reg

    def loss_and_grads(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """``(loss_data, loss_reg, grads)``: the gradients of the whole loss in
        ``model.parameters()`` order, of the whole batch on a mesh; the IPhi
        samples drawn from ``rng``, a generator on the state's device."""
        loss, loss_data, loss_reg = self._loss(state, batch, rng)
        grads = torch.autograd.grad(loss, list(state.model.parameters()))
        loss_data, loss_reg, *grads = self.mean_over_data(state, [loss_data, loss_reg, *grads],
                                                          len(batch["rr"]))
        return loss_data, loss_reg, grads

    def train_step(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """One optimizer step; returns ``(state, {"train_loss",
        "train_loss_reg"})``."""
        loss_data, loss_reg, grads = self.loss_and_grads(state, batch, rng)
        metrics = self.with_grad_norm({"train_loss": loss_data, "train_loss_reg": loss_reg}, grads)
        return self.apply_grads(state, grads), metrics

    @torch.no_grad()
    def predict(self, state: State, batch) -> torch.Tensor:
        """The model's output at ``batch["xy"]`` with code ``batch["rr"]``, in
        eval mode (the model is put back in the mode it was in)."""
        training = state.model.training
        state.model.eval()
        try:
            return state.model(torch.as_tensor(batch["xy"], device=state.device),
                               code=torch.as_tensor(batch["rr"], device=state.device))
        finally:
            state.model.train(training)

    @torch.no_grad()
    def valid_step(self, state: State, batch):
        loss = self._loss(state, batch)[0]
        return {"loss": self.mean_over_data(state, [loss], len(batch["rr"]))[0]}
