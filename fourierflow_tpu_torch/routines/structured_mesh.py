"""Structured-mesh routine, airfoil, pipe and plasticity (counterpart of
``fourierflow_tpu/routines/structured_mesh.py``): the relative L2 error of
``model(x)`` against ``y``, each sample flattened. ``loss_scale`` multiplies
the loss whose gradients train the model; the logged ``train_loss`` is
unscaled. No normalizer: every epoch trains. On a ``data`` mesh the loss,
its gradients and the validation loss are means over the whole batch
(``Routine.mean_over_data``); on ``data x model`` the F-FNO runs its split
form and the Geo-FNOs run whole on every ``model`` rank
(``parallel.shard_state``).
"""

from typing import Optional

import torch

from ..layers import lp_loss_rel
from .base import Routine, State

__all__ = ["StructuredMeshRoutine"]


class StructuredMeshRoutine(Routine):
    should_normalize = False
    mesh_axes = ("data", "model")
    splits_eval_batches = True

    def __init__(self, model=None, loss_scale: float = 1.0, optimizer=None, conv=None,
                 track_grad_norm: bool = False, **kwargs):
        super().__init__(optimizer, track_grad_norm)
        # `conv` is the reference's name for the model argument.
        self.model = model if model is not None else conv
        self.loss_scale = loss_scale

    def init(self, seed: int, sample_batch, device) -> State:
        """Initialise the model from ``seed`` on ``device``, in train mode,
        and the optimizer."""
        self.model.cpu().reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(device).train()
        return self.make_train_state(self.model)

    def _loss(self, model, batch, device) -> torch.Tensor:
        x = torch.as_tensor(batch["x"], device=device)
        y = torch.as_tensor(batch["y"], device=device)
        b = x.shape[0]
        return lp_loss_rel(model(x).reshape(b, -1), y.reshape(b, -1))

    def loss_and_grads(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """The unscaled loss of one batch and the gradients of ``loss_scale``
        times it, in ``model.parameters()`` order: ``(loss, grads)``, of the
        whole batch on a mesh."""
        loss = self._loss(state.model, batch, state.device)
        grads = torch.autograd.grad(loss * self.loss_scale, list(state.model.parameters()))
        loss, *grads = self.mean_over_data(state, [loss, *grads], len(batch["x"]))
        return loss, grads

    def train_step(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """One optimizer step; returns ``(state, {"train_loss"})``."""
        loss, grads = self.loss_and_grads(state, batch)
        metrics = self.with_grad_norm({"train_loss": loss}, grads)
        return self.apply_grads(state, grads), metrics

    @torch.no_grad()
    def predict(self, state: State, batch) -> torch.Tensor:
        """The model's output for ``batch["x"]``, in eval mode (the model is
        put back in the mode it was in)."""
        training = state.model.training
        state.model.eval()
        try:
            return state.model(torch.as_tensor(batch["x"], device=state.device))
        finally:
            state.model.train(training)

    @torch.no_grad()
    def valid_step(self, state: State, batch):
        loss = self._loss(state.model, batch, state.device)
        return {"loss": self.mean_over_data(state, [loss], len(batch["x"]))[0]}
