"""The MeshGraphNets routine, the counterpart of
``fourierflow_tpu/routines/meshgraphnet.py``: one-step training on the
velocity's change, and a rollout for validation.

Batches are dicts of padded arrays (``builders.CylinderFlowBuilder``):
``cells [b, C, 3]`` (-1 rows unused), ``mesh_pos [b, N, 2]``, ``node_type
[b, N]`` (-1 padded), and ``velocity`` / ``target_velocity`` ``[b, N, 2]``
to train on or ``[b, T, N, 2]`` to validate on (NaN on padded nodes).

The loss is half the squared error of the predicted change of velocity,
summed over the valid nodes' components and divided by the number of valid
nodes. The gradients are clipped by their global norm to ``clip_val``
before the optimizer. The rollout feeds each step's velocity plus the
predicted change back in (the JAX package integrates the change; the
reference feeds the bare change back) and scores each step as the loss.

On a ``data`` mesh the loss is the whole batch's ratio: each rank's summed
error over its valid nodes and its count of them are summed over the ranks
(``Routine.mean_over_data`` weighted by the counts), which ranks holding
different counts of valid nodes need; the gradients are reduced so too and
clipped by the norm of the reduced gradient, once. The validation's loss is
the whole batch's ratio in the same way. On ``data x model`` the model runs
whole on every ``model`` rank (JAX splits none of its leaves), each rank of
a data row computing the same step.
"""

from typing import Optional

import torch

from ..models.meshgraphnet import GraphProcessor, cylinder_edges, cylinder_nodes
from .base import Routine, State

__all__ = ["MeshGraphNetRoutine"]


def _masked_loss(preds, velocity, target_velocity):
    """``(sum of 0.5 (pred - change)^2 over valid components, number of
    valid nodes, valid mask [B, N, 2])``; a component is valid where its
    change is not NaN."""
    targets = target_velocity - velocity
    mask = ~torch.isnan(targets)
    sq = torch.where(mask, 0.5 * (preds - torch.nan_to_num(targets)) ** 2, 0.0)
    return sq.sum(), mask.any(-1).sum(), mask


class MeshGraphNetRoutine(Routine):
    should_normalize = False
    mesh_axes = ("data", "model")
    splits_eval_batches = True

    def __init__(self, n_layers: int = 15, latent_size: int = 128, output_dim: int = 2,
                 clip_val: float = 0.1, rollout_steps: int = 50, optimizer=None,
                 track_grad_norm: bool = False, **kwargs):
        super().__init__(optimizer, track_grad_norm)
        self.model = GraphProcessor(n_layers=n_layers, latent_size=latent_size,
                                    output_dim=output_dim)
        self.clip_val = clip_val
        self.rollout_steps = rollout_steps

    def init(self, seed: int, sample_batch, device) -> State:
        """Initialise the model from ``seed`` on ``device`` (flax's default
        initialisation) and the optimizer."""
        self.model.cpu().reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(device).train()
        return self.make_train_state(self.model)

    @staticmethod
    def _tensors(batch, device):
        return {k: torch.as_tensor(batch[k], device=device)
                for k in ("cells", "mesh_pos", "node_type", "velocity", "target_velocity")}

    def _loss(self, model, batch, device):
        """``(loss, valid)``: the loss of this rank's samples and their
        number of valid nodes."""
        b = self._tensors(batch, device)
        edges, senders, receivers = cylinder_edges(b["mesh_pos"], b["cells"])
        preds = model(cylinder_nodes(b["velocity"], b["node_type"]), edges, senders, receivers)
        sq, valid, _ = _masked_loss(preds, b["velocity"], b["target_velocity"])
        return sq / valid.clamp(min=1), valid

    def loss_and_grads(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """One batch's loss and its gradients clipped by their global norm,
        in ``model.parameters()`` order: ``(loss, grads)``, of the whole
        batch on a mesh."""
        loss, valid = self._loss(state.model, batch, state.device)
        grads = torch.autograd.grad(loss, list(state.model.parameters()))
        loss, *grads = self.mean_over_data(state, [loss, *grads], valid)
        norm = self.grad_norm(grads)
        scale = torch.where(norm < self.clip_val, 1.0, self.clip_val / (norm + 1e-9))
        return loss.detach(), [g * scale for g in grads]

    def train_step(self, state: State, batch, rng: Optional[torch.Generator] = None):
        """One optimizer step; returns ``(state, {"train_loss"[, "grad_norm"]})``."""
        loss, grads = self.loss_and_grads(state, batch)
        metrics = self.with_grad_norm({"train_loss": loss}, grads)
        return self.apply_grads(state, grads), metrics

    @torch.no_grad()
    def valid_step(self, state: State, batch):
        """The ``rollout_steps``-step rollout from each trajectory's first
        velocity: ``loss`` is the summed squared error of every step over
        the valid nodes of every step."""
        b = self._tensors(batch, state.device)
        edges, senders, receivers = cylinder_edges(b["mesh_pos"], b["cells"])
        velocity = b["velocity"][:, 0]
        total_sq, total_valid = 0.0, 0
        for t in range(min(self.rollout_steps, b["target_velocity"].shape[1])):
            preds = state.model(cylinder_nodes(velocity, b["node_type"]), edges, senders,
                                receivers)
            sq, valid, mask = _masked_loss(preds, velocity, b["target_velocity"][:, t])
            velocity = torch.where(mask, velocity + preds, velocity)
            total_sq, total_valid = total_sq + sq, total_valid + valid
        total_valid = torch.as_tensor(total_valid)
        loss = total_sq / torch.clamp(total_valid, min=1)
        loss, = self.mean_over_data(state, [loss], total_valid)
        return {"loss": loss,
                "weight": torch.tensor(float(self.global_count(state, batch, "velocity")))}
