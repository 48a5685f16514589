"""Save and load the port's own state (counterpart of
``fourierflow_tpu/trainers/callbacks.py::save_state/load_state``): the
model's ``state_dict``, the normalizer statistics, the optimizer's and the
scheduler's ``state_dict`` and the step count, with ``torch.save``."""

import os
from dataclasses import replace

import torch

from ..routines.base import State

__all__ = ["save_state", "load_state"]

_NORM_FIELDS = ("sum", "sum_squared", "count", "n_accumulations")


def _cpu(obj):
    """``obj`` with every tensor in it copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_state(path: str, state: State) -> None:
    """Write atomically (temporary file, then rename)."""
    blob = {"model": _cpu(state.model.state_dict()), "step": state.step}
    if state.normalizer is not None:
        blob["normalizer"] = {f: _cpu(getattr(state.normalizer, f)) for f in _NORM_FIELDS}
    if state.optimizer is not None:
        blob["optimizer"] = _cpu(state.optimizer.state_dict())
    if state.scheduler is not None:
        blob["scheduler"] = state.scheduler.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_state(path: str, state: State) -> State:
    """Restore into ``state`` (which fixes the model's structure and
    device) what the checkpoint holds: weights, normalizer, and, where both
    have them, the optimizer, the scheduler and the step count."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(blob["model"])
    norm = state.normalizer
    if norm is not None and "normalizer" in blob:
        dev = state.device
        norm = replace(norm, **{f: blob["normalizer"][f].to(dev) for f in _NORM_FIELDS})
    if state.optimizer is not None and "optimizer" in blob:
        state.optimizer.load_state_dict(blob["optimizer"])
    if state.scheduler is not None and "scheduler" in blob:
        state.scheduler.load_state_dict(blob["scheduler"])
    return replace(state, normalizer=norm, step=blob.get("step", state.step))
