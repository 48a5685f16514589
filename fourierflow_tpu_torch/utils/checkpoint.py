"""Save and load the port's own state (counterpart of
``fourierflow_tpu/trainers/callbacks.py::save_state/load_state``): the
model's ``state_dict`` and the normalizer statistics, with ``torch.save``."""

import os
from dataclasses import replace

import torch

from ..routines.base import State

__all__ = ["save_state", "load_state"]

_NORM_FIELDS = ("sum", "sum_squared", "count", "n_accumulations")


def save_state(path: str, state: State) -> None:
    """Write atomically (temporary file, then rename)."""
    blob = {"model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}
    if state.normalizer is not None:
        blob["normalizer"] = {f: getattr(state.normalizer, f).detach().cpu() for f in _NORM_FIELDS}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_state(path: str, state: State) -> State:
    """Restore weights and normalizer into ``state`` (which fixes the
    model's structure and device)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(blob["model"])
    norm = state.normalizer
    if norm is not None and "normalizer" in blob:
        dev = state.device
        norm = replace(norm, **{f: blob["normalizer"][f].to(dev) for f in _NORM_FIELDS})
    return State(state.model, norm)
