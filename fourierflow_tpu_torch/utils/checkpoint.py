"""Save and load the port's own state (counterpart of
``fourierflow_tpu/trainers/callbacks.py::save_state/load_state/
load_inference_state``): the model's ``state_dict``, the normalizer
statistics, the optimizer's and the scheduler's ``state_dict`` and the step
count, with ``torch.save``.

The port's checkpoints and the reference's Lightning ``.ckpt`` files are
both ``torch.save`` zip archives, so ``checkpoint_kind`` tells them apart by
what they hold: the port's a ``model`` entry, Lightning's a ``state_dict``.

A checkpoint always holds the whole state (a tensor-parallel fit saves it
gathered, ``parallel.gather_state``); restoring into a state whose weights
are split over a ``model`` mesh axis takes this rank's block of each split
weight and of its AdamW moments.
"""

import logging
import os
import pickle
from dataclasses import replace

import torch

from ..parallel.collectives import mesh_axis
from ..parallel.mesh import shard_tensor, split_dims
from ..routines.base import State

logger = logging.getLogger(__name__)

__all__ = ["save_state", "load_state", "load_inference_state", "read_checkpoint",
           "checkpoint_kind"]

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


def read_checkpoint(path: str):
    """What ``torch.save`` wrote at ``path``, on the CPU. A file that the
    weights-only unpickler refuses (a Lightning checkpoint may carry
    hyper-parameters and callback states) is unpickled in full, with a
    warning: that runs code from the file."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        logger.warning("%s: weights-only load refused (%s); unpickling it in full, which runs "
                       "code from the file: load only checkpoints you trust", path, err)
        return torch.load(path, map_location="cpu", weights_only=False)


def checkpoint_kind(blob, path: str = "checkpoint") -> str:
    """``"port"`` for the port's own checkpoint (a dict with ``model``),
    ``"lightning"`` for a reference Lightning checkpoint (a dict with
    ``state_dict``); raises ``ValueError`` for anything else."""
    if isinstance(blob, dict) and isinstance(blob.get("model"), dict):
        return "port"
    if isinstance(blob, dict) and isinstance(blob.get("state_dict"), dict):
        return "lightning"
    keys = sorted(map(str, blob))[:8] if isinstance(blob, dict) else type(blob).__name__
    raise ValueError(f"{path} is neither a checkpoint of this package (a 'model' entry) nor a "
                     f"Lightning checkpoint (a 'state_dict' entry): {keys}")


def _port_blob(path: str, blob):
    """The contents of the port's checkpoint at ``path`` (read unless given)."""
    if blob is None:
        try:
            blob = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as err:  # the port's checkpoints hold tensors and numbers
            raise ValueError(f"{path} is not a checkpoint of this package (a Lightning "
                             "checkpoint? import it with utils.torch_import."
                             "import_reference_checkpoint)") from err
    if checkpoint_kind(blob, path) != "port":
        raise ValueError(f"{path} is a Lightning checkpoint: import it with "
                         "utils.torch_import.import_reference_checkpoint")
    return blob


def _split_dims(state: State):
    """``(model axis, {name: split dim})`` of a tensor-parallel state, else
    ``(None, {})``."""
    specs = split_dims(state.model)
    tp = mesh_axis(state.mesh, "model")
    return (tp, specs) if tp is not None and specs else (None, {})


def _restore_weights(blob, state: State) -> State:
    """The weights into ``state.model`` (this rank's blocks of a split
    state's); the returned state carries the normalizer and step count of
    the checkpoint."""
    tp, specs = _split_dims(state)
    state.model.load_state_dict({k: shard_tensor(v, specs.get(k), tp)
                                 for k, v in blob["model"].items()})
    norm = state.normalizer
    if norm is not None and "normalizer" in blob:
        dev = state.device
        norm = replace(norm, **{f: blob["normalizer"][f].to(dev) for f in _NORM_FIELDS})
    return replace(state, normalizer=norm, step=blob.get("step", state.step))


def load_state(path: str, state: State) -> State:
    """Restore into ``state`` (which fixes the model's structure and
    device) what the checkpoint holds: weights, normalizer, and, where both
    have them, the optimizer, the scheduler and the step count."""
    blob = _port_blob(path, None)
    if state.optimizer is not None and "optimizer" in blob:
        tp, specs = _split_dims(state)
        if tp is not None:  # this rank's block of each split weight's moments
            dims = [specs.get(name) for name, _ in state.model.named_parameters()]
            for i, moments in blob["optimizer"]["state"].items():
                for k, v in moments.items():
                    if isinstance(v, torch.Tensor) and v.dim() > 0:
                        moments[k] = shard_tensor(v, dims[i], tp)
        state.optimizer.load_state_dict(blob["optimizer"])
    if state.scheduler is not None and "scheduler" in blob:
        state.scheduler.load_state_dict(blob["scheduler"])
    return _restore_weights(blob, state)


def load_inference_state(path: str, state: State, blob=None) -> State:
    """Restore the weights, the normalizer and the step count, and keep
    ``state``'s optimizer and scheduler as they are: evaluation and
    fine-tuning need no optimizer state, so this reads checkpoints written
    under any optimizer config. ``blob`` is the file's contents where the
    caller has read them already (``read_checkpoint``)."""
    return _restore_weights(_port_blob(path, blob), state)
