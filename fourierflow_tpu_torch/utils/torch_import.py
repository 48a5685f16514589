"""Load reference (PyTorch Lightning) checkpoints into the port's state
(counterpart of ``fourierflow_tpu/utils/torch_import.py``).

The port's models keep the reference's module tree and parameter names
(``models/ffno_grid_2d.py``, ``models/zongyi_fno_2d.py``), so a reference
``state_dict`` loads as it is once the Lightning experiment's ``conv.``
prefix is stripped: no transposes, and a shared tensor is listed under
every path in both. The experiment's ``normalizer.{sum, sum_squared,
count}`` buffers go into the state's ``NormalizerState``.

These are the reference's own checkpoints, not the port's (``.pt`` files
of ``utils/checkpoint.py``, read by ``load_state``).
"""

import logging
from dataclasses import replace
from typing import Dict

import torch

from ..models import FNOFactorized2DBlock, FNOZongyi2DBlock
from ..routines.base import State
from .checkpoint import read_checkpoint

logger = logging.getLogger(__name__)

__all__ = ["load_reference_state_dict", "import_reference_checkpoint"]

_PREFIX = "conv."
_NORMALIZER = "normalizer."


def load_reference_state_dict(path: str, blob=None) -> Dict[str, torch.Tensor]:
    """The tensors of a reference checkpoint: a Lightning ``.ckpt`` (the
    state dict under ``state_dict``) or a bare ``torch.save``d dict, on
    the CPU. ``blob`` is the file's contents where the caller has read them
    already (``utils.checkpoint.read_checkpoint``)."""
    blob = read_checkpoint(path) if blob is None else blob
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {k: v.detach() for k, v in blob.items() if isinstance(v, torch.Tensor)}


def _reference_family(keys) -> type:
    """The model class a reference state dict's names (``conv.`` stripped)
    belong to: F-FNO layers carry ``backcast_ff`` (and the head ``out``),
    the original FNO's carry ``spectral_layers.{i}.linear``."""
    keys = list(keys)
    if any(".backcast_ff." in k or k.startswith("out.") for k in keys):
        return FNOFactorized2DBlock
    if any(k.startswith("spectral_layers.") and ".linear." in k for k in keys):
        return FNOZongyi2DBlock
    raise ValueError("Unrecognized reference checkpoint: neither FNOFactorized2DBlock nor "
                     f"FNOZongyi2DBlock naming (keys: {sorted(keys)[:8]}...)")


def _check_match(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> None:
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"Checkpoint/model mismatch: missing in checkpoint: {missing[:6]}, "
                         f"unexpected in checkpoint: {extra[:6]}")
    for k, v in want.items():
        if tuple(got[k].shape) != tuple(v.shape):
            raise ValueError(f"Checkpoint/model mismatch: shape of {k}: checkpoint "
                             f"{tuple(got[k].shape)} vs model {tuple(v.shape)}")


def import_reference_checkpoint(path: str, state: State, blob=None) -> State:
    """Load a reference checkpoint's weights into ``state.model`` (in place,
    after a full check of names and shapes) and its normalizer statistics
    into the returned state's normalizer, with ``n_accumulations`` set to
    the count as in the JAX package. The optimizer is left as it is."""
    sd = load_reference_state_dict(path, blob)
    weights = {k[len(_PREFIX):] if k.startswith(_PREFIX) else k: v for k, v in sd.items()
               if not k.startswith(_NORMALIZER)}
    family = _reference_family(weights)
    if not isinstance(state.model, family):
        raise ValueError(f"Checkpoint/model mismatch: the checkpoint holds a {family.__name__}, "
                         f"the state a {type(state.model).__name__}")
    _check_match(weights, state.model.state_dict())
    state.model.load_state_dict(weights, strict=True)
    norm = state.normalizer
    if norm is not None and f"{_NORMALIZER}sum" in sd:
        stat = lambda name: sd[_NORMALIZER + name].to(state.device, torch.float32)
        if stat("sum").shape != norm.sum.shape:
            raise ValueError(f"Checkpoint/model mismatch: shape of {_NORMALIZER}sum: checkpoint "
                             f"{tuple(stat('sum').shape)} vs model {tuple(norm.sum.shape)}")
        count = stat("count").reshape(())
        norm = replace(norm, sum=stat("sum"), sum_squared=stat("sum_squared"), count=count,
                       n_accumulations=count.clone())
    logger.info("imported reference checkpoint %s: %s, %d tensors, normalizer %s", path,
                family.__name__, len(weights), "loaded" if norm is not state.normalizer else "kept")
    return replace(state, normalizer=norm)
