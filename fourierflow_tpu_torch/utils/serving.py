"""Serving export: the flagship rollout as one self-contained program
(counterpart of ``fourierflow_tpu/utils/serving.py``).

:func:`make_rollout_fn` wraps a trained routine and state in an
``nn.Module`` that runs the autoregressive Markov rollout without targets:
rebuild the features from each prediction, normalize, model forward,
denormalize, feed back (``routines/grid_2d_markov.py::rollout``). A
routine that appends a force takes it as a second input ``[b, X, Y]``,
fed to every step as the JAX package's ``serve(w0, force)`` does; one
that appends the viscosity cannot be served, since that path passes none.
:func:`export_rollout` traces it with ``torch.export`` at static shapes,
the loop unrolled, the weights and normalizer statistics inside the
program, and writes it with ``torch.export.save`` (``.pt2``).
:func:`load_exported` loads it back; a serving host calls it with a
vorticity field and needs none of the model code.

Unlike the JAX artifact, this one keeps the hand-written kernels: every
call of the spectral mix and of the feed-forward is a node of the
``fourierflow_tpu_torch`` operators (``ops/__init__.py``), so the program
launches ``ff_fwd`` and the spectral kernel on the card it was exported on,
and runs their plain versions when exported on the CPU. It serves on the
device it was exported on; loading it for another raises. The JAX
export's ``platforms`` has no counterpart here.
"""

import contextlib
import copy
import logging
import os
import time
import zipfile
from typing import Optional, Union

import torch
import torch.nn as nn

from ..layers import WNLinear, row_norms

logger = logging.getLogger(__name__)

__all__ = ["make_rollout_fn", "export_rollout", "load_exported", "ExportedRollout"]

# The matmul precisions an artifact may be made at: the port computes float32
# products at full float32 accuracy (its kernels as 3xTF32), which is
# "highest"; None means the same.
_PRECISIONS = (None, "highest")
_DEVICE_ENTRY = "device"  # extra file of the artifact naming its device


def _fold_weight_norm(model: nn.Module) -> nn.Module:
    """A copy of ``model`` in eval mode whose weight-normed linear layers
    hold their effective weight ``g * v / ||v||``, computed once as
    ``WNLinear.dense`` computes it on every call."""
    model = copy.deepcopy(model).eval()
    for m in model.modules():
        if isinstance(m, WNLinear) and m.wnorm:
            with torch.no_grad():
                v = m.weight_v
                w = m.weight_g * v / row_norms(v.square().sum(dim=1, keepdim=True))
            del m.weight_g, m.weight_v
            m.weight = nn.Parameter(w)
            m.wnorm = False
    return model


class _Rollout(nn.Module):
    """``forward(w0 [b, X, Y, 1], force [b, X, Y] or None) -> preds [b, X, Y,
    n_steps]``. The module holds the normalizer's ``mean`` and ``std`` as
    buffers and stands in for the normalizer in the routine's
    ``rollout_step``."""

    def __init__(self, routine, state, n_steps: int):
        super().__init__()
        self.routine = routine
        self.model = _fold_weight_norm(state.model)
        self.n_steps = n_steps
        if routine.should_normalize:
            norm = state.normalizer
            self.register_buffer("mean", norm.mean.detach().clone())
            self.register_buffer("std", norm.std.detach().clone())

    def forward(self, w0: torch.Tensor, force: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.takes_force != (force is not None):
            raise ValueError("the rollout takes (w0, force)" if self.takes_force else
                             "the rollout takes w0 alone: its routine appends no force")
        if force is not None and (force.dim() != 3 or force.shape != w0.shape[:3]):
            raise ValueError(f"force must be [b, X, Y] = {tuple(w0.shape[:3])}, got "
                             f"{tuple(force.shape)}")
        im, preds = w0, []
        for _ in range(self.n_steps):
            _, im = self.routine.rollout_step(self.model, self, im, force)
            preds.append(im[..., 0])
        return torch.stack(preds, dim=-1)

    @property
    def takes_force(self) -> bool:
        return bool(getattr(self.routine, "append_force", False))


def make_rollout_fn(routine, state, n_steps: int) -> nn.Module:
    """A serving module ``w0 [b, X, Y, 1] -> preds [b, X, Y, n_steps]``, or
    ``(w0, force [b, X, Y]) -> preds`` where the routine appends a force (a
    static force, fed to every step), on the state's device, holding the
    model (weight norm folded in) and the normalizer's mean and std as
    buffers. Mirrors the eval rollout without targets. A routine that
    appends the viscosity raises a ValueError: the serving path passes no
    viscosity, as in the JAX package."""
    if getattr(routine, "append_mu", False):
        raise ValueError("a routine with append_mu cannot be served: the rollout takes w0 and a "
                         "force, and no viscosity (the JAX package's serving path passes none)")
    return _Rollout(routine, state, n_steps)


def _check_precision(precision: Optional[str]) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision {precision!r} is not supported: the port computes float32 products at "
            "full float32 accuracy ('highest'); TF32 or bf16 products would make the artifact "
            "differ from the live model")


@contextlib.contextmanager
def _highest_matmul_precision():
    """Run a block at ``torch.set_float32_matmul_precision("highest")``."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def export_rollout(routine, state, out_path: str, n_steps: int, batch_size: int, size: int,
                   device: Union[str, torch.device, None] = None,
                   precision: Optional[str] = None) -> str:
    """Export the ``n_steps`` rollout at ``[batch_size, size, size, 1]``
    float32 on ``device`` (the state's device when None) to ``out_path``,
    with a force input ``[batch_size, size, size]`` where the routine
    appends one. Returns the path."""
    _check_precision(precision)
    dev = state.device
    asked = torch.device(device) if device is not None else dev
    if asked.type != dev.type or asked.index not in (None, dev.index):
        raise ValueError(f"the state lies on {dev}; export it on that device, not {asked}")
    serve = make_rollout_fn(routine, state, n_steps)
    example = (torch.zeros(batch_size, size, size, 1, device=dev),)
    if serve.takes_force:
        example += (torch.zeros(batch_size, size, size, device=dev),)
    start = time.perf_counter()
    with torch.no_grad(), _highest_matmul_precision():
        program = torch.export.export(serve, example, strict=False)
    traced = time.perf_counter() - start
    torch.export.save(program, out_path, extra_files={_DEVICE_ENTRY: str(dev)})
    saved = time.perf_counter() - start - traced
    logger.info("exported rollout (%d steps, batch %d, %d^2%s, on %s): %s (%d bytes), traced in "
                "%.2f s, saved in %.2f s, %d nodes", n_steps, batch_size, size,
                ", with a force" if serve.takes_force else "", dev, out_path,
                os.path.getsize(out_path), traced, saved, len(program.graph.nodes))
    return out_path


def _artifact_device(path: str) -> torch.device:
    """The device an artifact was exported on, read from its archive
    before any of its tensors are loaded."""
    try:
        with zipfile.ZipFile(path) as archive:
            names = [n for n in archive.namelist() if n.endswith(f"/extra/{_DEVICE_ENTRY}")]
            device = archive.read(names[0]).decode() if len(names) == 1 else None
    except zipfile.BadZipFile:
        device = None
    if device is None:
        raise ValueError(f"{path} is not a rollout exported by export_rollout")
    return torch.device(device)


class ExportedRollout:
    """A loaded artifact: ``rollout(w0) -> preds``, or ``rollout(w0, force)``
    where it was exported with a force (``takes_force``). ``program`` is the
    ``torch.export.ExportedProgram``; ``device`` the device it serves on."""

    def __init__(self, program, device: torch.device):
        self.program = program
        self.device = device
        self.module = program.module()
        self.takes_force = len(program.graph_signature.user_inputs) == 2

    def __call__(self, w0: torch.Tensor, force: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.takes_force != (force is not None):
            raise ValueError("the artifact takes (w0, force)" if self.takes_force else
                             "the artifact takes w0 alone")
        for t in (w0,) if force is None else (w0, force):
            if t.device.type != self.device.type or (
                    self.device.index is not None and t.device != self.device):
                raise ValueError(f"the artifact serves on {self.device}; an input lies on "
                                 f"{t.device}")
        with torch.no_grad(), _highest_matmul_precision():
            return self.module(w0) if force is None else self.module(w0, force)


def load_exported(path: str) -> ExportedRollout:
    """Load an artifact written by :func:`export_rollout`. Registers the
    port's operators first (the program names them). An artifact made on
    a CUDA device needs one."""
    from .. import ops  # noqa: F401  (defines the fourierflow_tpu_torch operators)

    device = _artifact_device(path)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported on {device} and serves there; this host has no "
                           "CUDA device (export again on the CPU to serve there)")
    return ExportedRollout(torch.export.load(path), device)
