"""``export`` command: write the rollout as a serving artifact (counterpart
of ``fourierflow_tpu/commands/export.py``).

Restores the state (the port's checkpoint or a reference Lightning
``.ckpt``), exports the ``n_steps`` rollout at ``[batch_size, size, size,
1]`` with ``utils.serving.export_rollout`` on the chosen device, loads the
artifact back as a check, and prints ``{"out_path", "n_steps",
"batch_size", "size"}``. A serving host runs it with
``fourierflow_tpu_torch.utils.serving.load_exported`` on the same kind of
device.
"""

import logging
from typing import List, Optional

from ..config import instantiate, load_config
from ..device import resolve_device
from ..utils.serving import export_rollout, load_exported
from .train import build_routine, restore_state

logger = logging.getLogger(__name__)

__all__ = ["main"]


def main(config_path: str, out_path: str, checkpoint_path: Optional[str] = None,
         torch_checkpoint: Optional[str] = None, overrides: Optional[List[str]] = None,
         n_steps: int = 20, batch_size: int = 1, size: int = 64, trial: int = 0,
         precision: Optional[str] = None, device: Optional[str] = None) -> str:
    dev = resolve_device(device)
    cfg = load_config(config_path, overrides)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    state = restore_state(routine, builder, dev, trial, checkpoint_path, torch_checkpoint)
    path = export_rollout(routine, state, out_path, n_steps=n_steps, batch_size=batch_size,
                          size=size, device=dev, precision=precision)
    # Load it back, so that a broken artifact fails here and not at serve time.
    artifact = load_exported(path)
    logger.info("artifact loads; serves on %s", artifact.device)
    print({"out_path": path, "n_steps": n_steps, "batch_size": batch_size, "size": size})
    return path
