"""Device selection for the port's entry points.

The port runs on the GPU: a process drives the card ``LOCAL_RANK`` (the
variable ``torchrun`` sets for each of its processes; card 0 where it is
not set). A caller that wants the CPU (the tests) asks for it by name; with
no GPU and no such request the entry point raises rather than quietly
running somewhere else.
"""

import os
from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda:LOCAL_RANK`` (``cuda:0`` without ``LOCAL_RANK``).
    Raises if CUDA is asked for and absent."""
    dev = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if device is None
           else torch.device(device))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fourierflow_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' (--device cpu) to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
