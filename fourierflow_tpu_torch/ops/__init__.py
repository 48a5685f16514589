"""Spectral and feed-forward ops, each with a plain PyTorch version and a
hand-written CUDA kernel (see ``csrc/``).

The four kernels are operators of the ``fourierflow_tpu_torch`` namespace
(``torch.ops.fourierflow_tpu_torch.{fused_ff, fused_ff_bwd, fused_mix_2d,
fused_mix_2d_adjoint}``), defined in ``LIBRARY`` when this package is
imported: a program exported with ``torch.export`` names them, so it loads
after this import.
"""

import torch

LIBRARY = torch.library.Library("fourierflow_tpu_torch", "DEF")

from .fused_ff import fused_ff, fused_ff_bwd  # noqa: E402
from .fused_spectral import fused_mix_2d, fused_mix_2d_adjoint  # noqa: E402
from .spectral import spectral_mix_axis  # noqa: E402

__all__ = ["LIBRARY", "fused_ff", "fused_ff_bwd", "fused_mix_2d", "fused_mix_2d_adjoint",
           "spectral_mix_axis", "KERNELS", "launch_counts", "reset_launch_counts"]

# The kernel wrappers by name: the forward ones run in the rollout, all four
# in a train step.
KERNELS = {"fused_ff": fused_ff, "fused_ff_bwd": fused_ff_bwd, "fused_mix_2d": fused_mix_2d,
           "fused_mix_2d_adjoint": fused_mix_2d_adjoint}


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
