"""Spectral and feed-forward ops, each with a plain PyTorch version and a
hand-written CUDA kernel (see ``csrc/``).

The kernels' calls are operators of the ``fourierflow_tpu_torch`` namespace
(``torch.ops.fourierflow_tpu_torch.{fused_ff, fused_ff_bwd, fused_mix_2d,
fused_mix_2d_adjoint, fused_mix_axis, fused_mix_axis_adjoint}``; the last
two launch the spectral kernel on one axis), defined in ``LIBRARY`` when
this package is imported: a program exported with ``torch.export`` names
them, so it loads after this import.
"""

import torch

LIBRARY = torch.library.Library("fourierflow_tpu_torch", "DEF")

from .fused_ff import fused_ff, fused_ff_bwd  # noqa: E402
from .fused_spectral import (fused_mix_2d, fused_mix_2d_adjoint, fused_mix_axis,  # noqa: E402
                             fused_mix_axis_adjoint)
from .spectral import spectral_mix_axis  # noqa: E402

__all__ = ["LIBRARY", "fused_ff", "fused_ff_bwd", "fused_mix_2d", "fused_mix_2d_adjoint",
           "fused_mix_axis", "fused_mix_axis_adjoint", "spectral_mix_axis", "KERNELS",
           "AXIS_KERNELS", "launch_counts", "reset_launch_counts"]

# The kernels by name and the wrapper that launches each: the forward ones run
# in the rollout, all four in a train step. Each count is of its wrapper's
# calls that reached the kernel: a call of ``fused_mix_2d`` or its adjoint is
# the spectral kernel's two axis launches.
KERNELS = {"fused_ff": fused_ff, "fused_ff_bwd": fused_ff_bwd, "fused_mix_2d": fused_mix_2d,
           "fused_mix_2d_adjoint": fused_mix_2d_adjoint}
# The spectral kernel's one-axis wrappers (the spatially split layer), counted
# apart: a call of each is one launch.
AXIS_KERNELS = {"fused_mix_axis": fused_mix_axis, "fused_mix_axis_adjoint": fused_mix_axis_adjoint}


def launch_counts(kernels=KERNELS) -> dict:
    """Calls of each of ``kernels``' wrappers that reached its kernel since the last reset."""
    return {name: fn.launches for name, fn in kernels.items()}


def reset_launch_counts() -> None:
    """Sets the count of every wrapper, those of ``AXIS_KERNELS`` too, to 0."""
    for fn in (*KERNELS.values(), *AXIS_KERNELS.values()):
        fn.launches = 0
