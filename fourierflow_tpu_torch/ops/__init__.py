"""Spectral and feed-forward ops, each with a plain PyTorch version and a
hand-written CUDA kernel (see ``csrc/``)."""

from .fused_ff import fused_ff, fused_ff_bwd
from .fused_spectral import fused_mix_2d, fused_mix_2d_adjoint
from .spectral import spectral_mix_axis

__all__ = ["fused_ff", "fused_ff_bwd", "fused_mix_2d", "fused_mix_2d_adjoint",
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
