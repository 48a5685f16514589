"""Spectral and feed-forward ops, each with a plain PyTorch version and a
hand-written CUDA kernel (see ``csrc/``)."""

from .fused_ff import fused_ff
from .fused_spectral import fused_mix_2d
from .spectral import spectral_mix_axis

__all__ = ["fused_ff", "fused_mix_2d", "spectral_mix_axis", "KERNELS", "launch_counts",
           "reset_launch_counts"]

# The kernel wrappers on the rollout path, by name.
KERNELS = {"fused_ff": fused_ff, "fused_mix_2d": fused_mix_2d}


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
