"""Factorized Cosine Neural Operator on a regular 2D grid, the FCNO family
(counterpart of ``fourierflow_tpu/models/cno_grid_2d.py``).

The F-FNO block (``models/ffno_grid_2d.py``) with the DCT-II in place of
the real FFT: each separable branch is ``ops.spectral.dct_mix_axis``
(plain torch, as the JAX package computes it), its per-mode weights real
``[width, width, modes]``; the feed-forwards run ``ops.fused_ff`` (the CUDA
kernel on a CUDA tensor). The contract (``{"forecast", "forecast_list"}``),
the fork options, the head, the parameter names and the initialisation
(shared weights with ``gain``, per-layer ones with 1.0) are the F-FNO
block's. ``mode`` is taken and ignored, as in the JAX package.
"""

import torch

from ..ops.spectral import dct_mix_axis
from .ffno_grid_2d import FNOFactorized2DBlock

__all__ = ["CNOFactorized2DBlock", "cosine_mix_2d"]


def cosine_mix_2d(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The separable DCT mix of ``x [batch, sx, sy, channels]``: the Y branch
    plus the X branch."""
    return dct_mix_axis(x, wy, 2) + dct_mix_axis(x, wx, 1)


class CNOFactorized2DBlock(FNOFactorized2DBlock):
    _pair = ()
    _mix = staticmethod(cosine_mix_2d)

    def __init__(self, modes: int, width: int, input_dim: int = 12, dropout: float = 0.0,
                 in_dropout: float = 0.0, n_layers: int = 4, share_weight: bool = False,
                 share_fork: bool = False, factor: int = 2, ff_weight_norm: bool = False,
                 n_ff_layers: int = 2, gain: float = 1.0, layer_norm: bool = False,
                 use_fork: bool = False, mode: str = "full"):
        super().__init__(modes, width, input_dim, dropout, in_dropout, n_layers, share_weight,
                         share_fork, factor, ff_weight_norm, n_ff_layers, gain, layer_norm,
                         use_fork)
