"""Factorized Cosine Neural Operator on a regular 2D grid, the FCNO family
(counterpart of ``fourierflow_tpu/models/cno_grid_2d.py``).

The F-FNO block (``models/ffno_grid_2d.py``) with the DCT-II in place of
the real FFT: each separable branch is ``ops.spectral.dct_mix_axis``
(plain torch, as the JAX package computes it), its per-mode weights real
``[width, width, modes]``; the feed-forwards run ``ops.fused_ff`` (the CUDA
kernel on a CUDA tensor). The contract (``{"forecast", "forecast_list"}``),
the fork options, the head, the parameter names and the initialisation
(shared weights with ``gain``, per-layer ones with 1.0) are the F-FNO
block's. ``mode`` is taken and ignored, as in the JAX package. So are the
parallel forms: on ``model`` the feed-forwards' hidden slices (the DCT
weights ``[C, C, M]`` stay whole, as JAX's ``_tp_spec`` leaves them); on
``spatial`` the Y branch on this rank's X rows and the X branch between the
two all-to-alls (``along_x``), summed where the unsplit form sums them.
"""

import torch

from ..ops.spectral import dct_mix_axis
from .ffno_grid_2d import FNOFactorized2DBlock, along_x

__all__ = ["CNOFactorized2DBlock", "cosine_mix_2d"]


def cosine_mix_2d(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, sp=None) -> torch.Tensor:
    """The separable DCT mix of ``x [batch, sx, sy, channels]``: the Y branch
    plus the X branch. With the ``spatial`` axis ``sp`` x is this rank's X
    rows of the grid, and so is the result. Both branches take x through one
    view (``models/ffno_grid_2d.py``)."""
    xv = x.view_as(x)
    return dct_mix_axis(xv, wy, 2) + along_x(lambda t: dct_mix_axis(t, wx, 1), xv, sp)


class CNOFactorized2DBlock(FNOFactorized2DBlock):
    _pair = ()
    _mix = staticmethod(cosine_mix_2d)
    _spatial_mix = staticmethod(cosine_mix_2d)

    def __init__(self, modes: int, width: int, input_dim: int = 12, dropout: float = 0.0,
                 in_dropout: float = 0.0, n_layers: int = 4, share_weight: bool = False,
                 share_fork: bool = False, factor: int = 2, ff_weight_norm: bool = False,
                 n_ff_layers: int = 2, gain: float = 1.0, layer_norm: bool = False,
                 use_fork: bool = False, mode: str = "full"):
        super().__init__(modes, width, input_dim, dropout, in_dropout, n_layers, share_weight,
                         share_fork, factor, ff_weight_norm, n_ff_layers, gain, layer_norm,
                         use_fork)
