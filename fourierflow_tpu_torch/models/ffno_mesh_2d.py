"""Factorized FNO on structured 2D meshes, airfoil and pipe (counterpart of
``fourierflow_tpu/models/ffno_mesh_2d.py``).

The input ``[batch, sx, sy, input_dim - 2]`` (the mesh coordinates) gets
two unit-square grid channels, ``in_proj``, and zero padding by
``padding`` on the high side of both spatial axes (the domain is not
periodic). Per layer: the separable spectral mix along both axes with
separate ``modes_x`` / ``modes_y`` (``ops.fused_mix_2d``, the CUDA kernel on
a CUDA tensor), the feed-forward "backcast" (``ops.fused_ff`` through
``layers.FeedForward``) and the residual ``x = x + backcast``. The padding
is cut from the last backcast, and the head (two weight-normed linear
layers, no activation between them, as in the JAX package) gives one
output channel.

On a ``data x model`` mesh (``set_parallel``) the layers take the grid
model's tensor-parallel form (``models/ffno_grid_2d.py``): the Fourier
weights are column shards ``[width, width/tp, modes, 2]``
(``parallel.shard_state``), so the mix gives this rank's output channels
(kernel B on the shard), all-gathered before the feed-forward's hidden
slice (``layers.FeedForward``, kernel A); x's gradient from the mix is
summed over the axis. A weight that the axis does not divide stays whole,
and so does the CNO subclass's real DCT weight ``[width, width, modes]``
(JAX's ``_tp_spec`` splits rank-4 and rank-5 Fourier weights only); its
feed-forwards split. The model has no spatially split form and no
dropout.

Parameter names follow the grid model's (``models/ffno_grid_2d.py``):
``in_proj.*``, ``spectral_layers.{i}.fourier_weight.{0,1}`` (X then Y,
``[width, width, modes, 2]``), ``spectral_layers.{i}.backcast_ff.layers.{j}.0.*``
and ``out.{0,1}.*``; with ``share_weight`` the shared pair also appears at
block level (``fourier_weight.{0,1}``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import FeedForward, WNLinear, _linspace, xavier_normal_init
from ..ops.fused_spectral import fused_mix_2d
from .ffno_grid_2d import ColumnParallel, _SpectralLayer, column_split_mix

__all__ = ["FNOFactorizedMesh2D", "get_grid_2d"]


def get_grid_2d(batch: int, size_x: int, size_y: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Unit-square coordinate channels ``[batch, size_x, size_y, 2]``, the
    points of the JAX package's ``linspace(0, 1)`` to the bit."""
    gx = _linspace(0.0, 1.0, size_x, dtype, device)[None, :, None, None]
    gy = _linspace(0.0, 1.0, size_y, dtype, device)[None, None, :, None]
    return torch.cat([gx.expand(batch, size_x, size_y, 1),
                      gy.expand(batch, size_x, size_y, 1)], dim=-1)


class FNOFactorizedMesh2D(ColumnParallel, nn.Module):
    """``forward`` takes ``[batch, sx, sy, input_dim - 2]`` and returns
    ``[batch, sx, sy, 1]``."""

    _pair = (2,)  # the per-mode weight's trailing dims (real, imaginary)

    def __init__(self, modes_x: int, modes_y: int, width: int, input_dim: int, n_layers: int,
                 share_weight: bool = False, factor: int = 4, ff_weight_norm: bool = True,
                 n_ff_layers: int = 2, layer_norm: bool = False, padding: int = 8):
        super().__init__()
        self.share_weight, self.padding = share_weight, padding
        self.in_proj = WNLinear(input_dim, width, wnorm=ff_weight_norm)
        make_w = lambda: nn.ParameterList(
            [nn.Parameter(torch.empty(width, width, m, *self._pair)) for m in (modes_x, modes_y)])
        if share_weight:
            self.fourier_weight = make_w()
        self.spectral_layers = nn.ModuleList(
            _SpectralLayer(self.fourier_weight if share_weight else make_w(),
                           FeedForward(width, factor, ff_weight_norm, n_ff_layers, layer_norm),
                           None)
            for _ in range(n_layers))
        self.out = nn.Sequential(WNLinear(width, 128, wnorm=ff_weight_norm),
                                 WNLinear(128, 1, wnorm=ff_weight_norm))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator=None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device: Fourier weights ``xavier_normal_``, linear
        layers torch's default."""
        self.in_proj.reset_parameters(generator)
        weights = [self.fourier_weight] if self.share_weight else [
            layer.fourier_weight for layer in self.spectral_layers]
        for pair in weights:
            for w in pair:
                xavier_normal_init(w, 1.0, generator)
        for layer in self.spectral_layers:
            layer.backcast_ff.reset_parameters(generator)
        for lin in self.out:
            lin.reset_parameters(generator)

    @staticmethod
    def _mix(x: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
        """The separable mix of both axes."""
        return fused_mix_2d(x, wy, wx)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        b, sx, sy, _ = x.shape
        x = torch.cat([x, get_grid_2d(b, sx, sy, x.dtype, x.device)], dim=-1)
        x = self.in_proj(x)
        p = self.padding
        if p:
            x = F.pad(x, (0, 0, 0, p, 0, p))
        h = x
        for layer in self.spectral_layers:
            h = layer.backcast_ff(column_split_mix(self._mix, x, *layer.fourier_weight,
                                                   self.tensor_parallel))
            x = x + h
        if p:
            h = h[:, :-p, :-p]
        return self.out(h)
