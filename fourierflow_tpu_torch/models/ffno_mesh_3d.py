"""Factorized FNO on structured 3D meshes, plasticity (counterpart of
``fourierflow_tpu/models/ffno_mesh_3d.py``).

As the 2D mesh model, with three grid channels, padding on the high side
of all three spatial axes, and three separable spectral branches (x, y,
z) summed in each layer. The branches are the plain
``ops.spectral.spectral_mix_axis`` (torch matmuls against truncated-DFT
bases), as the JAX package computes them outside any Pallas kernel; the
feed-forward runs ``ops.fused_ff`` (the CUDA kernel on a CUDA tensor). The
head gives ``output_dim`` channels.

On a ``data x model`` mesh (``set_parallel``) the three Fourier weights are
column shards ``[width, width/tp, modes, 2]`` (``parallel.shard_state``):
x enters the three branches once (its gradient from them summed over the
axis), they give this rank's output channels, summed X + Y + Z, and the
sum is all-gathered once before the feed-forward's hidden slice
(``layers.FeedForward``, kernel A). One gather of the sum is the three
gathers summed, element for element, at a third of the traffic. A weight
that the axis does not divide stays whole, and so does the CNO subclass's
real DCT weight ``[width, width, modes]`` (JAX's ``_tp_spec`` splits rank-4
and rank-5 Fourier weights only); its feed-forwards split. Under ``remat``
the collectives run inside the checkpointed layer. The model has no
spatially split form and no dropout.

Parameter names as the 2D mesh model's, with
``spectral_layers.{i}.fourier_weight.{0,1,2}`` for X, Y and Z. With
``remat`` each layer's three branches and feed-forward run under
``torch.utils.checkpoint`` (the layer's input kept, the rest recomputed in
the backward pass); the parameters are the same.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..layers import FeedForward, WNLinear, _linspace, xavier_normal_init
from ..ops.spectral import spectral_mix_axis
from .ffno_grid_2d import ColumnParallel, _SpectralLayer

__all__ = ["FNOFactorizedMesh3D", "get_grid_3d"]


def get_grid_3d(batch: int, sx: int, sy: int, sz: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Unit-cube coordinate channels ``[batch, sx, sy, sz, 3]``, the points of
    the JAX package's ``linspace(0, 1)`` to the bit."""
    axes = [_linspace(0.0, 1.0, n, dtype, device) for n in (sx, sy, sz)]
    grids = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(grids, dim=-1)[None].expand(batch, sx, sy, sz, 3)


class FNOFactorizedMesh3D(ColumnParallel, nn.Module):
    """``forward`` takes ``[batch, sx, sy, sz, input_dim - 3]`` and returns
    ``[batch, sx, sy, sz, output_dim]``."""

    # The per-mode weight's trailing dims (real, imaginary) and one separable
    # branch, ``mix_axis(x, w, axis)``; the CNO model replaces both.
    _pair = (2,)
    _mix_axis = staticmethod(spectral_mix_axis)

    def __init__(self, modes_x: int, modes_y: int, modes_z: int, width: int, input_dim: int,
                 output_dim: int, n_layers: int, share_weight: bool = False, factor: int = 4,
                 ff_weight_norm: bool = True, n_ff_layers: int = 2, layer_norm: bool = False,
                 padding: int = 8, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.share_weight, self.padding = share_weight, padding
        self.width, self.n_layers = width, n_layers
        self.in_proj = WNLinear(input_dim, width, wnorm=ff_weight_norm)
        make_w = lambda: nn.ParameterList(
            [nn.Parameter(torch.empty(width, width, m, *self._pair))
             for m in (modes_x, modes_y, modes_z)])
        if share_weight:
            self.fourier_weight = make_w()
        self.spectral_layers = nn.ModuleList(
            _SpectralLayer(self.fourier_weight if share_weight else make_w(),
                           FeedForward(width, factor, ff_weight_norm, n_ff_layers, layer_norm),
                           None)
            for _ in range(n_layers))
        self.out = nn.Sequential(WNLinear(width, 128, wnorm=ff_weight_norm),
                                 WNLinear(128, output_dim, wnorm=ff_weight_norm))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator=None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device: Fourier weights ``xavier_normal_``, linear
        layers torch's default."""
        self.in_proj.reset_parameters(generator)
        weights = [self.fourier_weight] if self.share_weight else [
            layer.fourier_weight for layer in self.spectral_layers]
        for triple in weights:
            for w in triple:
                xavier_normal_init(w, 1.0, generator)
        for layer in self.spectral_layers:
            layer.backcast_ff.reset_parameters(generator)
        for lin in self.out:
            lin.reset_parameters(generator)

    def _layer(self, layer, x: torch.Tensor) -> torch.Tensor:
        """One layer's three branches, summed, through its feed-forward."""
        wx, wy, wz = layer.fourier_weight
        x = self.mix_input(x, wx)
        mixed = self._mix_axis(x, wx, 1) + self._mix_axis(x, wy, 2) + self._mix_axis(x, wz, 3)
        return layer.backcast_ff(self.mix_output(mixed, wx, 4))

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        b, sx, sy, sz, _ = x.shape
        x = torch.cat([x, get_grid_3d(b, sx, sy, sz, x.dtype, x.device)], dim=-1)
        x = self.in_proj(x)
        p = self.padding
        if p:
            x = F.pad(x, (0, 0, 0, p, 0, p, 0, p))
        h = x
        for layer in self.spectral_layers:
            h = checkpoint(self._layer, layer, x, use_reentrant=False) if self.remat else \
                self._layer(layer, x)
            x = x + h
        if p:
            h = h[:, :-p, :-p, :-p]
        return self.out(h)
