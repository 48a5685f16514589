"""FNO++, the torus_li ablation without factorization (counterpart of
``fourierflow_tpu/models/zongyi_fno_plus_2d.py``).

Each layer applies the original FNO's full 2D spectral weights (``[in,
out, m, m, 2]`` on two corner blocks of modes, ``ops.spectral_conv_2d_full``
with torch.fft) and keeps F-FNO's block structure around them: the
feed-forward backcast (``ops.fused_ff`` through ``layers.FeedForward``), the
residual ``x = x + backcast``, optional weight and feed-forward sharing,
weight norm and the forecast fork. No spectral kernel runs here; the JAX
package computes this conv outside Pallas too.

On a ``data x model`` mesh (``set_parallel``) the dense weights are column
shards ``[in, out/tp, m, m, 2]`` (``parallel.shard_state``): the
convolution gives this rank's output channels, all-gathered before the
feed-forwards, and x's gradient from it is summed over the axis; every
feed-forward (backcast, forecast and the shared ones) takes its hidden
slice (kernel A). ``mode="no-fourier"`` has no weights and splits its
feed-forwards only. On a ``data x spatial`` mesh each rank holds its X rows
``[batch, X/sp, Y, width]`` of the grid: the convolution gathers its
truncated Y spectrum over ``spatial`` and gives back this rank's rows
(``spectral_conv_2d_full`` with ``sp``, as FNO-4's layer), and the
feed-forwards (kernel A on this rank's rows), the residual and the head act
on each cell alone; ``no-fourier`` needs no collective. The two axes are not
combined, and dropout has no split form.

Parameter names follow the port's ``FNOFactorized2DBlock``: ``in_proj.*``,
``spectral_layers.{i}.fourier_weight.{0,1}`` (the first and the second
corner block), ``spectral_layers.{i}.backcast_ff.*`` and ``out.{j}.*``;
shared tensors also appear at block level.
"""

from functools import partial
from typing import Optional

import torch
import torch.nn as nn

from ..layers import FeedForward, WNLinear, xavier_normal_init
from ..ops.spectral import spectral_conv_2d_full
from .ffno_grid_2d import ColumnParallel, _SpectralLayer, column_split_mix

__all__ = ["FNOPlus2DBlock"]


class FNOPlus2DBlock(ColumnParallel, nn.Module):
    """Stack of full-spectral-weight layers with the factorized block
    structure. ``forward`` takes ``[batch, X, Y, input_dim]`` and returns
    ``{"forecast": [batch, X, Y, 1], "forecast_list": [...]}``."""

    spatial_parallel = None  # the ``spatial`` axis (``set_parallel``); None on one device

    def __init__(self, modes: int, width: int, input_dim: int = 12, dropout: float = 0.0,
                 in_dropout: float = 0.0, n_layers: int = 4, share_weight: bool = False,
                 share_fork: bool = False, factor: int = 2, ff_weight_norm: bool = False,
                 n_ff_layers: int = 2, gain: float = 1.0, layer_norm: bool = False,
                 use_fork: bool = False, mode: str = "full"):
        super().__init__()
        if mode not in ("full", "no-fourier"):
            raise ValueError(f"FNOPlus2DBlock mode must be 'full' or 'no-fourier', got {mode!r}")
        self.modes, self.width, self.n_layers = modes, width, n_layers
        self.share_weight, self.share_fork, self.use_fork = share_weight, share_fork, use_fork
        self.mode, self.gain, self.in_dropout, self.dropout = mode, gain, in_dropout, dropout

        self.in_proj = WNLinear(input_dim, width, wnorm=ff_weight_norm)
        wshape = (width, width, modes, modes, 2)
        make_w = lambda: nn.ParameterList([nn.Parameter(torch.empty(wshape)) for _ in range(2)])
        make_ff = lambda: FeedForward(width, factor, ff_weight_norm, n_ff_layers, layer_norm,
                                      dropout)
        full = mode == "full"
        if full and share_weight:
            self.fourier_weight = make_w()
        if share_fork:
            self.backcast_ff = make_ff()
            if use_fork:
                self.forecast_ff = make_ff()
        self.spectral_layers = nn.ModuleList(
            _SpectralLayer(
                (self.fourier_weight if share_weight else make_w()) if full else None,
                self.backcast_ff if share_fork else make_ff(),
                (self.forecast_ff if share_fork else make_ff()) if use_fork else None,
            )
            for _ in range(n_layers)
        )
        self.out = nn.Sequential(WNLinear(width, 128, wnorm=ff_weight_norm),
                                 WNLinear(128, 1, wnorm=ff_weight_norm))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device: shared spectral weights ``xavier_normal_``
        with ``gain``, per-layer ones with gain 1, as the JAX package does."""
        self.in_proj.reset_parameters(generator)
        if self.mode == "full" and self.share_weight:
            for w in self.fourier_weight:
                xavier_normal_init(w, self.gain, generator)
        if self.share_fork:
            self.backcast_ff.reset_parameters(generator)
            if self.use_fork:
                self.forecast_ff.reset_parameters(generator)
        for layer in self.spectral_layers:
            if self.mode == "full" and not self.share_weight:
                for w in layer.fourier_weight:
                    xavier_normal_init(w, 1.0, generator)
            if not self.share_fork:
                layer.backcast_ff.reset_parameters(generator)
                if self.use_fork:
                    layer.forecast_ff.reset_parameters(generator)
        for lin in self.out:
            lin.reset_parameters(generator)

    def set_parallel(self, tensor=None, spatial=None) -> None:
        """The ``Axis`` of the ``model`` or of the ``spatial`` mesh axis that
        the layers' split forms use (None for both: one device). Both raise
        the ``ValueError`` of both, and dropout on a split block raises."""
        if tensor is not None and spatial is not None:
            raise ValueError("tensor and spatial parallelism cannot be combined")
        if (tensor or spatial) and (self.dropout > 0 or self.in_dropout > 0):
            raise NotImplementedError("dropout has no parallel form: each rank would draw its own")
        super().set_parallel(tensor)
        self.spatial_parallel = spatial

    def forward(self, x: torch.Tensor):
        x = self.in_proj(x)
        if self.in_dropout > 0.0:
            x = nn.functional.dropout(x, self.in_dropout, self.training)
        forecast = 0.0
        forecast_list = []
        b = x
        for layer in self.spectral_layers:
            if self.mode == "no-fourier":
                h = x
            else:
                h = column_split_mix(partial(spectral_conv_2d_full, norm="ortho",
                                             sp=self.spatial_parallel), x,
                                     *layer.fourier_weight, self.tensor_parallel)
            b = layer.backcast_ff(h)
            if self.use_fork:
                f_out = self.out(layer.forecast_ff(h))
                forecast = forecast + f_out
                forecast_list.append(f_out)
            x = x + b
        if not self.use_fork:
            forecast = self.out(b)
        return {"forecast": forecast, "forecast_list": forecast_list}
