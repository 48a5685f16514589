"""The Geo-FNO structured-mesh 2D baseline, airfoil and pipe (counterpart of
``fourierflow_tpu/models/zongyi_mesh_2d.py``).

Grid channels appended to the mesh coordinates, ``fc0``, zero padding by
``padding`` on the high side of both axes, then per layer the full 2D
spectral convolution (``ops.spectral.spectral_conv_2d_full``) plus a
channel-linear residual branch ``ws``, with a GELU after every layer but
the last; the padding is cut, and ``fc1`` -> GELU -> ``fc2`` gives one
channel. GELU is the tanh approximation, as flax's ``nn.gelu``.

Initialisation as the JAX package's: the spectral weights ``scale *
U(0, 1)`` on both parts with ``scale = 1 / width^2``, the linear layers
flax's ``Dense`` default (LeCun normal, truncated at two standard
deviations, zero bias). Parameter names: ``fc0.*``, ``convs.{i}.{0,1}``
(``[width, width, m1, m2, 2]``), ``ws.{i}.*``, ``fc1.*``, ``fc2.*``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import WNLinear
from ..ops.spectral import spectral_conv_2d_full
from .ffno_mesh_2d import get_grid_2d

__all__ = ["FNOMesh2D", "geo_complex_init", "dense_init"]

# flax's lecun_normal: variance 1/fan_in from a normal truncated at +-2, whose
# standard deviation this constant is (jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978


def geo_complex_init(weight: torch.Tensor, scale: float, generator=None) -> None:
    """torch's ``scale * rand(..., dtype=cfloat)`` on a real/imaginary pair
    tensor: each part ~ U(0, scale); in place."""
    with torch.no_grad():
        weight.uniform_(0.0, scale, generator=generator)


def dense_init(lin: WNLinear, generator=None) -> None:
    """flax ``nn.Dense``'s default initialisation of a linear layer without
    weight norm: LeCun normal weight, zero bias; in place."""
    std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        lin.bias.zero_()


class FNOMesh2D(nn.Module):
    """``forward`` takes ``[batch, sx, sy, 2]`` (the mesh coordinates) and
    returns ``[batch, sx, sy, 1]``."""

    def __init__(self, modes1: int, modes2: int, width: int, n_layers: int = 4,
                 padding: int = 8):
        super().__init__()
        self.width, self.n_layers, self.padding = width, n_layers, padding
        shape = (width, width, modes1, modes2, 2)
        self.fc0 = WNLinear(4, width)  # the coordinates and the grid
        self.convs = nn.ModuleList(
            nn.ParameterList([nn.Parameter(torch.empty(shape)) for _ in range(2)])
            for _ in range(n_layers))
        self.ws = nn.ModuleList(WNLinear(width, width) for _ in range(n_layers))
        self.fc1 = WNLinear(width, 128)
        self.fc2 = WNLinear(128, 1)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator=None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device."""
        scale = 1.0 / (self.width * self.width)
        for lin in (self.fc0, *self.ws, self.fc1, self.fc2):
            dense_init(lin, generator)
        for pair in self.convs:
            for w in pair:
                geo_complex_init(w, scale, generator)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        b, sx, sy, _ = x.shape
        x = self.fc0(torch.cat([x, get_grid_2d(b, sx, sy, x.dtype, x.device)], dim=-1))
        p = self.padding
        if p:
            x = F.pad(x, (0, 0, 0, p, 0, p))
        for i, (conv, w) in enumerate(zip(self.convs, self.ws, strict=True)):
            x = spectral_conv_2d_full(x, *conv, norm="backward") + w(x)
            if i < self.n_layers - 1:
                x = F.gelu(x, approximate="tanh")
        if p:
            x = x[:, :-p, :-p]
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
