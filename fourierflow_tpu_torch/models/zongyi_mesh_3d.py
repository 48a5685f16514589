"""The Geo-FNO structured-mesh 3D baseline, plasticity (counterpart of
``fourierflow_tpu/models/zongyi_mesh_3d.py``).

As the 2D Geo-FNO (``models/zongyi_mesh_2d.py``) on a 3D mesh: three grid
channels, padding 5 on the high side of the three spatial axes, the full
3D spectral convolution on the four (x, y) sign corners with the z
half-spectrum (``ops.spectral.spectral_conv_3d_full``), and
``output_dim`` output channels. Parameter names: ``fc0.*``,
``convs.{i}.{0,1,2,3}`` (``[width, width, m1, m2, m3, 2]``, corners +x+y,
-x+y, +x-y, -x-y), ``ws.{i}.*``, ``fc1.*``, ``fc2.*``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import WNLinear
from ..ops.spectral import spectral_conv_3d_full
from .ffno_mesh_3d import get_grid_3d
from .zongyi_mesh_2d import dense_init, geo_complex_init

__all__ = ["FNOMesh3D"]


class FNOMesh3D(nn.Module):
    """``forward`` takes ``[batch, sx, sy, sz, 1]`` (the input field) and
    returns ``[batch, sx, sy, sz, output_dim]``."""

    def __init__(self, modes1: int, modes2: int, modes3: int, width: int, n_layers: int = 4,
                 padding: int = 5, output_dim: int = 4):
        super().__init__()
        self.width, self.n_layers, self.padding = width, n_layers, padding
        shape = (width, width, modes1, modes2, modes3, 2)
        self.fc0 = WNLinear(4, width)  # the field and the grid
        self.convs = nn.ModuleList(
            nn.ParameterList([nn.Parameter(torch.empty(shape)) for _ in range(4)])
            for _ in range(n_layers))
        self.ws = nn.ModuleList(WNLinear(width, width) for _ in range(n_layers))
        self.fc1 = WNLinear(width, 128)
        self.fc2 = WNLinear(128, output_dim)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator=None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device."""
        scale = 1.0 / (self.width * self.width)
        for lin in (self.fc0, *self.ws, self.fc1, self.fc2):
            dense_init(lin, generator)
        for ws in self.convs:
            for w in ws:
                geo_complex_init(w, scale, generator)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        b, sx, sy, sz, _ = x.shape
        x = self.fc0(torch.cat([x, get_grid_3d(b, sx, sy, sz, x.dtype, x.device)], dim=-1))
        p = self.padding
        if p:
            x = F.pad(x, (0, 0, 0, p, 0, p, 0, p))
        for i, (conv, w) in enumerate(zip(self.convs, self.ws, strict=True)):
            x = spectral_conv_3d_full(x, list(conv), norm="backward") + w(x)
            if i < self.n_layers - 1:
                x = F.gelu(x, approximate="tanh")
        if p:
            x = x[:, :-p, :-p, :-p]
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
