"""The Geo-FNO point-cloud 2D baseline, elasticity (counterpart of
``fourierflow_tpu/models/zongyi_point_cloud_2d.py``).

``fc0`` lifts the points' features; layer 0 takes them by the NUDFT from
the points (deformed by ``iphi`` where the model has one) onto the
truncated spectrum, mixes its two corners with full complex weights and
inverts it onto the uniform ``s1 x s2`` grid, plus ``bs.0`` of the grid,
then GELU. Each middle layer is the full 2D spectral convolution
(``ops.spectral.spectral_conv_2d_full``) plus ``ws`` of the grid values and
``bs`` of the grid coordinates, then GELU. The last layer mixes the
corners of the grid's ``rfft2`` and evaluates them at the (deformed) query
points by the inverse NUDFT, plus ``bs`` of the undeformed points; the
head is ``fc1`` (128), GELU and ``fc2``. GELU is the tanh approximation, as
flax's ``nn.gelu``.

Initialisation as the JAX package's: the spectral weights ``U(0, 1/width^2)``
on both parts, the linear layers flax's ``Dense`` default. Parameter names:
``fc0``, ``convs.{i}.{0,1}`` (``[width, width, modes1, modes2, 2]``, i from
0 to ``n_layers``), ``ws.{i}`` (i from 0 to ``n_layers - 2``, the JAX
package's ``ws_{i}``), ``bs.{i}`` (0 to ``n_layers``), ``fc1``, ``fc2``,
``iphi.*``.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import WNLinear
from ..ops.nudft import inudft2d, nudft2d
from ..ops.spectral import spectral_conv_2d_full
from .ffno_mesh_2d import get_grid_2d
from .ffno_point_cloud_2d import corner_mix, halves_to_grid
from .zongyi_mesh_2d import dense_init, geo_complex_init

__all__ = ["FNOPointCloud2D"]


class FNOPointCloud2D(nn.Module):
    """``forward(u [batch, n_points, in_channels], code=None, x_in=None,
    x_out=None)`` returns ``[batch, n_points_out, out_channels]``; on a mesh
    (``is_mesh``) the points are ``u`` itself unless given."""

    def __init__(self, modes1: int, modes2: int, width: int, in_channels: int,
                 out_channels: int, n_layers: int = 4, is_mesh: bool = True, s1: int = 40,
                 s2: int = 40, iphi: Optional[nn.Module] = None):
        super().__init__()
        self.modes1, self.modes2, self.width = modes1, modes2, width
        self.is_mesh, self.s1, self.s2 = is_mesh, s1, s2
        self.iphi = iphi
        shape = (width, width, modes1, modes2, 2)
        self.fc0 = WNLinear(in_channels, width)
        self.convs = nn.ModuleList(
            nn.ParameterList([nn.Parameter(torch.empty(shape)) for _ in range(2)])
            for _ in range(n_layers + 1))
        self.ws = nn.ModuleList(WNLinear(width, width) for _ in range(n_layers - 1))
        self.bs = nn.ModuleList(WNLinear(2, width) for _ in range(n_layers + 1))
        self.fc1 = WNLinear(width, 128)
        self.fc2 = WNLinear(128, out_channels)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator=None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device, and ``iphi``'s."""
        for lin in (self.fc0, *self.ws, *self.bs, self.fc1, self.fc2):
            dense_init(lin, generator)
        for pair in self.convs:
            for w in pair:
                geo_complex_init(w, 1.0 / (self.width * self.width), generator)
        if self.iphi is not None:
            self.iphi.reset_parameters(generator)

    def forward(self, u: torch.Tensor, code: Optional[torch.Tensor] = None,
                x_in: Optional[torch.Tensor] = None, x_out: Optional[torch.Tensor] = None,
                **kwargs) -> torch.Tensor:
        if self.is_mesh and x_in is None:
            x_in = u
        if self.is_mesh and x_out is None:
            x_out = u
        m1, m2 = self.modes1, self.modes2
        xi_in = self.iphi(x_in, code) if self.iphi is not None else x_in
        xi_out = xi_in if x_out is x_in else (
            self.iphi(x_out, code) if self.iphi is not None else x_out)
        grid = get_grid_2d(u.shape[0], self.s1, self.s2, u.dtype, u.device)

        yr, yi = nudft2d(self.fc0(u), xi_in, m1, m2)
        mixed = corner_mix(torch.complex(yr, yi), *self.convs[0])
        uc = F.gelu(halves_to_grid(mixed.real, mixed.imag, self.s1, self.s2) + self.bs[0](grid),
                    approximate="tanh")
        for i, w in enumerate(self.ws, 1):
            uc = F.gelu(spectral_conv_2d_full(uc, *self.convs[i]) + w(uc) + self.bs[i](grid),
                        approximate="tanh")

        mixed = corner_mix(torch.fft.rfft2(uc, dim=(1, 2)), *self.convs[-1])
        pts = inudft2d(mixed.real, mixed.imag, xi_out, m1, m2) + self.bs[-1](x_out)
        return self.fc2(F.gelu(self.fc1(pts), approximate="tanh"))
