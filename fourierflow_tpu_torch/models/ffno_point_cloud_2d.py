"""Factorized FNO on 2D point clouds, elasticity (counterpart of
``fourierflow_tpu/models/ffno_point_cloud_2d.py``).

``fc0`` lifts the points' features; layer 0 takes them by the NUDFT
(``ops.nudft.nudft2d``) from the points, deformed by ``iphi`` where the
model has one, onto the truncated spectrum of a uniform ``s1 x s2`` grid and
inverts it there (``ops.fourier.irfftn``: the spectrum is not Hermitian,
and that inverse is the one the CPU computes, on every device). The middle
layers are the separable spectral mix of both grid axes (``ops.fused_mix_2d``,
the CUDA kernel on a CUDA tensor; both weights hold ``modes1`` modes), the
feed-forward (``ops.fused_ff`` through ``layers.FeedForward``: factor 2,
weight norm) and ``uc = uc + backcast + bs_grid(grid)``, with one
``bs_grid`` shared by layer 0 and every middle layer. The last layer mixes
the two corners of the grid's ``rfft2`` with full complex weights and
evaluates the result at the (deformed) query points by the inverse NUDFT,
plus ``bs_points`` of the undeformed ones; the head is ``fc1`` (128), GELU
(tanh approximation, as flax's ``nn.gelu``) and ``fc2``. Every linear
layer but the feed-forward's has no weight norm.

On a ``data x model`` mesh (``set_parallel``) the middle layers take the
grid model's tensor-parallel form (``models/ffno_grid_2d.py``): the mix on
column shards of the Fourier weights (kernel B), this rank's output
channels gathered over ``model``, then the feed-forward's hidden slice
(2 x width / tp wide; kernel A). The NUDFT layers, ``last_weight``,
``fc*``, ``bs_*`` and IPhi stay whole on every rank, as JAX's ``_tp_spec``
leaves them. The model has no spatially split form and no dropout.

Parameter names: ``fc0``, ``bs_grid``, ``bs_points``, ``fc1``, ``fc2``
(``weight [out, in]``, ``bias``); ``spectral_layers.{j}.fourier_weight.{0,1}``
(Y then X, ``[width, width, modes1, 2]``) and
``spectral_layers.{j}.backcast_ff.layers.{k}.0.*`` for the JAX package's
middle layer ``j + 1``; with ``share_weight`` the shared pair also at block
level (``fourier_weight.{0,1}``); ``last_weight.{0,1}`` (``[width, width,
modes1, modes2, 2]``, the JAX package's ``last_weight_{1,2}``); ``iphi.*``.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import FeedForward, WNLinear, xavier_normal_init
from ..ops.fourier import irfftn
from ..ops.fused_spectral import fused_mix_2d
from ..ops.nudft import inudft2d, nudft2d
from .ffno_grid_2d import ColumnParallel, _SpectralLayer, column_split_mix
from .ffno_mesh_2d import get_grid_2d
from .zongyi_mesh_2d import geo_complex_init

__all__ = ["FNOFactorizedPointCloud2D", "halves_to_grid", "corner_mix"]


def halves_to_grid(yr: torch.Tensor, yi: torch.Tensor, s1: int, s2: int) -> torch.Tensor:
    """The NUDFT's spectrum halves ``[b, 2 * m1, m2, c]`` zero-padded into the
    ``rfft2`` layout of an ``s1 x s2`` grid (rows ``:m1`` and ``-m1:``, where
    they overlap the second wins) and inverted: ``[b, s1, s2, c]``."""
    b, two_m1, m2, c = yr.shape
    m1 = two_m1 // 2
    z = torch.complex(yr, yi)
    out = z.new_zeros(b, s1, s2 // 2 + 1, c)
    out[:, :m1, :m2] = z[:, :m1]
    out[:, -m1:, :m2] = z[:, m1:]
    return irfftn(out, (s1, s2), dim=(1, 2))


def corner_mix(uf: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Complex channel mixing of the spectrum ``uf [b, sx, sy//2+1, i]`` on its
    two corner blocks (the first and the last ``m1`` x frequencies, the first
    ``m2`` y frequencies) by ``w1, w2 [i, o, m1, m2, 2]``: ``[b, 2 * m1, m2,
    o]``, the first corner's rows first."""
    m1, m2 = w1.shape[2], w1.shape[3]
    cw = lambda w: torch.view_as_complex(w.contiguous())
    return torch.cat([torch.einsum("bxyi,ioxy->bxyo", uf[:, :m1, :m2], cw(w1)),
                      torch.einsum("bxyi,ioxy->bxyo", uf[:, -m1:, :m2], cw(w2))], dim=1)


class FNOFactorizedPointCloud2D(ColumnParallel, nn.Module):
    """``forward(u [batch, n_points, in_channels], code=None, x_in=None,
    x_out=None)`` returns ``[batch, n_points_out, out_channels]``; on a mesh
    (``is_mesh``) the points are ``u`` itself unless given."""

    def __init__(self, modes1: int, modes2: int, width: int, in_channels: int,
                 out_channels: int, n_layers: int = 4, is_mesh: bool = True, s1: int = 40,
                 s2: int = 40, share_weight: bool = False, iphi: Optional[nn.Module] = None):
        super().__init__()
        self.modes1, self.modes2, self.width = modes1, modes2, width
        self.is_mesh, self.s1, self.s2, self.share_weight = is_mesh, s1, s2, share_weight
        self.iphi = iphi
        self.fc0 = WNLinear(in_channels, width)
        self.bs_grid = WNLinear(2, width)
        self.bs_points = WNLinear(2, width)
        make_w = lambda: nn.ParameterList(
            [nn.Parameter(torch.empty(width, width, modes1, 2)) for _ in range(2)])
        if share_weight:
            self.fourier_weight = make_w()
        self.spectral_layers = nn.ModuleList(
            _SpectralLayer(self.fourier_weight if share_weight else make_w(),
                           FeedForward(width, 2, True, 2), None)
            for _ in range(n_layers - 1))
        self.last_weight = nn.ParameterList(
            [nn.Parameter(torch.empty(width, width, modes1, modes2, 2)) for _ in range(2)])
        self.fc1 = WNLinear(width, 128)
        self.fc2 = WNLinear(128, out_channels)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator=None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device: Fourier weights ``xavier_normal_``, the last
        layer's ``U(0, 1/width^2)`` on both parts, linear layers torch's
        default, and ``iphi``'s."""
        for lin in (self.fc0, self.bs_grid, self.bs_points, self.fc1, self.fc2):
            lin.reset_parameters(generator)
        weights = [self.fourier_weight] if self.share_weight else [
            layer.fourier_weight for layer in self.spectral_layers]
        for pair in weights:
            for w in pair:
                xavier_normal_init(w, 1.0, generator)
        for layer in self.spectral_layers:
            layer.backcast_ff.reset_parameters(generator)
        for w in self.last_weight:
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
        grid_bias = self.bs_grid(get_grid_2d(u.shape[0], self.s1, self.s2, u.dtype, u.device))

        uc = halves_to_grid(*nudft2d(self.fc0(u), xi_in, m1, m2), self.s1, self.s2) + grid_bias
        for layer in self.spectral_layers:
            h = column_split_mix(fused_mix_2d, uc.contiguous(), *layer.fourier_weight,
                                 self.tensor_parallel)
            uc = uc + layer.backcast_ff(h) + grid_bias

        mixed = corner_mix(torch.fft.rfft2(uc, dim=(1, 2)), *self.last_weight)
        pts = inudft2d(mixed.real, mixed.imag, xi_out, m1, m2) + self.bs_points(x_out)
        return self.fc2(F.gelu(self.fc1(pts), approximate="tanh"))
