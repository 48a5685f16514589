"""Fully-factorized Geo-FNO on 2D point clouds, the "mesh_plus" variant
(counterpart of ``fourierflow_tpu/models/ffno_mesh_plus_2d.py``). No
registry name uses it.

Each layer has two independent per-axis branches. Layer 0 takes the
points' features by a per-axis NUDFT (``ops.nudft.nudft_axis``) onto the
frequencies ``0..m-1``, mixes them per mode and inverts them by a real DFT
(backward norm) onto a regular axis, broadcast along the other grid axis;
then the feed-forward and ``bs_grid`` of the grid. The middle layers are
the separable mix of the grid (``ops.fused_mix_2d``, the CUDA kernel on a
CUDA tensor), the feed-forward (``ops.fused_ff`` through
``layers.FeedForward``, the CUDA kernel where it takes the fused shape) and
``uc = uc + backcast + bs_grid(grid)``. The last layer has no feed-forward:
each branch transforms the grid along its axis, sums the other axis, mixes
and evaluates the spectrum at the query coordinates
(``ops.nudft.inudft_axis``), plus ``bs_points``; the head is ``fc1`` (128),
GELU (tanh approximation) and ``fc2``.

On a ``data x model`` mesh (``set_parallel``) every layer's Fourier weights
are column shards ``[width, width/tp, m, 2]`` (``parallel.shard_state``),
so each mix gives this rank's output channels, and the axis sums the
gradient of each mix's inputs once (the features and the coordinates of
the NUDFT layers, the grid of the others): layer 0's two branches are each
gathered ``[b, s, width]`` before their broadcast sum (two gathers of an
axis cost less than one of the grid); the middle layers run the grid
model's split mix (kernel B on the shard, ``column_split_mix``); the last
layer's two branches are summed on this rank's channels and gathered once.
Each feed-forward takes its hidden slice (kernel A). ``fc0``, ``bs_grid``,
``bs_points``, ``fc1``, ``fc2`` and ``iphi`` stay whole on every rank. The
model has no spatially split form.

As in the JAX package: the y branch reads coordinate 0 with ``modes2`` and
the x branch coordinate 1 with ``modes1``, and the x branch of the last
layer transforms the grid with its axes swapped. Initialisation: Fourier
weights ``xavier_normal_``, the feed-forwards torch's default, the other
linear layers flax's ``Dense`` default. Parameter names:
``spectral_layers.{i}.fourier_weight.{0,1}`` (Y ``[width, width, modes2,
2]``, then X with ``modes1``) for i from 0 to ``n_layers``,
``spectral_layers.{i}.backcast_ff.layers.{k}.0.*`` for i below
``n_layers``; ``fc0``, ``bs_grid``, ``bs_points``, ``fc1``, ``fc2``;
``iphi.*``.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import FeedForward, WNLinear, xavier_normal_init
from ..ops.dft import irdft_basis, rdft_basis
from ..ops.fused_spectral import fused_mix_2d
from ..ops.nudft import inudft_axis, nudft_axis
from .ffno_grid_2d import ColumnParallel, _SpectralLayer, column_split_mix
from .ffno_mesh_2d import get_grid_2d
from .zongyi_mesh_2d import dense_init

__all__ = ["FNOFullyFactorizedMesh2D"]


def _mix_modes(sr, si, w):
    """Per-mode complex channel mixing on one axis: s ``[b, m, i]``, w ``[i,
    o, m, 2]``."""
    wr, wi = w[..., 0], w[..., 1]
    yr = torch.einsum("bmi,iom->bmo", sr, wr) - torch.einsum("bmi,iom->bmo", si, wi)
    yi = torch.einsum("bmi,iom->bmo", sr, wi) + torch.einsum("bmi,iom->bmo", si, wr)
    return yr, yi


def _basis(arrays, like: torch.Tensor):
    return (torch.tensor(a, device=like.device, dtype=like.dtype) for a in arrays)


def _points_to_axis(feats, coord, w, s):
    """One branch of layer 0: NUDFT along ``coord``, mix, inverse real DFT
    (backward norm) onto a regular axis of length ``s``: ``[b, s, c]``."""
    m = w.shape[2]
    yr, yi = _mix_modes(*nudft_axis(feats, coord, m), w)
    cr, ci = _basis(irdft_basis(s, m, norm="backward"), yr)
    return torch.einsum("bmc,mn->bnc", yr, cr) + torch.einsum("bmc,mn->bnc", yi, ci)


def _grid_axis_to_points(x, coord, w):
    """One branch of the last layer: the real DFT of ``x [b, q, n, c]`` along
    axis 2 (backward norm), summed over axis 1, mixed and evaluated at
    ``coord``: ``[b, n_points, c]``."""
    m = w.shape[2]
    er, ei = _basis(rdft_basis(x.shape[2], m, norm="backward"), x)
    sr = torch.einsum("bqnc,nm->bqmc", x, er).sum(dim=1)
    si = torch.einsum("bqnc,nm->bqmc", x, ei).sum(dim=1)
    return inudft_axis(*_mix_modes(sr, si, w), coord, m)


class FNOFullyFactorizedMesh2D(ColumnParallel, nn.Module):
    """``forward(u [batch, n_points, in_channels], code=None, x_in=None,
    x_out=None)`` returns ``[batch, n_points_out, out_channels]``; on a mesh
    (``is_mesh``) the points are ``u`` itself unless given."""

    def __init__(self, modes1: int, modes2: int, width: int, in_channels: int,
                 out_channels: int, n_layers: int = 4, is_mesh: bool = True, s1: int = 40,
                 s2: int = 40, factor: int = 2, ff_weight_norm: bool = True,
                 n_ff_layers: int = 2, iphi: Optional[nn.Module] = None):
        super().__init__()
        self.is_mesh, self.s1, self.s2 = is_mesh, s1, s2
        self.iphi = iphi
        self.spectral_layers = nn.ModuleList(
            _SpectralLayer(
                nn.ParameterList([nn.Parameter(torch.empty(width, width, m, 2))
                                  for m in (modes2, modes1)]),
                FeedForward(width, factor, ff_weight_norm, n_ff_layers) if i < n_layers else None,
                None)
            for i in range(n_layers + 1))
        self.fc0 = WNLinear(in_channels, width)
        self.bs_grid = WNLinear(2, width)
        self.bs_points = WNLinear(2, width)
        self.fc1 = WNLinear(width, 128)
        self.fc2 = WNLinear(128, out_channels)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator=None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device, and ``iphi``'s."""
        for layer in self.spectral_layers:
            for w in layer.fourier_weight:
                xavier_normal_init(w, 1.0, generator)
            if hasattr(layer, "backcast_ff"):
                layer.backcast_ff.reset_parameters(generator)
        for lin in (self.fc0, self.bs_grid, self.bs_points, self.fc1, self.fc2):
            dense_init(lin, generator)
        if self.iphi is not None:
            self.iphi.reset_parameters(generator)

    def forward(self, u: torch.Tensor, code: Optional[torch.Tensor] = None,
                x_in: Optional[torch.Tensor] = None, x_out: Optional[torch.Tensor] = None,
                **kwargs) -> torch.Tensor:
        if self.is_mesh and x_in is None:
            x_in = u
        if self.is_mesh and x_out is None:
            x_out = u
        xi_in = self.iphi(x_in, code) if self.iphi is not None else x_in
        xi_out = xi_in if x_out is x_in else (
            self.iphi(x_out, code) if self.iphi is not None else x_out)
        grid_bias = self.bs_grid(get_grid_2d(u.shape[0], self.s1, self.s2, u.dtype, u.device))
        first, *middle, last = self.spectral_layers

        feats = self.fc0(u)
        wy, wx = first.fourier_weight
        # A split NUDFT layer gives part of its coordinates' gradient too (IPhi's).
        f, c = self.mix_input(feats, wy), self.mix_input(xi_in, wy)
        xy = self.mix_output(_points_to_axis(f, c[..., 0], wy, self.s2), wy, 2)  # [b, s2, c]
        xx = self.mix_output(_points_to_axis(f, c[..., 1], wx, self.s1), wx, 2)  # [b, s1, c]
        uc = first.backcast_ff(xy[:, None] + xx[:, :, None]) + grid_bias
        for layer in middle:
            h = column_split_mix(fused_mix_2d, uc.contiguous(), *layer.fourier_weight,
                                 self.tensor_parallel)
            uc = uc + layer.backcast_ff(h) + grid_bias

        wy, wx = last.fourier_weight
        g, c = self.mix_input(uc, wy), self.mix_input(xi_out, wy)
        pts = self.mix_output(_grid_axis_to_points(g, c[..., 0], wy)
                              + _grid_axis_to_points(g.transpose(1, 2), c[..., 1], wx), wy, 2)
        pts = pts + self.bs_points(x_out)
        return self.fc2(F.gelu(self.fc1(pts), approximate="tanh"))
