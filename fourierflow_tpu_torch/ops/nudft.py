"""Non-uniform direct Fourier transforms of the Geo-FNO point-cloud layers
(counterpart of ``fourierflow_tpu/ops/nudft.py``): a direct transform
between scattered points and a truncated uniform spectrum through the basis
``exp(-+ 2 pi i <x, k>)``, as cos/sin bases and einsums in plain torch (no
kernel computes them in the JAX package either).

Mode layout: ``2 * modes1`` x frequencies ``[0..modes1-1, -modes1..-1]`` and
``2 * modes2 - 1`` y frequencies ``[0..modes2-1, -(modes2-1)..-1]``; the
forward keeps the non-negative y half ``[..., :modes2]``, the inverse
extends it to the other half as the JAX package does.
"""

import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["nudft_wavenumbers", "nudft2d", "inudft2d", "nudft_axis", "inudft_axis"]


def nudft_wavenumbers(modes1: int, modes2: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(k1 [2 * modes1], k2 [2 * modes2 - 1])`` float32 frequency vectors."""
    k1 = np.concatenate([np.arange(0, modes1), np.arange(-modes1, 0)]).astype(np.float32)
    k2 = np.concatenate([np.arange(0, modes2), np.arange(-(modes2 - 1), 0)]).astype(np.float32)
    return k1, k2


def _basis(x: torch.Tensor, modes1: int, modes2: int, y_modes: int):
    """``(cos, sin)`` of ``2 pi <x, k>``, each ``[batch, n_points, 2 * modes1,
    y_modes]`` for the first ``y_modes`` y frequencies."""
    r = lambda lo, hi: torch.arange(lo, hi, device=x.device, dtype=x.dtype)
    k1 = torch.cat([r(0, modes1), r(-modes1, 0)])  # nudft_wavenumbers, made on x's device
    k2 = torch.cat([r(0, modes2), r(-(modes2 - 1), 0)])
    ang = x[..., 0, None, None] * k1[:, None] + x[..., 1, None, None] * k2[:y_modes]
    ang = 2 * math.pi * ang
    return torch.cos(ang), torch.sin(ang)


def nudft2d(u: torch.Tensor, x: torch.Tensor, modes1: int, modes2: int):
    """Forward NUDFT of scattered values ``u [batch, n_points, channels]`` at
    points ``x [batch, n_points, 2]``: ``(real, imag)``, each ``[batch, 2 *
    modes1, modes2, channels]``, the non-negative y half of the spectrum."""
    cr, si = _basis(x, modes1, modes2, modes2)
    return torch.einsum("bnc,bnxy->bxyc", u, cr), -torch.einsum("bnc,bnxy->bxyc", u, si)


def inudft2d(u_r: torch.Tensor, u_i: torch.Tensor, x: torch.Tensor, modes1: int,
             modes2: int) -> torch.Tensor:
    """Inverse NUDFT of the spectrum halves ``u_r, u_i [batch, 2 * modes1,
    modes2, channels]`` at query points ``x [batch, n_points, 2]``: ``[batch,
    n_points, channels]``. The negative y columns are the y > 0 columns
    conjugated and flipped along both axes, as in the JAX package (the row
    flip maps frequency k to -(k + 1)); then ``Re(sum u exp(+i ang))``."""
    ur = torch.cat([u_r, torch.flip(u_r[:, :, 1:], dims=(1, 2))], dim=2)
    ui = torch.cat([u_i, -torch.flip(u_i[:, :, 1:], dims=(1, 2))], dim=2)
    cr, si = _basis(x, modes1, modes2, 2 * modes2 - 1)
    return torch.einsum("bxyc,bnxy->bnc", ur, cr) - torch.einsum("bxyc,bnxy->bnc", ui, si)


def _axis_basis(coord: torch.Tensor, modes: int):
    k = torch.arange(modes, dtype=coord.dtype, device=coord.device)
    ang = 2 * math.pi * coord[..., None] * k
    return torch.cos(ang), torch.sin(ang)


def nudft_axis(u: torch.Tensor, coord: torch.Tensor, modes: int):
    """Forward NUDFT along one coordinate ``coord [batch, n_points]`` onto the
    frequencies ``0..modes-1``: ``(real, imag)``, each ``[batch, modes,
    channels]``, of ``sum_n u_n exp(-2 pi i coord_n k)``."""
    cr, si = _axis_basis(coord, modes)
    return torch.einsum("bnc,bnm->bmc", u, cr), -torch.einsum("bnc,bnm->bmc", u, si)


def inudft_axis(u_r: torch.Tensor, u_i: torch.Tensor, coord: torch.Tensor,
                modes: int) -> torch.Tensor:
    """Inverse of one axis's truncated positive-frequency spectrum ``[batch,
    modes, channels]`` at ``coord [batch, n_points]``: ``Re(sum_k u_k exp(+2
    pi i coord_n k))``, ``[batch, n_points, channels]``."""
    cr, si = _axis_basis(coord, modes)
    return torch.einsum("bmc,bnm->bnc", u_r, cr) - torch.einsum("bmc,bnm->bnc", u_i, si)
