"""Learned-interpolation Navier-Stokes step (Kochkov et al. 2021), the
counterpart of ``fourierflow_tpu/models/learned_interpolation.py``.

One model step advances incompressible 2D Navier-Stokes on a staggered
(MAC) grid by a coarse ``dt``:

1. Learned advection: a periodic CNN reads ``(u, v)`` and gives, for each of
   the four advected quantities (u along x and y, v along x and y),
   corrections to a 4-point interpolation stencil. The corrections sum to
   zero, so every stencil reproduces constants and the untrained model (the
   CNN's last layer starts at zero) is the second-order central scheme.
2. Explicit diffusion (5-point stencil), the Kolmogorov forcing ``sin(k y)``
   on u and a linear drag.
3. The pressure projection: the staggered divergence's Poisson problem,
   diagonal in the DFT of the 5-point Laplacian, solved with ``torch.fft``
   (the inverse through ``ops.fourier.irfft2``, which the card computes as
   the CPU does).

Fields are ``[batch, X, Y]`` (the JAX package's model takes one field and
is vmapped). The CNN's convolutions run in full float32 on every device,
forward and backward: cuDNN's TF32 is off inside them, whatever
``torch.backends.cudnn.allow_tf32`` says, since a 32-step unroll compounds
the difference.
"""

import contextlib
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fourier import irfft2

__all__ = ["LearnedInterpolationStep", "PeriodicCNN", "pressure_projection", "advect_linear"]

# flax's lecun_normal: variance 1/fan_in from a normal truncated at +-2, whose
# standard deviation this constant is (jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978


@functools.lru_cache(maxsize=16)
def _inv_laplacian_2d(n1: int, n2: int, h: float, device: torch.device) -> torch.Tensor:
    """The inverse eigenvalues of the periodic 5-point Laplacian in the
    ``rfft2`` layout (float64 numpy, rounded once), with the zero mode set
    to 0: the pressure is defined up to a constant. Cached (do not modify)."""
    lam1 = (2.0 * np.cos(2.0 * np.pi * np.arange(n1) / n1) - 2.0) / h ** 2
    lam2 = (2.0 * np.cos(2.0 * np.pi * np.arange(n2 // 2 + 1) / n2) - 2.0) / h ** 2
    lam = lam1[:, None] + lam2[None, :]
    lam[0, 0] = 1.0
    inv = np.where(lam == 0.0, 0.0, 1.0 / lam).astype(np.float32)
    inv[0, 0] = 0.0
    return torch.from_numpy(inv).to(device)


def pressure_projection(u: torch.Tensor, v: torch.Tensor,
                        h: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The staggered velocities (u on the x faces, offset (1, 0.5); v on
    the y faces, (0.5, 1)) ``[..., X, Y]`` projected onto the
    divergence-free subspace: the cell-centred divergence's Poisson solve,
    then the pressure's face gradient taken off."""
    n1, n2 = u.shape[-2], u.shape[-1]
    div = (u - torch.roll(u, 1, -2)) / h + (v - torch.roll(v, 1, -1)) / h
    p_hat = torch.fft.rfft2(div) * _inv_laplacian_2d(n1, n2, float(h), u.device)
    p = irfft2(p_hat, (n1, n2))
    return u - (torch.roll(p, -1, -2) - p) / h, v - (torch.roll(p, -1, -1) - p) / h


def _stencil_values(phi: torch.Tensor, dim: int) -> torch.Tensor:
    """The 4 neighbours of a face along ``dim``, at -1, 0, +1 and +2 cells
    from the face between cells 0 and 1: ``[..., 4]``."""
    return torch.stack([torch.roll(phi, 1, dim), phi, torch.roll(phi, -1, dim),
                        torch.roll(phi, -2, dim)], -1)


def advect_linear(phi: torch.Tensor, dim: int) -> torch.Tensor:
    """The second-order central interpolation of ``phi`` to the face along
    ``dim`` (the scheme the learned correction perturbs)."""
    return 0.5 * (phi + torch.roll(phi, -1, dim))


@contextlib.contextmanager
def _no_tf32():
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous


class _Conv2dFloat32(torch.autograd.Function):
    """A 3x3 convolution of an already padded input, stride 1, with TF32
    off in the forward and in the backward (which autograd runs outside the
    forward's context)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        with _no_tf32():
            return F.conv2d(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        with _no_tf32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]], [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                list(ctx.needs_input_grad))
        return gx, gw, gb


class PeriodicCNN(nn.Module):
    """The interpolation-coefficient network: ``n_layers`` 3x3 convolutions
    with periodic padding and ReLU between them (Kochkov et al.: 6 layers of
    64 features), the last one (``out``) initialised to zero. Takes and
    gives channels first, ``[B, C, X, Y]``."""

    def __init__(self, features: int = 64, n_layers: int = 6, out_channels: int = 16,
                 in_channels: int = 2):
        super().__init__()
        widths = [in_channels] + [features] * (n_layers - 1)
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3) for a, b in zip(widths[:-1], widths[1:]))
        self.out = nn.Conv2d(widths[-1], out_channels, 3)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """flax ``nn.Conv``'s default (LeCun normal kernels, zero biases);
        the ``out`` layer all zeros."""
        with torch.no_grad():
            for conv in self.convs:
                std = math.sqrt(1.0 / (conv.in_channels * 9)) / _TRUNC_STD
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                conv.bias.zero_()
            self.out.weight.zero_()
            self.out.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = lambda a: F.pad(a, (1, 1, 1, 1), mode="circular")
        for conv in self.convs:
            x = torch.relu(_Conv2dFloat32.apply(pad(x), conv.weight, conv.bias))
        return _Conv2dFloat32.apply(pad(x), self.out.weight, self.out.bias)


class LearnedInterpolationStep(nn.Module):
    """One Navier-Stokes step with learned advection interpolation:
    ``forward(u, v) -> (u, v)``, each ``[B, X, Y]`` at ``size``^2."""

    def __init__(self, size: int, dt: float, density: float = 1.0, viscosity: float = 1e-3,
                 forcing_wavenumber: int = 4, forcing_scale: float = 1.0, drag: float = 0.1,
                 domain_length: float = 2 * np.pi, features: int = 64, n_cnn_layers: int = 6):
        super().__init__()
        self.size, self.dt, self.viscosity, self.drag = size, dt, viscosity, drag
        self.h = domain_length / size
        self.coeff_net = PeriodicCNN(features, n_cnn_layers, out_channels=16)
        # The forcing on u at its faces' y (float64, rounded once) and the
        # central stencil, as buffers that move with the model.
        y = (np.arange(size) + 0.5) * self.h
        force_u = (forcing_scale * np.sin(forcing_wavenumber * y)).astype(np.float32)
        self.register_buffer("force_u", torch.from_numpy(force_u), persistent=False)
        self.register_buffer("base", torch.tensor([0.0, 0.5, 0.5, 0.0]), persistent=False)

    def reset_parameters(self, generator=None) -> None:
        self.coeff_net.reset_parameters(generator)

    def forward(self, u: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h, dt = self.h, self.dt
        # 16 channels: 4 interpolations x 4 taps, in flax's channel order.
        raw = self.coeff_net(torch.stack([u, v], 1)).permute(0, 2, 3, 1)
        raw = raw.reshape(*raw.shape[:-1], 4, 4)
        corr = raw - raw.mean(dim=-1, keepdim=True)  # corrections that sum to zero

        def interp(phi, dim, which):
            return (_stencil_values(phi, dim) * (self.base + corr[..., which, :])).sum(-1)

        # The advecting velocities at the flux faces: each staggered
        # component averaged onto the other's faces.
        u_at_v_face = 0.25 * (u + torch.roll(u, 1, -2) + torch.roll(u, -1, -1)
                              + torch.roll(torch.roll(u, 1, -2), -1, -1))
        v_at_u_face = 0.25 * (v + torch.roll(v, 1, -1) + torch.roll(v, -1, -2)
                              + torch.roll(torch.roll(v, 1, -1), -1, -2))

        # The flux-form advection of u (at the x faces), d(uu)/dx + d(vu)/dy ...
        uu_face = interp(u, -2, 0) * advect_linear(u, -2)
        vu_face = interp(u, -1, 1) * v_at_u_face
        adv_u = ((uu_face - torch.roll(uu_face, 1, -2)) / h
                 + (vu_face - torch.roll(vu_face, 1, -1)) / h)
        # ... and of v (at the y faces), d(uv)/dx + d(vv)/dy.
        uv_face = interp(v, -2, 2) * u_at_v_face
        vv_face = interp(v, -1, 3) * advect_linear(v, -1)
        adv_v = ((uv_face - torch.roll(uv_face, 1, -2)) / h
                 + (vv_face - torch.roll(vv_face, 1, -1)) / h)

        def laplacian(phi):
            return (torch.roll(phi, 1, -2) + torch.roll(phi, -1, -2) + torch.roll(phi, 1, -1)
                    + torch.roll(phi, -1, -1) - 4.0 * phi) / h ** 2

        du = -adv_u + self.viscosity * laplacian(u) + self.force_u[None, :] - self.drag * u
        dv = -adv_v + self.viscosity * laplacian(v) - self.drag * v
        return pressure_projection(u + dt * du, v + dt * dv, h)
