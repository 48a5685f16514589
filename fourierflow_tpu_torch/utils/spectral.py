"""Spectral and staggered-grid field utilities on the 2D torus
(counterpart of ``fourierflow_tpu/utils/spectral.py``): the vorticity to
velocity solve through the stream function, the isotropic 2/3-rule filter,
the finite-difference curl of staggered velocities, staggered
downsampling, the composite vorticity downsampling of the Kolmogorov
datasets and correlation metrics, and the correlation of two fields.

Fields are tensors whose last two axes are spatial; the transforms run
with ``torch.fft`` on the field's device. The spectral derivatives of a
real field are not Hermitian in the bins that are their own conjugates,
so every inverse goes through ``ops.fourier.irfft2``, which is defined
(and the same as the CPU's ``torch.fft.irfft2``) for any half-spectrum.
Constants are numpy, computed on the host and cached per device.
"""

import functools
from typing import Dict

import numpy as np
import torch

from ..ops.fourier import irfft2
from .grids import TORUS, Grid, laplacian_hat, rfft_mesh

__all__ = [
    "vorticity_to_velocity_solve",
    "circular_filter_2d",
    "velocity_to_vorticity_fd",
    "downsample_staggered_velocity",
    "downsample_vorticity_hat",
    "downsample_vorticity",
    "grid_correlation",
]

TWO_PI = 2.0 * np.pi


def div_real(z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``z / r`` for complex z and real r, each part divided once."""
    return torch.view_as_complex(torch.view_as_real(z) / r[..., None])


def _key(grid: Grid):
    return grid.shape, tuple((float(a), float(b)) for a, b in grid.domain)


@functools.lru_cache(maxsize=32)
def _solve_factors(shape, domain, device: torch.device):
    """``lap`` (real, (0, 0) set to 1), ``2 pi i ky`` and ``-2 pi i kx`` on
    ``device`` (do not modify)."""
    kx, ky = rfft_mesh(shape, domain)
    const = lambda a: torch.from_numpy(a).to(device)
    return (const(laplacian_hat(shape, domain)), const((TWO_PI * 1j * ky).astype(np.complex64)),
            const((-TWO_PI * 1j * kx).astype(np.complex64)))


def vorticity_to_velocity_solve(grid: Grid):
    """``solve(w_hat) -> (vx_hat, vy_hat)`` on the ``rfft2`` layout of
    ``grid``: ``psi = -w / lap``, ``vx = d(psi)/dy``, ``vy = -d(psi)/dx``."""
    shape, domain = _key(grid)

    def solve(w_hat: torch.Tensor):
        lap, d_y, d_x = _solve_factors(shape, domain, w_hat.device)
        psi_hat = -div_real(w_hat, lap)
        return d_y * psi_hat, d_x * psi_hat

    return solve


def circular_filter_2d(grid: Grid) -> np.ndarray:
    """The isotropic 2/3-rule low-pass mask on the ``rfft2`` layout (float32)."""
    kx, ky = rfft_mesh(grid.shape, grid.domain)
    k_max = float(grid.shape[0] // 2) / (grid.domain[0][1] - grid.domain[0][0])
    return ((kx ** 2 + ky ** 2) <= (2.0 / 3.0 * k_max) ** 2).astype(np.float32)


def velocity_to_vorticity_fd(vx: torch.Tensor, vy: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The finite-difference curl on the staggered grid,
    ``(roll(vy, -1, x) - vy) / dx - (roll(vx, -1, y) - vx) / dy``, on the
    last two axes."""
    dx, dy = grid.step
    dv_dx = (torch.roll(vy, shifts=-1, dims=-2) - vy) / dx
    du_dy = (torch.roll(vx, shifts=-1, dims=-1) - vx) / dy
    return dv_dx - du_dy


def _downsample_component(u: torch.Tensor, direction: int, factor: int,
                          ndim: int = 2) -> torch.Tensor:
    """One staggered velocity component: the fine faces that lie on each
    coarse face (stride ``factor`` from ``factor - 1`` along the face's
    axis), block-averaged along every other axis. The last ``ndim`` axes
    are spatial."""
    sl = [slice(None)] * u.dim()
    sl[u.dim() - ndim + direction] = slice(factor - 1, None, factor)
    u = u[tuple(sl)]
    for tr in range(ndim):
        if tr == direction:
            continue
        ax_tr = u.dim() - ndim + tr
        shape = list(u.shape)
        shape[ax_tr:ax_tr + 1] = [shape[ax_tr] // factor, factor]
        u = u.reshape(shape).mean(dim=ax_tr + 1)
    return u


def downsample_staggered_velocity(in_grid: Grid, out_grid: Grid, velocity):
    """Staggered velocities (component i at offset 1 along axis i, 0.5
    elsewhere) from ``in_grid`` to ``out_grid`` over the same domain."""
    factor = in_grid.shape[0] // out_grid.shape[0]
    if factor * out_grid.shape[0] != in_grid.shape[0]:
        raise ValueError(f"incompatible grids {in_grid.shape} -> {out_grid.shape}")
    return tuple(_downsample_component(v, i, factor, in_grid.ndim)
                 for i, v in enumerate(velocity))


def downsample_vorticity_hat(vorticity_hat: torch.Tensor, velocity_solve, in_grid: Grid,
                             out_grid: Grid) -> Dict[str, torch.Tensor]:
    """Spectral vorticity (the ``rfft2`` of ``[..., X, Y]`` fields) to the
    velocity, its staggered downsampling to ``out_grid`` and the
    finite-difference curl there: ``{"vx", "vy", "vorticity"}``."""
    vxhat, vyhat = velocity_solve(vorticity_hat)
    vx, vy = irfft2(torch.stack([vxhat, vyhat]), in_grid.shape)
    vx, vy = downsample_staggered_velocity(in_grid, out_grid, (vx, vy))
    return {"vx": vx, "vy": vy, "vorticity": velocity_to_vorticity_fd(vx, vy, out_grid)}


def downsample_vorticity(vorticity: torch.Tensor, out_size: int = 32,
                         domain=TORUS) -> torch.Tensor:
    """Vorticity trajectories ``[B, X, Y, T]`` to ``[B, out, out, T]``
    through the velocity (``downsample_vorticity_hat``), every field in one
    batched call."""
    _, sx, sy, _ = vorticity.shape
    in_grid = Grid(shape=(sx, sy), domain=domain)
    out_grid = Grid(shape=(out_size, out_size), domain=domain)
    w_hat = torch.fft.rfft2(vorticity.movedim(-1, 1), dim=(-2, -1))  # [B, T, X, Y//2+1]
    w = downsample_vorticity_hat(w_hat, vorticity_to_velocity_solve(in_grid), in_grid,
                                 out_grid)["vorticity"]
    return w.movedim(1, -1)


def grid_correlation(x: torch.Tensor, y: torch.Tensor, dims=(-2, -1)) -> torch.Tensor:
    """The normalised inner product of ``x`` and ``y`` over ``dims``."""
    xn = x / torch.linalg.vector_norm(x, dim=dims, keepdim=True)
    yn = y / torch.linalg.vector_norm(y, dim=dims, keepdim=True)
    return (xn * yn).sum(dim=dims)
