"""Uniform periodic grids and spectral helpers on the 2D torus
(counterpart of ``fourierflow_tpu/utils/grids.py``).

Wavenumbers are in cycles per unit length, as jax-cfd's ``Grid.rfft_mesh``
gives them: for a domain of length L the integer mode k has wavenumber
k/L, so a spectral derivative multiplies by ``2*pi*i*k``. The meshes are
numpy constants; the transforms run with ``torch.fft`` on the field's
device.
"""

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.fourier import irfft2

__all__ = ["Grid", "rfft_mesh", "fft_mesh", "laplacian_hat", "velocity_from_vorticity"]

TWO_PI = 2.0 * np.pi
TORUS = ((0, TWO_PI), (0, TWO_PI))


class Grid:
    """A uniform periodic grid (the config targets ``fourierflow.utils.Grid``
    and ``jax_cfd.base.grids.Grid``): ``shape`` cells over ``domain`` (one
    ``(lo, hi)`` an axis), or over ``(0, step * n)`` an axis. The cell size
    is ``step = L / n``; ``axes(offset)`` and ``mesh(offset)`` give the
    points at ``offset`` cells into each cell (0.5, the centres, by
    default), as numpy arrays."""

    def __init__(self, shape, step=None, domain=None):
        self.shape = tuple(int(s) for s in shape)
        if domain is not None:
            self.domain = tuple((float(a), float(b)) for a, b in domain)
        else:
            step = step if step is not None else 1.0
            steps = (step,) * len(self.shape) if np.ndim(step) == 0 else step
            self.domain = tuple((0.0, float(s) * n) for s, n in zip(steps, self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def step(self):
        return tuple((d[1] - d[0]) / n for d, n in zip(self.domain, self.shape))

    def axes(self, offset=0.5):
        return tuple(d[0] + (np.arange(n) + offset) * ((d[1] - d[0]) / n)
                     for d, n in zip(self.domain, self.shape))

    def mesh(self, offset=None):
        """float32 ``meshgrid`` (``ij``) of the points at ``offset`` (one an axis)."""
        offs = offset if offset is not None else (0.5,) * self.ndim
        axes = [d[0] + (np.arange(n) + o) * ((d[1] - d[0]) / n)
                for d, n, o in zip(self.domain, self.shape, offs)]
        return tuple(m.astype(np.float32) for m in np.meshgrid(*axes, indexing="ij"))

    def rfft_mesh(self):
        return rfft_mesh(self.shape, self.domain)

    def fft_mesh(self):
        return fft_mesh(self.shape, self.domain)


def _domain_lengths(domain) -> Tuple[float, float]:
    (x0, x1), (y0, y1) = domain
    return float(x1) - float(x0), float(y1) - float(y0)


def rfft_mesh(shape: Sequence[int], domain=TORUS):
    """``(kx, ky)`` wavenumber meshes of the ``rfft2`` layout ``[nx, ny//2+1]``,
    float32."""
    nx, ny = shape
    lx, ly = _domain_lengths(domain)
    kx = np.fft.fftfreq(nx, d=lx / nx)
    ky = np.fft.rfftfreq(ny, d=ly / ny)
    kxm, kym = np.meshgrid(kx, ky, indexing="ij")
    return kxm.astype(np.float32), kym.astype(np.float32)


def fft_mesh(shape: Sequence[int], domain=TORUS):
    """``(kx, ky)`` wavenumber meshes of the full ``fft2`` layout ``[nx, ny]``,
    float32."""
    nx, ny = shape
    lx, ly = _domain_lengths(domain)
    kx = np.fft.fftfreq(nx, d=lx / nx)
    ky = np.fft.fftfreq(ny, d=ly / ny)
    kxm, kym = np.meshgrid(kx, ky, indexing="ij")
    return kxm.astype(np.float32), kym.astype(np.float32)


def laplacian_hat(shape: Sequence[int], domain=TORUS) -> np.ndarray:
    """``(2*pi*i)^2 (kx^2 + ky^2)`` on the ``rfft2`` layout, real and
    negative, with the (0, 0) entry set to 1 so that the Poisson solve is
    defined."""
    kx, ky = rfft_mesh(shape, domain)
    lap = -(TWO_PI ** 2) * (kx ** 2 + ky ** 2)
    lap[0, 0] = 1.0
    return lap


def velocity_from_vorticity(w: torch.Tensor, domain=TORUS):
    """``(u, v)`` from the vorticity through the streamfunction: ``psi =
    -w / lap``, ``u = d(psi)/dy``, ``v = -d(psi)/dx``.

    ``w`` is ``[..., nx, ny]`` real (the last two axes spatial); ``u`` and
    ``v`` have its shape and type. The inverse is ``ops.fourier.irfft2``,
    which drops the imaginary parts of the y bins 0 and ny/2 as the CPU's
    ``torch.fft.irfft2`` does, on every device."""
    nx, ny = w.shape[-2], w.shape[-1]
    domain = tuple((float(a), float(b)) for a, b in domain)
    neg_lap, d_y, d_x = _velocity_factors(nx, ny, domain, w.device)
    psi = torch.fft.rfft2(w.float(), dim=(-2, -1)) / neg_lap
    u = irfft2(psi * d_y, (nx, ny), dim=(-2, -1))
    v = irfft2(psi * d_x, (nx, ny), dim=(-2, -1))
    return u.to(w.dtype), v.to(w.dtype)


@functools.lru_cache(maxsize=32)
def _velocity_factors(nx: int, ny: int, domain, device: torch.device):
    """``-lap``, ``2 pi i ky`` and ``-2 pi i kx`` on ``device`` (cached, so
    that a call copies nothing from the host; do not modify)."""
    kx, ky = rfft_mesh((nx, ny), domain)
    const = lambda a: torch.from_numpy(a).to(device)
    return (const(-laplacian_hat((nx, ny), domain)), 1j * const(TWO_PI * ky),
            -1j * const(TWO_PI * kx))
