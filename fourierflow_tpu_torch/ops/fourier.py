"""Inverse real FFTs (2D and n-D) that are defined for every half-spectrum.

A real inverse FFT reads only half of the spectrum and assumes the rest by
Hermitian symmetry. A half-spectrum that is not Hermitian (a derivative
``i k * w_h`` puts imaginary parts into the bins that are their own
conjugates; a mix of mode corners sets them freely) has no defined inverse
in cuFFT's multi-dimensional C2R. On the CPU, ``torch.fft.irfft2`` (and
the JAX package's ``jnp.fft.irfftn``) takes the complex inverse along the
first axis and then the C2R along the last, which drops the imaginary
parts of the last axis's bins 0 and n/2. ``irfft2`` and ``irfftn`` here
do the same steps on every device, so the card computes what the CPU
computes.
"""

import torch

__all__ = ["irfft2", "irfftn"]


def irfft2(z: torch.Tensor, s, dim=(-2, -1)) -> torch.Tensor:
    """Inverse of ``torch.fft.rfft2(x, dim=dim)`` for a grid of size ``s``:
    the complex inverse along ``dim[0]``, the imaginary parts of the
    self-conjugate bins of ``dim[1]`` (0, and s[1]/2 when s[1] is even)
    set to zero, the real inverse along ``dim[1]``. Equals
    ``torch.fft.irfft2(z, s, dim)`` on the CPU for any input."""
    return irfftn(z, s, dim)


def irfftn(z: torch.Tensor, s, dim) -> torch.Tensor:
    """Inverse of ``torch.fft.rfftn(x, dim=dim)`` for a grid of size ``s``
    over two or more axes: the complex inverse along every axis of ``dim``
    but the last, the imaginary parts of the last axis's self-conjugate
    bins (0, and n/2 when its size n is even) set to zero, the real inverse
    along the last axis."""
    *full, dy = [d % z.ndim for d in dim]
    ny = s[-1]
    z = torch.fft.ifftn(z, s=s[:-1], dim=full)
    zr = torch.view_as_real(z)  # [..., 2]; dims before it keep their index
    bins = [0] + ([ny // 2] if ny % 2 == 0 and ny // 2 < z.shape[dy] else [])
    for k in bins:
        zr.select(dy, k)[..., 1].zero_()
    return torch.fft.irfft(z, n=ny, dim=dy)
