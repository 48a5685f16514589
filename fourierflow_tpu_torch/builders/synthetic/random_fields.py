"""Gaussian random fields with power-law spectra, the initial conditions of
the Navier-Stokes data generator (counterpart of
``fourierflow_tpu/builders/synthetic/random_fields.py``): complex normal
coefficients scaled by the square roots of the eigenvalues of
``(-Lap + tau^2 I)^(-alpha)``, then an inverse FFT.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["gaussian_random_field", "grf_sqrt_eigenvalues"]


def grf_sqrt_eigenvalues(n_dims: int, size: int, alpha: float = 2.0, tau: float = 3.0,
                         sigma: Optional[float] = None) -> np.ndarray:
    """``[size] * n_dims`` float32 square-rooted eigenvalues, the k = 0 entry zero."""
    if sigma is None:
        sigma = tau ** (0.5 * (2 * alpha - n_dims))
    k_max = size // 2
    k1 = np.concatenate([np.arange(0, k_max), np.arange(-k_max, 0)])
    if n_dims == 1:
        ksq = k1**2
    elif n_dims == 2:
        kx, ky = np.meshgrid(k1, k1, indexing="ij")
        ksq = kx**2 + ky**2
    elif n_dims == 3:
        kx, ky, kz = np.meshgrid(k1, k1, k1, indexing="ij")
        ksq = kx**2 + ky**2 + kz**2
    else:
        raise ValueError(f"n_dims={n_dims} unsupported")
    eig = (size**n_dims) * math.sqrt(2.0) * sigma * (
        (4 * math.pi**2 * ksq + tau**2) ** (-alpha / 2.0)
    )
    eig.flat[0] = 0.0
    return eig.astype(np.float32)


def gaussian_random_field(n_samples: int, size: int, n_dims: int = 2, alpha: float = 2.0,
                          tau: float = 3.0, sigma: Optional[float] = None,
                          generator: Optional[torch.Generator] = None, device=None,
                          normals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> torch.Tensor:
    """``n_samples`` float32 fields of shape ``[size] * n_dims`` on ``device``.

    The real and then the imaginary standard normals are drawn from
    ``generator`` (on ``device``), unless ``normals`` hands both over."""
    shape = (n_samples,) + (size,) * n_dims
    if normals is None:
        re = torch.randn(shape, generator=generator, device=device)
        im = torch.randn(shape, generator=generator, device=device)
    else:
        re, im = (torch.as_tensor(np.array(a, dtype=np.float32)) if not torch.is_tensor(a)
                  else a for a in normals)
        re, im = re.to(device, torch.float32), im.to(device, torch.float32)
        if re.shape != shape or im.shape != shape:
            raise ValueError(f"normals must both have shape {shape}")
    eig = torch.from_numpy(grf_sqrt_eigenvalues(n_dims, size, alpha, tau, sigma)).to(re.device)
    coeff = eig * torch.complex(re, im)
    return torch.fft.ifftn(coeff, dim=tuple(range(1, n_dims + 1))).real.contiguous()
