"""Truncated real-DFT and DCT-II bases as dense matrices (counterpart of
``fourierflow_tpu/ops/dft.py``).

For an axis of length ``n`` truncated to ``modes`` rfft coefficients, the
forward transform of a real signal ``x: [..., n]`` is
``x @ Er + 1j * (x @ Ei)`` and the inverse of a spectrum that is zero
beyond ``modes`` is ``Yr @ Cr + Yi @ Ci``. Orthonormal scaling by default,
matching ``norm="ortho"``. The CUDA kernels take their bases from here,
built on the host once per (n, modes, dtype). The DCT-II bases, and the
DCT over one or more trailing axes, are those of the CNO models; like the
DFT bases they are built in numpy as the JAX package builds them, so both
packages hold the same bits.
"""

import functools

import numpy as np
import torch

__all__ = ["rdft_basis", "irdft_basis", "dct2_basis", "idct2_basis", "dct", "idct", "dct_2d",
           "idct_2d", "dct_3d", "idct_3d"]

_SCALE_FWD = {"ortho": lambda n: 1.0 / np.sqrt(n), "backward": lambda n: 1.0,
              "forward": lambda n: 1.0 / n}
_SCALE_INV = {"ortho": lambda n: 1.0 / np.sqrt(n), "backward": lambda n: 1.0 / n,
              "forward": lambda n: 1.0}


def _check(n: int, modes: int):
    if modes > n // 2 + 1:
        raise ValueError(f"modes={modes} exceeds n//2+1={n // 2 + 1}")


@functools.lru_cache(maxsize=128)
def rdft_basis(n: int, modes: int, norm: str = "ortho", dtype: str = "float32"):
    """``(Er, Ei)``, each ``[n, modes]`` numpy arrays (read-only: cached)."""
    _check(n, modes)
    ang = 2.0 * np.pi * np.arange(n)[:, None] * np.arange(modes)[None, :] / n
    scale = _SCALE_FWD[norm](n)
    er = (np.cos(ang) * scale).astype(dtype)
    ei = (-np.sin(ang) * scale).astype(dtype)
    er.flags.writeable = ei.flags.writeable = False
    return er, ei


@functools.lru_cache(maxsize=128)
def irdft_basis(n: int, modes: int, norm: str = "ortho", dtype: str = "float32"):
    """``(Cr, Ci)``, each ``[modes, n]``. Hermitian symmetry is folded in:
    mode 0 (and the Nyquist mode, when included) weigh 1, all others 2."""
    _check(n, modes)
    ang = 2.0 * np.pi * np.arange(modes)[:, None] * np.arange(n)[None, :] / n
    c = np.full((modes, 1), 2.0)
    c[0] = 1.0
    if n % 2 == 0 and modes == n // 2 + 1:
        c[-1] = 1.0
    scale = _SCALE_INV[norm](n)
    cr = (c * np.cos(ang) * scale).astype(dtype)
    ci = (-c * np.sin(ang) * scale).astype(dtype)
    cr.flags.writeable = ci.flags.writeable = False
    return cr, ci


@functools.lru_cache(maxsize=128)
def dct2_basis(n: int, modes: int, norm: str = "ortho", dtype: str = "float32"):
    """Truncated DCT-II matrix ``[n, modes]`` (read-only: cached): ``X = x @ D``
    with ``X_k = s_k * sum_t x_t * 2 cos(pi (2t + 1) k / (2n))``; under
    "ortho" ``s_0 = sqrt(1 / (4n))`` and ``s_k = sqrt(1 / (2n))``, as
    ``scipy.fft.dct(type=2, norm="ortho")``."""
    if modes > n:
        raise ValueError(f"modes={modes} exceeds n={n}")
    k = np.arange(modes)[None, :]
    t = np.arange(n)[:, None]
    d = 2.0 * np.cos(np.pi * (2 * t + 1) * k / (2 * n))
    if norm == "ortho":
        s = np.full((1, modes), np.sqrt(1.0 / (2 * n)))
        s[0, 0] = np.sqrt(1.0 / (4 * n))
        d = d * s
    d = d.astype(dtype)
    d.flags.writeable = False
    return d


@functools.lru_cache(maxsize=128)
def idct2_basis(n: int, modes: int, norm: str = "ortho", dtype: str = "float32"):
    """``[modes, n]`` inverse of the orthonormal DCT-II of a mode-truncated
    spectrum, ``x = X @ Dinv``: the forward basis transposed (read-only)."""
    d = dct2_basis(n, modes, norm=norm, dtype=dtype).T.copy()
    d.flags.writeable = False
    return d


def dct(x, axis: int = -1, norm: str = "ortho"):
    """DCT-II of a tensor along ``axis``, as one basis product."""
    d = torch.tensor(dct2_basis(x.shape[axis], x.shape[axis], norm=norm), device=x.device)
    return (x.movedim(axis, -1) @ d.to(x.dtype)).movedim(-1, axis)


def idct(x, axis: int = -1, norm: str = "ortho"):
    """Inverse DCT-II (DCT-III) of a tensor along ``axis``."""
    d = torch.tensor(idct2_basis(x.shape[axis], x.shape[axis], norm=norm), device=x.device)
    return (x.movedim(axis, -1) @ d.to(x.dtype)).movedim(-1, axis)


def dct_2d(x, norm: str = "ortho"):
    """Separable DCT-II over the last two axes."""
    return dct(dct(x, -1, norm), -2, norm)


def idct_2d(x, norm: str = "ortho"):
    return idct(idct(x, -1, norm), -2, norm)


def dct_3d(x, norm: str = "ortho"):
    """Separable DCT-II over the last three axes."""
    return dct(dct_2d(x, norm), -3, norm)


def idct_3d(x, norm: str = "ortho"):
    return idct(idct_2d(x, norm), -3, norm)
