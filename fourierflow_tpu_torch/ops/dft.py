"""Truncated real-DFT bases as dense matrices (counterpart of
``fourierflow_tpu/ops/dft.py``).

For an axis of length ``n`` truncated to ``modes`` rfft coefficients, the
forward transform of a real signal ``x: [..., n]`` is
``x @ Er + 1j * (x @ Ei)`` and the inverse of a spectrum that is zero
beyond ``modes`` is ``Yr @ Cr + Yi @ Ci``. Orthonormal scaling by default,
matching ``norm="ortho"``. The CUDA kernels take their bases from here,
built on the host once per (n, modes, dtype).
"""

import functools

import numpy as np

__all__ = ["rdft_basis", "irdft_basis"]

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
