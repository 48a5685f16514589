"""Forcing functions of the Kolmogorov flows (counterpart of
``fourierflow_tpu/utils/forcings.py``): a factory takes a grid and returns
``forcing(*velocities) -> forces``, real force fields on the velocity's
device (``(fx, fy)`` in 2D, where the pseudo-spectral and the projection
solvers call it; ``(fx, fy, fz)`` in 3D, the projection solver's).

The constant part is computed on the host in float64 and rounded once to
float32 (so it is the same bits on every device; in 2D within one float32
ulp of the JAX package's, whose cosine rounds otherwise; in 3D the JAX
package's numpy constant to the bit), and copied to a device once. A
forcing that does not depend on the velocity carries its fields as
``forcing.static`` (numpy, ``(fx, fy)``), so that the spectral solver can
transform them once.
"""

import numpy as np
import torch

from .grids import Grid

__all__ = ["kolmogorov_forcing_fn", "simple_turbulence_forcing"]


def _const(magnitude: float, wavenumber: int, grid: Grid) -> np.ndarray:
    """``magnitude * cos(wavenumber * y)`` on the offset-(0, 0) mesh of a 2D
    grid, float32."""
    if grid.ndim != 2:
        raise NotImplementedError(
            f"this forcing is 2D; a {grid.ndim}-D Kolmogorov flow takes "
            "simple_turbulence_forcing under the projection method (utils/finite_volume.py)")
    _, ys = grid.mesh(offset=(0, 0))
    return (magnitude * np.cos(wavenumber * ys.astype(np.float64))).astype(np.float32)


def _on(a: np.ndarray, like: torch.Tensor, cache: dict) -> torch.Tensor:
    """``a`` on ``like``'s device, copied once a device (so that a CUDA graph
    can capture the solver's step)."""
    if like.device not in cache:
        cache[like.device] = torch.from_numpy(a).to(like.device)
    return cache[like.device]


def kolmogorov_forcing_fn(grid: Grid, scale: float = 1.0, k: int = 4):
    """The constant x-direction forcing ``scale * cos(k y)`` (2D)."""
    fx = _const(scale, k, grid)
    fy = np.zeros_like(fx)
    cx, cy = {}, {}

    def forcing(vx, vy):
        return _on(fx, vx, cx), _on(fy, vx, cy)

    forcing.static = (fx, fy)
    return forcing


def simple_turbulence_forcing(grid: Grid, constant_magnitude: float = 1.0,
                              constant_wavenumber: int = 4, linear_coefficient: float = 0.0):
    """Kolmogorov forcing plus a linear (drag-like) velocity forcing, the
    ``jax_cfd`` config target of the Kolmogorov data configs: ``c cos(k y) +
    a v0`` on the first component and ``a v_i`` on the others. In 2D ``y``
    is the offset-(0, 0) mesh; on an N-D grid it is ``y`` at offset 0.5, a
    ``[1, Y, 1, ...]`` constant."""
    if grid.ndim == 2:
        f_const = _const(constant_magnitude, constant_wavenumber, grid)
    else:
        y = grid.axes(offset=0.5)[1]
        sh = [1] * grid.ndim
        sh[1] = len(y)
        f_const = (constant_magnitude * np.cos(constant_wavenumber * y)).reshape(sh).astype(
            np.float32)
    cache = {}

    def forcing(*vel):
        out = [linear_coefficient * v for v in vel]
        out[0] = out[0] + _on(f_const, vel[0], cache)
        return tuple(out)

    if linear_coefficient == 0 and grid.ndim == 2:
        forcing.static = (f_const, np.zeros_like(f_const))
    return forcing
