"""Pseudo-spectral 2D Navier-Stokes and IMEX time stepping (counterpart of
``fourierflow_tpu/utils/equations.py``), the solver of the Kolmogorov data
configs:

- ``NavierStokes2D``: the vorticity equation split into explicit advection
  (2/3-filtered) plus the curl of the forcing, and implicit diffusion and
  drag with an exact pointwise solve.
- ``crank_nicolson_rk4``: the Carpenter-Kennedy low-storage RK4 on the
  explicit terms with Crank-Nicolson sub-steps on the implicit ones (the
  scheme and tableau of jax-cfd's ``crank_nicolson_rk4``).
- ``stable_time_step``: the smaller of the advective CFL and the explicit
  diffusion limits.
- ``repeated`` / ``trajectory``: step composition as plain loops;
  ``graph_repeated``: on a CUDA device, runs of steps replayed from a CUDA
  graph (the JAX package's ``lax.scan``), the same kernels in the same order
  as the eager loop, so the same bits, without the host's time per launch;
  the state is a tensor or a tuple of tensors (the projection method's).

The state is the ``rfft2`` half-spectrum of the vorticity, ``[..., nx,
ny//2+1]`` complex64, with any leading batch axes. The linear term is real,
so the implicit term and solve multiply and divide each part by a float32
constant (computed in float64 on the host, as the JAX package's numpy
constants are, and rounded once). Inverse transforms go through
``ops.fourier.irfft2``: the derivative spectra are not Hermitian.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.fourier import irfft2
from .grids import Grid, rfft_mesh
from .spectral import circular_filter_2d, div_real, vorticity_to_velocity_solve

__all__ = ["NavierStokes2D", "crank_nicolson_rk4", "stable_time_step", "repeated", "trajectory",
           "graph_repeated"]

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass
class NavierStokes2D:
    """The implicit-explicit split of the 2D vorticity equation with
    ``viscosity``, linear ``drag`` and an optional forcing factory
    (``forcing_fn(grid) -> forcing(vx, vy)``)."""

    viscosity: float
    grid: Grid
    drag: float = 0.0
    smooth: bool = True
    forcing_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.grid.ndim != 2:
            raise NotImplementedError(
                f"NavierStokes2D takes a 2D grid (the spectral method is 2D only); a "
                f"{self.grid.ndim}-D Kolmogorov flow takes the projection method "
                "(utils/finite_volume.py::semi_implicit_navier_stokes)")
        kx, ky = rfft_mesh(self.grid.shape, self.grid.domain)
        # float64, rounded once where used.
        self.linear_term = self.viscosity * (-(TWO_PI ** 2) * (kx ** 2 + ky ** 2)) - self.drag
        self.velocity_solve = vorticity_to_velocity_solve(self.grid)
        self._forcing = self.forcing_fn(self.grid) if self.forcing_fn is not None else None
        self._derivative = ((TWO_PI * 1j * kx).astype(np.complex64),
                            (TWO_PI * 1j * ky).astype(np.complex64))
        self._filter = circular_filter_2d(self.grid)
        self._kx, self._ky = kx, ky
        self._cache = {}  # constants by device, and solve denominators by (time step, device)

    def _constants(self, device: torch.device):
        """``2 pi i kx``, ``2 pi i ky``, the filter, the linear term and the
        curl of a static forcing's spectrum (or None) on ``device``."""
        if device not in self._cache:
            self._cache[device] = self._make_constants(device)
        return self._cache[device]

    def _make_constants(self, device: torch.device):
        const = lambda a: torch.from_numpy(a).to(device)
        d_x, d_y = (const(a) for a in self._derivative)
        curl = None
        static = getattr(self._forcing, "static", None)
        if static is not None:
            fx_hat, fy_hat = (torch.fft.rfft2(torch.from_numpy(f)) for f in static)
            curl = (2j * np.pi * (torch.from_numpy(self._kx) * fy_hat
                                  - torch.from_numpy(self._ky) * fx_hat)).to(device)
        return (d_x, d_y, const(self._filter), const(self.linear_term.astype(np.float32)),
                curl)

    def _solve_denominator(self, time_step: float, device: torch.device) -> torch.Tensor:
        key = (time_step, device)
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(
                (1 - time_step * self.linear_term).astype(np.float32)).to(device)
        return self._cache[key]

    def explicit_terms(self, vorticity_hat: torch.Tensor) -> torch.Tensor:
        s = self.grid.shape
        d_x, d_y, filt, _, curl = self._constants(vorticity_hat.device)
        vxhat, vyhat = self.velocity_solve(vorticity_hat)
        vx, vy, grad_x, grad_y = irfft2(
            torch.stack([vxhat, vyhat, d_x * vorticity_hat, d_y * vorticity_hat]), s)
        terms = torch.fft.rfft2(-(grad_x * vx + grad_y * vy))
        if self.smooth:
            terms = terms * filt
        if curl is not None:
            terms = terms + curl
        elif self._forcing is not None:
            fx, fy = self._forcing(vx, vy)
            fx_hat, fy_hat = torch.fft.rfft2(torch.stack([fx, fy]))
            kx, ky = (torch.from_numpy(k).to(vx.device) for k in (self._kx, self._ky))
            terms = terms + 2j * np.pi * (kx * fy_hat - ky * fx_hat)
        return terms

    def implicit_terms(self, vorticity_hat: torch.Tensor) -> torch.Tensor:
        lin = self._constants(vorticity_hat.device)[3]
        return torch.view_as_complex(torch.view_as_real(vorticity_hat) * lin[..., None])

    def implicit_solve(self, vorticity_hat: torch.Tensor, time_step: float) -> torch.Tensor:
        return div_real(vorticity_hat, self._solve_denominator(float(time_step),
                                                               vorticity_hat.device))


# Carpenter-Kennedy RK4(3)5[2R+C] low-storage coefficients (the published
# tableau, as in jax-cfd's crank_nicolson_rk4).
_CK_ALPHAS = (0.0, 0.1496590219993, 0.3704009573644, 0.6222557631345, 0.9582821306748, 1.0)
_CK_BETAS = (0.0, -0.4178904745, -1.192151694643, -1.697784692471, -1.514183444257)
_CK_GAMMAS = (0.1496590219993, 0.3792103129999, 0.8229550293869, 0.6994504559488,
              0.1530572479681)


def crank_nicolson_rk4(equation, time_step: float):
    """One step of the low-storage IMEX scheme: the explicit terms by
    CK-RK4, the implicit ones by Crank-Nicolson sub-steps solved exactly."""
    dt = time_step
    f, g, g_inv = equation.explicit_terms, equation.implicit_terms, equation.implicit_solve

    def step_fn(u: torch.Tensor) -> torch.Tensor:
        h = torch.zeros_like(u)
        for k in range(len(_CK_GAMMAS)):
            h = f(u) + _CK_BETAS[k] * h
            mu = 0.5 * dt * (_CK_ALPHAS[k + 1] - _CK_ALPHAS[k])
            u = g_inv(u + _CK_GAMMAS[k] * dt * h + mu * g(u), mu)
        return u

    step_fn.time_step = dt
    return step_fn


def stable_time_step(max_velocity: float, max_courant_number: float, viscosity: float,
                     grid: Grid) -> float:
    """``min(CFL dt, explicit-diffusion dt)``; 0.0002191401125550916 for
    the 2048^2 Re = 1000 grid of the Kolmogorov configs."""
    dx = min(grid.step)
    dt_courant = max_courant_number * dx / max_velocity
    dt_diffusion = dx ** 2 / (viscosity * 2 ** grid.ndim)
    return min(dt_courant, dt_diffusion)


def repeated(step_fn: Callable, n: int) -> Callable:
    """``step_fn`` applied ``n`` times."""

    def f(state):
        for _ in range(n):
            state = step_fn(state)
        return state

    return f


def trajectory(step_fn: Callable, steps: int, post_process: Callable = lambda x: x):
    """``f(state) -> (final state, [post_process(state after each step)])``:
    ``steps`` applications of ``step_fn``, each state after a step passed
    to ``post_process`` (a list where the JAX package stacks a pytree)."""

    def f(state):
        outs = []
        for _ in range(steps):
            state = step_fn(state)
            outs.append(post_process(state))
        return state, outs

    return f


def _clone(state):
    return tuple(s.clone() for s in state) if isinstance(state, tuple) else state.clone()


def _copy_into(dst, src) -> None:
    if isinstance(dst, tuple):
        for d, s in zip(dst, src, strict=True):
            d.copy_(s)
    else:
        dst.copy_(src)


def graph_repeated(step_fn: Callable, like, graph_steps: int) -> Callable:
    """``run(state, k)``: ``step_fn`` applied ``k`` times to a state shaped
    as ``like``, a tensor (the spectral state) or a tuple of tensors (the
    projection method's velocities). On a CUDA device with ``graph_steps`` >
    0, ``graph_steps`` steps are captured once in a CUDA graph (after three
    eager steps on a copy, which fill the constants' caches and cuFFT's
    plans) and each run replays it ``k // graph_steps`` times, then takes
    the rest eagerly; the result may be the graph's own state tensors, valid
    until the next run. Otherwise every step runs eagerly."""
    first = like[0] if isinstance(like, tuple) else like
    if first.device.type != "cuda" or graph_steps <= 0:
        return lambda state, k: repeated(step_fn, k)(state)
    static = _clone(like)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        repeated(step_fn, 3)(_clone(static))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _copy_into(static, repeated(step_fn, graph_steps)(static))

    def run(state, k: int):
        if k < graph_steps:
            return repeated(step_fn, k)(state)
        _copy_into(static, state)
        for _ in range(k // graph_steps):
            graph.replay()
        return repeated(step_fn, k % graph_steps)(static)

    return run
