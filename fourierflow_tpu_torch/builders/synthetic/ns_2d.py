"""Crank-Nicolson pseudo-spectral Navier-Stokes solver on the 2D torus
(counterpart of ``fourierflow_tpu/builders/synthetic/ns_2d.py``), the
torus_li / torus_vis data generator.

The vorticity lives in the rfft half-spectrum ``[b, n, n//2+1]``. Each step
solves the Poisson equation for the stream function, takes the velocities
and the vorticity gradient spectrally, forms the advection term in
physical space, dealiases it by the 2/3 rule and advances the diffusion
term by Crank-Nicolson with explicit advection and forcing. The time loop
(the JAX package's ``lax.scan`` over record windows) is a loop on the
tensor's device; on a CUDA device its steps are replayed from a CUDA
graph. Inverse transforms go through ``ops.fourier.irfft2``: the
derivative spectra are not Hermitian, and that inverse is the one defined
on every device. Constants are computed on the CPU in float32 and then
moved, so they are the same bits on every device.
"""

import math
from enum import Enum
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ...ops.fourier import irfft2

__all__ = ["Force", "solve_navier_stokes_2d", "random_force", "li_force", "kolmogorov_force"]


class Force(str, Enum):
    li = "li"
    random = "random"
    none = "none"
    kolmogorov = "kolmogorov"


def _wavenumbers(n: int):
    """Integer wavenumbers in rfft2 layout: kx full [n], ky half [n//2+1]."""
    kx = np.fft.fftfreq(n, d=1.0 / n)
    ky = np.arange(n // 2 + 1)
    kxm, kym = np.meshgrid(kx, ky, indexing="ij")
    return kxm.astype(np.float32), kym.astype(np.float32)


def li_force(n: int) -> np.ndarray:
    """0.1*(sin(2pi(x+y)) + cos(2pi(x+y))) on [0,1)^2."""
    t = np.linspace(0, 1, n + 1)[:-1]
    x, y = np.meshgrid(t, t, indexing="ij")
    return (0.1 * (np.sin(2 * np.pi * (x + y)) + np.cos(2 * np.pi * (x + y)))).astype(
        np.float32
    )


def kolmogorov_force(n: int) -> np.ndarray:
    """-4*cos(4y) on [0,2pi)^2."""
    t = np.linspace(0, 2 * np.pi, n + 1)[:-1]
    _, y = np.meshgrid(t, t, indexing="ij")
    return (-4.0 * np.cos(4.0 * y)).astype(np.float32)


def _force_grid(n: int, cycles: int, device):
    """``k [1, cycles, 1, 1]`` (2 pi p for p = 1..cycles) and the grid
    ``x, y [1, 1, n, n]`` of ``random_force``."""
    ts = np.linspace(0, 1, n + 1)[:-1].astype(np.float32)
    x, y = np.meshgrid(ts, ts, indexing="ij")
    p = torch.arange(1, cycles + 1, dtype=torch.float32).reshape(1, cycles, 1, 1)
    return tuple(a.to(device) for a in (2 * math.pi * p, torch.from_numpy(x)[None, None],
                                        torch.from_numpy(y)[None, None]))


def _random_force(alphas, grid, t, t_scaling: float, scaling: float) -> torch.Tensor:
    k, x, y = grid
    phase = t_scaling * t
    a = alphas[..., None, None]  # [b, cycles, 6, 1, 1]
    f = (
        a[:, :, 0] * torch.sin(k * x + phase)
        + a[:, :, 1] * torch.cos(k * x + phase)
        + a[:, :, 2] * torch.sin(k * y + phase)
        + a[:, :, 3] * torch.cos(k * y + phase)
        + a[:, :, 4] * torch.sin(k * (x + y) + phase)
        + a[:, :, 5] * torch.cos(k * (x + y) + phase)
    )
    return scaling * f.sum(dim=1)


def random_force(alphas: torch.Tensor, n: int, t, t_scaling: float,
                 scaling: float) -> torch.Tensor:
    """Random sinusoid-mixture forcing ``[b, n, n]``: per sample and cycle
    p, six weighted terms sin/cos(2 pi p X + t_scaling t), the same for Y
    and X+Y. ``alphas [b, cycles, 6]`` are the U(0, 1) weights of each
    trajectory; ``t`` is a number or a 0-d tensor."""
    return _random_force(alphas, _force_grid(n, alphas.shape[1], alphas.device), t, t_scaling,
                         scaling)


def _div_real(z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``z / r`` for complex z and real r, each part divided once."""
    return torch.view_as_complex(torch.view_as_real(z) / r[..., None])


def _capture(steps_of, w_h, t, k):
    """A CUDA graph of ``k`` steps that reads and writes its own state
    tensors: ``(graph, static_w, static_t)``. The steps run three times on
    a copy of the state first, as capture needs (cuFFT plans, memory)."""
    static_w, static_t = w_h.clone(), t.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            steps_of(static_w, static_t, 1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        w, tt = steps_of(static_w, static_t, k)
        static_w.copy_(w)
        static_t.copy_(tt)
    return graph, static_w, static_t


@torch.no_grad()
def solve_navier_stokes_2d(
    w0,
    visc: Union[float, np.ndarray, torch.Tensor],
    t_end: float,
    delta_t: float,
    record_steps: int,
    cycles: Optional[int] = None,
    scaling: Optional[float] = None,
    t_scaling: Optional[float] = None,
    force: Union[str, Force] = Force.li,
    varying_force: bool = False,
    generator: Optional[torch.Generator] = None,
    alphas: Optional[torch.Tensor] = None,
    graph_steps: int = 50,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Solve 2D Navier-Stokes in vorticity form on ``w0 [b, n, n]``'s device.

    ``ceil(t_end / delta_t)`` steps are taken in ``record_steps`` windows of
    ``steps // record_steps`` steps; the field is recorded at the end of
    each window. ``visc`` is one viscosity or one per sample. The random
    force's weights ``alphas [b, cycles, 6]`` are drawn once, uniform in
    [0, 1), from ``generator`` (on w0's device), unless given.

    Returns ``(sol [b, n, n, record_steps], f)``: ``f`` is the static force
    (``[n, n]``, or ``[b, n, n]`` for a random one), the force recorded with
    each snapshot ``[b, n, n, record_steps]`` when it varies, or ``None``
    for ``force="none"``. Raises ``ValueError`` if the solution has a NaN.

    On a CUDA device, ``graph_steps`` steps are captured once in a CUDA
    graph and replayed (the counterpart of the JAX package's ``lax.scan``):
    the same kernels in the same order as the eager loop, so the same bits,
    without the host's time per launch. 0 runs every step eagerly.
    """
    force = Force(force)
    w0 = torch.as_tensor(w0)
    dev, dtype = w0.device, w0.dtype
    b, n, _ = w0.shape
    steps = math.ceil(t_end / delta_t)
    inner_steps = steps // record_steps
    if inner_steps < 1:
        raise ValueError("record_steps exceeds total solver steps")

    f_static = None
    if force == Force.random:
        if alphas is None:
            alphas = torch.rand((b, cycles, 6), generator=generator, device=dev)
        if not torch.is_tensor(alphas):
            alphas = torch.from_numpy(np.array(alphas, dtype=np.float32))
        alphas = alphas.to(dev, torch.float32)
        if not varying_force:
            f_static = random_force(alphas, n, 0.0, 0.0, scaling)
    else:
        # A varying force other than "random" is the random one with zero
        # weights, as in the JAX package.
        alphas = torch.zeros((b, 1, 6), device=dev)
        if force == Force.li:
            f_static = torch.from_numpy(li_force(n)).to(dev)
        elif force == Force.kolmogorov:
            f_static = torch.from_numpy(kolmogorov_force(n)).to(dev)
    varying = bool(varying_force)
    scaling, t_scaling = float(scaling or 0.0), float(t_scaling or 0.0)

    # Constants, in float32 on the CPU, then moved.
    kx, ky = (torch.from_numpy(a) for a in _wavenumbers(n))
    k_max = n // 2
    lap = 4 * (math.pi**2) * (kx**2 + ky**2)
    lap[0, 0] = 1.0
    dealias = ((torch.abs(ky) <= (2.0 / 3.0) * k_max)
               & (torch.abs(kx) <= (2.0 / 3.0) * k_max)).to(dtype)[None]
    visc = torch.as_tensor(np.asarray(visc, dtype=np.float32) if not torch.is_tensor(visc)
                           else visc.cpu(), dtype=dtype)
    if visc.ndim == 1:
        visc = visc[:, None, None]
    cn = 0.5 * delta_t * visc * lap[None]  # [b or 1, n, m]
    two_pi_i = 2 * math.pi * 1j
    # The derivative factors, applied to psi_h (q, v) and to w_h (w_x, w_y).
    d_psi = torch.stack([two_pi_i * ky, -two_pi_i * kx])[:, None]
    d_w = torch.stack([two_pi_i * kx, two_pi_i * ky])[:, None]
    lap, dealias, d_psi, d_w = (a.to(dev) for a in (lap, dealias, d_psi, d_w))
    one_minus, one_plus = (1.0 - cn).to(dev), (1.0 + cn).to(dev)

    w_h = torch.fft.rfft2(w0)
    dt_fh = None
    if force != Force.none and not varying:
        dt_fh = delta_t * torch.fft.rfft2(f_static)
    grid = _force_grid(n, alphas.shape[1], dev) if varying else None
    t = torch.zeros((), dtype=dtype, device=dev)
    g = torch.empty((4, b, n, n // 2 + 1), dtype=w_h.dtype, device=dev)

    def step(w_h, t):
        """One Crank-Nicolson step; the time advances only where the force
        reads it."""
        psi_h = _div_real(w_h, lap)
        torch.mul(d_psi, psi_h, out=g[:2])
        torch.mul(d_w, w_h, out=g[2:])
        q, v, w_x, w_y = irfft2(g, (n, n))
        f_adv = torch.fft.rfft2(q * w_x + v * w_y) * dealias
        rhs = -delta_t * f_adv
        if varying:
            rhs = rhs + delta_t * torch.fft.rfft2(_random_force(alphas, grid, t, t_scaling,
                                                                scaling))
        elif dt_fh is not None:
            rhs = rhs + dt_fh
        return _div_real(rhs + one_minus * w_h, one_plus), (t + delta_t if varying else t)

    def steps_of(w_h, t, k):
        for _ in range(k):
            w_h, t = step(w_h, t)
        return w_h, t

    graph = None
    if dev.type == "cuda" and 0 < graph_steps <= inner_steps:
        graph = _capture(steps_of, w_h, t, graph_steps)
    sol, fs = [], []
    for _ in range(record_steps):
        k = inner_steps
        if graph is not None:
            replay, static_w, static_t = graph
            static_w.copy_(w_h)
            static_t.copy_(t)
            for _ in range(inner_steps // graph_steps):
                replay.replay()
            w_h, t, k = static_w, static_t, inner_steps % graph_steps
        w_h, t = steps_of(w_h, t, k)
        sol.append(irfft2(w_h, (n, n)))
        if varying:
            # The force at the pre-step time of the window's last step.
            fs.append(_random_force(alphas, grid, t - delta_t, t_scaling, scaling))
    sol = torch.stack(sol, dim=-1)
    if torch.isnan(sol).any():
        raise ValueError("NaN values found.")
    if force == Force.none:
        return sol, None
    return sol, torch.stack(fs, dim=-1) if varying else f_static
