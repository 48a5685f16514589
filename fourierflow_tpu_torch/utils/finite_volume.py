"""Finite-volume Navier-Stokes, the projection method, in 2D and 3D
(counterpart of ``fourierflow_tpu/utils/finite_volume.py``), the solver of
the projection-method data configs (jax-cfd's ``semi_implicit_navier_stokes``
config target).

The state is a tuple of velocity components ``[..., X, Y(, Z)]`` on a
staggered (MAC) grid: component i lies on the faces at offset 1 along axis i
and 0.5 along the others (jax-cfd's convention), with any leading batch
axes. A step is explicit flux-form advection (van Leer upwind or linear
central), explicit diffusion and a forcing, then an exact pressure
projection: the divergence's Poisson problem is diagonal in the DFT of the
periodic 5- or 7-point Laplacian, solved with ``torch.fft`` (its inverse
through ``ops.fourier.irfftn``, so that the card computes what the CPU
computes). The inverse eigenvalues are float32 constants assembled as the
JAX package assembles them (a float32 sum of per-axis vectors), cached per
shape and device, so a step copies nothing from the host (it can be
captured in a CUDA graph once the cache is filled).

The 3D initial velocity (``filtered_velocity_field_3d``) is the curl of a
smooth random vector potential; its white noise is drawn from a
``torch.Generator`` or passed in (``noise``), so that the JAX package's
draws can be fed to it.
"""

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.fourier import irfftn
from .forcings import _on

__all__ = ["pressure_projection_nd", "semi_implicit_navier_stokes", "kolmogorov_forcing_fv",
           "filtered_velocity_field_3d", "potential_noise_3d", "velocity_from_potential_3d",
           "forward_euler", "classic_rk4"]

Velocity = Tuple[torch.Tensor, ...]


def _fd_laplacian_eigs_1d(shape: Sequence[int], h: Sequence[float]):
    """The DFT eigenvalues of the periodic second-order difference along
    each axis, ``(2 cos(2 pi k / n) - 2) / h^2`` (float32 numpy; the last
    axis in the ``rfft`` layout). Each vector's k = 0 entry is exactly 0."""
    ndim = len(shape)
    out = []
    for d, n in enumerate(shape):
        k = np.arange(n if d < ndim - 1 else n // 2 + 1)
        out.append(((2.0 * np.cos(2.0 * np.pi * k / n) - 2.0) / h[d] ** 2).astype(np.float32))
    return out


@functools.lru_cache(maxsize=32)
def _inv_laplacian(shape: Tuple[int, ...], h: Tuple[float, ...],
                   device: torch.device) -> torch.Tensor:
    """The inverse eigenvalues of the periodic N-D Laplacian in the ``rfftn``
    layout, with the zero mode set to 0 (the pressure's gauge): the float32
    broadcast sum of the per-axis vectors (each term is <= 0 and 0 only at
    its axis' k = 0, so the sum is 0 exactly at the zero mode), then its
    reciprocal. Cached a shape and device (do not modify)."""
    lam = None
    for d, vec in enumerate(_fd_laplacian_eigs_1d(shape, h)):
        sh = [1] * len(shape)
        sh[d] = len(vec)
        term = torch.from_numpy(vec).reshape(sh)
        lam = term if lam is None else lam + term
    return torch.where(lam == 0.0, 0.0, 1.0 / torch.where(lam == 0.0, 1.0, lam)).to(device)


def pressure_projection_nd(vel: Velocity, h: Sequence[float]) -> Velocity:
    """The staggered velocities projected onto the divergence-free
    subspace: the cell-centred divergence, its Poisson solve in the DFT
    basis, and the face gradient of the pressure taken off each component."""
    ndim = len(vel)
    shape = tuple(vel[0].shape[-ndim:])
    dims = tuple(range(-ndim, 0))
    h = tuple(float(s) for s in h)
    div = sum((v - torch.roll(v, 1, ax)) / h[d] for d, (v, ax) in enumerate(zip(vel, dims)))
    inv_lam = _inv_laplacian(shape, h, vel[0].device)
    p = irfftn(torch.fft.rfftn(div, dim=dims) * inv_lam, shape, dims)
    return tuple(v - (torch.roll(p, -1, ax) - p) / h[d] for d, (v, ax) in enumerate(zip(vel, dims)))


def kolmogorov_forcing_fv(grid, constant_magnitude: float = 1.0, constant_wavenumber: int = 4,
                          linear_coefficient: float = 0.0):
    """A ``sin(k y)`` body force on the first velocity component (``y`` at
    its faces, offset 0.5) plus a linear term on every component:
    ``forcing(*vel) -> tuple``. (The registry's configs use
    ``forcings.simple_turbulence_forcing``, a cosine.)"""
    y = grid.axes(offset=0.5)[1].astype(np.float32)
    sh = [1] * grid.ndim
    sh[1] = len(y)
    fu_const = (constant_magnitude * np.sin(constant_wavenumber * y)).reshape(sh)
    cache = {}

    def forcing(*vel):
        out = [linear_coefficient * v for v in vel]
        out[0] = out[0] + _on(fu_const, vel[0], cache)
        return tuple(out)

    return forcing


def forward_euler():
    """The name of the single-stage stepper (config parity with
    ``jax_cfd.base.time_stepping.forward_euler``)."""
    return "euler"


def classic_rk4():
    """The name of the projected classic Runge-Kutta-4 stepper (config
    parity with ``jax_cfd.base.time_stepping.classic_rk4``)."""
    return "rk4"


def _stepper_name(time_stepper) -> str:
    if time_stepper is None:
        return "euler"
    if isinstance(time_stepper, str):
        name = time_stepper
    elif callable(time_stepper):  # ${get_method:...classic_rk4} resolves to the function
        name = time_stepper()
    else:
        raise TypeError(f"unsupported time_stepper {time_stepper!r}")
    if name not in ("euler", "rk4"):
        raise ValueError(f"unknown time_stepper {name!r}")
    return name


def _van_leer_flux(c: torch.Tensor, u: torch.Tensor, dt: float, hh: float,
                   ax: int) -> torch.Tensor:
    """The upwind MUSCL flux of the cell quantity ``c`` carried by ``u`` at
    the forward face along ``ax`` (between ``c[j]`` and ``c[j + 1]``), with
    the van Leer (harmonic mean) slope limiter and the forward-Euler Courant
    correction ``0.5 (1 -+ u dt / h)``: jax-cfd's default convection."""
    dc = torch.roll(c, -1, ax) - c  # the slope across this face
    dc_back = c - torch.roll(c, 1, ax)  # the slope behind the donor j
    dc_fwd = torch.roll(dc, -1, ax)  # the slope ahead of the donor j + 1

    def limited(a, b):
        # The harmonic mean of two slopes of one sign, else 0 (an extremum).
        prod = a * b
        denom = a + b
        safe = torch.where(torch.abs(denom) > 1e-30, denom, 1.0)
        return torch.where(prod > 0.0, 2.0 * prod / safe, 0.0)

    cfl = u * (dt / hh)
    flux_pos = u * (c + 0.5 * (1.0 - cfl) * limited(dc, dc_back))
    flux_neg = u * (torch.roll(c, -1, ax) - 0.5 * (1.0 + cfl) * limited(dc, dc_fwd))
    return torch.where(u >= 0.0, flux_pos, flux_neg)


def semi_implicit_navier_stokes(density: float = 1.0, viscosity: float = 1e-3, dt: float = 1e-3,
                                grid=None, forcing: Optional[Callable] = None,
                                time_stepper=None, convect: Optional[str] = None, **kwargs):
    """``step_fn(vel) -> vel``: one step ``dt`` of explicit advection,
    diffusion and ``forcing`` (``forcing(*vel) -> tuple``), then the
    pressure projection.

    ``time_stepper`` is forward Euler (the default) or the projected
    classic RK4, which projects each stage's state before its explicit
    terms. ``convect`` is ``"van_leer"`` (limited upwind, stable under Euler
    at the Courant number of the configs) or ``"linear"`` (central, only
    neutrally stable, for RK4); by default van Leer under Euler and linear
    under RK4."""
    if isinstance(forcing, dict):
        from ..config import instantiate

        forcing = instantiate(forcing)
    stepper = _stepper_name(time_stepper)
    if convect is None:
        convect = "van_leer" if stepper == "euler" else "linear"
    if convect not in ("van_leer", "linear"):
        raise ValueError(f"unknown convect scheme {convect!r}")
    ndim = grid.ndim
    h = tuple(float(s) for s in grid.step)
    axes = tuple(range(-ndim, 0))
    nu = viscosity / density

    def laplacian(phi):
        val = 0.0
        for d, ax in enumerate(axes):
            val = val + (torch.roll(phi, 1, ax) + torch.roll(phi, -1, ax) - 2.0 * phi) / h[d] ** 2
        return val

    def advect_component_linear(vel, i):
        """The flux divergence of component i, sum_d d(v_d v_i)/dx_d, with
        the fluxes centrally interpolated to the corners and centres of
        v_i's control volume."""
        vi = vel[i]
        ax_i = axes[i]
        total = 0.0
        for d, ax_d in enumerate(axes):
            if d == i:
                vc = 0.5 * (vi + torch.roll(vi, 1, ax_i))  # at the cell centres
                flux = vc * vc
                total = total + (torch.roll(flux, -1, ax_i) - flux) / h[d]
            else:
                vd_c = 0.5 * (vel[d] + torch.roll(vel[d], -1, ax_i))  # v_d at the shared corner
                vi_f = 0.5 * (vi + torch.roll(vi, -1, ax_d))
                flux = vd_c * vi_f
                total = total + (flux - torch.roll(flux, 1, ax_d)) / h[d]
        return total

    def advect_component_van_leer(vel, i):
        """The linear scheme's flux locations (the forward faces of v_i's
        control volume along each axis), the carried value reconstructed
        upwind."""
        vi = vel[i]
        ax_i = axes[i]
        total = 0.0
        for d, ax_d in enumerate(axes):
            if d == i:
                u = 0.5 * (vi + torch.roll(vi, -1, ax_i))
            else:
                u = 0.5 * (vel[d] + torch.roll(vel[d], -1, ax_i))
            flux = _van_leer_flux(vi, u, dt, h[d], ax_d)
            total = total + (flux - torch.roll(flux, 1, ax_d)) / h[d]
        return total

    advect_component = (advect_component_van_leer if convect == "van_leer"
                        else advect_component_linear)

    def explicit_rhs(vel):
        f = forcing(*vel) if forcing is not None else None
        return tuple(-advect_component(vel, i) + nu * laplacian(v)
                     + (f[i] if f is not None else 0.0) for i, v in enumerate(vel))

    def euler_step(vel):
        vel = tuple(vel)
        dv = explicit_rhs(vel)
        return pressure_projection_nd(tuple(v + dt * d for v, d in zip(vel, dv)), h)

    def rk4_step(vel):
        u = tuple(vel)

        def stage(coeff, k):
            return pressure_projection_nd(tuple(v + dt * coeff * ki for v, ki in zip(u, k)), h)

        k1 = explicit_rhs(u)
        k2 = explicit_rhs(stage(0.5, k1))
        k3 = explicit_rhs(stage(0.5, k2))
        k4 = explicit_rhs(stage(1.0, k3))
        new = tuple(v + (dt / 6.0) * (a + 2.0 * b + 2.0 * c + d)
                    for v, a, b, c, d in zip(u, k1, k2, k3, k4))
        return pressure_projection_nd(new, h)

    return rk4_step if stepper == "rk4" else euler_step


def potential_noise_3d(grid, peak_wavenumber: float = 4.0, noise=None, batch: int = 1,
                       generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Spectrally filtered white noise ``[batch, X, Y, Z]``, one component
    of the vector potential of ``filtered_velocity_field_3d``: ``noise``
    (drawn from ``generator`` when not given) times the real, even envelope
    ``u exp(-u / 2)``, ``u = (|k| / kp)^2``, in the DFT basis."""
    shape = grid.shape
    lengths = [d[1] - d[0] for d in grid.domain]
    if noise is None:
        noise = torch.randn((batch, *shape), generator=generator, device=device)
    x = (noise.float() if isinstance(noise, torch.Tensor)
         else torch.from_numpy(np.array(noise, dtype=np.float32)))
    if device is not None:
        x = x.to(device)
    ks = [np.fft.fftfreq(n, d=length / n) for n, length in zip(shape, lengths)]
    ks[-1] = ks[-1][: shape[-1] // 2 + 1]
    kp = peak_wavenumber / lengths[0]
    kmag2 = None
    for d, k in enumerate(ks):
        sh = [1] * len(shape)
        sh[d] = len(k)
        term = torch.from_numpy((k ** 2).astype(np.float32)).reshape(sh).to(x.device)
        kmag2 = term if kmag2 is None else kmag2 + term
    u2 = kmag2 / torch.tensor(kp ** 2, dtype=torch.float32)
    env = u2 * torch.exp(-u2 / 2.0)
    dims = (-3, -2, -1)
    return irfftn(torch.fft.rfftn(x, dim=dims) * env, shape, dims)


def velocity_from_potential_3d(a: Sequence[torch.Tensor], grid,
                               maximum_velocity: float = 7.0) -> Velocity:
    """The curl of the vector potential ``a`` by centred differences,
    projected (which removes the differences' divergence) and scaled so that
    each field's fastest point moves at ``maximum_velocity``."""
    h = grid.step

    def ddx(f, ax, hh):
        return (torch.roll(f, -1, ax) - torch.roll(f, 1, ax)) / (2 * hh)

    u = ddx(a[2], -2, h[1]) - ddx(a[1], -1, h[2])
    v = ddx(a[0], -1, h[2]) - ddx(a[2], -3, h[0])
    w = ddx(a[1], -3, h[0]) - ddx(a[0], -2, h[1])
    u, v, w = pressure_projection_nd((u, v, w), h)
    speed = torch.sqrt(u ** 2 + v ** 2 + w ** 2)
    scale = maximum_velocity / torch.clamp(speed.amax(dim=(-3, -2, -1), keepdim=True), min=1e-12)
    return u * scale, v * scale, w * scale


def filtered_velocity_field_3d(grid, maximum_velocity: float = 7.0, peak_wavenumber: float = 4.0,
                               batch: int = 1, noise=None,
                               generator: Optional[torch.Generator] = None,
                               device=None) -> Velocity:
    """``batch`` random divergence-free 3D velocities ``(vx, vy, vz)``, each
    ``[batch, X, Y, Z]``: the curl of a smooth random vector potential whose
    energy peaks near ``peak_wavenumber``, scaled to ``maximum_velocity``.
    ``noise`` is the potential's three white-noise fields (``[batch, X, Y,
    Z]`` each, in the order of the JAX package's split keys), else three
    draws from ``generator``."""
    if noise is None:
        noise = [None] * 3
    a = [potential_noise_3d(grid, peak_wavenumber, n, batch, generator, device) for n in noise]
    return velocity_from_potential_3d(a, grid, maximum_velocity)
