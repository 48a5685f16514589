"""The port's projection method (``utils/finite_volume.py``, the N-D
forcing, the velocity snapshots and ``generate kolmogorov`` with
``method: projection``) against the JAX package's, on the CPU.

Tolerances (max |err| <= tol max |JAX|):
- ``pressure_projection_nd`` in 2D (32^2) and 3D (16^3): 1e-5; after it the
  finite-difference divergence is below 1e-5 of the velocities' own scale,
  and projecting again changes nothing beyond 1e-6.
- ``semi_implicit_navier_stokes``, Euler with van Leer, Euler with linear
  advection and RK4 with linear advection, 5 steps of the configs' CFL step
  at 32^2 and 16^3 (max velocity 7): 1e-5.
- ``simple_turbulence_forcing`` in 3D: the JAX package's numpy constant to
  the bit, and the linear term's rounding; ``kolmogorov_forcing_fv``: to the
  bit.
- ``filtered_velocity_field_3d`` on JAX's noise (the same split keys) and
  ``downsample_velocity_snapshot`` in 3D: 1e-5 and 1e-6.
- ``generate kolmogorov`` with a projection config cut to 32^2 (from a
  shared initial file) and 16^3: JAX's file names, fields, shapes, dtypes,
  ``time`` and attributes; the 32^2 trajectories from the same initial
  velocities agree to 1e-4.
- ``graph_repeated`` off the card on a velocity tuple is the eager loop.
"""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fourierflow_tpu.builders import kolmogorov as jax_kol
from fourierflow_tpu.commands.generate import kolmogorov as jax_generate
from fourierflow_tpu.utils import finite_volume as jax_fv
from fourierflow_tpu.utils import forcings as jax_forcings
from fourierflow_tpu.utils import grids as jax_grids
from fourierflow_tpu_torch.builders import kolmogorov as kol
from fourierflow_tpu_torch.commands.generate import kolmogorov as generate
from fourierflow_tpu_torch.config import instantiate, load_config
from fourierflow_tpu_torch.utils import equations, finite_volume, forcings, grids

TWO_PI = 2 * np.pi


def _np(a):
    return np.asarray(a.detach()) if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_rel(got, want, tol, what=""):
    """max |got - want| <= tol max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got.astype(np.float64) - want))
    scale = max(np.max(np.abs(want)), 1e-30)
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol:g} x {scale:.3e}"


def _grids(n, ndim):
    domain = ((0, TWO_PI),) * ndim
    return grids.Grid((n,) * ndim, domain=domain), jax_grids.Grid((n,) * ndim, domain=domain)


def _velocity(n, ndim, batch=2, seed=0):
    """Smooth divergence-free velocities ``batch`` x ``[n]*ndim`` from the JAX
    package's initial-field generators (max speed 7)."""
    _, jg = _grids(n, ndim)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    if ndim == 2:
        fields = [jax_kol.filtered_velocity_field(k, jg, 7.0, 4.0) for k in keys]
    else:
        fields = [jax_fv.filtered_velocity_field_3d(k, jg, 7.0, 4.0) for k in keys]
    return tuple(np.stack([np.asarray(f[i]) for f in fields]) for i in range(ndim))


def _divergence(vel, h):
    return sum((v - np.roll(v, 1, axis=a)) / h for a, v in zip(range(-len(vel), 0), vel))


@pytest.mark.parametrize("ndim,n", [(2, 32), (3, 16)])
def test_pressure_projection_nd_matches_jax(ndim, n):
    pg, _ = _grids(n, ndim)
    rng = np.random.RandomState(ndim)
    vel = tuple(rng.randn(2, *(n,) * ndim).astype(np.float32) for _ in range(ndim))
    got = finite_volume.pressure_projection_nd(tuple(map(torch.from_numpy, vel)), pg.step)
    want = jax_fv.pressure_projection_nd(tuple(map(jnp.asarray, vel)), list(pg.step))
    for i in range(ndim):
        assert_rel(got[i], want[i], 1e-5, f"component {i}")
    div = _divergence([_np(g).astype(np.float64) for g in got], pg.step[0])
    assert np.abs(div).max() <= 1e-5 * np.abs(vel[0]).max() / pg.step[0]
    again = finite_volume.pressure_projection_nd(got, pg.step)
    for a, b in zip(again, got):
        assert_rel(a, b, 1e-6, "projected twice")


def _step_config(n, ndim, stepper, convect):
    name = ("data/kolmogorov/three_dimensions/trajectories/test" if ndim == 3
            else "data/kolmogorov/compare_methods/drag/projection")
    over = [f"sim_grid.shape={[n] * ndim}"]
    if stepper == "rk4":
        over.append("step_fn.time_stepper=${get_method:jax_cfd.base.time_stepping.classic_rk4}")
    if convect:
        over.append(f"step_fn.convect={convect}")
    return name, over


@pytest.mark.parametrize("ndim,n", [(2, 32), (3, 16)])
@pytest.mark.parametrize("stepper,convect", [("euler", None), ("euler", "linear"),
                                             ("rk4", None)])
def test_semi_implicit_navier_stokes_matches_jax(ndim, n, stepper, convect):
    """5 steps of the registry's projection configs (the cosine forcing with
    linear coefficient -0.1, the configs' CFL step) from the same velocity;
    RK4's default advection is linear."""
    from fourierflow_tpu.config import instantiate as jax_instantiate
    from fourierflow_tpu.config import load_config as jax_load_config

    name, over = _step_config(n, ndim, stepper, convect)
    step = instantiate(load_config(name, over)["step_fn"])
    jstep = jax.jit(jax_instantiate(jax_load_config(name, over)["step_fn"]))
    vel = _velocity(n, ndim, seed=n + ndim)
    got = equations.repeated(step, 5)(tuple(map(torch.from_numpy, vel)))
    want = tuple(map(jnp.asarray, vel))
    for _ in range(5):
        want = jstep(want)
    for i in range(ndim):
        assert np.isfinite(_np(got[i])).all()
        assert_rel(got[i], want[i], 1e-5, f"{stepper}/{convect} component {i}")
    assert np.abs(_np(got[0]) - vel[0]).max() > 0


def test_default_advection_follows_the_stepper():
    pg, _ = _grids(8, 2)
    with pytest.raises(ValueError, match="convect"):
        finite_volume.semi_implicit_navier_stokes(grid=pg, convect="upwind")
    with pytest.raises(ValueError, match="time_stepper"):
        finite_volume.semi_implicit_navier_stokes(grid=pg, time_stepper="rk3")
    assert finite_volume._stepper_name(finite_volume.classic_rk4) == "rk4"
    assert finite_volume._stepper_name(None) == finite_volume.forward_euler() == "euler"


@pytest.mark.parametrize("name,kwargs", [
    ("simple_turbulence_forcing", dict(constant_magnitude=1, constant_wavenumber=4,
                                       linear_coefficient=-0.1)),
    ("kolmogorov_forcing_fv", dict(constant_magnitude=2.0, constant_wavenumber=3,
                                   linear_coefficient=-0.1))])
def test_3d_forcings_match_jax(name, kwargs):
    n = 16
    pg, jg = _grids(n, 3)
    module, jmodule = ((forcings, jax_forcings) if name == "simple_turbulence_forcing"
                       else (finite_volume, jax_fv))
    pf, jf = getattr(module, name)(pg, **kwargs), getattr(jmodule, name)(jg, **kwargs)
    rng = np.random.RandomState(3)
    vel = [rng.randn(2, n, n, n).astype(np.float32) for _ in range(3)]
    got = pf(*map(torch.from_numpy, vel))
    want = jf(*map(jnp.asarray, vel))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (2, n, n, n)
        assert_rel(a, b, 2.0 ** -22)
    zero = [np.zeros_like(v) for v in vel]
    const, jconst = pf(*map(torch.from_numpy, zero))[0], jf(*map(jnp.asarray, zero))[0]
    np.testing.assert_array_equal(_np(const), np.asarray(jconst))


def test_filtered_velocity_field_3d_from_jax_noise():
    n = 16
    pg, jg = _grids(n, 3)
    key = jax.random.PRNGKey(11)
    want = jax_fv.filtered_velocity_field_3d(key, jg, 7.0, 4.0)
    noise = [np.asarray(jax.random.normal(k, (n,) * 3, jnp.float32))[None]
             for k in jax.random.split(key, 3)]
    got = finite_volume.filtered_velocity_field_3d(pg, 7.0, 4.0, noise=noise)
    for i in range(3):
        assert got[i].shape == (1, n, n, n)
        assert_rel(got[i][0], want[i], 1e-5, f"component {i}")
    speed = torch.sqrt(sum(c ** 2 for c in got))
    assert abs(float(speed.max()) - 7.0) < 1e-5
    div = _divergence([_np(c[0]).astype(np.float64) for c in got], pg.step[0])
    assert np.abs(div).max() <= 1e-4 * 7.0 / pg.step[0]
    drawn = finite_volume.filtered_velocity_field_3d(
        pg, 7.0, 4.0, batch=2, generator=torch.Generator().manual_seed(0))
    assert all(c.shape == (2, n, n, n) and torch.isfinite(c).all() for c in drawn)


def test_downsample_velocity_snapshot_3d_matches_jax():
    pg, jg = _grids(16, 3)
    out_sizes = {(16, 1): 16, (8, 1): 8, (4, 2): 4}
    p_out = {k: grids.Grid((s,) * 3, domain=pg.domain) for k, s in out_sizes.items()}
    j_out = {k: jax_grids.Grid((s,) * 3, domain=jg.domain) for k, s in out_sizes.items()}
    vel = _velocity(16, 3, batch=2, seed=5)
    got = kol.downsample_velocity_snapshot(pg, p_out, None, True, tuple(map(torch.from_numpy, vel)))
    want = jax_kol.downsample_velocity_snapshot(jg, j_out, None, True, tuple(map(jnp.asarray, vel)))
    for key in out_sizes:
        assert sorted(got[key]) == sorted(want[key]) == ["vx", "vy", "vz"]
        for name in ("vx", "vy", "vz"):
            assert_rel(got[key][name], want[key][name], 1e-6, f"{key} {name}")


def test_graph_repeated_off_the_card_steps_a_velocity_tuple():
    pg, _ = _grids(16, 2)
    step = finite_volume.semi_implicit_navier_stokes(dt=0.01, grid=pg)
    state = tuple(map(torch.from_numpy, _velocity(16, 2, batch=1)))
    run = equations.graph_repeated(step, state, 4)
    for a, b in zip(run(state, 6), equations.repeated(step, 6)(state)):
        assert torch.equal(a, b)


def test_check_method_takes_the_projection_method_in_2d_and_3d():
    for ndim in (2, 3):
        kol.check_method("projection", _grids(8, ndim)[0])
    kol.check_method("pseudo_spectral", _grids(8, 2)[0])
    with pytest.raises(NotImplementedError, match="pseudo-spectral method is 2D"):
        kol.check_method("pseudo_spectral", _grids(8, 3)[0])
    with pytest.raises(NotImplementedError, match="unknown method"):
        kol.check_method("lattice_boltzmann", _grids(8, 2)[0])


# --- generation ----------------------------------------------------------------------
def _cut(name, n, **over):
    """A projection config of the registry with the JAX package's targets,
    cut to ``n`` and to a few steps."""
    from fourierflow_tpu.experiments import get_experiment as jax_get_experiment

    cfg = jax_get_experiment(name)
    ndim = len(cfg["sim_grid"]["shape"])
    cfg["domain"] = [[0, TWO_PI]] * ndim
    cfg["sim_grid"]["shape"] = [n] * ndim
    cfg.pop("init_path", None)
    cfg.update(n_trajectories=2, inner_steps=2, outer_steps=4, warmup_steps=1,
               out_sizes=[{"size": n, "k": 1}, {"size": n // 2, "k": 2}])
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def projection_files(tmp_path_factory):
    """Each package's files of a 2D trajectory config (from the JAX
    package's 32^2 initial velocities), a 3D trajectory config and a 3D
    initial-conditions config at 16^3 (each from its own random fields)."""
    d = tmp_path_factory.mktemp("proj")
    jdir, pdir = d / "jax", d / "port"
    jdir.mkdir()
    pdir.mkdir()
    init = jdir / "init_32.h5"
    vx, vy = _velocity(32, 2, batch=2, seed=7)
    with h5py.File(init, "w") as f:
        f["vx"], f["vy"] = vx, vy
    configs = {
        "control": _cut("data/kolmogorov/re_1000/learned_interpolation/control", 32,
                        init_path=str(init), warmup_steps=0),
        "rk4": _cut("data/kolmogorov/compare_methods/downsampling/projection_rk4/128", 32,
                    init_path=str(init), warmup_steps=0),
        "three_d": _cut("data/kolmogorov/three_dimensions/trajectories/test", 16),
        "three_d_ic": _cut("data/kolmogorov/three_dimensions/initial_conditions/test", 16,
                           outer_steps=0, warmup_steps=2),
    }
    for name, cfg in configs.items():
        path = d / f"{name}.yaml"
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        jax_generate(str(path))
        for f in os.listdir(d):
            if f.endswith(".h5"):
                os.replace(d / f, jdir / f)
        generate(str(path), device="cpu", out_dir=str(pdir))
    return jdir, pdir


def test_generated_projection_files_match_jax_layout(projection_files):
    jdir, pdir = projection_files
    names = sorted(f for f in os.listdir(jdir) if f != "init_32.h5")
    assert names == sorted(os.listdir(pdir))
    assert "three_d_16_1.h5" in names and "three_d_ic_8.h5" in names
    for name in names:
        with h5py.File(jdir / name, "r") as jf, h5py.File(pdir / name, "r") as pf:
            assert sorted(pf) == sorted(jf), name
            for key in jf:
                assert pf[key].shape == jf[key].shape and pf[key].dtype == jf[key].dtype, key
            assert dict(pf.attrs) == dict(jf.attrs)
            if "time" in jf:
                np.testing.assert_array_equal(pf["time"][...], jf["time"][...])
            three_d = name.startswith("three_d")
            assert ("vz" in pf) == three_d and ("vorticity" in pf) == (not three_d)
            for key in ("vx", "vy", "vz", "vorticity"):
                if key in pf:
                    a = pf[key][...]
                    assert np.isfinite(a).all() and np.abs(a).max() > 0
                    if a.ndim == 2 + (3 if three_d else 2):
                        assert np.abs(a[:, 1] - a[:, 0]).max() > 0


@pytest.mark.parametrize("name", ["control_32_1.h5", "control_16_2.h5", "rk4_32_1.h5",
                                  "rk4_16_2.h5"])
def test_projection_trajectories_from_the_same_initial_velocity_match_jax(projection_files,
                                                                           name):
    jdir, pdir = projection_files
    with h5py.File(jdir / name, "r") as jf, h5py.File(pdir / name, "r") as pf:
        for key in ("vx", "vy", "vorticity"):
            assert_rel(pf[key][...], jf[key][...], 1e-4, f"{name} {key}")
