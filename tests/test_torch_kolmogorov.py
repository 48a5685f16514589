"""The port's Kolmogorov-flow slice against the JAX package's, on the CPU.

- Grids, wavenumber meshes and ``stable_time_step``: to the bit (the
  2048^2 Re = 1000 step is 0.0002191401125550916). The forcings: within
  one float32 ulp (XLA's float32 cosine rounds otherwise than the port's
  float64 cosine rounded once), with a linear term within 2^-22 of the
  largest value.
- ``utils/spectral.py`` at 32^2 and 64^2: max |err| <= 1e-6 max |JAX|.
- ``filtered_velocity_field`` from JAX's normals (drawn from the same split
  keys): 1e-5; ``NavierStokes2D.explicit_terms`` and 1 and 20 CN-RK4 steps
  at 64^2 (Re = 1000): 1e-5.
- ``generate kolmogorov`` on the JAX test's tiny config
  (``tests/test_kolmogorov.py``): the same file names, shapes, ``time`` and
  attributes; from the same initial field (the JAX package's file) the
  trajectories agree to 1e-4; h5py and the JAX datasets read the port's
  files.
- The four datasets and the builder: the same samples and batch order as
  JAX's on the same files (the downsampled initial ``corr_data`` frame:
  1e-6).
- ``valid_step`` with ``corr_data`` (4 layers, width 16, 32^2, corr 16^2)
  with JAX's weights carried across: the same metrics, reduced ones
  included (1e-4); ``save_predictions`` at 128^2 (downsampled) and 32^2:
  JAX's arrays (1e-5).
- The vorticity_change ablation: JAX's routine raises ``KeyError: 'dy'`` on
  a Kolmogorov batch; the port raises a ``ValueError`` that says why.
- One tiny ``train`` run by registry name on generated files.
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
from fourierflow_tpu.config import instantiate as jax_instantiate
from fourierflow_tpu.models import FNOFactorized2DBlock as JaxBlock
from fourierflow_tpu.ops.fourier import rfft2 as jax_rfft2
from fourierflow_tpu.routines import Grid2DMarkovRoutine as JaxRoutine
from fourierflow_tpu.utils import equations as jax_eq
from fourierflow_tpu.utils import forcings as jax_forcings
from fourierflow_tpu.utils import grids as jax_grids
from fourierflow_tpu.utils import spectral as jax_spectral
from fourierflow_tpu_torch.builders import kolmogorov as kol
from fourierflow_tpu_torch.commands import train
from fourierflow_tpu_torch.commands.generate import kolmogorov as generate
from fourierflow_tpu_torch.config import instantiate, load_config
from fourierflow_tpu_torch.models import FNOFactorized2DBlock
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.utils import equations, forcings, grids, spectral
from fourierflow_tpu_torch.utils.weights import state_dict_from_flax

TWO_PI = 2 * np.pi
DOMAIN = ((0, TWO_PI), (0, TWO_PI))
KOCH_STEP = 0.0002191401125550916


def _np(a):
    return np.asarray(a.detach()) if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_rel(got, want, tol, what=""):
    """max |got - want| <= tol max |want| (complex arrays by parts)."""
    got, want = _np(got), _np(want)
    if np.iscomplexobj(want) or np.iscomplexobj(got):
        got, want = (np.stack([a.real, a.imag], -1) for a in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got.astype(np.float64) - want)) if want.size else 0.0
    scale = max(np.max(np.abs(want)), 1e-30) if want.size else 1.0
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol:g} x {scale:.3e}"


def _field(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _smooth_vorticity(n, batch=2, seed=0):
    """Smooth vorticities [batch, n, n] (JAX's filtered field, fd curl)."""
    grid = jax_grids.Grid((n, n), domain=DOMAIN)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    out = []
    for key in keys:
        vx, vy = jax_kol.filtered_velocity_field(key, grid, 7.0, 4.0)
        out.append(np.asarray(jax_spectral.velocity_to_vorticity_fd(vx, vy, grid)))
    return np.stack(out)


# --- grids, forcings, time step --------------------------------------------------------
@pytest.mark.parametrize("shape,domain", [((32, 32), DOMAIN), ((64, 48), DOMAIN),
                                          ((16, 16), ((0, 8 * np.pi), (0, 8 * np.pi))),
                                          ((30, 20), ((-1.0, 2.0), (0.5, 1.5)))])
def test_grid_and_meshes_match_jax_to_the_bit(shape, domain):
    jg, pg = jax_grids.Grid(shape, domain=domain), grids.Grid(shape, domain=domain)
    assert pg.shape == jg.shape and pg.domain == jg.domain and pg.step == jg.step
    assert pg.ndim == jg.ndim
    for a, b in zip(pg.axes(), jg.axes()):
        np.testing.assert_array_equal(a, b)
    for offset in (None, (0, 0), (1, 0.5)):
        for a, b in zip(pg.mesh(offset), jg.mesh(offset)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(pg.rfft_mesh() + pg.fft_mesh(), jg.rfft_mesh() + jg.fft_mesh()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(grids.fft_mesh(shape, domain), jax_grids.fft_mesh(shape, domain)):
        np.testing.assert_array_equal(a, b)
    step = grids.Grid(shape, step=0.25)
    assert step.domain == jax_grids.Grid(shape, step=0.25).domain


@pytest.mark.parametrize("name,kwargs", [
    ("kolmogorov_forcing_fn", {}), ("kolmogorov_forcing_fn", dict(scale=2.0, k=2)),
    ("simple_turbulence_forcing", {}),
    ("simple_turbulence_forcing", dict(constant_magnitude=1, constant_wavenumber=4,
                                       linear_coefficient=-0.1))])
def test_forcings_match_jax(name, kwargs):
    n = 64
    jf = getattr(jax_forcings, name)(jax_grids.Grid((n, n), domain=DOMAIN), **kwargs)
    pf = getattr(forcings, name)(grids.Grid((n, n), domain=DOMAIN), **kwargs)
    vx, vy = _field(1, 2, n, n), _field(2, 2, n, n)
    want = [np.broadcast_to(np.asarray(f), (2, n, n)) for f in jf(jnp.asarray(vx), jnp.asarray(vy))]
    got = [np.broadcast_to(_np(f), (2, n, n)) for f in pf(torch.from_numpy(vx), torch.from_numpy(vy))]
    static = kwargs.get("linear_coefficient", 0) == 0
    assert (getattr(pf, "static", None) is not None) == static
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        if static:
            np.testing.assert_array_max_ulp(a, b, maxulp=1)
        else:  # a * v + cos(...): the cosine's ulp, and the sum's rounding
            assert_rel(a, b, 2.0 ** -22)


def test_3d_forcing_raises_naming_the_projection_method():
    """The 2D-only forcing raises on a 3D grid, naming what a 3D flow takes;
    simple_turbulence_forcing has an N-D branch (held to the JAX package in
    tests/test_torch_projection.py)."""
    grid = grids.Grid((8, 8, 8), domain=DOMAIN + DOMAIN[:1])
    with pytest.raises(NotImplementedError, match="simple_turbulence_forcing.*projection method"):
        forcings.kolmogorov_forcing_fn(grid)
    fx, fy, fz = forcings.simple_turbulence_forcing(grid)(*torch.zeros(3, 1, 8, 8, 8))
    assert fx.shape == (1, 8, 8, 8) and fx.abs().max() > 0 and not fy.any() and not fz.any()


def test_stable_time_step_of_the_registry_is_exact():
    cfg = load_config("data/kolmogorov/re_1000/trajectories/train")
    assert instantiate(cfg["time_step"]) == KOCH_STEP == 0.0002191401125550916
    for n, visc in ((64, 1e-3), (256, 1e-3), (2048, 5e-4), (8, 10.0)):
        args = (7.0, 0.5, visc)
        assert (equations.stable_time_step(*args, grids.Grid((n, n), domain=DOMAIN))
                == jax_eq.stable_time_step(*args, jax_grids.Grid((n, n), domain=DOMAIN)))


# --- spectral utilities ----------------------------------------------------------------
def _spectral_case(name, n):
    """(port result, JAX result) of one utility at grid n."""
    jg, pg = jax_grids.Grid((n, n), domain=DOMAIN), grids.Grid((n, n), domain=DOMAIN)
    w = _smooth_vorticity(n, 2)
    jw, pw = jnp.asarray(w), torch.from_numpy(w)
    jhat, phat = jax_rfft2(jw, axes=(-2, -1)), torch.fft.rfft2(pw)
    half = grids.Grid((n // 2, n // 2), domain=DOMAIN)
    jhalf = jax_grids.Grid((n // 2, n // 2), domain=DOMAIN)
    vx, vy = _field(3, 2, n, n), _field(4, 2, n, n)
    if name == "vorticity_to_velocity_solve":
        return (torch.stack(spectral.vorticity_to_velocity_solve(pg)(phat)),
                np.stack(jax_spectral.vorticity_to_velocity_solve(jg)(jhat)))
    if name == "circular_filter_2d":
        return spectral.circular_filter_2d(pg), jax_spectral.circular_filter_2d(jg)
    if name == "velocity_to_vorticity_fd":
        return (spectral.velocity_to_vorticity_fd(torch.from_numpy(vx), torch.from_numpy(vy), pg),
                jax_spectral.velocity_to_vorticity_fd(jnp.asarray(vx), jnp.asarray(vy), jg))
    if name == "downsample_staggered_velocity":
        return (torch.stack(spectral.downsample_staggered_velocity(
                    pg, half, (torch.from_numpy(vx), torch.from_numpy(vy)))),
                np.stack(jax_spectral.downsample_staggered_velocity(
                    jg, jhalf, (jnp.asarray(vx), jnp.asarray(vy)))))
    if name == "downsample_vorticity_hat":
        got = spectral.downsample_vorticity_hat(phat, spectral.vorticity_to_velocity_solve(pg),
                                                pg, half)
        want = jax_spectral.downsample_vorticity_hat(
            jhat, jax_spectral.vorticity_to_velocity_solve(jg), jg, jhalf)
        return (torch.stack([got[k] for k in ("vx", "vy", "vorticity")]),
                np.stack([want[k] for k in ("vx", "vy", "vorticity")]))
    if name == "downsample_vorticity":
        traj = np.stack([_smooth_vorticity(n, 2, seed) for seed in range(3)], -1)  # [2, n, n, 3]
        return (spectral.downsample_vorticity(torch.from_numpy(traj), 16),
                jax_spectral.downsample_vorticity(jnp.asarray(traj), 16))
    assert name == "grid_correlation"  # of the field and the field with noise
    other = (w + 0.3 * w.std() * vx).astype(np.float32)
    return (spectral.grid_correlation(pw, torch.from_numpy(other)),
            jax_spectral.grid_correlation(jw, jnp.asarray(other)))


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("name", ["vorticity_to_velocity_solve", "circular_filter_2d",
                                  "velocity_to_vorticity_fd", "downsample_staggered_velocity",
                                  "downsample_vorticity_hat", "downsample_vorticity",
                                  "grid_correlation"])
def test_spectral_utility_matches_jax(name, n):
    got, want = _spectral_case(name, n)
    assert_rel(got, want, 1e-6, name)


def test_filtered_velocity_field_from_jax_normals():
    grid = (64, 64)
    key = jax.random.PRNGKey(5)
    jvx, jvy = jax_kol.filtered_velocity_field(key, jax_grids.Grid(grid, domain=DOMAIN), 7.0, 4.0)
    kr, ki = jax.random.split(key)
    normals = [np.array(jax.random.normal(k, grid))[None] for k in (kr, ki)]
    vx, vy = kol.filtered_velocity_field(grids.Grid(grid, domain=DOMAIN), 7.0, 4.0,
                                         normals=normals)
    assert_rel(vx[0], jvx, 1e-5, "vx")
    assert_rel(vy[0], jvy, 1e-5, "vy")
    speed = torch.sqrt(vx ** 2 + vy ** 2)
    assert abs(float(speed.max()) - 7.0) < 1e-5


# --- the equation and the stepper ---------------------------------------------------
@pytest.fixture(scope="module")
def equation_pair():
    """The Re = 1000 equation of the data configs at 64^2, built from one
    config by each package's ``instantiate``, and a smooth initial state."""
    cfg = load_config("data/kolmogorov/re_1000/trajectories/train", ["sim_grid.shape=[64,64]"])
    return (instantiate(cfg["step_fn"]["equation"]), jax_instantiate(cfg["step_fn"]["equation"]),
            instantiate(cfg["time_step"]), _smooth_vorticity(64, 2, seed=3))


def test_explicit_terms_match_jax(equation_pair):
    peq, jeq, _, w = equation_pair
    want = jax.vmap(jeq.explicit_terms)(jax_rfft2(jnp.asarray(w), axes=(-2, -1)))
    assert_rel(peq.explicit_terms(torch.fft.rfft2(torch.from_numpy(w))), want, 1e-5)


@pytest.mark.parametrize("steps", [1, 20])
def test_crank_nicolson_rk4_matches_jax(equation_pair, steps):
    peq, jeq, dt, w = equation_pair
    jstep = jax.jit(jax.vmap(jax_eq.repeated(jax_eq.crank_nicolson_rk4(jeq, dt), steps)))
    want = jstep(jax_rfft2(jnp.asarray(w), axes=(-2, -1)))
    got = equations.repeated(equations.crank_nicolson_rk4(peq, dt), steps)(
        torch.fft.rfft2(torch.from_numpy(w)))
    assert_rel(torch.view_as_real(got), np.stack([np.real(want), np.imag(want)], -1), 1e-5)


def test_graph_repeated_off_the_card_is_the_loop(equation_pair):
    peq, _, dt, w = equation_pair
    step = equations.crank_nicolson_rk4(peq, dt)
    state = torch.fft.rfft2(torch.from_numpy(w))
    run = equations.graph_repeated(step, state, 4)
    assert torch.equal(run(state, 6), equations.repeated(step, 6)(state))
    _, outs = equations.trajectory(step, 2, lambda s: s.abs().sum())(state)
    assert len(outs) == 2


def test_projection_method_and_3d_raise():
    """What the generator does not take raises, naming what it needs: the
    spectral method on a 3D grid (NavierStokes2D and check_method) and an
    unknown method. The projection method's jax-cfd targets translate to
    the port's finite-volume solver, and its configs pass check_method."""
    from fourierflow_tpu.experiments import get_experiment as jax_get_experiment
    from fourierflow_tpu_torch.config import import_string, translate
    from fourierflow_tpu_torch.utils import finite_volume

    grid3 = grids.Grid((8, 8, 8), domain=DOMAIN + DOMAIN[:1])
    with pytest.raises(NotImplementedError, match="spectral method is 2D only.*projection"):
        equations.NavierStokes2D(1e-3, grid3)
    with pytest.raises(NotImplementedError, match="pseudo-spectral method is 2D"):
        kol.generate_kolmogorov(grid3, [{"size": 8, "k": 1}], "pseudo_spectral", None)
    with pytest.raises(NotImplementedError, match="unknown method"):
        kol.check_method("vortex_particles", grids.Grid((8, 8), domain=DOMAIN))
    for name in ("data/kolmogorov/three_dimensions/trajectories/train",
                 "data/kolmogorov/compare_methods/drag/projection"):
        cfg = jax_get_experiment(name)
        kol.check_method(cfg["method"], instantiate(cfg["sim_grid"] | {
            "domain": [[0, TWO_PI]] * len(cfg["sim_grid"]["shape"])}))
        assert (import_string(translate(cfg["step_fn"]["_target_"]))
                is finite_volume.semi_implicit_navier_stokes)


# --- generation -------------------------------------------------------------------------
TINY = {
    "domain": [[0, TWO_PI], [0, TWO_PI]],
    "sim_grid": {"_target_": "fourierflow_tpu.utils.Grid", "shape": [64, 64],
                 "domain": "${domain}"},
    "time_step": 0.005,
    "method": "pseudo_spectral",
    "step_fn": {
        "_target_": "jax_cfd.spectral.time_stepping.crank_nicolson_rk4",
        "equation": {
            "_target_": "fourierflow.utils.equations.NavierStokes2D", "grid": "${sim_grid}",
            "viscosity": 1e-2, "drag": 0.1, "smooth": True,
            "forcing_fn": {
                "_target_": "functools.partial",
                "_args_": ["${get_method:jax_cfd.base.forcings.simple_turbulence_forcing}"],
                "constant_magnitude": 1, "constant_wavenumber": 4, "linear_coefficient": 0,
            },
        },
        "time_step": "${time_step}",
    },
    "downsample_fn": "${get_method:fourierflow.builders.kolmogorov.downsample_vorticity}",
    "n_trajectories": 2, "max_velocity": 7.0, "peak_wavenumber": 4.0, "seed": 1234,
    "inner_steps": 4, "outer_steps": 6, "warmup_steps": 0,
    "out_sizes": [{"size": 64, "k": 1}, {"size": 32, "k": 1}, {"size": 32, "k": 2}],
}
INIT = dict(TINY, outer_steps=0, warmup_steps=3,
            out_sizes=[{"size": 64, "k": 1}, {"size": 32, "k": 1}])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny dataset made by each package: JAX's ``init`` and ``train``
    (from its own initial field), the port's ``init`` and ``train`` (from
    its own), and the port's ``from_jax_init`` (from JAX's initial field)."""
    d = tmp_path_factory.mktemp("kol")
    for name, cfg in (("init", INIT), ("train", TINY)):
        with open(d / f"{name}.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
    jdir, pdir = d / "jax", d / "port"
    for sub in (jdir, pdir):
        sub.mkdir()
    for name in ("init", "train"):
        jax_generate(str(d / f"{name}.yaml"))
        for f in os.listdir(d):
            if f.endswith(".h5"):
                os.replace(d / f, jdir / f)
        generate(str(d / f"{name}.yaml"), device="cpu", out_dir=str(pdir))
    with open(d / "from_jax_init.yaml", "w") as f:
        yaml.safe_dump(dict(TINY, init_path=str(jdir / "init_64.nc")), f)
    generate(str(d / "from_jax_init.yaml"), device="cpu", out_dir=str(pdir))
    with open(d / "train.yaml", "w") as f:
        yaml.safe_dump(dict(TINY, init_path=str(jdir / "init_64.nc")), f)
    jax_generate(str(d / "train.yaml"))
    for f in os.listdir(d):
        if f.endswith(".h5"):
            os.replace(d / f, jdir / f.replace("train", "from_jax_init"))
    return jdir, pdir


def test_generated_files_match_jax_layout(files):
    jdir, pdir = files
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names
    for name in names:
        with h5py.File(jdir / name, "r") as jf, h5py.File(pdir / name, "r") as pf:
            assert sorted(pf) == sorted(jf)
            for key in jf:
                assert pf[key].shape == jf[key].shape and pf[key].dtype == jf[key].dtype, key
            assert dict(pf.attrs) == dict(jf.attrs)
            if "time" in jf:
                np.testing.assert_array_equal(pf["time"][...], jf["time"][...])
            for key in ("vorticity", "vx", "vy"):
                a = pf[key][...]
                assert np.isfinite(a).all() and np.abs(a).max() > 0
                if a.ndim == 4:
                    assert np.abs(a[:, 1] - a[:, 0]).max() > 0


def test_trajectories_from_the_same_initial_field_match_jax(files):
    jdir, pdir = files
    for name in ("from_jax_init_64_1.h5", "from_jax_init_32_1.h5", "from_jax_init_32_2.h5"):
        with h5py.File(jdir / name, "r") as jf, h5py.File(pdir / name, "r") as pf:
            for key in ("vorticity", "vx", "vy"):
                assert_rel(pf[key][...], jf[key][...], 1e-4, f"{name} {key}")


def test_jax_datasets_read_the_port_files(files):
    _, pdir = files
    ds = jax_kol.KolmogorovMarkovDataset(str(pdir / "train_64_1.h5"), k=1)
    assert len(ds) == 2 * 5 and ds.sample(np.arange(3))["x"].shape == (3, 64, 64, 1)
    traj = jax_kol.KolmogorovTrajectoryDataset(str(pdir / "init_64.h5"),
                                               str(pdir / "train_64_1.h5"),
                                               str(pdir / "train_32_1.h5"))
    assert traj.sample(np.arange(2))["corr_data"].shape == (2, 32, 32, 7)


# --- datasets and the builder -----------------------------------------------------------
def _same(got, want, tol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        if tol:
            assert_rel(got[k], want[k], tol, k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("k", [1, 2])
def test_markov_dataset_matches_jax(files, k):
    jdir, _ = files
    path = str(jdir / "train_64_1.nc")  # the .nc name resolves to the .h5 file
    jd, pd = jax_kol.KolmogorovMarkovDataset(path, k=k), kol.KolmogorovMarkovDataset(path, k=k)
    assert len(pd) == len(jd)
    idx = np.random.RandomState(k).permutation(len(jd))[:5]
    _same(pd.sample(idx), jd.sample(idx))


@pytest.mark.parametrize("k,end,corr", [(1, None, "train_32_1"), (2, None, "train_32_1"),
                                        (2, 5, "train_32_1"), (1, -2, "train_32_1")])
def test_trajectory_dataset_matches_jax(files, k, end, corr):
    jdir, _ = files
    args = (str(jdir / "init_64.h5"), str(jdir / "train_64_1.h5"), str(jdir / f"{corr}.h5"))
    jd = jax_kol.KolmogorovTrajectoryDataset(*args, k=k, end=end)
    pd = kol.KolmogorovTrajectoryDataset(*args, k=k, end=end)
    assert len(pd) == len(jd)
    idx = np.array([1, 0])
    got, want = pd.sample(idx), jd.sample(idx)
    _same({key: v for key, v in got.items() if key != "corr_data"},
          {key: v for key, v in want.items() if key != "corr_data"})
    assert_rel(got["corr_data"], want["corr_data"], 1e-6, "corr_data")
    np.testing.assert_array_equal(got["corr_data"][..., 1:], want["corr_data"][..., 1:])


def test_multi_dataset_and_builder_batches_match_jax(files):
    jdir, _ = files
    paths = [str(jdir / "train_64_1.h5"), str(jdir / "train_32_1.h5")]
    jm, pm = (m.KolmogorovMultiDataset(paths, k=1, batch_size=3) for m in (jax_kol, kol))
    assert len(pm) == len(jm)
    jbatches = list(jm.batches(shuffle=True, rng=np.random.default_rng(4)))
    pbatches = list(pm.batches(shuffle=True, rng=np.random.default_rng(4)))
    assert [b["x"].shape for b in pbatches] == [b["x"].shape for b in jbatches]
    for got, want in zip(pbatches, jbatches, strict=True):
        _same(got, want)

    def builders(mod, train):
        traj = mod.KolmogorovTrajectoryDataset(str(jdir / "init_64.h5"),
                                               str(jdir / "train_64_1.h5"),
                                               str(jdir / "train_32_1.h5"), k=2)
        return mod.KolmogorovBuilder(train, traj, traj, batch_size=4)

    for train_j, train_p in ((jm, pm), (jax_kol.KolmogorovMarkovDataset(paths[0]),
                                        kol.KolmogorovMarkovDataset(paths[0]))):
        jb, pb = builders(jax_kol, train_j), builders(kol, train_p)
        assert pb.batches_per_epoch == jb.batches_per_epoch
        for got, want in zip(pb.train_batches(np.random.default_rng(9)),
                             jb.train_batches(np.random.default_rng(9)), strict=True):
            _same(got, want)
        for split in ("val_batches", "test_batches"):
            for got, want in zip(getattr(pb, split)(), getattr(jb, split)(), strict=True):
                _same(got, want, tol=1e-6)
        assert pb.sample_batch()["x"].shape[1:] == next(pb.train_batches())["x"].shape[1:]
    _same(pb.inference_data(), {k: v for k, v in jb.inference_data().items()})


# --- the routine ------------------------------------------------------------------------
MODEL = dict(modes=6, width=16, n_layers=4, share_weight=True, factor=4, ff_weight_norm=True,
             gain=0.1)


@pytest.fixture(scope="module")
def routines():
    """JAX's and the port's Kolmogorov routine (velocity channels) at 32^2
    with the same weights and normalizer, and a validation batch with a
    16^2 ``corr_data``."""
    rng = np.random.RandomState(21)
    traj = np.concatenate([_smooth_vorticity(32, 2, seed) [..., None] for seed in range(5)], -1)
    traj = (traj + 0.05 * rng.randn(*traj.shape)).astype(np.float32)  # [2, 32, 32, 5]
    corr = np.asarray(jax_spectral.downsample_vorticity(jnp.asarray(traj), 16))
    batch = {"data": traj, "corr_data": (corr + 0.1 * rng.randn(*corr.shape)).astype(np.float32)}
    kw = dict(n_steps=4, use_velocity=True, max_accumulations=100, step_size=0.28)
    jr = JaxRoutine(model=JaxBlock(input_dim=5, **MODEL), **kw)
    pr = Grid2DMarkovRoutine(model=FNOFactorized2DBlock(input_dim=5, **MODEL), **kw)
    x = {"x": np.moveaxis(traj, -1, 1).reshape(-1, 32, 32, 1)}
    js = jr.accumulate_step(jr.init(jax.random.PRNGKey(0), x), {"x": jnp.asarray(x["x"])})
    ps = pr.init(0, x, "cpu")
    ps.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params),
                                                  MODEL["n_layers"]))
    ps = pr.accumulate_step(ps, x)
    return jr, js, pr, ps, batch


def test_valid_step_with_corr_data_matches_jax(routines):
    jr, js, pr, ps, batch = routines
    want = jax.tree.map(np.asarray, jr.valid_step(js, jax.tree.map(jnp.asarray, batch)))
    got = pr.valid_step(ps, batch)
    assert {"reduced_time_until", "reduced_corr", "reduced_correlations"} <= set(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_rel(got[k], want[k], 1e-4, k)


@pytest.mark.parametrize("n", [128, 32])
def test_save_predictions_matches_jax(routines, tmp_path, n):
    jr, _, pr, _, _ = routines
    preds = np.stack([_smooth_vorticity(n, 2, seed) for seed in range(3)], -1)
    times = np.arange(3) * 0.28
    jr.save_predictions(preds, times=times, path=str(tmp_path / "jax.h5"))
    path = pr.save_predictions(torch.from_numpy(preds), times=times, path=str(tmp_path / "p.h5"))
    with h5py.File(tmp_path / "jax.h5", "r") as jf, h5py.File(path, "r") as pf:
        assert sorted(pf) == sorted(jf)
        assert pf["vorticity"].shape == (2, min(n, 64), min(n, 64), 3)
        for key in jf:
            assert pf[key].shape == jf[key].shape, key
            assert_rel(pf[key][...], jf[key][...], 1e-5, key)


def test_vorticity_change_ablation_raises_on_kolmogorov_batches(files):
    """The registry's vorticity_change trains with learn_difference on
    KolmogorovMarkovDataset batches, which have no 'dy': JAX raises a
    KeyError inside its step; the port says why."""
    jdir, _ = files
    batch = kol.KolmogorovMarkovDataset(str(jdir / "train_64_1.h5")).sample(np.arange(2))
    jr = JaxRoutine(model=JaxBlock(input_dim=3, **MODEL), learn_difference=True)
    js = jr.init(jax.random.PRNGKey(0), batch)
    with pytest.raises(KeyError, match="dy"):
        jr.train_step(js, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
    cfg = load_config("torus_kochkov/ffno/ablation/vorticity_change",
                      ["routine.conv.n_layers=2", "routine.conv.width=8", "routine.conv.modes=4"])
    pr = train.build_routine(cfg["routine"])
    ps = pr.init(0, batch, "cpu")
    with pytest.raises(ValueError, match="'dy'.*does not give"):
        pr.train_step(ps, batch, torch.Generator().manual_seed(0))


def test_train_by_registry_name_on_generated_files(files, tmp_path, monkeypatch):
    """``train torus_kochkov/ffno/grid_sizes/64`` shrunk, on the port's tiny
    files laid out as the registry names them (64^2 pairs at k 2, the 32^2
    corr file), one epoch after the normalizer pass, the validation with the
    reduced metrics and the test pass."""
    _, pdir = files
    root = tmp_path / "data" / "kolmogorov" / "re_1000"
    for sub in ("trajectories", "initial_conditions"):
        (root / sub).mkdir(parents=True)
    for split in ("train", "valid", "test"):
        os.symlink(pdir / "train_64_1.h5", root / "trajectories" / f"{split}_64_4.h5")
        os.symlink(pdir / "train_32_1.h5", root / "trajectories" / f"{split}_32_4.h5")
        os.symlink(pdir / "init_64.h5", root / "initial_conditions" / f"{split}_64.h5")
    monkeypatch.setenv("DATA_ROOT", str(tmp_path / "data"))
    over = ["routine.conv.n_layers=2", "routine.conv.width=8", "routine.conv.modes=4",
            "builder.batch_size=4", "builder.train_dataset.k=2", "builder.valid_dataset.k=2",
            "builder.test_dataset.k=2", "trainer.max_epochs=2"]
    trainer, state = train.main("torus_kochkov/ffno/grid_sizes/64", over,
                                config_dir=str(tmp_path / "run"), device="cpu")
    logs = trainer.logs
    assert trainer.global_step == 2 and state.model.in_proj.in_features == 5
    for key in ("valid_loss", "valid_reduced_time_until", "valid_reduced_corr", "test_loss",
                "test_reduced_corr"):
        assert np.isfinite(logs[key]), key
    assert logs["test_reduced_correlations"].shape == (3,)


def test_generate_cli_needs_the_card_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    from fourierflow_tpu_torch.commands.__main__ import main as cli

    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(dict(INIT, warmup_steps=1, n_trajectories=1)))
    args = ["generate", "kolmogorov", str(path), "sim_grid.shape=[16,16]",
            'out_sizes=[{"size": 16, "k": 1}]', "--out-dir", str(tmp_path / "out")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(args)
    assert not (tmp_path / "out").exists()
    cli(args + ["--device", "cpu"])
    with h5py.File(tmp_path / "out" / "tiny_16.h5", "r") as f:
        assert f["vorticity"].shape == (1, 16, 16) and f.attrs["inner_steps"] == 4


def test_h5_writer_attributes_and_atomic_writes(tmp_path):
    """Scalar root attributes, read by h5py; an atomic file stands under
    ``.tmp`` until it is closed, and is deleted when its writer fails."""
    from fourierflow_tpu_torch.utils.hdf5 import H5Writer, read_dataset

    path = tmp_path / "a.h5"
    with H5Writer(str(path), {"w": ((2, 3), np.float32)}, attrs={"dt": 0.005, "inner_steps": 4},
                  atomic=True) as f:
        f.write("w", 0, np.ones((2, 3)))
        assert os.path.exists(str(path) + ".tmp") and not path.exists()
    with h5py.File(path, "r") as f:
        assert dict(f.attrs) == {"dt": 0.005, "inner_steps": 4}
        assert f.attrs["inner_steps"].dtype == np.int64
    np.testing.assert_array_equal(read_dataset(str(path), "w"), np.ones((2, 3)))
    with pytest.raises(RuntimeError):
        with H5Writer(str(path), {"w": ((1,), np.float32)}, atomic=True):
            raise RuntimeError("interrupted")
    assert sorted(os.listdir(tmp_path)) == ["a.h5"]
    np.testing.assert_array_equal(read_dataset(str(path), "w"), np.ones((2, 3)))
