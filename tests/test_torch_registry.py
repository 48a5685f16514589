"""The port's experiment registry (every family of the JAX registry: the
torus families, the structured-mesh and point-cloud families, the learned
interpolation, MeshGraphNet and the Kolmogorov data configs of both
methods) against the JAX package's, on the CPU.

- Names: the port's ``experiment_names()`` equals the JAX registry's 342
  names (64 of them data configs); an unknown name raises a ``KeyError``
  with close matches.
- Nodes: every config equals JAX's, with the JAX package's target prefix
  mapped onto the port's.
- Instantiation: every routine builds in the port at 2 layers, initialises
  on a batch of its builder's layout (on a grid that holds its modes; the
  mesh models' padding included; the elasticity routines on a batch of
  scattered points and codes; the learned interpolation on an ``(inputs,
  outputs)`` tuple at 32^2; MeshGraphNet on a small padded graph) and runs
  its model forward; every data config's stepper, at a 32^2 grid (16^3 for
  the 3D projection configs), takes a step: a vorticity spectrum for the
  pseudo-spectral method, a velocity tuple for the projection method.
- ``load_config`` reads a registry name, ``configs list|export`` on the
  command line, and each name is its own run directory.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from fourierflow_tpu.experiments import experiment_names as jax_experiment_names
from fourierflow_tpu.experiments import get_experiment as jax_get_experiment
from fourierflow_tpu_torch.commands.__main__ import main as cli
from fourierflow_tpu_torch.commands.train import build_routine, experiment_dir
from fourierflow_tpu_torch.config import instantiate, load_config
from fourierflow_tpu_torch.experiments import experiment_names, get_experiment
from fourierflow_tpu_torch.models.meshgraphnet import build_cylinder_graph
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine

FAMILIES = ("torus_li", "torus_vis", "torus_vis_force", "torus_kochkov", "airfoil", "pipe",
            "plasticity", "elasticity", "cylinder_flow", "data")
NAMES = experiment_names()
EXPERIMENTS = [n for n in NAMES if not n.startswith("data/")]
DATA_CONFIGS = [n for n in NAMES if n.startswith("data/")]
GRID = 32  # the smallest grid that holds 16 (F-FNO) and 12 (FNO-4) modes
# Mesh grids whose padded sizes hold the mesh models' modes: 32 x modes need 62 points
# (56 + 8), 16 y modes 30 (24 + 8); in 3D, 12 y modes 22 (16 + 8; Geo-FNO 16 + 5) and 8
# z modes 14 (10 + 8; Geo-FNO's 10 + 5 points have 8 rfft bins).
MESH_2D, MESH_3D = (56, 24), (56, 16, 10)


def _port_targets(node):
    """``node`` with the JAX package's names mapped onto the port's."""
    if isinstance(node, dict):
        return {k: _port_targets(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_port_targets(v) for v in node]
    if isinstance(node, str):
        return node.replace("fourierflow_tpu.", "fourierflow_tpu_torch.")
    return node


def test_names_equal_the_jax_names():
    want = [n for n in jax_experiment_names() if n.split("/")[0] in FAMILIES]
    assert NAMES == want == sorted(jax_experiment_names())
    assert len(NAMES) == 342 and len(DATA_CONFIGS) == 64


def test_unknown_name_raises_with_close_matches():
    with pytest.raises(KeyError, match="close matches.*cylinder_flow/baseline"):
        get_experiment("cylinder_flow/baselines")


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_jax(name):
    assert get_experiment(name) == _port_targets(jax_get_experiment(name))


def _sample_batch(cfg, grid):
    """A batch of the builder's layout on a ``grid`` x ``grid`` grid."""
    rng = np.random.RandomState(0)
    field = lambda c: rng.randn(2, grid, grid, c).astype(np.float32)
    target = cfg["builder"]["_target_"].rsplit(".", 1)[1]
    if target == "NSZongyiBuilder":  # 10 input frames and 2 position channels
        return {"x": field(12), "y": field(10)}
    batch = {"x": field(1), "y": field(1)}
    if target == "NSContextualBuilder":
        batch.update(f=field(1)[..., 0], mu=np.array([1e-5, 1e-4], np.float32))
    if target == "KolmogorovBuilder":
        batch.update(vx=field(1), vy=field(1))
    return batch


def _mesh_instantiates(cfg):
    rng = np.random.RandomState(0)
    routine = build_routine(cfg["routine"])
    if cfg["builder"]["_target_"].endswith("PlasticityBuilder"):
        x, out_shape = rng.randn(2, *MESH_3D, 1), (2, *MESH_3D, 4)
    else:
        x, out_shape = rng.randn(2, *MESH_2D, 2), (2, *MESH_2D, 1)
    x = x.astype(np.float32)
    state = routine.init(0, {"x": x}, "cpu")
    with torch.no_grad():
        out = state.model(torch.from_numpy(x))
    assert out.shape == out_shape and torch.isfinite(out).all()


def _point_cloud_instantiates(cfg):
    """A batch of 30 points scattered in the unit square and 42-value codes."""
    rng = np.random.RandomState(0)
    routine = build_routine(cfg["routine"])
    xy, rr = rng.rand(2, 30, 2).astype(np.float32), rng.randn(2, 42).astype(np.float32)
    state = routine.init(0, {"xy": xy, "rr": rr}, "cpu")
    with torch.no_grad():
        out = state.model(torch.from_numpy(xy), code=torch.from_numpy(rr))
    assert out.shape == (2, 30, 1) and torch.isfinite(out).all()


def _learned_interpolation_instantiates(name):
    """The routine at 32^2, 2 CNN layers, on an ``(inputs, outputs)`` tuple:
    one model step of smooth velocities."""
    cfg = load_config(name, ["routine.size=32", "routine.n_cnn_layers=2"])
    routine = build_routine(cfg["routine"])
    x = np.linspace(0, 2 * np.pi, 32, endpoint=False, dtype=np.float32)
    vx = np.broadcast_to(np.sin(4 * x)[None, None, :], (2, 32, 32)).copy()
    vy = np.broadcast_to(np.cos(3 * x)[None, :, None], (2, 32, 32)).copy()
    batch = ({"vx": vx, "vy": vy}, {"vx": vx[..., None], "vy": vy[..., None]})
    state = routine.init(0, batch, "cpu")
    with torch.no_grad():
        u, v = state.model(torch.from_numpy(vx), torch.from_numpy(vy))
    assert u.shape == v.shape == (2, 32, 32) and torch.isfinite(u).all()
    assert len(state.model.coeff_net.convs) == 1 and not torch.equal(u, torch.from_numpy(vx))


def _meshgraphnet_instantiates(name):
    """Two triangles of a 5-node mesh padded to 6 nodes and 3 cells."""
    routine = build_routine(load_config(name, ["routine.n_layers=2"])["routine"])
    cells = np.array([[[0, 1, 2], [1, 2, 3], [-1, -1, -1]]] * 2, np.int32)
    pos = np.random.RandomState(0).rand(2, 6, 2).astype(np.float32)
    pos[:, 5] = np.nan
    node_type = np.array([[0, 0, 4, 5, 6, -1]] * 2, np.int32)
    velocity = np.where(np.isnan(pos), np.nan, 0.5).astype(np.float32)
    batch = {"cells": cells, "mesh_pos": pos, "node_type": node_type, "velocity": velocity,
             "target_velocity": velocity}
    state = routine.init(0, batch, "cpu")
    graph = build_cylinder_graph(*(torch.from_numpy(batch[k]) for k in (
        "velocity", "node_type", "mesh_pos", "cells")))
    with torch.no_grad():
        out = state.model(*graph)
    assert out.shape == (2, 6, 2) and torch.isfinite(out).all()
    assert len(state.model.graph_layers) == 2


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_routine_instantiates(name):
    if name.startswith("torus_kochkov/learned_interpolation/"):
        return _learned_interpolation_instantiates(name)
    if name.startswith("cylinder_flow/"):
        return _meshgraphnet_instantiates(name)
    if name.split("/")[0] in ("airfoil", "pipe", "plasticity"):
        return _mesh_instantiates(load_config(name, ["routine.model.n_layers=2"]))
    if name.startswith("elasticity/"):
        return _point_cloud_instantiates(load_config(name, ["routine.model.n_layers=2"]))
    cfg = load_config(name, ["routine.conv.n_layers=2"])
    grid = max(GRID, 2 * cfg["routine"]["conv"].get("modes", 0))  # torus_kochkov: 32 or 64 modes
    routine = build_routine(cfg["routine"])
    batch = _sample_batch(cfg, grid)
    state = routine.init(0, batch, "cpu")
    x = torch.from_numpy(batch["x"])
    if isinstance(routine, Grid2DMarkovRoutine):
        x = routine.build_features(x, batch.get("f"), batch.get("mu"))
    with torch.no_grad():
        out = state.model(x)["forecast"]
    assert out.shape == (2, grid, grid, 1) and torch.isfinite(out).all()


def _projection_steps(name):
    """A projection config's grid cut to 32^2 (16^3 in 3D), its CFL step and
    its finite-volume stepper: one step of a smooth divergence-free velocity
    tuple stays finite and changes it."""
    ndim = len(get_experiment(name)["sim_grid"]["shape"])
    n = 32 if ndim == 2 else 16
    cfg = load_config(name, [f"sim_grid.shape={[n] * ndim}"])
    grid = instantiate(cfg["sim_grid"])
    dt = instantiate(cfg["time_step"])
    x = torch.linspace(0, 2 * np.pi * (1 - 1 / n), n)
    shape = (1,) + (n,) * ndim
    # u = sin(y) along x and v = sin(x) along y (w = 0 in 3D): each component
    # constant along its own axis, so divergence-free on the staggered grid.
    vel = [torch.sin(x).reshape([1, 1, n] + [1] * (ndim - 2)).expand(shape),
           torch.sin(x).reshape([1, n] + [1] * (ndim - 1)).expand(shape)]
    vel = tuple(v.contiguous() for v in vel) + ((torch.zeros(shape),) if ndim == 3 else ())
    out = instantiate(cfg["step_fn"])(vel)
    assert grid.shape == (n,) * ndim and 0 < dt < 1
    assert len(out) == ndim and all(torch.isfinite(o).all() for o in out)
    assert not torch.equal(out[0], vel[0])


@pytest.mark.parametrize("name", DATA_CONFIGS)
def test_data_config_steps(name):
    """The config's grid, time step and stepper, the grid cut to 32^2: one
    step of a smooth field (the vorticity spectrum of the pseudo-spectral
    method's CN-RK4, the velocity tuple of the projection method's
    finite-volume step) stays finite and changes it."""
    if get_experiment(name)["method"] == "projection":
        return _projection_steps(name)
    cfg = load_config(name, ["sim_grid.shape=[32,32]"])
    grid = instantiate(cfg["sim_grid"])
    dt = cfg["time_step"] if isinstance(cfg["time_step"], float) else instantiate(cfg["time_step"])
    step = instantiate(cfg["step_fn"])
    x = torch.linspace(0, 2 * np.pi * (1 - 1 / 32), 32)
    w_hat = torch.fft.rfft2(torch.sin(4 * x)[None, :, None] * torch.cos(3 * x)[None, None, :])
    out = step(w_hat)
    assert grid.shape == (32, 32) and 0 < dt < 1 and step.time_step == dt
    assert torch.isfinite(torch.view_as_real(out)).all() and not torch.equal(out, w_hat)


def test_load_config_reads_the_registry_with_overrides():
    cfg = load_config("torus_vis/02_no_mu", ["builder.ssr=1", "routine.conv.n_layers=4"])
    assert cfg["builder"]["ssr"] == 1 and cfg["routine"]["conv"]["n_layers"] == 4
    assert cfg["builder"]["data_path"].endswith("/torus/torus_vis.h5")
    assert cfg["routine"]["append_force"] and not cfg["routine"]["append_mu"]
    assert get_experiment("experiments/torus_vis/02_no_mu/config.yaml") == get_experiment(
        "torus_vis/02_no_mu")
    with pytest.raises(KeyError, match="close matches"):
        get_experiment("torus_vis/02_no_nu")


def test_each_name_is_its_own_run_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    four, deep = (experiment_dir(f"torus_li/markov/{n}_layers") for n in (4, 24))
    assert four != deep and four == str(tmp_path / "torus_li/markov/4_layers")
    yaml_path = tmp_path / "exp" / "config.yaml"
    os.makedirs(yaml_path.parent)
    yaml_path.write_text("{}")
    assert experiment_dir(str(yaml_path)) == str(tmp_path / "exp")


def test_configs_cli_lists_and_exports(tmp_path, capsys):
    cli(["configs", "list"])
    assert capsys.readouterr().out.split() == NAMES
    cli(["configs", "export", "torus_vis_force/06_shared_all_no_fork", "--out-dir",
         str(tmp_path)])
    path = capsys.readouterr().out.strip()
    assert path == str(tmp_path / "torus_vis_force/06_shared_all_no_fork.yaml")
    with open(path) as f:
        assert yaml.safe_load(f) == get_experiment("torus_vis_force/06_shared_all_no_fork")
    assert load_config(path) == load_config("torus_vis_force/06_shared_all_no_fork")
