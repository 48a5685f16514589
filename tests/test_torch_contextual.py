"""The port's torus_vis slice against the JAX package's, on the CPU.

- ``utils/hdf5.py``'s memory-mapped read: a strided read equals the full
  read, and a dataset never written reads as zeros.
- ``NSContextualBuilder`` on one file written by the port's HDF5 writer
  and by h5py, read through h5py and through ``utils/hdf5.py``: every
  array equals the JAX builder's exactly.
- ``velocity_from_vorticity`` and ``build_features`` with the velocity,
  position, force and viscosity channels.
- Train steps with force and viscosity, and with velocity; the rollout
  with a static and a time-varying force; the serving module, its export
  and its refusal of a viscosity; ``train`` then ``test`` on a registry
  name, and ``infer``, ``predict``, ``sample`` and ``export`` passing the
  force and viscosity.

Tolerances are relative to the largest reference value unless stated:
1e-5 where both sides compute in float32 and only the order of the sums
differs (the velocity: real-pair DFTs in JAX, ``torch.fft`` in the port).
"""

import pickle
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu.builders import NSContextualBuilder as JaxBuilder
from fourierflow_tpu.models import FNOFactorized2DBlock as JaxBlock
from fourierflow_tpu.routines import Grid2DMarkovRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu.utils.grids import velocity_from_vorticity as jax_velocity
from fourierflow_tpu.utils.serving import make_rollout_fn as jax_make_rollout_fn
from fourierflow_tpu_torch.builders import NSContextualBuilder
from fourierflow_tpu_torch.commands import export, infer, predict, sample, train
from fourierflow_tpu_torch.commands import test as test_command
from fourierflow_tpu_torch.commands.generate import navier_stokes
from fourierflow_tpu_torch.models import FNOFactorized2DBlock
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.utils.grids import velocity_from_vorticity
from fourierflow_tpu_torch.utils.hdf5 import H5Writer, read_dataset
from fourierflow_tpu_torch.utils.serving import export_rollout, load_exported, make_rollout_fn
from fourierflow_tpu_torch.utils.weights import state_dict_from_flax

GRID, T, N_LAYERS = 16, 8, 2
MODEL = dict(modes=4, width=8, input_dim=3, n_layers=N_LAYERS, share_weight=True, factor=2,
             ff_weight_norm=True, gain=0.1)
TOL = 1e-5


def _close_to_max(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (what, err, np.max(np.abs(want)))


# --- data -------------------------------------------------------------------------------
def _splits(varying: bool, seed=0):
    """{split: {"u", "f", "mu"}} of 3, 2 and 2 trajectories [GRID, GRID, T]."""
    rng = np.random.RandomState(seed)
    out = {}
    for split, n in (("train", 3), ("valid", 2), ("test", 2)):
        f_shape = (n, GRID, GRID, T) if varying else (n, GRID, GRID)
        out[split] = {"u": rng.randn(n, GRID, GRID, T).astype(np.float32),
                      "f": rng.randn(*f_shape).astype(np.float32),
                      "mu": rng.uniform(1e-5, 1e-4, n).astype(np.float32)}
    return out


def _write(path, splits, writer):
    if writer == "h5py":
        with h5py.File(path, "w") as f:
            for split, arrays in splits.items():
                for key, a in arrays.items():
                    f.create_dataset(f"{split}/{key}", data=a)
    else:
        layout = {f"{split}/{key}": (a.shape, a.dtype)
                  for split, arrays in splits.items() for key, a in arrays.items()}
        with H5Writer(str(path), layout) as f:
            for split, arrays in splits.items():
                for key, a in arrays.items():
                    f.write(f"{split}/{key}", 0, a)
    return str(path)


@pytest.mark.parametrize("writer", ["port", "h5py"])
def test_read_dataset_mmap_reads_strided_and_unwritten(writer, tmp_path):
    """A memory-mapped read sliced as the builders slice it equals the full
    read; a dataset that was never written reads as zeros."""
    splits = _splits(varying=True)
    path = _write(tmp_path / "d.h5", splits, writer)
    full = read_dataset(path, "train/u")
    mapped = read_dataset(path, "train/u", mmap=True)
    assert isinstance(mapped, np.memmap) and not mapped.flags.writeable
    np.testing.assert_array_equal(full, splits["train"]["u"])
    np.testing.assert_array_equal(mapped[:, ::2, ::2, ::3], full[:, ::2, ::2, ::3])
    empty = tmp_path / "e.h5"
    if writer == "h5py":
        with h5py.File(empty, "w") as f:
            f.create_dataset("train/f", shape=(2, 4, 4), dtype=np.float32)
    else:
        H5Writer(str(empty), {"train/f": ((2, 4, 4), np.float32)}).close()
    for mmap in (False, True):
        np.testing.assert_array_equal(read_dataset(str(empty), "train/f", mmap=mmap),
                                      np.zeros((2, 4, 4), np.float32))


@pytest.mark.parametrize("ssr,k", [(1, 1), (2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("varying", [False, True], ids=["constant", "varying"])
@pytest.mark.parametrize("writer,reader", [("port", "h5py"), ("h5py", "h5py"),
                                           ("port", "hdf5"), ("h5py", "hdf5")])
def test_builder_matches_jax(writer, reader, varying, ssr, k, tmp_path, monkeypatch):
    path = _write(tmp_path / "vis.h5", _splits(varying), writer)
    want = JaxBuilder(path, ssr=ssr, k=k, batch_size=4)
    if reader == "hdf5":
        monkeypatch.setitem(sys.modules, "h5py", None)  # load_array falls back to utils/hdf5.py
    got = NSContextualBuilder(path, ssr=ssr, k=k, batch_size=4)
    for split in ("train_data", "valid_data", "test_data"):
        g, w = getattr(got, split), getattr(want, split)
        assert sorted(g) == sorted(w), split
        for key in w:
            assert g[key].dtype == w[key].dtype, (split, key)
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"{split}/{key}")
    inference = got.inference_data()
    np.testing.assert_array_equal(inference["f"], want.inference_data()["f"])


# --- features ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,domain", [((2, 16, 16), ((0, 2 * np.pi), (0, 2 * np.pi))),
                                          ((2, 15, 16), ((0, 2 * np.pi), (0, 2 * np.pi))),
                                          ((2, 16, 15), ((0, 1.0), (0, 3.0)))])
def test_velocity_matches_jax(shape, domain):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = jax_velocity(jnp.asarray(w), domain)
    got = velocity_from_vorticity(torch.from_numpy(w), domain)
    for name, a, b in zip("uv", got, want):
        _close_to_max(a.numpy(), np.asarray(b), what=name)


def _contextual_batch(b=4, seed=2, varying=False):
    rng = np.random.RandomState(seed)
    f_shape = (b, GRID, GRID, T) if varying else (b, GRID, GRID)
    return {"x": rng.randn(b, GRID, GRID, 1).astype(np.float32),
            "y": rng.randn(b, GRID, GRID, 1).astype(np.float32),
            "f": rng.randn(*f_shape).astype(np.float32),
            "mu": rng.uniform(1e-5, 1e-4, b).astype(np.float32)}


@pytest.mark.parametrize("use_velocity", [False, True])
@pytest.mark.parametrize("use_position", [False, True])
@pytest.mark.parametrize("force", [None, "3d", "4d"])
@pytest.mark.parametrize("append_mu", [False, True])
def test_build_features_matches_jax(use_velocity, use_position, force, append_mu):
    """Channels in JAX's order (w, u, v, positions, force, mu): equal to the
    bit except the velocity's, which agree to rel 1e-5."""
    batch = _contextual_batch(varying=force == "4d")
    kw = dict(use_velocity=use_velocity, use_position=use_position,
              append_force=force is not None, append_mu=append_mu)
    want = np.asarray(JaxRoutine(**kw).build_features(
        jnp.asarray(batch["x"]), jnp.asarray(batch["f"]), jnp.asarray(batch["mu"])))
    got = Grid2DMarkovRoutine(**kw).build_features(
        torch.from_numpy(batch["x"]), torch.from_numpy(batch["f"]),
        torch.from_numpy(batch["mu"])).numpy()
    assert got.shape == want.shape
    vel = [1, 2] if use_velocity else []
    if vel:
        _close_to_max(got[..., vel], want[..., vel], what="velocity")
    rest = [i for i in range(want.shape[-1]) if i not in vel]
    np.testing.assert_array_equal(got[..., rest], want[..., rest])


# --- train steps, rollout ---------------------------------------------------------------
def _pair(routine_kw, batch, lr=1e-3):
    """JAX and port routines with the same weights and one normalizer pass
    over ``batch``; the port model is made with input_dim 3 and sized to
    the features by ``init``."""
    jr = JaxRoutine(model=JaxBlock(**MODEL), max_accumulations=1000,
                    optimizer=jax_make_optimizer(lr=lr, weight_decay=1e-4), **routine_kw)
    js = jr.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    js = jr.accumulate_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
    pr = Grid2DMarkovRoutine(model=FNOFactorized2DBlock(**MODEL), max_accumulations=1000,
                             optimizer=make_optimizer(lr=lr, weight_decay=1e-4), **routine_kw)
    ps = pr.init(0, batch, "cpu")
    ps.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params), N_LAYERS))
    ps = pr.accumulate_step(ps, batch)
    return jr, js, pr, ps


def _named(params):
    return {k: v.numpy() for k, v in state_dict_from_flax(jax.tree.map(np.asarray, params),
                                                          N_LAYERS).items()}


@pytest.mark.parametrize("routine_kw,n_feats", [
    (dict(append_force=True, append_mu=True), 5),
    (dict(use_velocity=True), 5),
], ids=["force_mu", "velocity"])
def test_train_steps_match_jax(routine_kw, n_feats):
    """Three ``train_step``s without noise: the losses agree to rel 1e-5 and
    the parameters after them to 2e-5 absolute (as in
    ``test_torch_training.py``: Adam turns summation-order noise in a
    gradient near zero into an update of up to lr)."""
    batches = [_contextual_batch(seed=s) for s in (3, 4, 5)]
    jr, js, pr, ps = _pair(routine_kw, batches[0])
    assert ps.model.in_proj.in_features == n_feats
    for batch in batches:
        js, jm = jr.train_step(js, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        ps, pm = pr.train_step(ps, batch)
        assert float(pm["train_loss"]) == pytest.approx(float(jm["train_loss"]), rel=TOL)
    want = _named(js.params)
    for name, p in ps.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name], rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("varying", [False, True], ids=["static", "varying"])
@pytest.mark.parametrize("use_velocity", [False, True])
def test_rollout_matches_jax(varying, use_velocity):
    """A 4-step rollout over 8 frames with force and viscosity: the
    predictions and step losses agree to rel 1e-5; a varying force's step t
    is frame T - 4 + t."""
    routine_kw = dict(append_force=True, append_mu=True, use_velocity=use_velocity, n_steps=4)
    jr, js, pr, ps = _pair(routine_kw, _contextual_batch())
    rng = np.random.RandomState(6)
    f_shape = (2, GRID, GRID, T) if varying else (2, GRID, GRID)
    batch = {"data": rng.randn(2, GRID, GRID, T).astype(np.float32),
             "f": rng.randn(*f_shape).astype(np.float32),
             "mu": rng.uniform(1e-5, 1e-4, 2).astype(np.float32)}
    want = jr.rollout(js, {k: jnp.asarray(v) for k, v in batch.items()})
    got = pr.rollout(ps, batch)
    for name, a, b in zip(("preds", "step_losses"), got[:2], want[:2]):
        _close_to_max(a.numpy(), np.asarray(b), what=name)
    # Another force in the frames the rollout does not read changes nothing.
    if varying:
        other = dict(batch, f=np.concatenate([batch["f"][..., :4] + 1, batch["f"][..., 4:]], -1))
        torch.testing.assert_close(pr.rollout(ps, other)[0], got[0], rtol=0, atol=0)


# --- serving ----------------------------------------------------------------------------
def _served():
    jr, js, pr, ps = _pair(dict(append_force=True), _contextual_batch())
    rng = np.random.RandomState(7)
    w0 = rng.randn(2, GRID, GRID, 1).astype(np.float32)
    force = rng.randn(2, GRID, GRID).astype(np.float32)
    return jr, js, pr, ps, torch.from_numpy(w0), torch.from_numpy(force)


def test_serving_with_a_force_matches_rollout_and_jax():
    """The serving module with a static force equals ``routine.rollout`` to
    the bit, and JAX's ``make_rollout_fn(...)(w0, force [b, X, Y])`` to rel
    1e-5."""
    jr, js, pr, ps, w0, force = _served()
    with torch.no_grad():
        got = make_rollout_fn(pr, ps, 3)(w0, force)
    pr.n_steps = 3
    data = torch.cat([w0, torch.zeros(2, GRID, GRID, 3)], dim=-1)
    torch.testing.assert_close(got, pr.rollout(ps, {"data": data, "f": force})[0], rtol=0, atol=0)
    want = jax_make_rollout_fn(jr, js, 3)(jnp.asarray(w0.numpy()), jnp.asarray(force.numpy()))
    _close_to_max(got.numpy(), np.asarray(want), what="serving vs JAX")
    with pytest.raises(ValueError, match="takes \\(w0, force\\)"):
        make_rollout_fn(pr, ps, 3)(w0)


def test_export_with_a_force_round_trips(tmp_path):
    _, _, pr, ps, w0, force = _served()
    path = export_rollout(pr, ps, str(tmp_path / "f.pt2"), n_steps=3, batch_size=2, size=GRID,
                          device="cpu")
    artifact = load_exported(path)
    assert artifact.takes_force
    with torch.no_grad():
        live = make_rollout_fn(pr, ps, 3)(w0, force)
    torch.testing.assert_close(artifact(w0, force), live, rtol=0, atol=0)
    with pytest.raises(ValueError, match="takes \\(w0, force\\)"):
        artifact(w0)


def test_serving_refuses_a_viscosity():
    _, _, pr, ps = _pair(dict(append_force=True, append_mu=True), _contextual_batch())
    with pytest.raises(ValueError, match="append_mu"):
        make_rollout_fn(pr, ps, 2)


# --- the commands on registry names ------------------------------------------------------
@pytest.fixture(scope="module")
def vis_force_path(tmp_path_factory):
    """A tiny torus_vis_force file from the port's generator: a random force
    varying in time, mu in [1e-5, 1e-4], 2 trajectories a split, 20 records."""
    path = str(tmp_path_factory.mktemp("vis") / "vis_force.h5")
    navier_stokes(path, n_train=2, n_valid=2, n_test=2, s=GRID, t=0.2, steps=20, delta=1e-3,
                  mu_min=1e-5, mu_max=1e-4, force="random", varying_force=True, device="cpu")
    return path


def _shrunk(path):
    return [f"builder.data_path={path}", "builder.ssr=1", "builder.k=2", "builder.batch_size=4",
            "routine.conv.n_layers=2", "routine.conv.width=8", "routine.conv.modes=4",
            "trainer.max_epochs=2", "trainer.limit_train_batches=3"]


def test_train_then_test_on_registry_name(vis_force_path, tmp_path, monkeypatch):
    """``torus_vis_force/01_baseline`` at 2 layers: ``train`` writes under
    the name's own run directory, and ``test`` finds that checkpoint."""
    monkeypatch.chdir(tmp_path)
    name, overrides = "torus_vis_force/01_baseline", _shrunk(vis_force_path)
    trainer, state = train.main(name, overrides, device="cpu")
    assert trainer.global_step == 3 and state.model.in_proj.in_features == 5
    runs = list((tmp_path / name / "checkpoints").glob("trial-0-*/last.ckpt"))
    assert len(runs) == 1
    logs = test_command.main(name, overrides=overrides, device="cpu")
    assert np.isfinite(logs["test_loss"]) and logs["test_correlations"].shape == (9,)
    assert logs["test_loss"] == pytest.approx(trainer.logs["test_loss"], rel=1e-6)


def test_inference_commands_pass_force_and_viscosity(vis_force_path, tmp_path, capsys):
    """``infer`` (padding a varying force with the data), ``predict`` and
    ``sample`` on ``torus_vis_force/01_baseline``, and ``export`` of
    ``torus_vis/02_no_mu`` (a force, no viscosity) whose artifact takes the
    force, all from a freshly initialised state."""
    name, overrides = "torus_vis_force/01_baseline", _shrunk(vis_force_path)
    run = infer.main(name, overrides=overrides, n_steps=12, device="cpu")
    assert run.result["shape"] == (2, GRID, GRID, 12)
    assert run.batch["f"].shape == (2, GRID, GRID, 13) and run.batch["mu"].shape == (2,)
    assert predict.main(name, overrides=overrides, device="cpu") > 0
    with open(sample.main(name, overrides=overrides, out_path=str(tmp_path / "s.pkl"),
                          device="cpu"), "rb") as f:
        batch, preds = pickle.load(f)
    assert preds.shape == (2, GRID, GRID, 9) and batch["f"].shape == (2, GRID, GRID, 10)
    path = export.main("torus_vis/02_no_mu", str(tmp_path / "a.pt2"), overrides=overrides,
                       n_steps=2, size=GRID, device="cpu")
    artifact = load_exported(path)
    assert artifact.takes_force
    assert artifact(torch.zeros(1, GRID, GRID, 1), torch.ones(1, GRID, GRID)).shape == (
        1, GRID, GRID, 2)
    with pytest.raises(ValueError, match="append_mu"):
        export.main(name, str(tmp_path / "b.pt2"), overrides=overrides, n_steps=2, size=GRID,
                    device="cpu")
