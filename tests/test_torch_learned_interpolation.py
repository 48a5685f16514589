"""The port's learned-interpolation slice (``models/learned_interpolation.py``,
``routines/learned_interpolator.py``, the Kolmogorov velocity datasets and
``learned_interpolation_state_dict_from_flax``) against the JAX package's,
on the CPU, at 32^2 with 8 features, 2 CNN layers and an unroll of 2, the
out layer randomised (it starts at zero), the weights carried across by the
converter.

Tolerances (max |err| <= tol max |JAX|):
- ``PeriodicCNN`` forward and its input and weight gradients: 1e-5.
- ``pressure_projection``: 1e-5; ``LearnedInterpolationStep`` forward and
  its weight gradients: 1e-5.
- ``LearnedInterpolatorRoutine``'s train step (AdamW, weight decay 1e-4):
  the loss, every gradient and every parameter after the step 1e-5; ``valid_step`` at 32^2 and at
  64^2 (downsampled to 32^2 first): every log within 1e-4.
- The velocity datasets: JAX's samples on the same files, to the bit; the
  validation targets at frame ``i s k - 1``.
- ``train`` and ``test`` by registry name on tiny files; the convolutions
  run with TF32 off in the forward and the backward whatever the global
  flag says.
"""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu.builders import kolmogorov as jax_kol
from fourierflow_tpu.models import learned_interpolation as jax_li
from fourierflow_tpu.routines import LearnedInterpolatorRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu.utils import grids as jax_grids
from fourierflow_tpu_torch.builders import kolmogorov as kol
from fourierflow_tpu_torch.commands import test as test_command
from fourierflow_tpu_torch.commands import train
from fourierflow_tpu_torch.models import learned_interpolation as li
from fourierflow_tpu_torch.routines import LearnedInterpolatorRoutine
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.utils.weights import learned_interpolation_state_dict_from_flax

TWO_PI = 2 * np.pi
DT = 0.014024967203525862  # the registry's x32 model step
SMALL = dict(features=8, n_cnn_layers=2)


def _np(a):
    return np.asarray(a.detach()) if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_rel(got, want, tol, what=""):
    """max |got - want| <= tol max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got.astype(np.float64) - want)) if want.size else 0.0
    scale = max(np.max(np.abs(want)), 1e-30) if want.size else 1.0
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol:g} x {scale:.3e}"


def _velocity(n, batch=2, seed=0):
    """Smooth divergence-free staggered velocities ``[batch, n, n]`` (max
    speed 7, the Kolmogorov flows')."""
    grid = jax_grids.Grid((n, n), domain=((0, TWO_PI), (0, TWO_PI)))
    fields = [jax_kol.filtered_velocity_field(k, grid, 7.0, 4.0)
              for k in jax.random.split(jax.random.PRNGKey(seed), batch)]
    return tuple(np.stack([np.asarray(f[i]) for f in fields]) for i in range(2))


def _randomised(params, seed=8, scale=0.05):
    """``params`` with the CNN's out kernel and bias drawn from a normal."""
    params = jax.tree.map(np.asarray, params)
    out = params["params"]["coeff_net"]["out"]
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    out["kernel"] = np.asarray(scale * jax.random.normal(k1, out["kernel"].shape))
    out["bias"] = np.asarray(scale * jax.random.normal(k2, out["bias"].shape))
    return params


def _grads_by_name(model, grads):
    return dict(zip([n for n, _ in model.named_parameters()], grads))


def _flat_flax_grads(grads):
    """Flax gradients in the port's parameter names (through the converter)."""
    return learned_interpolation_state_dict_from_flax(jax.tree.map(np.asarray, grads))


# --- the model ------------------------------------------------------------------------
def test_periodic_cnn_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 2).astype(np.float32)
    cot = rng.randn(2, 32, 32, 16).astype(np.float32)
    jnet = jax_li.PeriodicCNN(features=8, n_layers=2, out_channels=16)
    params = {"params": jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(1), x[0])["params"])}
    params["params"]["out"]["kernel"] = 0.05 * rng.randn(*params["params"]["out"]["kernel"].shape)

    def jloss(p, xx):
        return (jax.vmap(lambda a: jnet.apply(p, a))(xx) * cot).sum()

    want, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    want_out = jax.vmap(lambda a: jnet.apply(params, a))(jnp.asarray(x))

    net = li.PeriodicCNN(features=8, n_layers=2, out_channels=16)
    sd = learned_interpolation_state_dict_from_flax({"coeff_net": params["params"]})
    net.load_state_dict({k.removeprefix("coeff_net."): v for k, v in sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = net(xt).permute(0, 2, 3, 1)
    assert_rel(out, want_out, 1e-5, "forward")
    loss = (out * torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, [xt, *net.parameters()])
    assert_rel(grads[0].permute(0, 2, 3, 1), jgx, 1e-5, "dx")
    want_g = {k.removeprefix("coeff_net."): v
              for k, v in _flat_flax_grads({"coeff_net": jgp["params"]}).items()}
    for name, g in zip([n for n, _ in net.named_parameters()], grads[1:]):
        assert_rel(g, want_g[name], 1e-5, name)


def test_pressure_projection_matches_jax():
    rng = np.random.RandomState(1)
    u, v = (rng.randn(3, 32, 32).astype(np.float32) for _ in range(2))
    h = TWO_PI / 32
    got = li.pressure_projection(torch.from_numpy(u), torch.from_numpy(v), h)
    want = jax_li.pressure_projection(jnp.asarray(u), jnp.asarray(v), h)
    for a, b in zip(got, want):
        assert_rel(a, b, 1e-5)
    div = (_np(got[0]) - np.roll(_np(got[0]), 1, -2)) / h + (
        _np(got[1]) - np.roll(_np(got[1]), 1, -1)) / h
    assert np.abs(div).max() < 1e-4 * np.abs(u).max() / h


@pytest.fixture(scope="module")
def step_pair():
    """JAX's and the port's step at 32^2 with the same randomised weights."""
    u, v = _velocity(32, seed=3)
    jstep = jax_li.LearnedInterpolationStep(size=32, dt=DT, **SMALL)
    params = _randomised(jstep.init(jax.random.PRNGKey(0), u[0], v[0]))
    step = li.LearnedInterpolationStep(size=32, dt=DT, **SMALL)
    step.load_state_dict(learned_interpolation_state_dict_from_flax(params))
    return jstep, params, step, u, v


def test_learned_interpolation_step_matches_jax(step_pair):
    jstep, params, step, u, v = step_pair
    rng = np.random.RandomState(2)
    cu, cv = (rng.randn(*u.shape).astype(np.float32) for _ in range(2))

    def jloss(p):
        a, b = jax.vmap(lambda x, y: jstep.apply(p, x, y))(jnp.asarray(u), jnp.asarray(v))
        return (a * cu).sum() + (b * cv).sum(), (a, b)

    (_, (ju, jv)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    pu, pv = step(torch.from_numpy(u), torch.from_numpy(v))
    assert_rel(pu, ju, 1e-5, "u")
    assert_rel(pv, jv, 1e-5, "v")
    assert np.abs(_np(pu) - u).max() > 0
    loss = (pu * torch.from_numpy(cu)).sum() + (pv * torch.from_numpy(cv)).sum()
    grads = _grads_by_name(step, torch.autograd.grad(loss, list(step.parameters())))
    want = _flat_flax_grads(jg)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        assert_rel(g, want[name], 1e-5, name)


def test_convolutions_run_without_tf32(monkeypatch):
    """Whatever ``torch.backends.cudnn.allow_tf32`` says, the CNN's
    convolutions see it off, forward and backward, and the flag is put
    back."""
    seen = []
    conv2d, conv_bwd = torch.nn.functional.conv2d, torch.ops.aten.convolution_backward

    def spy(fn):
        def wrapped(*args, **kwargs):
            seen.append(torch.backends.cudnn.allow_tf32)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy(conv2d))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", spy(conv_bwd))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    net = li.PeriodicCNN(features=4, n_layers=2)
    x = torch.randn(1, 2, 8, 8, requires_grad=True)
    net(x).sum().backward()
    assert seen == [False] * 4 and torch.backends.cudnn.allow_tf32


def test_convolutions_run_deterministic(monkeypatch):
    """Whatever ``cudnn.deterministic`` and ``cudnn.benchmark`` say, the
    CNN's convolutions see cuDNN's deterministic algorithms without
    benchmarking, forward and backward, and both flags are put back."""
    seen = []
    conv2d, conv_bwd = torch.nn.functional.conv2d, torch.ops.aten.convolution_backward
    cudnn = torch.backends.cudnn

    def spy(fn):
        def wrapped(*args, **kwargs):
            seen.append((cudnn.deterministic, cudnn.benchmark))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy(conv2d))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", spy(conv_bwd))
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    net = li.PeriodicCNN(features=4, n_layers=2)
    x = torch.randn(1, 2, 8, 8, requires_grad=True)
    net(x).sum().backward()
    assert seen == [(True, False)] * 4
    assert not cudnn.deterministic and cudnn.benchmark


# --- the routine ------------------------------------------------------------------------
def _routines(size, lr=1e-3, weight_decay=1e-4, inner=2, outer=3):
    kw = dict(size=size, dt=DT * 32 / size, unroll_length=2, inner_steps=inner,
              outer_steps=outer, **SMALL)
    jr = JaxRoutine(optimizer=jax_make_optimizer(lr=lr, weight_decay=weight_decay), **kw)
    pr = LearnedInterpolatorRoutine(optimizer=make_optimizer(lr=lr, weight_decay=weight_decay),
                                    **kw)
    u, v = _velocity(size, seed=size)
    inputs = {"vx": u, "vy": v}
    js = jr.init(jax.random.PRNGKey(0), (inputs, None))
    js = js.replace(params=jax.tree.map(jnp.asarray, _randomised(js.params)))
    js = js.replace(opt_state=jr.optimizer.init(js.params))
    ps = pr.init(0, (inputs, None), "cpu")
    ps.model.load_state_dict(learned_interpolation_state_dict_from_flax(js.params))
    return jr, js, pr, ps, inputs


def test_train_step_matches_jax():
    jr, js, pr, ps, inputs = _routines(32)
    # The targets: two steps of the same solver with other weights.
    teacher = LearnedInterpolatorRoutine(size=32, dt=DT, unroll_length=2, **SMALL)
    tstate = teacher.init(7, (inputs, None), "cpu")
    with torch.no_grad():
        tstate.model.coeff_net.out.weight.normal_(0.0, 0.05,
                                                  generator=torch.Generator().manual_seed(9))
        u, v = torch.from_numpy(inputs["vx"]), torch.from_numpy(inputs["vy"])
        targets = []
        for _ in range(2):
            u, v = tstate.model(u, v)
            targets.append((u.numpy(), v.numpy()))
    outputs = {"vx": np.stack([t[0] for t in targets], -1),
               "vy": np.stack([t[1] for t in targets], -1)}
    batch = (inputs, outputs)

    want_loss, want_grads = jax.value_and_grad(jr._loss)(js.params, inputs, outputs)
    loss, grads = pr.loss_and_grads(ps, batch)
    assert_rel(loss, want_loss, 1e-5, "loss")
    want_g = _flat_flax_grads(want_grads)
    for name, g in _grads_by_name(ps.model, grads).items():
        assert_rel(g, want_g[name], 1e-5, f"grad {name}")

    js2, jm = jr.train_step(js, jax.tree.map(jnp.asarray, batch))
    ps2, pm = pr.train_step(ps, batch)
    assert_rel(pm["train_loss"], jm["train_loss"], 1e-5, "train_loss")
    want_p = learned_interpolation_state_dict_from_flax(jax.tree.map(np.asarray, js2.params))
    for name, p in ps2.model.named_parameters():
        assert_rel(p, want_p[name], 1e-5, f"param {name}")
    assert ps2.step == 1


@pytest.mark.parametrize("size", [32, 64])
def test_valid_step_matches_jax(size):
    jr, js, pr, ps, inputs = _routines(size, inner=2, outer=3)
    rng = np.random.RandomState(size)
    batch = {"vx": inputs["vx"], "vy": inputs["vy"],
             "targets": rng.randn(2, 32, 32, 3).astype(np.float32),
             "times": np.tile(np.arange(1, 4, dtype=np.float32), (2, 1))}
    # Targets the rollout tracks for a while: the downsampled rollout itself, perturbed.
    with torch.no_grad():
        u, v = torch.from_numpy(inputs["vx"]), torch.from_numpy(inputs["vy"])
        for t in range(3):
            for _ in range(2):
                u, v = ps.model(u, v)
            batch["targets"][..., t] = (pr._vorticity_32(u, v).numpy()
                                        + (0.3 * t) * batch["targets"][..., t])
    want = jax.tree.map(np.asarray, jr.valid_step(js, jax.tree.map(jnp.asarray, batch)))
    got = pr.valid_step(ps, batch)
    assert sorted(got) == sorted(want)
    assert 0 < float(want["reduced_time_until"]) < 3 * pr.step_size + 1e-6
    for k in want:
        assert_rel(got[k], want[k], 1e-4, k)


# --- the datasets ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def velocity_files(tmp_path_factory):
    """A trajectory file (vx, vy [2, 40, 8, 8]), an initial-condition file
    and a 32^2-style corr file whose frame j holds j + 1."""
    d = tmp_path_factory.mktemp("li")
    rng = np.random.RandomState(4)
    with h5py.File(d / "train_8_1.h5", "w") as f:
        f["vx"] = rng.randn(2, 40, 8, 8).astype(np.float32)
        f["vy"] = rng.randn(2, 40, 8, 8).astype(np.float32)
    with h5py.File(d / "init_8.h5", "w") as f:
        f["vx"] = rng.randn(2, 8, 8).astype(np.float32)
        f["vy"] = rng.randn(2, 8, 8).astype(np.float32)
    with h5py.File(d / "corr_32_1.h5", "w") as f:
        f["vorticity"] = np.broadcast_to(np.arange(1, 41, dtype=np.float32)[None, :, None, None],
                                         (2, 40, 4, 4))
        f["time"] = 0.5 * np.arange(1, 41, dtype=np.float32)
    return d


@pytest.mark.parametrize("k,unroll", [(2, 4), (1, 3)])
def test_velocity_dataset_matches_jax(velocity_files, k, unroll):
    path = str(velocity_files / "train_8_1.h5")
    ds = kol.KolmogorovVelocityDataset(path, k=k, unroll_length=unroll)
    jds = jax_kol.KolmogorovVelocityDataset(path, k=k, unroll_length=unroll)
    assert len(ds) == len(jds) == 2 * (40 - k * unroll)
    idx = np.array([0, 5, len(ds) - 1, len(ds) // 2 + 3])
    got, want = ds.sample(idx), jds.sample(idx)
    for a, b in zip(got, want):
        for name in ("vx", "vy"):
            np.testing.assert_array_equal(a[name], b[name])
    assert got[1]["vx"].shape == (4, 8, 8, unroll)


@pytest.mark.parametrize("k,inner,outer,picked", [(2, 4, 3, [8, 16, 24]),
                                                  (1, 1, 5, [1, 2, 3, 4, 5]),
                                                  (1, 16, 100, [16, 32])])
def test_velocity_trajectory_dataset_matches_jax(velocity_files, k, inner, outer, picked):
    kw = dict(init_path=str(velocity_files / "init_8.nc"),
              corr_path=str(velocity_files / "corr_32_1.nc"), k=k, inner_steps=inner,
              outer_steps=outer)
    got = kol.KolmogorovVelocityTrajectoryDataset(**kw).sample(np.array([1, 0]))
    want = jax_kol.KolmogorovVelocityTrajectoryDataset(**kw).sample(np.array([1, 0]))
    assert sorted(got) == sorted(want) == ["targets", "times", "vx", "vy"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(got["targets"][0, 0, 0], picked)
    np.testing.assert_allclose(got["times"][0], 0.5 * np.array(picked))


def test_builder_takes_input_output_tuples(velocity_files):
    path = str(velocity_files / "train_8_1.h5")
    traj = dict(init_path=str(velocity_files / "init_8.h5"),
                corr_path=str(velocity_files / "corr_32_1.h5"), k=2, inner_steps=4, outer_steps=3)
    pb = kol.KolmogorovBuilder(kol.KolmogorovVelocityDataset(path, k=2, unroll_length=4),
                               kol.KolmogorovVelocityTrajectoryDataset(**traj),
                               kol.KolmogorovVelocityTrajectoryDataset(**traj), batch_size=8)
    jb = jax_kol.KolmogorovBuilder(jax_kol.KolmogorovVelocityDataset(path, k=2, unroll_length=4),
                                   jax_kol.KolmogorovVelocityTrajectoryDataset(**traj),
                                   jax_kol.KolmogorovVelocityTrajectoryDataset(**traj),
                                   batch_size=8)
    sample, jsample = pb.sample_batch(), jb.sample_batch()
    assert isinstance(sample, tuple)
    for a, b in zip(sample, jsample):
        for name in ("vx", "vy"):
            np.testing.assert_array_equal(a[name], b[name])
    for a, b in zip(pb.train_batches(np.random.default_rng(3)),
                    jb.train_batches(np.random.default_rng(3))):
        np.testing.assert_array_equal(a[1]["vy"], b[1]["vy"])
    assert pb.batches_per_epoch == jb.batches_per_epoch == 8
    data = pb.inference_data()
    assert data["targets"].shape == (2, 4, 4, 3) and data["vx"].shape == (2, 8, 8)


def test_train_and_test_by_registry_name(tmp_path, monkeypatch):
    """``train`` and ``test`` of ``torus_kochkov/learned_interpolation/rollout/x32``
    shrunk (8 features, 2 layers, an unroll of 2, 3 snapshots of 2 steps) on
    tiny files laid out as the registry names them: two train steps of
    ``(inputs, outputs)`` batches, the validation's reduced metrics, the
    checkpoint monitored on ``valid_reduced_time_until``, the test pass."""
    root = tmp_path / "data" / "kolmogorov" / "re_1000"
    for sub in ("trajectories", "initial_conditions"):
        (root / sub).mkdir(parents=True)
    u, v = _velocity(32, batch=4, seed=1)
    rng = np.random.RandomState(5)
    with h5py.File(root / "trajectories" / "train_32_1.h5", "w") as f:
        f["vx"] = (u[:, None] + 0.01 * rng.randn(4, 20, 32, 32)).astype(np.float32)
        f["vy"] = (v[:, None] + 0.01 * rng.randn(4, 20, 32, 32)).astype(np.float32)
    for split in ("valid", "test"):
        with h5py.File(root / "initial_conditions" / f"{split}_32.h5", "w") as f:
            f["vx"], f["vy"] = u[:2], v[:2]
        with h5py.File(root / "trajectories" / f"{split}_32_1.h5", "w") as f:
            # x32 snapshots every k 4 x 8 frames: frames 31, 63 and 95.
            f["vorticity"] = rng.randn(2, 96, 32, 32).astype(np.float32)
            f["time"] = np.arange(1, 97, dtype=np.float32)
    monkeypatch.setenv("DATA_ROOT", str(tmp_path / "data"))
    name = "torus_kochkov/learned_interpolation/rollout/x32"
    over = ["routine.features=8", "routine.n_cnn_layers=2", "routine.unroll_length=2",
            "routine.inner_steps=2", "builder.train_dataset.unroll_length=2",
            "builder.valid_dataset.outer_steps=3", "builder.test_dataset.outer_steps=3",
            "trainer.max_epochs=1", "trainer.limit_train_batches=2"]
    trainer, state = train.main(name, over, config_dir=str(tmp_path / "run"), device="cpu")
    logs = trainer.logs
    assert trainer.global_step == 2 and np.isfinite(logs["train_loss"])
    for key in ("valid_loss", "valid_rho", "valid_reduced_time_until", "test_loss"):
        assert np.isfinite(logs[key]), key
    assert logs["test_correlations"].shape == (3,) and logs["test_weight"] == 2
    assert os.path.exists(next((tmp_path / "run" / "checkpoints").iterdir()) / "last.ckpt")
    test_logs = test_command.main(name, overrides=over, config_dir=str(tmp_path / "run"),
                                  device="cpu")
    assert_rel(test_logs["test_loss"], logs["test_loss"], 1e-6)
