"""The port's FNO-4 baseline (torus_li/zongyi) against the JAX package's,
on the CPU.

Every learning-rate schedule, the full 2D spectral convolution (forward
and gradients), ``FNOZongyi2DBlock``, ``Grid2DRolloutRoutine``'s loss and
every gradient through the 10-step unroll (linspace and Fourier
positions, teacher forcing) and its validation metrics, all with the
weights carried across by ``zongyi_state_dict_from_flax``;
``NSZongyiBuilder``'s arrays; and the port's ``train`` on the zongyi
config, shrunk, for two epochs.
"""

import json
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu import schedulers as jax_schedulers
from fourierflow_tpu.builders import NSZongyiBuilder as JaxBuilder
from fourierflow_tpu.models import FNOZongyi2DBlock as JaxBlock
from fourierflow_tpu.ops.spectral import spectral_conv_2d_full as jax_spectral_conv_2d_full
from fourierflow_tpu.routines import Grid2DRolloutRoutine as JaxRoutine
from fourierflow_tpu_torch import schedulers
from fourierflow_tpu_torch.builders import NSZongyiBuilder
from fourierflow_tpu_torch.commands import train
from fourierflow_tpu_torch.config import load_config
from fourierflow_tpu_torch.models import FNOZongyi2DBlock
from fourierflow_tpu_torch.ops.spectral import spectral_conv_2d_full
from fourierflow_tpu_torch.routines import Grid2DRolloutRoutine
from fourierflow_tpu_torch.utils.hdf5 import H5Writer
from fourierflow_tpu_torch.utils.weights import zongyi_state_dict_from_flax

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs/torus_li/zongyi/4_layers.yaml")
MODEL = dict(modes1=4, modes2=4, width=8, n_layers=2)
TOL = 1e-5  # forward: max |port - JAX| / max |JAX|, float32
GRAD_TOL = 1e-4  # gradients: max |port - JAX| / max |JAX| per tensor, float32


def _close_to_max(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


def _named(tree):
    return {k: v.numpy() for k, v in
            zongyi_state_dict_from_flax(jax.tree.map(np.asarray, tree)).items()}


# --- schedules -----------------------------------------------------------------------
SCHEDULES = {
    "cosine_with_warmup": dict(lr=0.0025, num_warmup_steps=50, num_training_steps=1000),
    "linear_with_warmup": dict(lr=0.0025, num_warmup_steps=50, num_training_steps=1000),
    "exponential_with_warmup": dict(lr=0.0025, num_warmup_steps=50, decay_rate=0.5,
                                    decay_steps=100),
    "step_lr": dict(lr=0.0025, step_size=100, gamma=0.5),
    "step_lr, interval epoch": dict(lr=0.0025, step_size=3, gamma=0.5, steps_per_epoch=50),
    "swa_lr": dict(lr=0.0025, swa_lr=0.0005, swa_step_start=300, anneal_steps=200),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    """Over a range of steps, to 1e-6 relative; 1e-9 absolute (4e-7 of lr)
    where a decay ends near 0, as the JAX schedule computes in float32."""
    fn = name.split(",")[0]
    steps = [0, 1, 49, 50, 51, 99, 100, 101, 149, 150, 299, 300, 301, 400, 500, 999, 1000, 1500]
    want = [float(getattr(jax_schedulers, fn)(**SCHEDULES[name])(s)) for s in steps]
    got = [getattr(schedulers, fn)(**SCHEDULES[name])(s) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_interval_epoch_gives_the_schedule_steps_per_epoch():
    """The zongyi config's step_lr node says ``interval: epoch``: the
    schedule counts epochs of the builder's batches."""
    cfg = load_config(CONFIG, ["routine.scheduler.scheduler.step_size=2"])
    routine = train.build_routine(cfg["routine"], SimpleNamespace(batches_per_epoch=7))
    schedule = routine.optimizer.schedule
    assert [schedule(s) for s in (0, 13, 14, 27, 28)] == [
        0.0025, 0.0025, 0.00125, 0.00125, 0.000625]
    no_builder = train.build_routine(cfg["routine"]).optimizer.schedule
    assert no_builder(2) == 0.00125


# --- the spectral convolution -----------------------------------------------------------
@pytest.mark.parametrize("sx,sy,m1,m2", [(16, 16, 5, 3), (15, 15, 4, 6), (16, 12, 8, 4),
                                         (12, 12, 7, 5)])
def test_spectral_conv_2d_full_matches_jax(sx, sy, m1, m2):
    """Forward and the gradients of x and both weights (even, odd and
    non-square grids, m1 != m2; 12 x 12 with m1 7 makes the corners
    overlap), to TOL and GRAD_TOL of the largest value."""
    rng = np.random.RandomState(sx + m1)
    x = rng.randn(2, sx, sy, 6).astype(np.float32)
    w1, w2 = (rng.randn(6, 5, m1, m2, 2).astype(np.float32) * 0.1 for _ in range(2))
    ct = rng.randn(2, sx, sy, 5).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jax_spectral_conv_2d_full(*a, norm="ortho"), x, w1, w2)
    want_grads = vjp(jnp.asarray(ct))
    ins = [torch.tensor(a, requires_grad=True) for a in (x, w1, w2)]
    got = spectral_conv_2d_full(*ins, norm="ortho")
    _close_to_max(got.detach().numpy(), want, TOL, "out")
    grads = torch.autograd.grad(got, ins, torch.from_numpy(ct))
    for what, g, w in zip(("dx", "dw1", "dw2"), grads, want_grads):
        _close_to_max(g.numpy(), w, GRAD_TOL, what)


# --- the model -------------------------------------------------------------------------
@pytest.mark.parametrize("residual", [False, True])
def test_fno_zongyi_2d_block_matches_jax(residual):
    x = np.random.RandomState(0).randn(2, 16, 16, 12).astype(np.float32)
    jm = JaxBlock(**MODEL, residual=residual)
    params = jm.init(jax.random.PRNGKey(0), x)
    want = np.asarray(jm.apply(params, x)["forecast"])
    pm = FNOZongyi2DBlock(**MODEL, residual=residual)
    pm.load_state_dict(zongyi_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    got = pm(torch.from_numpy(x))["forecast"].detach().numpy()
    _close_to_max(got, want, TOL, "forecast")
    assert sum(p.numel() for p in pm.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))


def test_fno_zongyi_2d_block_full_width_and_remat():
    """The config's widths: 926,357 parameters, as the reference counts; the
    remat model matches the JAX remat model in forward and gradients."""
    pm = FNOZongyi2DBlock(modes1=12, modes2=12, width=20, n_layers=4)
    assert sum(p.numel() for p in pm.parameters()) == 926_357
    x = np.random.RandomState(0).randn(2, 16, 16, 12).astype(np.float32)
    jm = JaxBlock(**MODEL, remat=True)
    params = jm.init(jax.random.PRNGKey(0), x)
    want = np.asarray(jm.apply(params, x)["forecast"])
    ct = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    want_grads = _named(jax.grad(lambda p: jnp.sum(jm.apply(p, x)["forecast"] * ct))(params))
    pm = FNOZongyi2DBlock(**MODEL, remat=True)
    pm.load_state_dict(zongyi_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    got = pm(torch.from_numpy(x))["forecast"]
    _close_to_max(got.detach().numpy(), want, TOL, "forecast")
    grads = torch.autograd.grad((got * torch.from_numpy(ct)).sum(), list(pm.parameters()))
    for (name, _), g in zip(pm.named_parameters(), grads, strict=True):
        _close_to_max(g.numpy(), want_grads[name], GRAD_TOL, name)


# --- the routine -----------------------------------------------------------------------
def _trajectories(b=4, n=16, t=20, seed=0):
    rng = np.random.RandomState(seed)
    base, drift = rng.randn(b, n, n, 1), rng.randn(b, n, n, 1)
    return (base + 0.1 * np.arange(t) * drift).astype(np.float32)


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    """A file in the generator's layout (``train/u``), written by the port."""
    data = _trajectories(6)
    path = str(tmp_path_factory.mktemp("data") / "ns.h5")
    with H5Writer(path, {"train/u": (data.shape, np.float32)}) as w:
        w.write("train/u", 0, data)
    return path


ROUTINES = {
    "linspace": dict(),
    "fourier positions": dict(use_fourier_position=True),
    "teacher forcing": dict(teacher_forcing=True),
    "no positions": dict(append_pos=False),
}


def _routines(data_path, kw):
    append_pos = kw.get("append_pos", True)
    jb = JaxBuilder(data_path, 4, 2, batch_size=4, key="train/u", append_pos=append_pos)
    pb = NSZongyiBuilder(data_path, 4, 2, batch_size=4, key="train/u", append_pos=append_pos)
    input_dim = 34 if kw.get("use_fourier_position") else (12 if append_pos else 10)
    jr = JaxRoutine(model=JaxBlock(**MODEL), **kw)
    js = jr.init(jax.random.PRNGKey(1), jb.sample_batch())
    pr = Grid2DRolloutRoutine(model=FNOZongyi2DBlock(**MODEL, input_dim=input_dim), **kw)
    ps = pr.init(0, pb.sample_batch(), "cpu")
    ps.model.load_state_dict(zongyi_state_dict_from_flax(jax.tree.map(np.asarray, js.params)))
    return jb, jr, js, pb, pr, ps


@pytest.mark.parametrize("case", list(ROUTINES))
def test_rollout_loss_and_every_gradient_match_jax(case, data_path):
    """The mean step loss of the 10-step unroll and the gradient of every
    parameter against ``jax.value_and_grad`` of the JAX routine's unroll;
    the full-field loss beside it."""
    jb, jr, js, pb, pr, ps = _routines(data_path, ROUTINES[case])
    batch = pb.sample_batch()
    jbatch = {k: jnp.asarray(v) for k, v in jb.sample_batch().items()}
    for k in batch:
        np.testing.assert_array_equal(batch[k], np.asarray(jbatch[k]))

    def loss_fn(params):
        loss, loss_full, *_ = jr._unroll(params, jbatch["x"], jbatch["y"], training=True)
        return loss, loss_full

    (want_loss, want_full), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(js.params)
    loss, grads, loss_full = pr.loss_and_grads(ps, batch)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(loss_full) == pytest.approx(float(want_full), rel=1e-5)
    want_named = _named(want_grads)
    names = [name for name, _ in ps.model.named_parameters()]
    assert len(names) == len(grads) == len(want_named)
    for name, g in zip(names, grads):
        _close_to_max(g.numpy(), want_named[name], GRAD_TOL, name)


@pytest.mark.parametrize("case", ["linspace", "fourier positions"])
def test_valid_step_matches_jax(case, data_path):
    jb, jr, js, pb, pr, ps = _routines(data_path, ROUTINES[case])
    batch = next(pb.val_batches())
    want = jr.valid_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
    got = pr.valid_step(ps, batch)
    assert set(got) == set(want)
    for k in ("loss_avg", "loss", "corr", "correlations", "step_losses"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["time_until"]) == float(want["time_until"])


def test_train_step_matches_jax_two_steps(data_path):
    """Two AdamW steps from the same weights: losses and parameters (2e-5
    absolute, as in the flagship's train-step test)."""
    from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
    from fourierflow_tpu_torch.routines.base import make_optimizer

    jb = JaxBuilder(data_path, 4, 2, batch_size=2, key="train/u")
    pb = NSZongyiBuilder(data_path, 4, 2, batch_size=2, key="train/u")
    jr = JaxRoutine(model=JaxBlock(**MODEL), optimizer=jax_make_optimizer(lr=1e-3,
                                                                         weight_decay=1e-4))
    pr = Grid2DRolloutRoutine(model=FNOZongyi2DBlock(**MODEL),
                              optimizer=make_optimizer(lr=1e-3, weight_decay=1e-4))
    js = jr.init(jax.random.PRNGKey(2), jb.sample_batch())
    ps = pr.init(0, pb.sample_batch(), "cpu")
    ps.model.load_state_dict(zongyi_state_dict_from_flax(jax.tree.map(np.asarray, js.params)))
    for batch in list(pb.val_batches())[:1] + [pb.sample_batch()]:
        js, jm = jr.train_step(js, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        ps, pm = pr.train_step(ps, batch)
        assert float(pm["train_loss"]) == pytest.approx(float(jm["train_loss"]), rel=1e-5)
        assert float(pm["train_loss_full"]) == pytest.approx(float(jm["train_loss_full"]),
                                                              rel=1e-5)
    want = _named(js.params)
    for name, p in ps.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name], rtol=0, atol=2e-5, err_msg=name)


# --- the builder ------------------------------------------------------------------------
@pytest.mark.parametrize("ssr,append_pos", [(1, True), (2, False)])
def test_ns_zongyi_builder_matches_jax(data_path, ssr, append_pos):
    kw = dict(train_size=4, test_size=2, ssr=ssr, batch_size=3, key="train/u",
              append_pos=append_pos)
    jb, pb = JaxBuilder(data_path, **kw), NSZongyiBuilder(data_path, **kw)
    for split in ("train_data", "valid_data", "test_data"):
        want, got = getattr(jb, split), getattr(pb, split)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(pb.inference_data()["data"], jb.inference_data()["data"])
    assert pb.batches_per_epoch == 2


# --- the train command ------------------------------------------------------------------
def test_train_command_on_the_zongyi_config(data_path, tmp_path):
    """The config shrunk (width 8, 4 modes, 2 layers), its targets mapped
    onto the port, for 2 epochs of 2 steps on the CPU, then the test pass;
    step_size 1 so that the epoch schedule halves the rate each epoch."""
    overrides = [f"builder.data_path={data_path}", "builder.key=train/u",
                 "builder.train_size=4", "builder.test_size=2", "builder.batch_size=2",
                 "routine.conv.width=8", "routine.conv.modes1=4", "routine.conv.modes2=4",
                 "routine.conv.n_layers=2", "routine.scheduler.scheduler.step_size=1",
                 "trainer.max_epochs=2"]
    trainer, state = train.main(CONFIG, overrides, config_dir=str(tmp_path), device="cpu")
    assert isinstance(state.model, FNOZongyi2DBlock)
    assert trainer.global_step == state.step == 4
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.0025 * 0.25)
    (run_dir,) = (tmp_path / "checkpoints").iterdir()
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["test_loss"] > 0 and np.isfinite(rows[-2]["train_loss_full"])
    assert len(rows[-1]["test_correlations"]) == 10
