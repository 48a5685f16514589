"""The rest of the port's ``train`` and trainer, on the CPU: the
existing-results guard, ``resume``, ``checkpoint_path``, ``pretrained_path``
(the port's checkpoint and a reference Lightning ``.ckpt``), ``profile_dir``
and the CLI's flags; ``utils/profiling.py``; the parallel keys that raise;
and the ``StochasticWeightAveraging`` and ``WandbLogger`` callbacks.

A resumed fit is held to the JAX package's resumed fit on the same file and
config: both restart at epoch 0 with ``global_step`` 0, and a normalizing
routine's epoch 0 adds statistics to the restored ones. Tolerances: the
restored state to the bit; the normalizer's sums against JAX to rtol 1e-5;
SWA's averages against the JAX callback to 1e-6.
"""

import copy
import glob
import json
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from fourierflow_tpu.commands import train as jax_train
from fourierflow_tpu.trainers.callbacks import StochasticWeightAveraging as JaxSWA
from fourierflow_tpu.utils import profiling as jax_profiling
from fourierflow_tpu_torch.commands import train
from fourierflow_tpu_torch.commands.__main__ import main as cli
from fourierflow_tpu_torch.config import instantiate, load_config
from fourierflow_tpu_torch.trainers import (Callback, StochasticWeightAveraging, Trainer,
                                            WandbLogger)
from fourierflow_tpu_torch.utils import profiling
from fourierflow_tpu_torch.utils.checkpoint import (checkpoint_kind, load_inference_state,
                                                    load_state, read_checkpoint, save_state)

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs/torus_li/markov/24_layers.yaml")
SHRINK = ["routine.conv.n_layers=2", "routine.conv.width=8", "routine.conv.modes=4"]
SUM_RTOL = 1e-5  # normalizer sums, port vs JAX
SWA_TOL = 1e-6


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    """8 trajectories of 6 frames on 16 x 16: the 4 train trajectories give
    4 batches of 4 (the batch size divides the train size)."""
    rng = np.random.RandomState(11)
    t = np.arange(6)[None, None, None, :]
    base, drift = rng.randn(8, 16, 16, 1), rng.randn(8, 16, 16, 1)
    path = tmp_path_factory.mktemp("data") / "traj.npy"
    np.save(path, (base + 0.1 * t * drift).astype(np.float32))
    return str(path)


def _overrides(data_path, *extra):
    return [f"builder.data_path={data_path}", "builder.train_size=4", "builder.test_size=4",
            "builder.batch_size=4", *SHRINK, "trainer.max_epochs=2", *extra]


def _run(data_path, tmp_path, *extra, **kw):
    return train.main(CONFIG, _overrides(data_path, *extra), config_dir=str(tmp_path),
                      no_test=True, device="cpu", **kw)


@pytest.fixture
def fit_starts(monkeypatch):
    """Copies of the states each ``Trainer.fit`` starts from."""
    starts = []
    fit = Trainer.fit

    def recording_fit(self, routine, builder, state=None):
        starts.append(copy.deepcopy(state))
        return fit(self, routine, builder, state)

    monkeypatch.setattr(Trainer, "fit", recording_fit)
    return starts


def _assert_state_is_file(state, path, optimizer=True):
    """Weights, normalizer and step of ``state`` equal the checkpoint's to
    the bit; with ``optimizer`` the AdamW moments and schedule too, else no
    moments."""
    blob = torch.load(path, weights_only=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, blob["model"][k]), k
    for f, v in blob["normalizer"].items():
        assert torch.equal(getattr(state.normalizer, f), v), f
    opt = state.optimizer.state_dict()
    if optimizer:
        assert state.step == blob["step"] > 0
        assert opt["state"] and opt["state"].keys() == blob["optimizer"]["state"].keys()
        for i, moments in blob["optimizer"]["state"].items():
            for name, v in moments.items():
                assert torch.equal(opt["state"][i][name], v), (i, name)
        assert state.scheduler.state_dict() == blob["scheduler"]
    else:
        assert not opt["state"] and state.step == 0


# --- the existing-results guard and resume ------------------------------------------------
@pytest.mark.parametrize("how", ["force", "resume", "checkpoint_path"])
def test_existing_results_need_force_resume_or_a_checkpoint(data_path, tmp_path, how):
    _run(data_path, tmp_path, "trainer.max_epochs=1")
    with pytest.raises(train.ExistingExperimentFound, match="--resume"):
        _run(data_path, tmp_path, "trainer.max_epochs=1")
    (last,) = glob.glob(str(tmp_path / "checkpoints/trial-0-*/last.ckpt"))
    value = last if how == "checkpoint_path" else True
    _run(data_path, tmp_path, "trainer.max_epochs=1", **{how: value})
    assert len(glob.glob(str(tmp_path / "checkpoints/trial-0-*"))) == 2
    # Another trial has no results yet.
    _run(data_path, tmp_path, "trainer.max_epochs=1", trial=1)


def test_resume_starts_from_the_newest_last_ckpt_to_the_bit(data_path, tmp_path, fit_starts):
    _, first = _run(data_path, tmp_path)
    _, second = _run(data_path, tmp_path, "trainer.max_epochs=3", force=True)
    dirs = sorted(glob.glob(str(tmp_path / "checkpoints/trial-0-*")))
    assert len(dirs) == 2 and first.step == 4 and second.step == 8
    trainer, resumed = _run(data_path, tmp_path, resume=True)
    start = fit_starts[-1]
    _assert_state_is_file(start, os.path.join(dirs[-1], "last.ckpt"))
    assert start.step == 8
    # The reference's restart: epoch 0 again, the trainer's step from 0.
    assert trainer.global_step == 4 and trainer.current_epoch == 1 and resumed.step == 12
    assert len(glob.glob(str(tmp_path / "checkpoints/trial-0-*"))) == 3


def test_checkpoint_path_restores_the_whole_state(data_path, tmp_path, fit_starts):
    _run(data_path, tmp_path / "a")
    (last,) = glob.glob(str(tmp_path / "a/checkpoints/trial-0-*/last.ckpt"))
    cli(["train", CONFIG, *_overrides(data_path), "--device", "cpu", "--no-test",
         "--config-dir", str(tmp_path / "b"), "--checkpoint-path", last])
    _assert_state_is_file(fit_starts[-1], last)


def test_resumed_fit_counts_match_jax(data_path, tmp_path):
    """After train then resume (2 epochs each), the JAX package's and the
    port's trainers agree on global_step, the epoch, and the normalizer's
    count and n_accumulations; the sums within rtol 1e-5."""
    overrides = _overrides(data_path)
    jax_train.main(CONFIG, overrides, no_test=True, config_dir=str(tmp_path / "jax"))
    jt, js = jax_train.main(CONFIG, overrides, no_test=True, resume=True,
                            config_dir=str(tmp_path / "jax"))
    _run(data_path, tmp_path / "port")
    pt, ps = _run(data_path, tmp_path / "port", resume=True)
    assert pt.global_step == jt.global_step == 4
    assert pt.current_epoch == jt.current_epoch == 1 and pt.logs["epoch"] == jt.logs["epoch"]
    assert ps.step == int(js.step) == 8
    for f in ("count", "n_accumulations"):
        assert float(getattr(ps.normalizer, f)) == float(getattr(js.normalizer, f)), f
    for f in ("sum", "sum_squared"):
        np.testing.assert_allclose(getattr(ps.normalizer, f).numpy(),
                                   np.asarray(getattr(js.normalizer, f)), rtol=SUM_RTOL,
                                   err_msg=f)


# --- pretrained_path -------------------------------------------------------------------------
def _lightning_ckpt(port_ckpt, path):
    """A reference Lightning checkpoint of the same weights: ``conv.``-prefixed
    names, the normalizer's buffers, and metadata the weights-only unpickler
    refuses."""
    blob = torch.load(port_ckpt, weights_only=True)
    sd = {f"conv.{k}": v for k, v in blob["model"].items()}
    for f in ("sum", "sum_squared", "count"):
        sd[f"normalizer.{f}"] = blob["normalizer"][f]
    torch.save({"state_dict": sd, "epoch": 3, "callbacks": {"opaque": _Opaque()}}, path)
    return str(path)


class _Opaque:
    """Stands for the pickled objects of a Lightning checkpoint."""


@pytest.mark.parametrize("kind", ["port", "lightning"])
def test_pretrained_path_loads_weights_only(data_path, tmp_path, fit_starts, monkeypatch, kind):
    _run(data_path, tmp_path / "a")
    (last,) = glob.glob(str(tmp_path / "a/checkpoints/trial-0-*/last.ckpt"))
    path = last if kind == "port" else _lightning_ckpt(last, tmp_path / "ref.ckpt")
    monkeypatch.setenv("PRETRAINED_DIR", os.path.dirname(path))
    pre = f"pretrained_path=$PRETRAINED_DIR/{os.path.basename(path)}"
    _run(data_path, tmp_path / "b", "trainer.max_epochs=1", pre)
    start = fit_starts[-1]
    blob = torch.load(last, weights_only=True)
    for k, v in start.model.state_dict().items():
        assert torch.equal(v, blob["model"][k]), k
    assert not start.optimizer.state_dict()["state"] and start.step == 0
    assert start.scheduler is None or start.scheduler.state_dict()["last_epoch"] == 0
    norm = start.normalizer
    assert torch.equal(norm.sum, blob["normalizer"]["sum"])
    assert float(norm.count) == float(blob["normalizer"]["count"]) > 0


def test_pretrained_path_missing_raises(data_path, tmp_path):
    with pytest.raises(FileNotFoundError, match="pretrained_path"):
        _run(data_path, tmp_path, f"pretrained_path={tmp_path}/none.ckpt")


def test_checkpoint_kind_tells_the_port_from_lightning(data_path, tmp_path):
    """Both are torch.save zip files starting with ``PK``: the contents
    decide. The port's loaders refuse a Lightning file, and anything else
    raises."""
    _run(data_path, tmp_path / "a", "trainer.max_epochs=1")
    (last,) = glob.glob(str(tmp_path / "a/checkpoints/trial-0-*/last.ckpt"))
    ref = _lightning_ckpt(last, tmp_path / "ref.ckpt")
    for path in (last, ref):
        with open(path, "rb") as f:
            assert f.read(2) == b"PK"
    assert checkpoint_kind(read_checkpoint(last)) == "port"
    assert checkpoint_kind(read_checkpoint(ref)) == "lightning"
    torch.save({"weights": torch.zeros(2)}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="neither"):
        checkpoint_kind(read_checkpoint(str(tmp_path / "other.pt")))
    _, state = _run(data_path, tmp_path / "b", "trainer.max_epochs=1")
    for load in (load_state, load_inference_state):
        with pytest.raises(ValueError, match="Lightning"):
            load(ref, state)


def test_load_inference_state_keeps_the_optimizer(data_path, tmp_path):
    _, trained = _run(data_path, tmp_path / "a")
    path = str(tmp_path / "state.ckpt")
    save_state(path, trained)
    _, fresh = _run(data_path, tmp_path / "b", "trainer.max_epochs=1")
    opt = copy.deepcopy(fresh.optimizer.state_dict())
    loaded = load_inference_state(path, fresh)
    assert loaded.step == trained.step and loaded.optimizer.state_dict() == opt
    for k, v in trained.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v), k


# --- profiling ---------------------------------------------------------------------------------
def test_profile_dir_writes_a_trace_on_the_cpu(data_path, tmp_path):
    cli(["train", CONFIG, *_overrides(data_path, "trainer.limit_train_batches=1"), "--device",
         "cpu", "--no-test", "--config-dir", str(tmp_path / "run"), "--profile-dir",
         str(tmp_path / "trace")])
    (path,) = glob.glob(str(tmp_path / "trace/trace-*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("fused_ff" in str(e.get("name", "")) for e in events)


def test_trace_disabled_writes_nothing(tmp_path):
    with profiling.trace(str(tmp_path / "t"), enabled=False) as prof:
        torch.ones(3).sum()
    assert prof is None and not (tmp_path / "t").exists()


def test_step_timer_matches_jax(monkeypatch):
    """The same marks at the same (monkeypatched) clock readings give the
    same EMA rates."""
    ticks = np.cumsum([0.0, 0.5, 0.25, 1.0, 0.125, 0.3]).tolist()
    rates = []
    for timer in (profiling.StepTimer(ema=0.8), jax_profiling.StepTimer(ema=0.8)):
        clock = iter(ticks)
        monkeypatch.setattr(sys.modules[type(timer).__module__].time, "perf_counter",
                            lambda clock=clock: next(clock))
        rates.append([timer.mark(n) for n in (1, 1, 2, 4, 1, 3)])
    got, want = rates
    assert got[0] is None and want[0] is None
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-12)


# --- the parallel keys -------------------------------------------------------------------------
@pytest.mark.parametrize("key", ["tensor_parallel", "spatial_parallel"])
def test_parallel_trainer_keys_raise(key):
    """A mesh of 2 in one process raises, as the JAX package's mesh does on
    one device (a world of 4 builds it: tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match=f"{key}=2 needs at least that many devices; have 1"):
        train.build_trainer({key: 2}, device="cpu")
    assert isinstance(train.build_trainer({key: 1, "data_parallel": True}, device="cpu"),
                      Trainer)


# --- SWA and W&B ----------------------------------------------------------------------------------
class _Progress:
    """The Trainer's counters that the callbacks read."""

    def __init__(self, max_epochs):
        self.max_epochs, self.global_step, self.current_epoch, self.logs = max_epochs, 0, 0, {}


class _Model(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(rng.randn(3, 4).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.from_numpy(rng.randn(5).astype(np.float32)))


class _PortState:
    def __init__(self, model):
        self.model = model


class _JaxState:
    def __init__(self, params):
        self.params = params

    def replace(self, params):
        return _JaxState(params)


@pytest.mark.parametrize("start,total", [(0.5, None), (0.5, 40), (0.25, None), (12, None),
                                         (0, None)])
def test_swa_matches_the_jax_callback(start, total):
    """Five epochs of 8 steps with new weights at each epoch's end: the same
    start step, epochs averaged and averaged weights as the JAX callback."""
    rng = np.random.RandomState(3)
    model = _Model(rng)
    port, ref = StochasticWeightAveraging(start, total), JaxSWA(start, total)
    progress = _Progress(max_epochs=5)
    for epoch in range(5):
        progress.current_epoch, progress.global_step = epoch, 8 * (epoch + 1)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
        params = {k: jax.numpy.asarray(v.detach().numpy().copy())  # a copy: a view of p changes with it
                  for k, v in model.named_parameters()}
        assert port._start_step(progress) == ref._start_step(progress)
        port.on_epoch_end(progress, None, _PortState(model))
        ref.on_epoch_end(progress, None, _JaxState(params))
    assert port.n_averaged == ref.n_averaged > 0
    state = port.on_fit_end(progress, None, _PortState(model))
    want = ref.on_fit_end(progress, None, _JaxState(None)).params
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=SWA_TOL, err_msg=k)


def test_swa_in_a_fit_averages_the_epoch_end_weights(data_path, tmp_path):
    """Through the trainer: the final weights are the mean of the weights at
    each epoch's end (the normalizer epoch's included: start step 0)."""
    recorded = []

    class Record(Callback):
        def on_epoch_end(self, trainer, routine, state):
            recorded.append({k: v.detach().clone() for k, v in state.model.named_parameters()})

    cfg = load_config(CONFIG, _overrides(data_path, "trainer.max_epochs=3"))
    builder = instantiate(cfg["builder"])
    routine = train.build_routine(cfg["routine"], builder)
    trainer = Trainer(max_epochs=3, callbacks=[Record(), StochasticWeightAveraging(0)],
                      device="cpu")
    state = trainer.fit(routine, builder)
    assert len(recorded) == 3
    for k, p in state.model.named_parameters():
        want = (recorded[0][k] + recorded[1][k]) / 2
        want = (want * 2 + recorded[2][k]) / 3
        assert torch.equal(p.detach(), want), k


def test_wandb_logger_without_wandb_warns_and_logs_nothing(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    with caplog.at_level("WARNING"):
        logger = WandbLogger(project="p")
    assert "wandb unavailable" in caplog.text and logger._run is None
    progress = _Progress(1)
    progress.logs = {"train_loss": 0.5}
    assert logger.on_epoch_end(progress, None, None) is None
    assert logger.on_test_end(progress, None, None) is None
