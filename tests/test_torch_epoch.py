"""The port's device-resident epoch against its per-batch loop and against
the JAX package's Trainer, on the CPU.

- ``make_scan_epoch(_indexed)``: the normalizer epoch and a train epoch
  equal a per-batch loop run by hand over ``epoch_permutation``'s batches
  with the same step generators, to the bit (parameters, AdamW state,
  normalizer, metrics), on flat pairs and on Kolmogorov's virtual items.
- Against ``fourierflow_tpu``'s ``Trainer(fast_loop=True)`` on the same
  ``NSMarkovBuilder`` data (15 pairs, batch 4: the partial batch dropped):
  ``global_step``, the normalizer's count and the logged keys are equal;
  the final train loss within the bound of JAX's own fast-vs-host test
  (the permutations differ).
- Which path ``fit`` takes, over ``fast_loop``, ``limit_train_batches``,
  ``fast_dev_run`` and builders with ``train_data``, with the Kolmogorov
  device protocol and without it (the multi-resolution dataset): the same
  ``global_step`` as the JAX package's.
- The Kolmogorov device protocol: ``sample_fn`` equal to JAX's on the same
  indices, the Markov routine's ``("w",)`` passed through, and
  ``global_step`` over 3 epochs.
- The evaluation set uploaded once and sliced on the device: the same
  metrics as the streamed batches, to the bit.

The model is the flagship's F-FNO cut to 2 layers of width 8 with 4 modes
on 16^2 grids; JAX's initial weights are carried across by
``state_dict_from_flax``.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu.builders import NSMarkovBuilder as JaxNSMarkovBuilder
from fourierflow_tpu.builders import kolmogorov as jax_kol
from fourierflow_tpu.commands.train import build_trainer as jax_build_trainer
from fourierflow_tpu.models import FNOFactorized2DBlock as JaxBlock
from fourierflow_tpu.routines import Grid2DMarkovRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu.trainers import Trainer as JaxTrainer
from fourierflow_tpu_torch.builders import NSMarkovBuilder
from fourierflow_tpu_torch.builders import kolmogorov as kol
from fourierflow_tpu_torch.commands.train import build_trainer
from fourierflow_tpu_torch.models import FNOFactorized2DBlock
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.trainers import Trainer
from fourierflow_tpu_torch.trainers import trainer as trainer_mod
from fourierflow_tpu_torch.trainers.trainer import (epoch_permutation, make_scan_epoch,
                                                    make_scan_epoch_indexed, step_generator)
from fourierflow_tpu_torch.utils.weights import state_dict_from_flax

MODEL = dict(modes=4, width=8, n_layers=2, share_weight=True, factor=4, ff_weight_norm=True,
             gain=0.1)
ROUTINE = dict(n_steps=3, max_accumulations=1000, use_velocity=True)
LR = 3e-3
BATCH = 4
# NSMarkovBuilder: 3 trajectories of 7 records give 3 x 5 = 15 one-step pairs, so batch 4
# leaves a partial batch of 3 that the device-resident epoch drops.
N_TRAJ, N_REC, N_TRAIN = 5, 7, 3


@pytest.fixture(scope="module")
def ns_path(tmp_path_factory):
    rng = np.random.RandomState(5)
    t = np.arange(N_REC)[None, None, None, :]
    base = rng.randn(N_TRAJ, 16, 16, 1).astype(np.float32)
    drift = rng.randn(N_TRAJ, 16, 16, 1).astype(np.float32)
    path = tmp_path_factory.mktemp("ns") / "traj.npy"
    np.save(path, (base + 0.1 * t * drift).astype(np.float32))
    return str(path)


@pytest.fixture(scope="module")
def kol_dir(tmp_path_factory):
    """Small Kolmogorov-layout files from a seed: trajectories ``[2, 6, n,
    n]`` at 16^2 and 8^2 with ``time``, initial conditions ``[2, 16, 16]``
    and an 8^2 reference with the initial frame (7 frames)."""
    d = tmp_path_factory.mktemp("kol")
    rng = np.random.RandomState(9)
    f32 = lambda *shape: rng.randn(*shape).astype(np.float32)
    for name, shape in (("train_16", (2, 6, 16, 16)), ("train_8", (2, 6, 8, 8)),
                        ("init_16", (2, 16, 16)), ("corr_8", (2, 7, 8, 8))):
        with h5py.File(d / f"{name}.h5", "w") as f:
            for key in ("vorticity", "vx", "vy"):
                f.create_dataset(key, data=f32(*shape))
            if len(shape) == 4:
                f.create_dataset("time", data=np.arange(shape[1], dtype=np.float32) * 0.1)
    return d


def _port_routine(lr=LR, noise_std=0.0):
    return Grid2DMarkovRoutine(model=FNOFactorized2DBlock(input_dim=5, **MODEL),
                               noise_std=noise_std, optimizer=make_optimizer(lr=lr), **ROUTINE)


def _jax_routine(lr=LR):
    return JaxRoutine(model=JaxBlock(input_dim=5, **MODEL),
                      optimizer=jax_make_optimizer(lr=lr), **ROUTINE)


def _carried_state(routine, jax_routine, port_builder, jax_builder):
    """The port's state with the weights JAX's Trainer(seed=0) starts from."""
    js = jax_routine.init(jax.random.PRNGKey(0), jax_builder.sample_batch())
    state = routine.init(0, port_builder.sample_batch(), "cpu")
    state.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params),
                                                     MODEL["n_layers"]))
    return state


def _kol_builder(mod, d, kind="markov", batch_size=BATCH):
    train = {"markov": lambda: mod.KolmogorovMarkovDataset(str(d / "train_16.h5"), k=1),
             "multi": lambda: mod.KolmogorovMultiDataset(
                 [str(d / "train_16.h5"), str(d / "train_8.h5")], k=1, batch_size=batch_size),
             }[kind]()
    traj = mod.KolmogorovTrajectoryDataset(str(d / "init_16.h5"), str(d / "train_16.h5"),
                                           str(d / "corr_8.h5"), k=1)
    return mod.KolmogorovBuilder(train, traj, traj, batch_size=batch_size)


def _builders(kind, ns_path, kol_dir):
    """The port's and JAX's builder of one kind."""
    if kind == "ns_markov":
        kw = dict(train_size=N_TRAIN, test_size=2, batch_size=BATCH)
        return NSMarkovBuilder(ns_path, **kw), JaxNSMarkovBuilder(ns_path, **kw)
    return _kol_builder(kol, kol_dir, kind.split("_")[1]), _kol_builder(jax_kol, kol_dir,
                                                                         kind.split("_")[1])


def _assert_states_equal(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters(), strict=True):
        assert torch.equal(p, q), name
    for f in ("sum", "sum_squared", "count", "n_accumulations"):
        assert torch.equal(getattr(a.normalizer, f), getattr(b.normalizer, f)), f
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for key, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][key]), (i, key)
    assert a.step == b.step


# --- the epoch against a per-batch loop run by hand ------------------------------------
def _hand_epoch(routine, state, host_batch, n_items, epoch, seed, first_step, accumulate):
    """The per-batch loop over ``epoch_permutation``'s batches, gathered on
    the host, with ``step_generator``'s generators; the mean metrics as the
    epoch takes them."""
    losses = []
    for i, idx in enumerate(epoch_permutation(seed, epoch, n_items, BATCH)):
        batch = host_batch(idx.numpy())
        if accumulate:
            state = routine.accumulate_step(state, batch)
            continue
        state, m = routine.train_step(state, batch, step_generator(seed, first_step + i, "cpu"))
        losses.append(m["train_loss"])
    return state, {"train_loss": torch.stack(losses).float().mean().item()} if losses else {}


@pytest.mark.parametrize("kind", ["ns_markov", "kol_markov"])
def test_scan_epoch_equals_the_per_batch_loop_over_its_batches(kind, ns_path, kol_dir):
    """Epoch 0 accumulating the normalizer, epoch 1 training with noise
    (step generators from global step 7): parameters, AdamW moments,
    normalizer and mean loss to the bit."""
    port, _ = _builders(kind, ns_path, kol_dir)
    seed, first = 3, 7
    if kind == "ns_markov":
        data, sample_fn, n = port.train_data, trainer_mod.gather, len(port.train_data["x"])
        host_batch = lambda idx: {k: v[idx] for k, v in port.train_data.items()}
    else:
        data, sample_fn, n = port.train_dataset.device_train_data(fields=("w",))
        host_batch = port.train_dataset.sample
    data = trainer_mod.to_device(data, "cpu")
    runs = []
    for fast in (True, False):
        routine = _port_routine(noise_std=0.05)
        state = routine.init(0, port.sample_batch(), "cpu")
        if fast:
            acc = make_scan_epoch_indexed(routine, BATCH, n, sample_fn, accumulate=True,
                                          seed=seed)
            train = (make_scan_epoch(routine, BATCH, seed=seed) if kind == "ns_markov" else
                     make_scan_epoch_indexed(routine, BATCH, n, sample_fn, seed=seed))
            state, acc_metrics = acc(state, data, 0)
            assert acc_metrics == {}
            state, metrics = train(state, data, 1, first)
        else:
            state, _ = _hand_epoch(routine, state, host_batch, n, 0, seed, 0, True)
            state, metrics = _hand_epoch(routine, state, host_batch, n, 1, seed, first, False)
        runs.append((state, metrics))
    (fast_state, fast_metrics), (loop_state, loop_metrics) = runs
    assert fast_state.step == n // BATCH and fast_metrics == loop_metrics
    _assert_states_equal(fast_state, loop_state)


def test_epoch_permutation_is_a_seeded_cpu_draw():
    perm = epoch_permutation(0, 2, 15, 4)
    assert perm.shape == (3, 4) and perm.dtype == torch.int64 and perm.device.type == "cpu"
    assert len(set(perm.flatten().tolist())) == 12 and int(perm.max()) < 15
    assert torch.equal(perm, epoch_permutation(0, 2, 15, 4))
    assert not torch.equal(perm, epoch_permutation(0, 3, 15, 4))
    assert not torch.equal(perm, epoch_permutation(1, 2, 15, 4))


# --- against the JAX package's Trainer -----------------------------------------------
def test_default_trainer_matches_jax_fast_loop(ns_path):
    port, jb = _builders("ns_markov", ns_path, None)
    n = len(port.train_data["x"])
    assert n % BATCH != 0
    jt = JaxTrainer(max_epochs=4, seed=0, data_parallel=False, fast_loop=True)
    js = jt.fit(_jax_routine(), jb)
    routine = _port_routine()
    pt = Trainer(max_epochs=4, seed=0, device="cpu")
    ps = pt.fit(routine, port, _carried_state(routine, _jax_routine(), port, jb))
    assert pt.global_step == jt.global_step == 3 * (n // BATCH) == ps.step == int(js.step)
    assert float(ps.normalizer.count) == float(js.normalizer.count)
    assert float(ps.normalizer.n_accumulations) == float(js.normalizer.n_accumulations)
    assert set(pt.logs) == set(jt.logs)
    losses = (pt.logs["train_loss"], jt.logs["train_loss"])
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) < 0.5 * max(losses)


PATHS = [(True, None, False), (False, None, False), (True, 2, False), (True, None, True)]


@pytest.mark.parametrize("builder", ["ns_markov", "kol_markov", "kol_multi"])
@pytest.mark.parametrize("fast_loop,limit,fast_dev_run", PATHS)
def test_fit_takes_the_path_the_jax_trainer_takes(fast_loop, limit, fast_dev_run, builder,
                                                  ns_path, kol_dir):
    """``global_step`` after ``fit``: n // batch a train epoch on the
    device-resident path; ceil(n / batch), or the limit, on the per-batch
    loop (fast_dev_run: one step)."""
    port, jb = _builders(builder, ns_path, kol_dir)
    cfg = dict(max_epochs=3, limit_train_batches=limit, fast_dev_run=fast_dev_run,
               data_parallel=False, check_val_every_n_epoch=100)
    jt, pt = jax_build_trainer(cfg), build_trainer(cfg, device="cpu")
    jt.mesh = None  # fast_dev_run's JAX Trainer ignores data_parallel: one device, as the port's
    jt.fast_loop = pt.fast_loop = fast_loop
    jt.check_val_every_n_epoch = pt.check_val_every_n_epoch = 100
    jt.fit(_jax_routine(), jb)
    routine = _port_routine()
    pt.fit(routine, port, _carried_state(routine, _jax_routine(), port, jb))
    n = len(port.train_data["x"]) if builder == "ns_markov" else len(port.train_dataset)
    if fast_dev_run:
        want = 1
    elif limit is not None:
        want = 2 * limit
    elif fast_loop and builder != "kol_multi":
        want = 2 * (n // BATCH)
    elif builder == "kol_multi":
        want = 2 * sum(-(-len(d) // BATCH) for d in port.train_dataset.datasets)
    else:
        want = 2 * -(-n // BATCH)
    assert pt.global_step == jt.global_step == want


# --- the Kolmogorov device protocol -------------------------------------------------
@pytest.mark.parametrize("fields", [("w",), ("w", "vx", "vy")])
def test_markov_sample_fn_matches_jax(kol_dir, fields):
    path = str(kol_dir / "train_16.h5")
    jd, pd = (m.KolmogorovMarkovDataset(path, k=2) for m in (jax_kol, kol))
    jdata, jfn, jn = jd.device_train_data(fields=fields)
    pdata, pfn, pn = pd.device_train_data(fields=fields)
    assert pn == jn == len(pd) and sorted(pdata) == sorted(jdata) == sorted(fields)
    idx = np.random.RandomState(1).permutation(pn)[:5]
    want = jfn({k: jnp.asarray(v) for k, v in jdata.items()}, jnp.asarray(idx))
    got = pfn(trainer_mod.to_device(pdata, "cpu"), torch.from_numpy(idx))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    host = pd.sample(idx)  # the per-batch path's batch: the same arrays
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=k)


def test_velocity_sample_fn_matches_jax(kol_dir):
    path = str(kol_dir / "train_16.h5")
    jd, pd = (m.KolmogorovVelocityDataset(path, k=1, unroll_length=2) for m in (jax_kol, kol))
    jdata, jfn, jn = jd.device_train_data()
    pdata, pfn, pn = pd.device_train_data()
    assert pn == jn == len(pd) == 2 * 4
    idx = np.array([7, 0, 3, 4])
    want = jfn({k: jnp.asarray(v) for k, v in jdata.items()}, jnp.asarray(idx))
    got = pfn(trainer_mod.to_device(pdata, "cpu"), torch.from_numpy(idx))
    host = pd.sample(idx)
    for part in range(2):
        assert sorted(got[part]) == sorted(want[part]) == ["vx", "vy"]
        for k in ("vx", "vy"):
            np.testing.assert_array_equal(got[part][k].numpy(), np.asarray(want[part][k]))
            np.testing.assert_array_equal(got[part][k].numpy(), host[part][k])
    assert got[1]["vx"].shape == (4, 16, 16, 2)


def test_trainer_passes_the_routines_fields(kol_dir):
    """The Markov routine declares ("w",): only the vorticity goes to the
    device, as JAX's ``test_fast_path_uploads_only_declared_fields``."""
    builder = _kol_builder(kol, kol_dir)
    seen = {}
    orig = builder.train_dataset.device_train_data

    def spy(fields=("w", "vx", "vy")):
        seen["fields"] = fields
        return orig(fields=fields)

    builder.train_dataset.device_train_data = spy
    routine = _port_routine()
    assert routine.device_data_fields == ("w",)
    trainer = Trainer(max_epochs=2, seed=0, device="cpu", check_val_every_n_epoch=100)
    trainer.fit(routine, builder)
    assert seen["fields"] == ("w",) and np.isfinite(trainer.logs["train_loss"])


def test_kolmogorov_trainer_counts_full_batches(kol_dir):
    """As JAX's ``test_kolmogorov_trainer_fast_path``: 3 epochs, the first
    the normalizer's, validation with the reduced metrics included."""
    builder = _kol_builder(kol, kol_dir)
    trainer = Trainer(max_epochs=3, seed=0, device="cpu")
    trainer.fit(_port_routine(lr=1e-3), builder)
    assert np.isfinite(trainer.logs["train_loss"]) and np.isfinite(trainer.logs["valid_loss"])
    assert trainer.global_step == 2 * (len(builder.train_dataset) // BATCH) == 4


# --- the evaluation set on the device ------------------------------------------------
def test_evaluate_uploads_once_and_equals_the_streamed_batches(ns_path, monkeypatch):
    builder = NSMarkovBuilder(ns_path, train_size=N_TRAIN, test_size=3, batch_size=2)
    routine = _port_routine()
    state = routine.init(0, builder.sample_batch(), "cpu")
    for batch in builder.train_batches(np.random.default_rng(0)):
        state = routine.accumulate_step(state, batch)
    uploads = []
    to_device = trainer_mod.to_device

    def counting(tree, device):  # to_device recurses through the module: count the dicts
        if isinstance(tree, dict):
            uploads.append(sorted(tree))
        return to_device(tree, device)

    monkeypatch.setattr(trainer_mod, "to_device", counting)
    resident, streamed = Trainer(device="cpu"), Trainer(device="cpu", fast_loop=False)
    for split in ("valid", "valid", "test"):
        got = resident.evaluate(routine, builder, state, split=split)
        want = streamed.evaluate(routine, builder, state, split=split)
        assert sorted(got) == sorted(want) and f"{split}_loss" in got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert uploads == [["data", "times"], ["data", "times"]]  # valid once, then test
    assert set(resident._eval_cache) == {(builder, "valid"), (builder, "test")}
