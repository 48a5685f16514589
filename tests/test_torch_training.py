"""The port's training slice against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. On a
CPU tensor the port's autograd Functions run their plain versions, forward
and backward; the JAX functions run their Pallas kernels in interpret mode
(or the einsum chain they equal). Then the schedule, the optimizer chain,
one full ``train_step`` from carried weights, the ``train`` command on a
shrunk flagship config, and the Trainer and its checkpoint callback. Tolerances are relative to the largest reference
value unless stated: 1e-5 where both sides compute in float32 and only the
order of the sums differs.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fourierflow_tpu.builders import NSMarkovBuilder as JaxBuilder
from fourierflow_tpu.builders.base import iterate_batches as jax_iterate_batches
from fourierflow_tpu.layers import normalizer_accumulate as jax_normalizer_accumulate
from fourierflow_tpu.layers import normalizer_apply as jax_normalizer_apply
from fourierflow_tpu.layers import normalizer_inverse as jax_normalizer_inverse
from fourierflow_tpu.layers import lp_loss_rel as jax_lp_loss_rel
from fourierflow_tpu.models import FNOFactorized2DBlock as JaxBlock
from fourierflow_tpu.ops.pallas_ff import fused_ff as jax_fused_ff
from fourierflow_tpu.ops.pallas_spectral import fused_mix_2d as jax_fused_mix_2d
from fourierflow_tpu.ops.spectral import spectral_mix_axis as jax_spectral_mix_axis
from fourierflow_tpu.routines import Grid2DMarkovRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu.schedulers import cosine_with_warmup as jax_cosine_with_warmup
from fourierflow_tpu_torch.builders import NSMarkovBuilder, iterate_batches
from fourierflow_tpu_torch.commands import infer, train
from fourierflow_tpu_torch.models import FNOFactorized2DBlock
from fourierflow_tpu_torch.ops import fused_ff, fused_mix_2d
from fourierflow_tpu_torch.ops.fused_ff import fused_ff_bwd_plain, fused_ff_plain
from fourierflow_tpu_torch.ops.fused_spectral import fused_mix_2d_adjoint_plain, fused_mix_2d_plain
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.routines.base import Routine, make_optimizer
from fourierflow_tpu_torch.schedulers import cosine_with_warmup
from fourierflow_tpu_torch.utils.checkpoint import load_state
from fourierflow_tpu_torch.utils.weights import state_dict_from_flax

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs/torus_li/markov/24_layers.yaml")
MODEL = dict(modes=4, width=16, input_dim=3, n_layers=4, share_weight=True, factor=4,
             ff_weight_norm=True, gain=0.1)
SHRINK = ["routine.conv.n_layers=2", "routine.conv.width=8", "routine.conv.modes=4"]


def _close_to_max(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (what, err, np.max(np.abs(want)))


def _grads(fn, args, cotangent):
    """Gradients of ``sum(cotangent * fn(*args))`` in every argument (torch)."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(cotangent))]


def _jax_vjp(fn, args, cotangent):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return [np.asarray(g) for g in vjp(jnp.asarray(cotangent))]


# --- fused feed-forward backward -------------------------------------------------
def _ff_inputs(rows, cin=8, hidden=32, cout=8, seed=0, lead=()):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, rows, cin).astype(np.float32)
    w1 = (rng.randn(cin, hidden) * 0.3).astype(np.float32)
    b1 = (rng.randn(hidden) * 0.1).astype(np.float32)
    w2 = (rng.randn(hidden, cout) * 0.3).astype(np.float32)
    b2 = (rng.randn(cout) * 0.1).astype(np.float32)
    g = rng.randn(*lead, rows, cout).astype(np.float32)
    return (x, w1, b1, w2, b2), g


@pytest.mark.parametrize("rows,lead", [(300, ()), (4500, ()), (13, (2, 3))])
def test_fused_ff_function_matches_jax_fused_backward(rows, lead):
    """dx, dW1, db1, dW2, db2 of the port's Function against ``jax.vjp`` of
    the JAX kernel with its fused backward (``_ff_bwd_pallas`` in interpret
    mode); 4,500 rows span three of its 2,048-row blocks, so its
    accumulation across blocks and its zero-padded last block are used."""
    args, g = _ff_inputs(rows, seed=rows, lead=lead)
    want = _jax_vjp(lambda *a: jax_fused_ff(*a, True, True), args, g)
    got = _grads(fused_ff, args, g)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        _close_to_max(a, b, what=name)


def test_fused_ff_function_runs_its_backward():
    args, _ = _ff_inputs(5)
    out = fused_ff(*(torch.from_numpy(a).requires_grad_() for a in args))
    assert type(out.grad_fn).__name__ == "_FusedFFBackward"


def test_fused_ff_bwd_plain_matches_autograd_of_the_composition():
    """The plain backward against torch autograd of relu(x@w1+b1)@w2+b2 in
    float64, with leading dims and non-square widths."""
    args, g = _ff_inputs(11, cin=6, hidden=24, cout=5, seed=3, lead=(2,))
    want = _grads(lambda x, w1, b1, w2, b2: torch.relu(x @ w1 + b1) @ w2 + b2,
                  [a.astype(np.float64) for a in args], g.astype(np.float64))
    x, w1, b1, w2, _ = map(torch.from_numpy, args)
    got = fused_ff_bwd_plain(x, torch.from_numpy(g), w1, b1, w2)
    assert got[0].shape == x.shape and got[0].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in got[1:])
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        _close_to_max(a.numpy(), b, what=name)


def test_fused_ff_bwd_plain_bf16_rounds_only_dx():
    """In bf16 the plain backward computes in float32 from the rounded
    inputs and rounds only dx; the weight gradients stay float32."""
    args, g = _ff_inputs(9, seed=4)
    xb, gb, w1, b1, w2 = (torch.from_numpy(a).bfloat16() for a in (args[0], g, *args[1:4]))
    got = fused_ff_bwd_plain(xb, gb, w1, b1, w2)
    want = fused_ff_bwd_plain(xb.float(), gb.float(), w1.float(), b1.float(), w2.float())
    assert got[0].dtype == torch.bfloat16
    torch.testing.assert_close(got[0], want[0].bfloat16(), rtol=0, atol=0)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- spectral mix backward ---------------------------------------------------------
def _mix_inputs(b=2, sx=16, sy=16, c=8, m=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, sx, sy, c).astype(np.float32)
    wy = (rng.randn(c, c, m, 2) * 0.1).astype(np.float32)
    wx = (rng.randn(c, c, m, 2) * 0.1).astype(np.float32)
    g = rng.randn(b, sx, sy, c).astype(np.float32)
    return (x, wy, wx), g


@pytest.mark.parametrize("n,m", [(16, 4), (15, 4), (16, 9)])
def test_fused_mix_2d_function_matches_jax_kernel_vjp(n, m):
    """dx, dwy, dwx against ``jax.vjp`` of the JAX kernel (interpret mode):
    its adjoint launch for dx and its einsums over spectra for the weights.
    An odd grid, and 9 modes on 16 points (the Nyquist mode)."""
    args, g = _mix_inputs(sx=n, sy=n, m=m, seed=n + m)
    want = _jax_vjp(lambda *a: jax_fused_mix_2d(*a, True), args, g)
    got = _grads(fused_mix_2d, args, g)
    for name, a, b in zip(("dx", "dwy", "dwx"), got, want):
        _close_to_max(a, b, what=name)


def test_fused_mix_2d_function_non_square_matches_jax_branches():
    args, g = _mix_inputs(sx=12, sy=10, m=3, seed=5)

    def jax_mix(x, wy, wx):
        return (jax_spectral_mix_axis(x, wy, 2, impl="dft")
                + jax_spectral_mix_axis(x, wx, 1, impl="dft"))

    want = _jax_vjp(jax_mix, args, g)
    got = _grads(fused_mix_2d, args, g)
    for name, a, b in zip(("dx", "dwy", "dwx"), got, want):
        _close_to_max(a, b, what=name)


@pytest.mark.parametrize("sx,sy,m", [(12, 10, 3), (16, 16, 9)])
def test_fused_mix_2d_adjoint_plain_is_the_vjp(sx, sy, m):
    """The plain adjoint against torch autograd's vector-Jacobian product of
    the plain forward with respect to x."""
    (x, wy, wx), g = _mix_inputs(sx=sx, sy=sy, m=m, seed=7)
    want = _grads(lambda x: fused_mix_2d_plain(x, torch.from_numpy(wy), torch.from_numpy(wx)),
                  [x], g)[0]
    got = fused_mix_2d_adjoint_plain(torch.from_numpy(g), torch.from_numpy(wy),
                                     torch.from_numpy(wx))
    _close_to_max(got.numpy(), want)


def test_fused_mix_2d_function_runs_its_backward():
    (x, wy, wx), _ = _mix_inputs()
    out = fused_mix_2d(*(torch.from_numpy(a).requires_grad_() for a in (x, wy, wx)))
    assert type(out.grad_fn).__name__ == "_FusedMix2dBackward"


# --- schedule and optimizer --------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 499, 500, 50_000, 100_000])
def test_cosine_with_warmup_matches_jax(step):
    args = dict(lr=0.0025, num_warmup_steps=500, num_training_steps=100_000, num_cycles=0.5)
    want = float(jax_cosine_with_warmup(**args)(step))
    assert cosine_with_warmup(**args)(step) == pytest.approx(want, rel=1e-6, abs=1e-12)


def _toy_state(routine, values):
    model = torch.nn.ParameterList([torch.nn.Parameter(torch.tensor(v)) for v in values])
    return routine.make_train_state(model)


def test_optimizer_applies_the_schedule_from_step_zero():
    """The first three updates use schedule(0), schedule(1), schedule(2), as
    optax counts: under warm-up the first update has lr 0."""
    schedule = cosine_with_warmup(lr=0.01, num_warmup_steps=4, num_training_steps=20)
    routine = Routine(make_optimizer(lr=0.01, weight_decay=0.0, schedule=schedule))
    state = _toy_state(routine, [np.ones(3, np.float32)])
    applied = []
    for _ in range(3):
        applied.append(state.optimizer.param_groups[0]["lr"])
        state = routine.apply_grads(state, [torch.ones(3)])
    want = [float(jax_cosine_with_warmup(0.01, 4, 20)(s)) for s in range(3)]
    np.testing.assert_allclose(applied, want, rtol=1e-6)
    assert applied[0] == 0.0 and state.step == 3


@pytest.mark.parametrize("clip_val,k", [(None, 1), (0.05, 1), (None, 3), (0.05, 2)])
def test_clip_and_accumulation_match_optax_chain(clip_val, k):
    """AdamW + clip by value + k-step mean accumulation under a warm-up
    schedule, against the JAX package's optax chain on the same gradients,
    step by step. Tolerance 1e-5 relative: float32 arithmetic in both."""
    rng = np.random.RandomState(k)
    values = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    kw = dict(lr=0.01, weight_decay=0.1, clip_val=clip_val, accumulate_grad_batches=k)
    tx = jax_make_optimizer(schedule=jax_cosine_with_warmup(0.01, 2, 12), **kw)
    routine = Routine(make_optimizer(schedule=cosine_with_warmup(0.01, 2, 12), **kw))
    state = _toy_state(routine, values)
    params = [jnp.asarray(v) for v in values]
    opt_state = tx.init(params)
    for t in range(7):
        grads = [(rng.randn(*v.shape) * 0.2).astype(np.float32) for v in values]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, params)
        params = optax.apply_updates(params, updates)
        state = routine.apply_grads(state, [torch.from_numpy(g) for g in grads])
        for p, want in zip(state.model, params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {t}")


# --- one train step against the JAX routine -------------------------------------
@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    rng = np.random.RandomState(11)
    t = np.arange(6)[None, None, None, :]
    base = rng.randn(8, 16, 16, 1).astype(np.float32)
    drift = rng.randn(8, 16, 16, 1).astype(np.float32)
    path = tmp_path_factory.mktemp("data") / "traj.npy"
    np.save(path, (base + 0.1 * t * drift).astype(np.float32))
    return str(path)


def _named(tree, n_layers):
    return {k: v.numpy() for k, v in state_dict_from_flax(jax.tree.map(np.asarray, tree),
                                                          n_layers).items()}


def test_train_steps_match_jax_routine(data_path):
    """From weights carried by ``state_dict_from_flax`` and one normalizer
    epoch, with no noise and a constant lr: the loss, every gradient
    (weight-norm ``g``/``v`` and biases through the ``w.t()`` views, and the
    Fourier weights shared by all layers) and the normalizer of the first
    step, then the losses and parameters over three ``train_step``s.
    Gradients match to 1e-4 of their largest value. Parameters after Adam
    steps are held to 2e-5 absolute: Adam divides by the gradient's running
    RMS, so a gradient near zero turns summation-order noise into an update
    of up to lr (1e-3) in either direction; with these inputs none is that
    small, and the bound is 50x below lr."""
    n = MODEL["n_layers"]
    jb = JaxBuilder(data_path, train_size=4, test_size=4, batch_size=4)
    jr = JaxRoutine(model=JaxBlock(**MODEL), max_accumulations=1000,
                    optimizer=jax_make_optimizer(lr=1e-3, weight_decay=1e-4))
    js = jr.init(jax.random.PRNGKey(0), jb.sample_batch())
    for batch in jax_iterate_batches(jb.train_data, 4):
        js = jr.accumulate_step(js, batch)

    pb = NSMarkovBuilder(data_path, train_size=4, test_size=4, batch_size=4)
    pr = Grid2DMarkovRoutine(model=FNOFactorized2DBlock(**MODEL), max_accumulations=1000,
                             optimizer=make_optimizer(lr=1e-3, weight_decay=1e-4))
    ps = pr.init(0, pb.sample_batch(), "cpu")
    ps.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params), n))
    for batch in iterate_batches(pb.train_data, 4):
        ps = pr.accumulate_step(ps, batch)

    batches = list(iterate_batches(pb.train_data, 4))[:3]
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    x = jr.build_features(first["x"])
    norm = jax_normalizer_accumulate(js.normalizer, x)
    x = jax_normalizer_apply(norm, x)

    def loss_fn(params):
        im = jax_normalizer_inverse(norm, jr.model.apply(params, x)["forecast"], channel=0)
        return jax_lp_loss_rel(im.reshape(4, -1), first["y"].reshape(4, -1))

    want_loss, want_grads = jax.value_and_grad(loss_fn)(js.params)
    loss, grads, pnorm = pr.loss_and_grads(ps, batches[0])
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want_named = _named(want_grads, n)
    names = [name for name, _ in ps.model.named_parameters()]
    assert len(names) == len(grads) and "fourier_weight.0" in names
    for name, g in zip(names, grads):
        _close_to_max(g.numpy(), want_named[name], tol=1e-4, what=name)
    for f in ("sum", "sum_squared", "count", "n_accumulations"):
        np.testing.assert_allclose(getattr(pnorm, f).numpy(), np.asarray(getattr(norm, f)),
                                   rtol=1e-6, err_msg=f)

    for batch in batches:
        js, jm = jr.train_step(js, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        ps, pm = pr.train_step(ps, batch)
        assert float(pm["train_loss"]) == pytest.approx(float(jm["train_loss"]), rel=1e-5)
    assert ps.step == int(js.step) == 3
    want_params = _named(js.params, n)
    for name, p in ps.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_params[name], rtol=0, atol=2e-5, err_msg=name)


def test_noise_comes_from_the_generator(data_path):
    """With noise the loss depends on the generator's seed only."""
    pb = NSMarkovBuilder(data_path, train_size=4, test_size=4, batch_size=4)
    pr = Grid2DMarkovRoutine(model=FNOFactorized2DBlock(**MODEL), noise_std=0.1)
    state = pr.init(0, pb.sample_batch(), "cpu")
    batch = pb.sample_batch()
    loss = lambda seed: float(pr.loss_and_grads(state, batch,
                                                torch.Generator().manual_seed(seed))[0])
    assert loss(1) == loss(1) != loss(2)
    with pytest.raises(ValueError, match="generator"):
        pr.loss_and_grads(state, batch)


# --- the train command ------------------------------------------------------------
def _overrides(data_path, *extra):
    return [f"builder.data_path={data_path}", "builder.train_size=4", "builder.test_size=4",
            "builder.batch_size=4", *SHRINK, "trainer.max_epochs=2",
            "trainer.limit_train_batches=2", *extra]


def test_train_on_cpu_then_infer_reads_its_checkpoint(data_path, tmp_path):
    trainer, state = train.main(CONFIG, _overrides(data_path), config_dir=str(tmp_path),
                                device="cpu")
    (run_dir,) = (tmp_path / "checkpoints").iterdir()
    assert {"last.ckpt", "metrics.jsonl"} <= {p.name for p in run_dir.iterdir()}
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["test_loss"] > 0 and np.isfinite(rows[-2]["train_loss"])
    assert trainer.global_step == state.step == 2 and rows[-2]["epoch"] == 1

    run = infer.main(CONFIG, str(run_dir / "last.ckpt"), overrides=_overrides(data_path),
                     n_steps=3, device="cpu")
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(run.state.model.state_dict()[k], v, rtol=0, atol=0)
    assert run.state.step == 2 and torch.isfinite(run.result["preds"]).all()
    resumed = load_state(str(run_dir / "last.ckpt"), run.state)
    assert resumed.optimizer.state_dict()["state"], "the optimizer moments were saved"
    torch.testing.assert_close(resumed.normalizer.mean, state.normalizer.mean)


def test_train_cli_refuses_existing_results_without_force(data_path, tmp_path):
    from fourierflow_tpu_torch.commands.__main__ import main

    args = ["train", CONFIG, *_overrides(data_path), "--device", "cpu", "--no-test",
            "--config-dir", str(tmp_path)]
    main(args)
    with pytest.raises(train.ExistingExperimentFound):
        main(args)
    main([*args, "--force", "--trial", "0"])


def test_train_raises_without_gpu_unless_cpu_requested(monkeypatch, data_path, tmp_path):
    from fourierflow_tpu_torch.commands.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", CONFIG, *_overrides(data_path), "--config-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()


# --- trainer and callbacks -------------------------------------------------------
class _ToyRoutine(Routine):
    """One parameter; the train loss is whatever the test sets."""

    should_normalize = False

    def __init__(self, loss):
        super().__init__(make_optimizer(lr=0.1))
        self.loss = loss

    def init(self, seed, sample_batch, device):
        return self.make_train_state(torch.nn.Linear(1, 1, device=device))

    def train_step(self, state, batch, rng=None):
        grads = [torch.ones_like(p) for p in state.model.parameters()]
        return self.apply_grads(state, grads), {"train_loss": torch.tensor(self.loss)}

    def valid_step(self, state, batch):
        return {"loss": torch.tensor(float(state.step))}


class _ToyBuilder:
    def __init__(self, n=3):
        self.data = {"x": np.zeros((n, 1), np.float32)}

    def train_batches(self, rng=None):
        return iterate_batches(self.data, 1, shuffle=True, rng=rng)

    def val_batches(self):
        return iterate_batches(self.data, 3)

    test_batches = val_batches

    def sample_batch(self):
        return next(self.val_batches())


def test_trainer_stops_on_a_nan_loss():
    from fourierflow_tpu_torch.trainers import Trainer

    with pytest.raises(FloatingPointError, match="train_loss is NaN at epoch 0"):
        Trainer(max_epochs=2, device="cpu").fit(_ToyRoutine(float("nan")), _ToyBuilder())
    trainer = Trainer(max_epochs=2, device="cpu")
    state = trainer.fit(_ToyRoutine(0.5), _ToyBuilder())
    assert trainer.global_step == state.step == 6 and trainer.logs["train_loss"] == 0.5


def test_model_checkpoint_keeps_the_best_monitored_state(tmp_path):
    """With ``monitor`` a checkpoint is written only when the metric
    improves in the mode's direction; ``last.ckpt`` at every epoch; the test
    pass then reads the best one."""
    from fourierflow_tpu_torch.trainers import ModelCheckpoint, Trainer

    cb = ModelCheckpoint(str(tmp_path), monitor="valid_loss", mode="max")
    trainer = Trainer(max_epochs=3, callbacks=[cb], device="cpu")
    routine = _ToyRoutine(0.5)
    state = trainer.fit(routine, _ToyBuilder())
    assert cb.best == 9.0 and cb.best_path == str(tmp_path / "best.ckpt")
    assert {p.name for p in tmp_path.iterdir()} == {"best.ckpt", "last.ckpt"}
    cb_min = ModelCheckpoint(str(tmp_path / "min"), monitor="valid_loss", mode="min")
    Trainer(max_epochs=3, callbacks=[cb_min], device="cpu").fit(_ToyRoutine(0.5), _ToyBuilder())
    assert cb_min.best == 3.0
    best = train.resolve_test_state([cb_min], routine.init(0, None, "cpu"))
    assert best.step == 3 and state.step == 9
