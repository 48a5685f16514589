"""Per-layer remat, the low-pass mode and the Trainer's remat guard of the
port, on the CPU.

- Remat against the port's eager path, for ``FNOFactorized2DBlock`` (with
  shared weights, forks and dropout in training mode, and in the low-pass
  mode), ``FNOZongyi2DBlock`` and ``FNOFactorizedMesh3D``: the same
  ``state_dict`` keys, the forward and every parameter's gradient equal to
  the bit (the recompute runs the same plain ops on the same inputs, and
  dropout's default generator is restored for it).
- Each remat model against the JAX package's remat model, the weights
  carried across: forward to ``rtol 1e-4, atol 1e-5`` (as
  ``test_torch_model.py``), gradients to 1e-4 of their largest value.
- ``spectral_lowpass_axis`` against the JAX function with both of its
  ``impl``s along both axes, and ``FNOFactorized2DBlock(mode="low-pass")``
  against its JAX counterpart in forward and gradients.
- The guard: ``Trainer(auto_remat=True)`` turns remat on where the JAX
  guard's test expects (monkeypatched device memory), leaves the
  parameters as they were and an explicit ``remat=True`` alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu import models as jax_models
from fourierflow_tpu.ops.spectral import spectral_lowpass_axis as jax_spectral_lowpass_axis
from fourierflow_tpu_torch import models
from fourierflow_tpu_torch.builders import NSMarkovBuilder
from fourierflow_tpu_torch.ops.spectral import spectral_lowpass_axis
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.trainers import trainer as trainer_mod
from fourierflow_tpu_torch.utils.weights import (mesh_state_dict_from_flax, state_dict_from_flax,
                                                 zongyi_state_dict_from_flax)

RTOL, ATOL = 1e-4, 1e-5  # forward against JAX, as tests/test_torch_model.py
GRAD_TOL = 1e-4  # gradients against JAX: max |err| / max |JAX| per tensor

FFNO = dict(modes=4, width=8, input_dim=3, n_layers=3, factor=2)
# name: (port class, keyword arguments, input shape, converter of JAX params)
MODELS = {
    "ffno": (models.FNOFactorized2DBlock, dict(FFNO, ff_weight_norm=True), (2, 16, 16, 3),
             lambda p: state_dict_from_flax(p, 3)),
    "ffno_shared_fork": (models.FNOFactorized2DBlock,
                         dict(FFNO, share_weight=True, use_fork=True, gain=0.1),
                         (2, 16, 16, 3), lambda p: state_dict_from_flax(p, 3)),
    "ffno_low_pass": (models.FNOFactorized2DBlock, dict(FFNO, mode="low-pass"), (2, 16, 12, 3),
                      lambda p: state_dict_from_flax(p, 3)),
    "zongyi": (models.FNOZongyi2DBlock, dict(modes1=4, modes2=4, width=8, n_layers=3,
                                             input_dim=3), (2, 16, 16, 3),
               zongyi_state_dict_from_flax),
    "mesh_3d": (models.FNOFactorizedMesh3D, dict(modes_x=4, modes_y=3, modes_z=3, width=8,
                                                 input_dim=4, output_dim=2, n_layers=2,
                                                 padding=2), (2, 10, 8, 6, 1),
                lambda p: mesh_state_dict_from_flax(p, 2)),
}
# Dropout in training mode: the remat recompute must draw the same masks.
PORT_ONLY = {
    "ffno_fork_dropout": (models.FNOFactorized2DBlock,
                          dict(FFNO, share_weight=True, use_fork=True, dropout=0.3,
                               in_dropout=0.2), (2, 16, 16, 3), None),
}


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _out(result):
    return result["forecast"] if isinstance(result, dict) else result


def _forward_and_grads(model, x, ct, seed=5):
    torch.manual_seed(seed)
    out = _out(model(torch.from_numpy(x)))
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), list(model.parameters()),
                                allow_unused=True)
    return out.detach(), grads


@pytest.mark.parametrize("name", sorted({**MODELS, **PORT_ONLY}))
def test_remat_equals_eager_to_the_bit(name):
    cls, kw, shape, _ = {**MODELS, **PORT_ONLY}[name]
    eager, remat = cls(**kw), cls(**kw, remat=True)
    assert list(remat.state_dict()) == list(eager.state_dict())
    remat.load_state_dict(eager.state_dict())
    x = _x(shape)
    training = "dropout" in name
    eager.train(training)
    remat.train(training)
    out = _out(eager(torch.from_numpy(x)))
    ct = _x(tuple(out.shape), seed=3)
    want_out, want_grads = _forward_and_grads(eager, x, ct)
    got_out, got_grads = _forward_and_grads(remat, x, ct)
    assert torch.equal(got_out, want_out)
    if training:  # the masks are drawn: another seed gives another output
        assert not torch.equal(_forward_and_grads(remat, x, ct, seed=6)[0], want_out)
    names = [n for n, _ in eager.named_parameters()]
    for n, a, b in zip(names, got_grads, want_grads, strict=True):
        assert (a is None and b is None) or torch.equal(a, b), n


def _close_to_max(got, want, tol, what):
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


def _jax_class(cls):
    return getattr(jax_models, cls.__name__)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_matches_jax_remat(name):
    """The port's remat model against the JAX package's remat model (the
    JAX feed-forward's plain reference on the CPU), weights carried across."""
    cls, kw, shape, convert = MODELS[name]
    jax_model = _jax_class(cls)(**kw, remat=True)
    x = _x(shape)
    params = jax_model.init(jax.random.PRNGKey(1), x)
    want_out = np.asarray(_out(jax_model.apply(params, x)))
    ct = _x(want_out.shape, seed=7)
    want_grads = jax.grad(lambda p: jnp.sum(_out(jax_model.apply(p, x)) * ct))(params)
    model = cls(**kw, remat=True).eval()
    model.load_state_dict(convert(jax.tree.map(np.asarray, params)))
    out, grads = _forward_and_grads(model, x, ct)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=RTOL, atol=ATOL)
    want_named = convert(jax.tree.map(np.asarray, want_grads))
    names = [n for n, _ in model.named_parameters()]
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    for n, g in zip(names, grads, strict=True):
        if g is None:  # with forks the last backcast feeds nothing: JAX's gradient is zero
            assert not want_named[n].any(), n
        else:
            _close_to_max(g.numpy(), want_named[n].numpy(), GRAD_TOL, n)


# --- the low-pass mode ------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["dft", "fft"])
@pytest.mark.parametrize("axis,modes", [(1, 4), (2, 4), (1, 9), (2, 7)])
def test_spectral_lowpass_axis_matches_jax(impl, axis, modes):
    """Truncation below, at and up to the Nyquist bin of a 16 x 12 grid."""
    x = _x((2, 16, 12, 5), seed=axis + modes)
    want = np.asarray(jax_spectral_lowpass_axis(jnp.asarray(x), modes, axis, impl=impl))
    got = spectral_lowpass_axis(torch.from_numpy(x), modes, axis)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_low_pass_block_matches_jax_and_has_no_fourier_weights():
    cls, kw, shape, convert = MODELS["ffno_low_pass"]
    jax_model = jax_models.FNOFactorized2DBlock(**kw)
    x = _x(shape, seed=2)
    params = jax_model.init(jax.random.PRNGKey(3), x)
    want_out = np.asarray(jax_model.apply(params, x)["forecast"])
    ct = _x(want_out.shape, seed=4)
    want_grads = jax.grad(lambda p: jnp.sum(jax_model.apply(p, x)["forecast"] * ct))(params)
    model = cls(**kw).eval()
    assert not any("fourier_weight" in n for n in model.state_dict())
    model.load_state_dict(convert(jax.tree.map(np.asarray, params)))
    out, grads = _forward_and_grads(model, x, ct)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=RTOL, atol=ATOL)
    want_named = convert(jax.tree.map(np.asarray, want_grads))
    for (n, _), g in zip(model.named_parameters(), grads, strict=True):
        _close_to_max(g.numpy(), want_named[n].numpy(), GRAD_TOL, n)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        models.FNOFactorized2DBlock(**FFNO, mode="band-pass")


# --- the Trainer's guard -----------------------------------------------------------------
@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    rng = np.random.RandomState(11)
    t = np.arange(6)[None, None, None, :]
    base, drift = rng.randn(8, 16, 16, 1), rng.randn(8, 16, 16, 1)
    path = tmp_path_factory.mktemp("data") / "traj.npy"
    np.save(path, (base + 0.1 * t * drift).astype(np.float32))
    return str(path)


def _markov_routine(**kw):
    return Grid2DMarkovRoutine(model=models.FNOFactorized2DBlock(**FFNO, **kw), n_steps=2,
                               max_accumulations=100)


def test_auto_remat_guard(data_path, monkeypatch):
    """As ``tests/test_training.py::test_auto_remat_hbm_guard``: with 1 KiB
    of device memory the guard turns remat on and training proceeds with
    the same parameters; the estimator is None for a model without the
    F-FNO attributes; with 16 GiB the small config stays eager."""
    builder = NSMarkovBuilder(data_path, train_size=4, test_size=4, batch_size=4)
    routine = _markov_routine()
    assert routine.model.remat is False
    want = routine.init(0, builder.sample_batch(), "cpu")
    want = {k: v.clone() for k, v in want.model.state_dict().items()}

    monkeypatch.setattr(trainer_mod, "_device_hbm_bytes", lambda device: 1024)
    trainer = trainer_mod.Trainer(max_epochs=1, seed=0, device="cpu")
    trainer._maybe_enable_remat(routine, builder)
    assert routine.model.remat is True
    state = routine.init(0, builder.sample_batch(), "cpu")
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    fit = trainer_mod.Trainer(max_epochs=2, seed=0, device="cpu")
    fit.fit(routine, builder)
    assert fit.global_step > 0 and np.isfinite(fit.logs["train_loss"])

    assert trainer_mod._estimate_activation_bytes(object(), {}) is None
    est = trainer_mod._estimate_activation_bytes(routine.model, builder.sample_batch())
    x = builder.sample_batch()["x"]
    assert est == int(FFNO["n_layers"] * x.shape[0] * x.shape[1] * x.shape[2] * FFNO["width"]
                      * trainer_mod.SAVED_INPUTS_PER_LAYER["FNOFactorized2DBlock"] * 4)

    monkeypatch.setattr(trainer_mod, "_device_hbm_bytes", lambda device: 16 << 30)
    routine2 = _markov_routine()
    trainer_mod.Trainer(max_epochs=1, seed=0, device="cpu")._maybe_enable_remat(routine2, builder)
    assert routine2.model.remat is False


def test_auto_remat_guard_leaves_explicit_choices_alone(data_path, monkeypatch):
    builder = NSMarkovBuilder(data_path, train_size=4, test_size=4, batch_size=4)
    monkeypatch.setattr(trainer_mod, "_device_hbm_bytes", lambda device: 1024)
    routine = _markov_routine(remat=True)
    trainer_mod.Trainer(device="cpu")._maybe_enable_remat(routine, builder)
    assert routine.model.remat is True
    routine = _markov_routine()
    trainer_mod.Trainer(max_epochs=1, device="cpu", auto_remat=False).fit(routine, builder)
    assert routine.model.remat is False
    # The CPU's memory is unbounded to the guard.
    monkeypatch.undo()
    assert trainer_mod._device_hbm_bytes("cpu") == float("inf")
    trainer_mod.Trainer(device="cpu")._maybe_enable_remat(routine, builder)
    assert routine.model.remat is False


@pytest.mark.parametrize("name", ["ffno", "zongyi", "mesh_3d"])
def test_activation_estimate_uses_the_model_familys_coefficient(name):
    """The estimate is ``n_layers * batch * cells * width * 4`` bytes times
    the coefficient measured for the model's family."""
    cls, kw, shape, _ = MODELS[name]
    model = cls(**kw)
    est = trainer_mod._estimate_activation_bytes(model, {"x": np.zeros(shape, np.float32)})
    coefficient = trainer_mod.SAVED_INPUTS_PER_LAYER[cls.__name__]
    assert coefficient > 0
    assert est == int(kw["n_layers"] * shape[0] * np.prod(shape[1:-1]) * kw["width"]
                      * coefficient * 4)


def test_activation_estimate_is_none_for_a_model_without_a_coefficient():
    """A model with ``n_layers`` and ``width`` but no measured coefficient
    (and no remat) is left to the caller: None."""
    model = models.FNOMesh2D(modes1=4, modes2=4, width=8, n_layers=2)
    assert type(model).__name__ not in trainer_mod.SAVED_INPUTS_PER_LAYER
    assert trainer_mod._estimate_activation_bytes(
        model, {"x": np.zeros((2, 16, 16, 2), np.float32)}) is None
