"""The port's torus_li ablations against the JAX package's, on the CPU.

- The shuffled grid: the same permutations as JAX's, and train steps
  whose losses and parameters agree.
- ``FNOPlus2DBlock`` (FNO++, ``no_factorization*``) with its weights
  carried by ``plus_state_dict_from_flax``: the forward with and without
  shared weights, with the fork and with a shared fork, and without the
  Fourier layers; the gradient of every parameter; its train steps under
  the markov routine.
- ``zongyi_markov``: the original FNO under the markov routine, from its
  registry config, whose ``input_dim`` (12) the routine's 3 feature
  channels replace as flax's inferred input layer does.

Tolerances are relative to the largest reference value: 1e-5 where both
sides compute in float32 and only the order of the sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu.models import FNOFactorized2DBlock as JaxBlock
from fourierflow_tpu.models import FNOPlus2DBlock as JaxPlus
from fourierflow_tpu.models import FNOZongyi2DBlock as JaxZongyi
from fourierflow_tpu.routines import Grid2DMarkovRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu_torch.commands.train import build_routine
from fourierflow_tpu_torch.config import load_config
from fourierflow_tpu_torch.models import FNOFactorized2DBlock, FNOPlus2DBlock
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.utils.weights import (plus_state_dict_from_flax, state_dict_from_flax,
                                                 zongyi_state_dict_from_flax)

GRID, N_LAYERS = 16, 2
FFNO = dict(modes=4, width=8, input_dim=3, n_layers=N_LAYERS, share_weight=True, factor=2,
            ff_weight_norm=True, gain=0.1)
PLUS = dict(modes=4, width=8, input_dim=3, n_layers=N_LAYERS, factor=2, ff_weight_norm=True,
            gain=0.1)
TOL = 1e-5


def _close_to_max(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (what, err, np.max(np.abs(want)))


def _x(b=2, c=3, seed=0):
    return np.random.RandomState(seed).randn(b, GRID, GRID, c).astype(np.float32)


# --- the shuffled grid ------------------------------------------------------------------
@pytest.mark.parametrize("grid_size", [16, (16,), (64,)])
def test_shuffle_permutations_equal_jax(grid_size):
    want = JaxRoutine(shuffle_grid=True, grid_size=grid_size)
    got = Grid2DMarkovRoutine(shuffle_grid=True, grid_size=grid_size)
    for name in ("x_idx", "x_inv", "y_idx", "y_inv"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert not np.array_equal(got.x_idx.numpy(), got.y_idx.numpy())
    with pytest.raises(ValueError, match="one grid size"):
        Grid2DMarkovRoutine(shuffle_grid=True, grid_size=(16, 16))


# --- FNO++ ------------------------------------------------------------------------------
PLUS_CASES = {
    "not_shared": dict(share_weight=False),
    "shared_weights": dict(share_weight=True),
    "shared_all": dict(share_weight=True, share_fork=True),
    "fork": dict(use_fork=True),
    "shared_fork": dict(share_weight=True, share_fork=True, use_fork=True),
    "no_fourier": dict(mode="no-fourier"),
}


def _plus_pair(**kw):
    cfg = dict(PLUS, **kw)
    jm = JaxPlus(**cfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(_x()))
    pm = FNOPlus2DBlock(**cfg)
    pm.load_state_dict(plus_state_dict_from_flax(jax.tree.map(np.asarray, params), N_LAYERS))
    return jm, params, pm


@pytest.mark.parametrize("case", PLUS_CASES)
def test_fno_plus_forward_matches_jax(case):
    jm, params, pm = _plus_pair(**PLUS_CASES[case])
    x = _x(seed=3)
    want = jm.apply(params, jnp.asarray(x))
    got = pm(torch.from_numpy(x))
    _close_to_max(got["forecast"].detach().numpy(), np.asarray(want["forecast"]), what=case)
    assert len(got["forecast_list"]) == len(want["forecast_list"])
    for a, b in zip(got["forecast_list"], want["forecast_list"]):
        _close_to_max(a.detach().numpy(), np.asarray(b), what=f"{case} forecast_list")
    assert (sum(p.numel() for p in pm.parameters())
            == sum(a.size for a in jax.tree.leaves(params)))


@pytest.mark.parametrize("case", ["not_shared", "shared_fork"])
def test_fno_plus_gradients_match_jax(case):
    """The gradient of ``sum(forecast * g)`` in every parameter against
    ``jax.grad``, to 1e-5 of each gradient's largest value."""
    jm, params, pm = _plus_pair(**PLUS_CASES[case])
    x, g = _x(seed=4), np.random.RandomState(5).randn(2, GRID, GRID, 1).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x))["forecast"] * g))(params)
    want = {k: v.numpy() for k, v in plus_state_dict_from_flax(
        jax.tree.map(np.asarray, want), N_LAYERS).items()}
    names = [n for n, _ in pm.named_parameters()]
    loss = (pm(torch.from_numpy(x))["forecast"] * torch.from_numpy(g)).sum()
    grads = torch.autograd.grad(loss, list(pm.parameters()))
    for name, grad in zip(names, grads):
        _close_to_max(grad.numpy(), want[name], what=name)


def test_fno_plus_refuses_other_modes():
    with pytest.raises(ValueError, match="mode"):
        FNOPlus2DBlock(**PLUS, mode="low-pass")


# --- train steps of the ablations -------------------------------------------------------
def _batches(seeds=(6, 7, 8)):
    out = []
    for s in seeds:
        rng = np.random.RandomState(s)
        out.append({"x": rng.randn(4, GRID, GRID, 1).astype(np.float32),
                    "y": rng.randn(4, GRID, GRID, 1).astype(np.float32)})
    return out


ABLATIONS = {
    "shuffle_xy_grid": (JaxBlock, FNOFactorized2DBlock, FFNO, state_dict_from_flax,
                        dict(shuffle_grid=True, grid_size=GRID)),
    "no_factorization": (JaxPlus, FNOPlus2DBlock, PLUS, plus_state_dict_from_flax, {}),
    "no_factorization_shared_all": (JaxPlus, FNOPlus2DBlock,
                                    dict(PLUS, share_weight=True, share_fork=True),
                                    plus_state_dict_from_flax, {}),
}


@pytest.mark.parametrize("name", ABLATIONS)
def test_ablation_train_steps_match_jax(name):
    """One normalizer pass and three ``train_step``s without noise from the
    same weights: the losses agree to rel 1e-5, the parameters after them
    to 2e-5 absolute (Adam's updates are at most lr; see
    ``test_torch_training.py``)."""
    jax_model, port_model, cfg, convert, routine_kw = ABLATIONS[name]
    batches = _batches()
    jr = JaxRoutine(model=jax_model(**cfg), max_accumulations=1000,
                    optimizer=jax_make_optimizer(lr=1e-3, weight_decay=1e-4), **routine_kw)
    js = jr.init(jax.random.PRNGKey(0), batches[0])
    pr = Grid2DMarkovRoutine(model=port_model(**cfg), max_accumulations=1000,
                             optimizer=make_optimizer(lr=1e-3, weight_decay=1e-4), **routine_kw)
    ps = pr.init(0, batches[0], "cpu")
    ps.model.load_state_dict(convert(jax.tree.map(np.asarray, js.params), N_LAYERS))
    for batch in batches:
        js = jr.accumulate_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ps = pr.accumulate_step(ps, batch)
    for batch in batches:
        js, jm = jr.train_step(js, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        ps, pm = pr.train_step(ps, batch)
        assert float(pm["train_loss"]) == pytest.approx(float(jm["train_loss"]), rel=TOL)
    want = {k: v.numpy() for k, v in convert(jax.tree.map(np.asarray, js.params),
                                             N_LAYERS).items()}
    for key, p in ps.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key], rtol=0, atol=2e-5, err_msg=key)


# --- zongyi_markov -----------------------------------------------------------------------
@pytest.mark.parametrize("residual", [False, True])
def test_zongyi_markov_from_registry_matches_jax(residual):
    """``torus_li/ablation/zongyi_markov*/4_layers`` (shrunk): the config's
    ``input_dim`` stays at FNOZongyi2DBlock's default of 12, the routine
    builds 3 feature channels, and ``init`` sizes the input layer to them;
    the model's forward on the normalized features agrees with JAX's."""
    key = "zongyi_markov_residual" if residual else "zongyi_markov"
    cfg = load_config(f"torus_li/ablation/{key}/4_layers",
                      ["routine.conv.n_layers=2", "routine.conv.modes1=4",
                       "routine.conv.modes2=4", "routine.conv.width=8"])
    assert "input_dim" not in cfg["routine"]["conv"]
    routine = build_routine(cfg["routine"])
    assert routine.model.in_proj.in_features == 12
    batch = _batches()[0]
    state = routine.init(0, batch, "cpu")
    assert state.model.in_proj.in_features == 3
    conv = {k: v for k, v in cfg["routine"]["conv"].items() if k != "_target_"}
    jr = JaxRoutine(model=JaxZongyi(**conv), max_accumulations=1000)
    js = jr.accumulate_step(jr.init(jax.random.PRNGKey(2), batch), batch)
    state.model.load_state_dict(zongyi_state_dict_from_flax(jax.tree.map(np.asarray, js.params)))
    state = routine.accumulate_step(state, batch)
    x = jr.build_features(jnp.asarray(batch["x"]))
    x = np.array((x - js.normalizer.mean) / js.normalizer.std)
    want = np.asarray(jr.model.apply(js.params, jnp.asarray(x))["forecast"])
    with torch.no_grad():
        got = state.model(torch.from_numpy(x))["forecast"].numpy()
    _close_to_max(got, want, what=key)
