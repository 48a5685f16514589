"""The port's CNO family (the factorized DCT models on grids and meshes)
against the JAX package's, on the CPU.

- ``dct2_basis`` / ``idct2_basis``: the JAX package's bits, and
  ``scipy.fft.dct(type=2, norm="ortho")`` to 1e-6 of the largest value;
  ``dct``/``idct`` over one, two and three trailing axes against JAX's and
  inverse to each other.
- ``dct_mix_axis``: forward and the gradients of x and the weight, ``rtol
  1e-5, atol 1e-6`` of the largest value, on every spatial axis.
- ``CNOFactorized2DBlock`` (per-layer weights; shared weights with a gain,
  shared fork; ``use_fork``), ``CNOFactorizedMesh2D`` and
  ``CNOFactorizedMesh3D`` (padding 8 and 0, shared and not) at 2 layers,
  the weights carried across by ``cno_state_dict_from_flax``: the forward to
  ``rtol 1e-4, atol 1e-5`` and every parameter's gradient of a scalar loss
  to ``rtol 1e-4, atol 1e-5`` of its largest value.
- ``Grid2DMarkovRoutine`` with a CNO conv (the ``torus_kochkov/fcno``
  configuration, shrunk): a normalizer pass and three steps held to the JAX
  routine's (losses to rel 1e-5, parameters to 2e-5).
- The registry's 14 ``fcno`` names equal JAX's and build; the CNO targets
  resolve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

from fourierflow_tpu import models as jax_models
from fourierflow_tpu.experiments import experiment_names as jax_experiment_names
from fourierflow_tpu.experiments import get_experiment as jax_get_experiment
from fourierflow_tpu.ops import dft as jax_dft
from fourierflow_tpu.ops.spectral import dct_mix_axis as jax_dct_mix_axis
from fourierflow_tpu.routines import Grid2DMarkovRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu_torch import models
from fourierflow_tpu_torch.commands.train import build_routine
from fourierflow_tpu_torch.config import import_string, load_config, translate
from fourierflow_tpu_torch.experiments import experiment_names, get_experiment
from fourierflow_tpu_torch.ops import dft
from fourierflow_tpu_torch.ops.spectral import dct_mix_axis
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.utils.weights import cno_state_dict_from_flax

RTOL, ATOL = 1e-4, 1e-5  # models: forward against JAX; gradients of their largest value
OP_RTOL, OP_ATOL = 1e-5, 1e-6  # the DCT ops, of the largest value
GRID_2D, GRID_3D = (20, 12), (12, 10, 8)


def _close(got, want, what, rtol=RTOL, atol=ATOL, scale=1.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol, err_msg=what)


def _close_to_max(got, want, what, rtol=RTOL, atol=ATOL):
    _close(got, want, what, rtol, atol, max(float(np.abs(np.asarray(want)).max()), 1e-30))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --- the DCT bases and transforms -----------------------------------------------------
@pytest.mark.parametrize("n,modes", [(8, 8), (40, 12), (59, 16), (109, 32)])
def test_dct_bases_equal_jax_and_scipy(n, modes):
    d, di = dft.dct2_basis(n, modes), dft.idct2_basis(n, modes)
    np.testing.assert_array_equal(d, jax_dft.dct2_basis(n, modes))
    np.testing.assert_array_equal(di, jax_dft.idct2_basis(n, modes))
    x = _x(3, n).astype(np.float64)
    want = scipy.fft.dct(x, type=2, norm="ortho")[:, :modes]
    _close_to_max(x @ d.astype(np.float64), want, "dct2_basis vs scipy", 1e-6, 1e-6)
    if modes == n:  # the inverse of the whole spectrum
        _close_to_max(want @ di.astype(np.float64), x, "idct2_basis vs scipy", 1e-6, 1e-6)
    with pytest.raises(ValueError, match="exceeds"):
        dft.dct2_basis(n, n + 1)


@pytest.mark.parametrize("name", ["dct", "idct", "dct_2d", "idct_2d", "dct_3d", "idct_3d"])
def test_dct_transforms_match_jax(name):
    x = _x(2, 7, 6, 5)
    got = getattr(dft, name)(torch.from_numpy(x)).numpy()
    _close_to_max(got, np.asarray(getattr(jax_dft, name)(jnp.asarray(x))), name, OP_RTOL, OP_ATOL)
    inverse = name[1:] if name.startswith("i") else "i" + name
    back = getattr(dft, inverse)(torch.from_numpy(got)).numpy()
    _close_to_max(back, x, f"{inverse} of {name}", OP_RTOL, OP_ATOL)


@pytest.mark.parametrize("shape,modes,axis", [((2, 20, 12, 6), 5, 1), ((2, 20, 12, 6), 12, 2),
                                              ((2, 12, 10, 8, 4), 3, 3)])
def test_dct_mix_axis_matches_jax(shape, modes, axis):
    x, w = _x(*shape), _x(shape[-1], 5, modes, seed=1)
    want, vjp = jax.vjp(lambda x, w: jax_dct_mix_axis(x, w, axis), x, w)
    ct = _x(*want.shape, seed=2)
    want_grads = vjp(jnp.asarray(ct))
    ins = [torch.tensor(a, requires_grad=True) for a in (x, w)]
    got = dct_mix_axis(*ins, axis)
    _close_to_max(got.detach().numpy(), want, "dct_mix_axis", OP_RTOL, OP_ATOL)
    for name, g, wg in zip(("dx", "dw"), torch.autograd.grad(got, ins, torch.from_numpy(ct)),
                           want_grads, strict=True):
        _close_to_max(g.numpy(), wg, name, OP_RTOL, OP_ATOL)


# --- the three models -----------------------------------------------------------------
def _hold_model(jax_model, port_model, x, convert, output=lambda out: out):
    """Forward and every parameter's gradient of ``sum(out * ct)``, with the
    JAX initial weights carried across."""
    params = jax_model.init(jax.random.PRNGKey(1), x)
    want_out = np.asarray(output(jax_model.apply(params, x)))
    ct = np.random.RandomState(7).randn(*want_out.shape).astype(np.float32)
    want_grads = jax.grad(lambda p: jnp.sum(output(jax_model.apply(p, x)) * ct))(params)
    port_model.load_state_dict(convert(jax.tree.map(np.asarray, params)))
    out = output(port_model(torch.from_numpy(x)))
    _close(out.detach().numpy(), want_out, "forward")
    names = [n for n, _ in port_model.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                list(port_model.parameters()))
    assert sum(p.numel() for p in port_model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    want_named = convert(jax.tree.map(np.asarray, want_grads))
    for name, g in zip(names, grads, strict=True):
        _close_to_max(g.numpy(), want_named[name].numpy(), name)


BLOCK_CASES = {
    "per_layer": dict(),
    "shared_gain": dict(share_weight=True, gain=0.1, factor=4, ff_weight_norm=True),
    "fork": dict(use_fork=True, share_fork=True),
}


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_cno_block_matches_jax(case):
    kw = dict(modes=5, width=8, input_dim=3, n_layers=2, **BLOCK_CASES[case])
    _hold_model(jax_models.CNOFactorized2DBlock(**kw), models.CNOFactorized2DBlock(**kw),
                _x(2, 16, 14, 3), lambda p: cno_state_dict_from_flax(p, 2, grid=True),
                output=lambda out: out["forecast"])


def test_cno_block_init_follows_gain():
    """Shared weights xavier-normal with ``gain``, per-layer ones with 1."""
    gain = lambda w: float(w.detach().std()) / (2.0 / ((64 + 64) * 16)) ** 0.5
    shared = models.CNOFactorized2DBlock(modes=16, width=64, share_weight=True, gain=0.1)
    assert gain(shared.fourier_weight[0]) == pytest.approx(0.1, rel=0.05)
    assert shared.fourier_weight[0].shape == (64, 64, 16)
    own = models.CNOFactorized2DBlock(modes=16, width=64, gain=0.1)
    assert gain(own.spectral_layers[1].fourier_weight[1]) == pytest.approx(1.0, rel=0.05)


@pytest.mark.parametrize("share_weight,padding", [(False, 8), (False, 0), (True, 8)])
def test_cno_mesh_2d_matches_jax(share_weight, padding):
    kw = dict(modes_x=6, modes_y=4, width=16, input_dim=4, n_layers=2,
              share_weight=share_weight, padding=padding)
    _hold_model(jax_models.CNOFactorizedMesh2D(**kw), models.CNOFactorizedMesh2D(**kw),
                _x(2, *GRID_2D, 2), lambda p: cno_state_dict_from_flax(p, 2))


@pytest.mark.parametrize("share_weight,padding", [(False, 8), (True, 0)])
def test_cno_mesh_3d_matches_jax(share_weight, padding):
    kw = dict(modes_x=5, modes_y=4, modes_z=3, width=8, input_dim=4, output_dim=4, n_layers=2,
              share_weight=share_weight, padding=padding)
    _hold_model(jax_models.CNOFactorizedMesh3D(**kw), models.CNOFactorizedMesh3D(**kw),
                _x(2, *GRID_3D, 1), lambda p: cno_state_dict_from_flax(p, 2))


# --- the markov routine with a CNO conv -----------------------------------------------
def test_markov_routine_with_cno_conv_matches_jax():
    """``torus_kochkov/fcno``'s conv (shared weights, gain 0.1, factor 4,
    weight norm; 5 input channels from the velocity) at 2 layers, width 8:
    one normalizer pass over three batches, then three ``train_step``s
    without noise from the same weights."""
    conv = dict(modes=4, width=8, n_layers=2, input_dim=5, share_weight=True, factor=4,
                ff_weight_norm=True, gain=0.1)
    kw = dict(use_velocity=True, max_accumulations=1000)
    batches = [{"x": _x(4, 16, 16, 1, seed=s), "y": _x(4, 16, 16, 1, seed=s + 10)}
               for s in range(3)]
    jr = JaxRoutine(model=jax_models.CNOFactorized2DBlock(**conv),
                    optimizer=jax_make_optimizer(lr=1e-3, weight_decay=1e-4), **kw)
    js = jr.init(jax.random.PRNGKey(0), batches[0])
    pr = Grid2DMarkovRoutine(conv=models.CNOFactorized2DBlock(**conv),
                             optimizer=make_optimizer(lr=1e-3, weight_decay=1e-4), **kw)
    ps = pr.init(0, batches[0], "cpu")
    convert = lambda p: cno_state_dict_from_flax(jax.tree.map(np.asarray, p), 2, grid=True)
    ps.model.load_state_dict(convert(js.params))
    for batch in batches:
        js = jr.accumulate_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ps = pr.accumulate_step(ps, batch)
    for batch in batches:
        js, jm = jr.train_step(js, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        ps, pm = pr.train_step(ps, batch)
        assert float(pm["train_loss"]) == pytest.approx(float(jm["train_loss"]), rel=1e-5)
    want = convert(js.params)
    for key, p in ps.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), rtol=0, atol=2e-5, err_msg=key)


# --- the registry ---------------------------------------------------------------------
def _port_targets(node):
    if isinstance(node, dict):
        return {k: _port_targets(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_port_targets(v) for v in node]
    if isinstance(node, str):
        return node.replace("fourierflow_tpu.", "fourierflow_tpu_torch.")
    return node


FCNO_NAMES = [n for n in experiment_names() if "/fcno/" in n]


def test_registry_holds_the_14_fcno_names_of_jax():
    assert FCNO_NAMES == [n for n in jax_experiment_names() if "/fcno/" in n]
    assert len(FCNO_NAMES) == 14
    for name in FCNO_NAMES:
        assert get_experiment(name) == _port_targets(jax_get_experiment(name)), name
    cfg = load_config("torus_kochkov/fcno/grid_sizes/128")
    assert cfg["routine"]["conv"]["_target_"] == "fourierflow_tpu_torch.models.CNOFactorized2DBlock"
    assert cfg["routine"]["conv"]["modes"] == 32 and cfg["routine"]["conv"]["share_weight"]
    model = get_experiment("plasticity/fcno/24_layers")["routine"]["model"]
    assert model["_target_"].endswith("CNOFactorizedMesh3D") and model["modes_x"] == 32


@pytest.mark.parametrize("name", ["airfoil/fcno/4_layers", "plasticity/fcno/4_layers"])
def test_fcno_mesh_routines_build(name):
    """At full width and 2 layers on a small mesh: the forward's shape."""
    routine = build_routine(load_config(name, ["routine.model.n_layers=2"])["routine"])
    shape = (40, 16, 10, 1) if name.startswith("plasticity") else (40, 20, 2)
    x = torch.from_numpy(_x(1, *shape))
    state = routine.init(0, {"x": x.numpy()}, "cpu")
    with torch.no_grad():
        out = state.model(x)
    assert out.shape == (1, *shape[:-1], 4 if name.startswith("plasticity") else 1)


@pytest.mark.parametrize("target,port", [
    ("fourierflow_tpu.models.CNOFactorized2DBlock", models.CNOFactorized2DBlock),
    ("fourierflow_tpu.models.CNOFactorizedMesh2D", models.CNOFactorizedMesh2D),
    ("fourierflow_tpu.models.CNOFactorizedMesh3D", models.CNOFactorizedMesh3D),
    ("fourierflow.modules.CNOFactorized2DBlock", models.CNOFactorized2DBlock),
])
def test_targets_resolve_to_the_port(target, port):
    assert import_string(translate(target)) is port
