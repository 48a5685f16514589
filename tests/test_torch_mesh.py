"""The port's structured-mesh family (airfoil, pipe, plasticity) against the
JAX package's, on the CPU.

- ``spectral_conv_3d_full``: forward and the gradients of x and the four
  corner weights, with corners that overlap and that do not.
- ``FNOFactorizedMesh2D`` (shared weights and not, padding 8 and 0),
  ``FNOFactorizedMesh3D``, ``FNOMesh2D`` and ``FNOMesh3D`` at 2 layers on odd,
  non-square grids, the weights carried across by
  ``mesh_state_dict_from_flax`` / ``geo_state_dict_from_flax``: the forward
  to ``rtol 1e-4, atol 1e-5`` and the gradient of a scalar loss with
  respect to every parameter to ``rtol 1e-4, atol 1e-5`` of that
  gradient's largest value. The JAX feed-forward runs its plain reference,
  as the JAX package's CPU tests run it.
- ``StructuredMeshRoutine``: three AdamW steps with ``loss_scale`` 20 held
  to the JAX routine (parameters to ``atol 2e-5``; the logged loss is the
  unscaled one).
- Both builders on files written here, element for element against the
  JAX builders (the 2D builder's train / test / valid order).
- The registry's 78 airfoil / pipe / plasticity names and their configs
  against the JAX registry (the 12 ``fcno`` names are held in
  ``test_torch_cno.py``); a misspelt name raises; the remat 3D model
  against the JAX remat model.
- ``train``, ``test`` and ``predict`` on registry names, shrunk, on files
  written here under ``DATA_ROOT``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from fourierflow_tpu import models as jax_models
from fourierflow_tpu.builders import PlasticityBuilder as JaxPlasticityBuilder
from fourierflow_tpu.builders import StructuredMesh2DBuilder as JaxMeshBuilder
from fourierflow_tpu.experiments import experiment_names as jax_experiment_names
from fourierflow_tpu.experiments import get_experiment as jax_get_experiment
from fourierflow_tpu.models.ffno_mesh_2d import get_grid_2d as jax_get_grid_2d
from fourierflow_tpu.models.ffno_mesh_3d import get_grid_3d as jax_get_grid_3d
from fourierflow_tpu.ops.spectral import spectral_conv_3d_full as jax_spectral_conv_3d_full
from fourierflow_tpu.routines import StructuredMeshRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu_torch import models
from fourierflow_tpu_torch.builders import PlasticityBuilder, StructuredMesh2DBuilder
from fourierflow_tpu_torch.commands import predict, train
from fourierflow_tpu_torch.commands import test as test_command
from fourierflow_tpu_torch.config import import_string, load_config, translate
from fourierflow_tpu_torch.experiments import experiment_names, get_experiment
from fourierflow_tpu_torch.models.ffno_mesh_2d import get_grid_2d
from fourierflow_tpu_torch.models.ffno_mesh_3d import get_grid_3d
from fourierflow_tpu_torch.ops.spectral import spectral_conv_3d_full
from fourierflow_tpu_torch.routines import StructuredMeshRoutine
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.utils.weights import geo_state_dict_from_flax, mesh_state_dict_from_flax

RTOL, ATOL = 1e-4, 1e-5  # forward: against the JAX output; gradients: of their largest value
FAMILIES = ("airfoil", "pipe", "plasticity")
GRID_2D, GRID_3D = (20, 12), (12, 10, 8)


def _close(got, want, what, scale=1.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL, atol=ATOL, err_msg=what)


def _close_to_max(got, want, what):
    _close(got, want, what, scale=max(float(np.abs(np.asarray(want)).max()), 1e-30))


# --- spectral_conv_3d_full -----------------------------------------------------------
@pytest.mark.parametrize("sx,sy,sz,m1,m2,m3", [(12, 10, 8, 4, 3, 3), (11, 9, 7, 6, 5, 4),
                                               (10, 8, 6, 3, 3, 4)])
def test_spectral_conv_3d_full_matches_jax(sx, sy, sz, m1, m2, m3):
    """Even and odd grids; 11 x 9 with m1 6 and m2 5 makes the corners
    overlap (the later corner wins in both)."""
    rng = np.random.RandomState(sx + m1)
    x = rng.randn(2, sx, sy, sz, 5).astype(np.float32)
    ws = [(rng.randn(5, 4, m1, m2, m3, 2) * 0.1).astype(np.float32) for _ in range(4)]
    ct = rng.randn(2, sx, sy, sz, 4).astype(np.float32)
    want, vjp = jax.vjp(lambda x, *w: jax_spectral_conv_3d_full(x, list(w)), x, *ws)
    want_grads = vjp(jnp.asarray(ct))
    ins = [torch.tensor(a, requires_grad=True) for a in (x, *ws)]
    got = spectral_conv_3d_full(ins[0], ins[1:])
    _close(got.detach().numpy(), want, "out")
    grads = torch.autograd.grad(got, ins, torch.from_numpy(ct))
    for i, (g, w) in enumerate(zip(grads, want_grads, strict=True)):
        _close_to_max(g.numpy(), w, f"grad {i}")


def test_grids_equal_jax_to_the_bit():
    np.testing.assert_array_equal(get_grid_2d(2, 229, 59).numpy(),
                                  np.asarray(jax_get_grid_2d(2, 229, 59)))
    np.testing.assert_array_equal(get_grid_3d(1, 101, 31, 20).numpy(),
                                  np.asarray(jax_get_grid_3d(1, 101, 31, 20)))


# --- the four models ------------------------------------------------------------------
def _hold_model(jax_model, port_model, x, convert):
    """Forward and every parameter's gradient of ``sum(out * ct)``, with the
    JAX initial weights carried across."""
    params = jax_model.init(jax.random.PRNGKey(1), x)
    want_out = np.asarray(jax_model.apply(params, x))
    ct = np.random.RandomState(7).randn(*want_out.shape).astype(np.float32)
    want_grads = jax.grad(lambda p: jnp.sum(jax_model.apply(p, x) * ct))(params)
    port_model.load_state_dict(convert(jax.tree.map(np.asarray, params)))
    out = port_model(torch.from_numpy(x))
    _close(out.detach().numpy(), want_out, "forward")
    names = [n for n, _ in port_model.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                list(port_model.parameters()))
    want_named = convert(jax.tree.map(np.asarray, want_grads))
    assert len(names) == len(grads) and sum(p.numel() for p in port_model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    for name, g in zip(names, grads, strict=True):
        _close_to_max(g.numpy(), want_named[name].numpy(), name)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("share_weight", [False, True])
@pytest.mark.parametrize("padding", [8, 0])
def test_ffno_mesh_2d_matches_jax(share_weight, padding):
    kw = dict(modes_x=6, modes_y=4, width=16, input_dim=4, n_layers=2,
              share_weight=share_weight, padding=padding)
    _hold_model(jax_models.FNOFactorizedMesh2D(**kw), models.FNOFactorizedMesh2D(**kw),
                _x(2, *GRID_2D, 2), lambda p: mesh_state_dict_from_flax(p, 2))


@pytest.mark.parametrize("share_weight,padding", [(False, 8), (False, 0), (True, 8)])
def test_ffno_mesh_3d_matches_jax(share_weight, padding):
    kw = dict(modes_x=5, modes_y=4, modes_z=3, width=8, input_dim=4, output_dim=4, n_layers=2,
              share_weight=share_weight, padding=padding)
    _hold_model(jax_models.FNOFactorizedMesh3D(**kw), models.FNOFactorizedMesh3D(**kw),
                _x(2, *GRID_3D, 1), lambda p: mesh_state_dict_from_flax(p, 2))


@pytest.mark.parametrize("padding", [8, 0])
def test_geo_fno_mesh_2d_matches_jax(padding):
    kw = dict(modes1=6, modes2=4, width=16, n_layers=2, padding=padding)
    _hold_model(jax_models.FNOMesh2D(**kw), models.FNOMesh2D(**kw), _x(2, *GRID_2D, 2),
                geo_state_dict_from_flax)


@pytest.mark.parametrize("padding", [5, 0])
def test_geo_fno_mesh_3d_matches_jax(padding):
    kw = dict(modes1=5, modes2=4, modes3=3, width=8, n_layers=2, padding=padding)
    _hold_model(jax_models.FNOMesh3D(**kw), models.FNOMesh3D(**kw), _x(2, *GRID_3D, 1),
                geo_state_dict_from_flax)


def test_remat_raises():
    """The remat 3D model against the JAX remat model (forward and
    gradients, as the eager models above)."""
    kw = dict(modes_x=5, modes_y=4, modes_z=3, width=8, input_dim=4, output_dim=4, n_layers=2,
              padding=2, remat=True)
    _hold_model(jax_models.FNOFactorizedMesh3D(**kw), models.FNOFactorizedMesh3D(**kw),
                _x(2, *GRID_3D, 1), lambda p: mesh_state_dict_from_flax(p, 2))


def test_geo_init_follows_the_jax_package():
    """Spectral weights ~ U(0, 1/width^2) on both parts; Dense kernels LeCun
    normal truncated at 2 std, zero biases."""
    m = models.FNOMesh2D(modes1=8, modes2=8, width=32, n_layers=1)
    w = m.convs[0][0].detach()
    assert 0 <= float(w.min()) and float(w.max()) <= 1 / 32 ** 2
    assert float(w.mean()) == pytest.approx(0.5 / 32 ** 2, rel=0.05)
    kernel = m.ws[0].weight.detach()
    assert float(kernel.std()) == pytest.approx(32 ** -0.5, rel=0.1)
    assert float(kernel.abs().max()) <= 2 * 32 ** -0.5 / 0.87962566103423978 + 1e-6
    assert not m.fc1.bias.any()


# --- the routine ----------------------------------------------------------------------
def _mesh_batches(n_batches, b, seed=3):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(b, *GRID_2D, 2).astype(np.float32),
             "y": rng.randn(b, *GRID_2D).astype(np.float32)} for _ in range(n_batches)]


@pytest.mark.parametrize("model", ["ffno", "geo-fno"])
def test_routine_steps_match_jax(model):
    """Three AdamW steps (lr 1e-3, weight decay 1e-4) with loss_scale 20
    from the same weights: every step's logged loss is the unscaled one and
    equals JAX's, the parameters after them agree to 2e-5."""
    if model == "ffno":
        kw = dict(modes_x=6, modes_y=4, width=16, input_dim=4, n_layers=2)
        jm, pm = jax_models.FNOFactorizedMesh2D(**kw), models.FNOFactorizedMesh2D(**kw)
        convert = lambda p: mesh_state_dict_from_flax(p, 2)
    else:
        kw = dict(modes1=6, modes2=4, width=16, n_layers=2)
        jm, pm = jax_models.FNOMesh2D(**kw), models.FNOMesh2D(**kw)
        convert = geo_state_dict_from_flax
    batches = _mesh_batches(3, 2)
    jr = JaxRoutine(model=jm, loss_scale=20,
                    optimizer=jax_make_optimizer(lr=1e-3, weight_decay=1e-4))
    js = jr.init(jax.random.PRNGKey(0), batches[0])
    pr = StructuredMeshRoutine(conv=pm, loss_scale=20,
                               optimizer=make_optimizer(lr=1e-3, weight_decay=1e-4))
    ps = pr.init(0, batches[0], "cpu")
    ps.model.load_state_dict(convert(jax.tree.map(np.asarray, js.params)))
    for batch in batches:
        unscaled = float(pr.valid_step(ps, batch)["loss"])
        js, jmet = jr.train_step(js, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        ps, pmet = pr.train_step(ps, batch)
        assert float(pmet["train_loss"]) == pytest.approx(unscaled, rel=1e-6)
        assert float(pmet["train_loss"]) == pytest.approx(float(jmet["train_loss"]), rel=1e-5)
    assert ps.step == int(js.step) == 3
    want = convert(jax.tree.map(np.asarray, js.params))
    for name, p in ps.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)


def test_loss_scale_scales_the_gradients_only():
    kw = dict(modes1=4, modes2=3, width=8, n_layers=1)
    batch = _mesh_batches(1, 2)[0]
    losses, grads = [], []
    for scale in (1.0, 20.0):
        r = StructuredMeshRoutine(model=models.FNOMesh2D(**kw), loss_scale=scale,
                                  track_grad_norm=True)
        state = r.init(0, batch, "cpu")
        loss, g = r.loss_and_grads(state, batch)
        losses.append(float(loss))
        grads.append(g)
        _, metrics = r.train_step(state, batch)
        assert float(metrics["grad_norm"]) == pytest.approx(float(r.grad_norm(g)), rel=1e-6)
    assert losses[0] == losses[1]
    for a, b in zip(*grads, strict=True):
        _close_to_max(b.numpy(), 20 * a.numpy(), "scaled gradient")


# --- the builders ---------------------------------------------------------------------
def _write_mesh_files(root, n, prefix="", sx=GRID_2D[0], sy=GRID_2D[1], channels=5, seed=0):
    """X, Y ``[n, sx, sy]`` and Q ``[n, channels, sx, sy]`` as float64 .npy
    files ``{prefix}{X,Y,Q}.npy``, as the Geo-FNO files are."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for key, name, shape in (("x1_path", "X", (n, sx, sy)), ("x2_path", "Y", (n, sx, sy)),
                             ("sigma_path", "Q", (n, channels, sx, sy))):
        paths[key] = str(root / f"{prefix}{name}.npy")
        np.save(paths[key], rng.randn(*shape))
    return paths


def test_structured_mesh_2d_builder_matches_jax(tmp_path):
    """Train, then test, then valid, element for element; one Q channel."""
    paths = _write_mesh_files(tmp_path, 13)
    kw = dict(output_dim=4, train_size=5, valid_size=3, test_size=4, batch_size=2)
    got, want = StructuredMesh2DBuilder(**paths, **kw), JaxMeshBuilder(**paths, **kw)
    q = np.load(paths["sigma_path"])[:, 4].astype(np.float32)
    for split, lo, hi in (("train", 0, 5), ("test", 5, 9), ("valid", 9, 12)):
        a, b = getattr(got, f"{split}_data"), getattr(want, f"{split}_data")
        for k in ("x", "y"):
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split} {k}")
        np.testing.assert_array_equal(a["y"], q[lo:hi])
    assert got.train_data["x"].shape == (5, *GRID_2D, 2)
    for k, v in got.inference_data().items():
        np.testing.assert_array_equal(v, want.inference_data()[k])
    assert got.batches_per_epoch == 3


def _write_plasticity_file(path, n, s1=12, s2=10, t=8, seed=0):
    rng = np.random.RandomState(seed)
    scipy.io.savemat(path, {"input": rng.randn(n, s1), "output": rng.randn(n, s1, s2, t, 4)})


def test_plasticity_builder_matches_jax(tmp_path):
    path = str(tmp_path / "plas.mat")
    _write_plasticity_file(path, 9)
    kw = dict(train_size=4, valid_size=2, test_size=3, s1=12, s2=10, t=8, batch_size=2)
    got, want = PlasticityBuilder(path, **kw), JaxPlasticityBuilder(path, **kw)
    for split in ("train", "valid", "test"):
        a, b = getattr(got, f"{split}_data"), getattr(want, f"{split}_data")
        for k in ("x", "y"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split} {k}")
    assert got.train_data["x"].shape == (4, 12, 10, 8, 1)
    assert got.test_data["y"].shape == (3, 12, 10, 8, 4)
    np.testing.assert_array_equal(got.inference_data()["x"], want.inference_data()["x"])


# --- the registry ---------------------------------------------------------------------
def _port_targets(node):
    if isinstance(node, dict):
        return {k: _port_targets(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_port_targets(v) for v in node]
    if isinstance(node, str):
        return node.replace("fourierflow_tpu.", "fourierflow_tpu_torch.")
    return node


MESH_NAMES = [n for n in experiment_names()
              if n.split("/")[0] in FAMILIES and "/fcno/" not in n]


def test_registry_holds_the_78_mesh_names_of_jax():
    want = [n for n in jax_experiment_names()
            if n.split("/")[0] in FAMILIES and "/fcno/" not in n]
    assert MESH_NAMES == want and len(MESH_NAMES) == 78
    for name in MESH_NAMES:
        assert get_experiment(name) == _port_targets(jax_get_experiment(name)), name


def test_registry_hyperparameters():
    routine = lambda name: get_experiment(name)["routine"]
    assert routine("airfoil/ffno/24_layers")["model"]["modes_x"] == 32
    assert routine("airfoil/ffno-small/4_layers")["model"]["width"] == 32
    assert routine("pipe/ffno/8_layers")["model"]["modes_y"] == 16
    geo = get_experiment("plasticity/geo-fno/4_layers")
    assert geo["builder"]["batch_size"] == 20 and geo["routine"].get("loss_scale") is None
    assert get_experiment("airfoil/geo-fno/4_layers")["routine"]["loss_scale"] == 20
    assert get_experiment("plasticity/ffno/24_layers")["builder"]["batch_size"] == 2
    cfg = load_config("airfoil/ffno/24_layers")
    assert cfg["routine"]["_target_"] == "fourierflow_tpu_torch.routines.StructuredMeshRoutine"
    assert cfg["routine"]["model"]["_target_"] == "fourierflow_tpu_torch.models.FNOFactorizedMesh2D"
    assert cfg["builder"]["x1_path"].endswith("/geo-fno/airfoil/naca/NACA_Cylinder_X.npy")


@pytest.mark.parametrize("target,port", [
    ("fourierflow_tpu.models.FNOFactorizedMesh2D", models.FNOFactorizedMesh2D),
    ("fourierflow_tpu.models.FNOFactorizedMesh3D", models.FNOFactorizedMesh3D),
    ("fourierflow_tpu.models.FNOMesh2D", models.FNOMesh2D),
    ("fourierflow_tpu.models.FNOMesh3D", models.FNOMesh3D),
    ("fourierflow_tpu.routines.StructuredMeshRoutine", StructuredMeshRoutine),
    ("fourierflow_tpu.builders.StructuredMesh2DBuilder", StructuredMesh2DBuilder),
    ("fourierflow_tpu.builders.PlasticityBuilder", PlasticityBuilder),
    ("fourierflow.modules.FNOFactorizedMesh2D", models.FNOFactorizedMesh2D),
    ("fourierflow.modules.FNOFactorizedMesh3D", models.FNOFactorizedMesh3D),
    ("fourierflow.routines.StructuredMeshExperiment", StructuredMeshRoutine),
    ("fourierflow.builders.StructuredMesh2DBuilder", StructuredMesh2DBuilder),
    ("fourierflow.builders.PlasticityBuilder", PlasticityBuilder),
])
def test_targets_resolve_to_the_port(target, port):
    """The JAX package's and the reference's names of the family's targets."""
    assert import_string(translate(target)) is port


@pytest.mark.parametrize("name", ["cylinder_flow/baseline",
                                  "torus_kochkov/learned_interpolation/rollout/x64"])
def test_not_ported_names_raise(name):
    """The names that once raised for want of their modules are in the
    registry now; a misspelt one raises a KeyError naming them."""
    assert name in jax_experiment_names() and get_experiment(name)["routine"]
    with pytest.raises(KeyError, match="close matches.*" + name.split("/")[-1]):
        get_experiment(name + "_")


@pytest.mark.parametrize("name", ["airfoil/geo-fno/4_layers", "plasticity/ffno/4_layers"])
def test_adam_configs_build_adamw_with_decay(name):
    """The registry's Adam (Geo-FNO) is AdamW with weight decay 1e-4, as the
    JAX package builds it, like its AdamW (F-FNO); StepLR counts epochs of
    the builder's batches."""
    from types import SimpleNamespace

    routine = train.build_routine(load_config(name)["routine"],
                                  SimpleNamespace(batches_per_epoch=7))
    assert routine.optimizer.weight_decay == 1e-4 and routine.optimizer.lr == 1e-3
    if "geo-fno" in name:
        assert routine.optimizer.schedule(7 * 100) == 0.0005


# --- the commands ---------------------------------------------------------------------
SHRINK_2D = ["builder.train_size=4", "builder.valid_size=2", "builder.test_size=2",
             "builder.batch_size=2", "routine.model.n_layers=2", "routine.model.width=8",
             "routine.model.modes_x=5", "routine.model.modes_y=4", "trainer.max_epochs=2"]
SHRINK_3D = ["builder.train_size=2", "builder.valid_size=1", "builder.test_size=1",
             "builder.batch_size=2", "builder.s1=12", "builder.s2=10", "builder.t=8", "routine.model.n_layers=2",
             "routine.model.width=8", "routine.model.modes1=4", "routine.model.modes2=3",
             "routine.model.modes3=3", "trainer.max_epochs=1"]


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """The registry's airfoil and plasticity files, tiny, under DATA_ROOT."""
    root = tmp_path / "data"
    _write_mesh_files(root / "geo-fno/airfoil/naca", 8, prefix="NACA_Cylinder_")
    (root / "geo-fno/plasticity").mkdir(parents=True)
    _write_plasticity_file(str(root / "geo-fno/plasticity/plas_N987_T20.mat"), 4)
    monkeypatch.setenv("DATA_ROOT", str(root))
    return root


def test_train_test_predict_airfoil_ffno_by_name(data_root, tmp_path):
    name = "airfoil/ffno/24_layers"
    run = str(tmp_path / "run")
    trainer, state = train.main(name, SHRINK_2D, config_dir=run, device="cpu")
    assert trainer.global_step == state.step == 4
    rows = [json.loads(line) for line in next((tmp_path / "run/checkpoints").iterdir())
            .joinpath("metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(rows[0]["train_loss"]) and rows[-1]["test_loss"] > 0
    logs = test_command.main(name, overrides=SHRINK_2D, config_dir=run, device="cpu")
    assert logs["test_loss"] == pytest.approx(trainer.logs["test_loss"], rel=1e-6)
    assert predict.main(name, overrides=SHRINK_2D, device="cpu") > 0


def test_train_plasticity_geo_fno_by_name(data_root, tmp_path):
    trainer, state = train.main("plasticity/geo-fno/4_layers", SHRINK_3D,
                                config_dir=str(tmp_path / "run"), device="cpu")
    assert trainer.global_step == 1 and np.isfinite(trainer.logs["test_loss"])
    out = state.model(torch.zeros(1, 12, 10, 8, 1))
    assert out.shape == (1, 12, 10, 8, 4)
