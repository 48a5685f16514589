"""The port's point-cloud family (elasticity) against the JAX package's, on
the CPU.

- ``nudft2d``, ``inudft2d``, ``nudft_axis``, ``inudft_axis``: forward and the
  gradients of their inputs, ``rtol 1e-5, atol 1e-6`` of the largest value
  (measured: at most 4.1e-7); the wavenumbers equal.
- ``hilbert_index`` / ``hilbert_sort``: equal to the JAX package's.
- ``IPhi`` with and without a code, at width 8 (to ``rtol 1e-5, atol 1e-6``;
  measured 8e-8) and at width 64, where the 16 bands reach ``pi * 2^15`` and
  an ulp of the angle or the radius moves the top band's argument by up to
  ~6e-3 rad, and the float32 product of the band and the angle rounds it by
  up to 8e-3 rad in both packages: there both are held to a float64 numpy
  IPhi of the same weights, and to each other, within 5e-4 of the largest
  output (measured over 4 seeds, with and without a code: 8.1e-5 to 1.4e-4
  from float64 in each package, 5.3e-5 to 2.1e-4 between them; XLA's
  float32 atan2 and the port's, taken in float64 and rounded once, differ
  by an ulp in some points).
- ``FNOFactorizedPointCloud2D`` (shared weights and not),
  ``FNOPointCloud2D`` and ``FNOFullyFactorizedMesh2D`` with an IPhi at small
  widths, the weights carried across by ``point_cloud_state_dict_from_flax``
  / ``geo_point_cloud_state_dict_from_flax``: the forward to ``rtol 1e-4,
  atol 1e-5`` and every parameter's gradient of a scalar loss to ``rtol
  1e-4, atol 1e-5`` of its largest value.
- ``PointCloudRoutine``: three AdamW steps held to the JAX routine's
  (parameters to ``atol 2e-5``); the IPhi regularisation drawn from the
  routine's generator.
- ``ElasticityBuilder`` on files written here, element for element against
  the JAX builder; ``train``, ``test`` and ``predict`` on a registry name,
  shrunk, on files written under ``DATA_ROOT``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu import models as jax_models
from fourierflow_tpu.builders import ElasticityBuilder as JaxElasticityBuilder
from fourierflow_tpu.ops import nudft as jax_nudft
from fourierflow_tpu.routines import PointCloudRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu.utils.hilbert import hilbert_index as jax_hilbert_index
from fourierflow_tpu.utils.hilbert import hilbert_sort as jax_hilbert_sort
from fourierflow_tpu_torch import models
from fourierflow_tpu_torch.builders import ElasticityBuilder
from fourierflow_tpu_torch.commands import predict, train
from fourierflow_tpu_torch.commands import test as test_command
from fourierflow_tpu_torch.config import import_string, translate
from fourierflow_tpu_torch.layers import lp_loss_rel
from fourierflow_tpu_torch.ops import nudft
from fourierflow_tpu_torch.routines import PointCloudRoutine
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.utils.hilbert import hilbert_index, hilbert_sort
from fourierflow_tpu_torch.utils.weights import (geo_point_cloud_state_dict_from_flax,
                                                 point_cloud_state_dict_from_flax)

RTOL, ATOL = 1e-4, 1e-5  # models: forward against JAX; gradients of their largest value
OP_RTOL, OP_ATOL = 1e-5, 1e-6  # the transforms and IPhi at width 8, of the largest value
WIDE_IPHI_TOL = 5e-4  # IPhi at width 64: of the largest output (see the module docstring)


def _close(got, want, what, rtol=RTOL, atol=ATOL, scale=1.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol, err_msg=what)


def _close_to_max(got, want, what, rtol=RTOL, atol=ATOL):
    _close(got, want, what, rtol, atol, max(float(np.abs(np.asarray(want)).max()), 1e-30))


def _points(b, n, seed=0):
    """Points scattered in the unit square, as the elasticity meshes."""
    return np.random.RandomState(seed).rand(b, n, 2).astype(np.float32)


# --- the transforms -------------------------------------------------------------------
def test_wavenumbers_equal_jax():
    for m1, m2 in ((4, 3), (16, 16), (1, 1)):
        for a, b in zip(nudft.nudft_wavenumbers(m1, m2), jax_nudft.nudft_wavenumbers(m1, m2),
                        strict=True):
            np.testing.assert_array_equal(a, b)


def _hold_op(jax_fn, port_fn, args, what):
    """Forward and the gradients of every input of ``sum(out * ct)``."""
    want, vjp = jax.vjp(jax_fn, *args)
    outs = want if isinstance(want, tuple) else (want,)
    cts = [np.random.RandomState(5 + i).randn(*o.shape).astype(np.float32)
           for i, o in enumerate(outs)]
    want_grads = vjp(tuple(map(jnp.asarray, cts)) if isinstance(want, tuple)
                     else jnp.asarray(cts[0]))
    ins = [torch.tensor(a, requires_grad=True) for a in args]
    got = port_fn(*ins)
    got = got if isinstance(got, tuple) else (got,)
    for i, (g, w) in enumerate(zip(got, outs, strict=True)):
        _close_to_max(g.detach().numpy(), w, f"{what} out {i}", OP_RTOL, OP_ATOL)
    grads = torch.autograd.grad(got, ins, [torch.from_numpy(c) for c in cts])
    for i, (g, w) in enumerate(zip(grads, want_grads, strict=True)):
        _close_to_max(g.numpy(), w, f"{what} grad {i}", OP_RTOL, OP_ATOL)


@pytest.mark.parametrize("m1,m2", [(4, 3), (16, 16), (12, 12)])
def test_nudft2d_and_inverse_match_jax(m1, m2):
    rng = np.random.RandomState(m1)
    x, u = _points(2, 50, seed=m1), rng.randn(2, 50, 5).astype(np.float32)
    _hold_op(lambda u, x: jax_nudft.nudft2d(u, x, m1, m2),
             lambda u, x: nudft.nudft2d(u, x, m1, m2), (u, x), "nudft2d")
    ur, ui = (rng.randn(2, 2 * m1, m2, 5).astype(np.float32) for _ in range(2))
    _hold_op(lambda a, b, x: jax_nudft.inudft2d(a, b, x, m1, m2),
             lambda a, b, x: nudft.inudft2d(a, b, x, m1, m2), (ur, ui, x), "inudft2d")


@pytest.mark.parametrize("modes", [1, 7, 16])
def test_nudft_axis_and_inverse_match_jax(modes):
    rng = np.random.RandomState(modes)
    coord, u = _points(2, 40, seed=modes)[..., 0], rng.randn(2, 40, 6).astype(np.float32)
    _hold_op(lambda u, c: jax_nudft.nudft_axis(u, c, modes),
             lambda u, c: nudft.nudft_axis(u, c, modes), (u, coord), "nudft_axis")
    sr, si = (rng.randn(2, modes, 6).astype(np.float32) for _ in range(2))
    _hold_op(lambda a, b, c: jax_nudft.inudft_axis(a, b, c, modes),
             lambda a, b, c: nudft.inudft_axis(a, b, c, modes), (sr, si, coord), "inudft_axis")


def test_inudft2d_mirrors_the_reference_flip():
    """One mode at row k, column 1: its mirror lands at row -(k + 1), column
    -1, conjugated (the reference's extension, kept as it is)."""
    m1, m2 = 3, 3
    x = torch.from_numpy(_points(1, 7))
    ur, ui = torch.zeros(1, 2 * m1, m2, 1), torch.zeros(1, 2 * m1, m2, 1)
    ur[0, 1, 1], ui[0, 1, 1] = 1.0, 0.5
    k1, k2 = (torch.from_numpy(k).double() for k in nudft.nudft_wavenumbers(m1, m2))
    ang = lambda kx, ky: 2 * np.pi * (x[0, :, 0].double() * kx + x[0, :, 1].double() * ky)
    # the mode at (k1[1], k2[1]); its mirror at row 2 m1 - 1 - 1 = 4 (k1 = -2), column -1
    want = (torch.cos(ang(k1[1], k2[1])) - 0.5 * torch.sin(ang(k1[1], k2[1]))
            + torch.cos(ang(k1[4], k2[-1])) + 0.5 * torch.sin(ang(k1[4], k2[-1])))
    got = nudft.inudft2d(ur, ui, x, m1, m2)[0, :, 0].double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("order", [3, 16])
def test_hilbert_matches_jax(order):
    rng = np.random.RandomState(order)
    pos = rng.randn(500, 2) * [3.0, 0.5]
    np.testing.assert_array_equal(hilbert_sort(pos, order), jax_hilbert_sort(pos, order))
    xs, ys = rng.randint(0, 2 ** order, (2, 300))
    np.testing.assert_array_equal(hilbert_index(xs, ys, order), jax_hilbert_index(xs, ys, order))


# --- IPhi -----------------------------------------------------------------------------
def _iphi_pair(width, code, seed=0):
    """The JAX IPhi's output, its params, and the port's IPhi with them."""
    x = _points(2, 100, seed)
    c = np.random.RandomState(seed + 1).randn(2, 42).astype(np.float32) if code else None
    jm = jax_models.IPhi(width=width)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), x, c))
    pm = models.IPhi(width, code_dim=42 if code else None)
    sd = point_cloud_state_dict_from_flax({"iphi": params["params"]}, 1)
    pm.load_state_dict({k.removeprefix("iphi."): v for k, v in sd.items()})
    return x, c, np.asarray(jm.apply(params, x, c)), params["params"], pm


def _iphi_float64(p, x, code, width):
    """IPhi in float64 numpy with the weights ``p`` (flax's tree)."""
    x = x.astype(np.float64)
    lin = lambda name, h: h @ p[name]["kernel"].astype(np.float64) + p[name]["bias"]
    xd = np.stack([x[..., 0], x[..., 1], np.arctan2(x[..., 1] - 1e-4, x[..., 0] - 1e-4),
                   np.linalg.norm(x - 1e-4, axis=-1)], axis=-1)
    ang = (xd[..., None] * (np.pi * 2.0 ** np.arange(width // 4))).reshape(*xd.shape[:2], -1)
    h = np.concatenate([lin("fc0", xd), np.sin(ang), np.cos(ang)], axis=-1)
    if code is None:
        h = lin("fc_no_code", h)
    else:
        cd = lin("fc_code", code.astype(np.float64))[:, None]
        h = np.concatenate([np.broadcast_to(cd, (*x.shape[:2], width)), h], axis=-1)
    for k in (1, 2, 3):
        h = np.tanh(lin(f"fc{k}", h))
    return x + x * lin("fc4", h)


@pytest.mark.parametrize("code", [True, False])
def test_iphi_matches_jax(code):
    x, c, want, params, pm = _iphi_pair(8, code)
    got = pm(torch.from_numpy(x), None if c is None else torch.from_numpy(c))
    _close_to_max(got.detach().numpy(), want, "iphi", OP_RTOL, OP_ATOL)
    assert ("fc_code" in params) == code and ("fc_no_code" in params) != code


@pytest.mark.parametrize("code", [True, False])
def test_iphi_width_64_against_float64(code):
    x, c, want, params, pm = _iphi_pair(64, code, seed=2)
    got = pm(torch.from_numpy(x), None if c is None else torch.from_numpy(c)).detach().numpy()
    ref = _iphi_float64(params, x, c, 64)
    scale = np.abs(ref).max()
    port_err, jax_err = np.abs(got - ref).max() / scale, np.abs(want - ref).max() / scale
    assert port_err <= WIDE_IPHI_TOL and jax_err <= WIDE_IPHI_TOL, (port_err, jax_err)
    assert np.abs(got - want).max() / scale <= WIDE_IPHI_TOL


def test_iphi_code_must_match_construction():
    with pytest.raises(ValueError, match="without a code"):
        models.IPhi(8)(torch.zeros(1, 3, 2))
    with pytest.raises(ValueError, match="with a code"):
        models.IPhi(8, code_dim=None)(torch.zeros(1, 3, 2), torch.zeros(1, 42))


# --- the three models -----------------------------------------------------------------
KW = dict(modes1=3, modes2=3, width=8, in_channels=2, out_channels=1, s1=12, s2=10)


def _model_pair(kind, n_layers=3, share_weight=False):
    kw = dict(KW, n_layers=n_layers)
    if kind == "ffno":
        kw["share_weight"] = share_weight
        return (jax_models.FNOFactorizedPointCloud2D(**kw, iphi=jax_models.IPhi(width=8)),
                models.FNOFactorizedPointCloud2D(**kw, iphi=models.IPhi(8)),
                lambda p: point_cloud_state_dict_from_flax(p, n_layers))
    if kind == "geo":
        return (jax_models.FNOPointCloud2D(**kw, iphi=jax_models.IPhi(width=8)),
                models.FNOPointCloud2D(**kw, iphi=models.IPhi(8)),
                geo_point_cloud_state_dict_from_flax)
    kw["modes2"] = 4  # the y branch's modes differ from the x branch's
    return (jax_models.FNOFullyFactorizedMesh2D(**kw, iphi=jax_models.IPhi(width=8)),
            models.FNOFullyFactorizedMesh2D(**kw, iphi=models.IPhi(8)),
            lambda p: point_cloud_state_dict_from_flax(p, n_layers))


def _cloud_batch(b=2, n=40, seed=3):
    rng = np.random.RandomState(seed)
    return {"xy": _points(b, n, seed), "rr": rng.randn(b, 42).astype(np.float32),
            "sigma": rng.randn(b, n, 1).astype(np.float32)}


@pytest.mark.parametrize("kind,share_weight", [("ffno", False), ("ffno", True), ("geo", False),
                                               ("plus", False)])
def test_point_cloud_models_match_jax(kind, share_weight):
    """Forward and every parameter's gradient of ``sum(out * ct)`` through the
    IPhi deformation, the JAX initial weights carried across."""
    jm, pm, convert = _model_pair(kind, share_weight=share_weight)
    batch = _cloud_batch()
    xy, rr = batch["xy"], batch["rr"]
    params = jm.init(jax.random.PRNGKey(1), xy, code=rr)
    want = np.asarray(jm.apply(params, xy, code=rr))
    ct = np.random.RandomState(7).randn(*want.shape).astype(np.float32)
    want_grads = jax.grad(lambda p: jnp.sum(jm.apply(p, xy, code=rr) * ct))(params)
    pm.load_state_dict(convert(jax.tree.map(np.asarray, params)))
    out = pm(torch.from_numpy(xy), code=torch.from_numpy(rr))
    _close(out.detach().numpy(), want, "forward")
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), list(pm.parameters()))
    assert sum(p.numel() for p in pm.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    want_named = convert(jax.tree.map(np.asarray, want_grads))
    for name, g in zip(names, grads, strict=True):
        _close_to_max(g.numpy(), want_named[name].numpy(), name)


def test_point_cloud_ffno_takes_separate_query_points():
    """``x_out`` other than the input points: the last layer evaluates there,
    as JAX's does."""
    jm, pm, convert = _model_pair("ffno", n_layers=2)
    batch = _cloud_batch()
    x_out = _points(2, 17, seed=9)
    params = jm.init(jax.random.PRNGKey(1), batch["xy"], code=batch["rr"])
    want = np.asarray(jm.apply(params, batch["xy"], code=batch["rr"], x_out=x_out))
    pm.load_state_dict(convert(jax.tree.map(np.asarray, params)))
    got = pm(torch.from_numpy(batch["xy"]), code=torch.from_numpy(batch["rr"]),
             x_out=torch.from_numpy(x_out))
    _close(got.detach().numpy(), want, "forward at x_out")


def test_init_follows_the_jax_package():
    """The last layer's and Geo-FNO's spectral weights ~ U(0, 1/width^2);
    Geo-FNO's linear layers flax's Dense (zero biases), the F-FNO's torch's."""
    m = models.FNOFactorizedPointCloud2D(modes1=8, modes2=8, width=32, in_channels=2,
                                         out_channels=1, n_layers=2)
    w = m.last_weight[0].detach()
    assert 0 <= float(w.min()) and float(w.max()) <= 1 / 32 ** 2
    assert m.fc1.bias.abs().max() > 0
    g = models.FNOPointCloud2D(modes1=8, modes2=8, width=32, in_channels=2, out_channels=1)
    assert float(g.convs[1][0].detach().max()) <= 1 / 32 ** 2 and not g.bs[0].bias.any()


# --- the routine ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ffno", "geo"])
def test_routine_steps_match_jax(kind):
    """Three AdamW steps (lr 1e-3, weight decay 1e-4) without a generator
    (no regularisation), from the same weights: every step's loss equals
    JAX's, the parameters after them agree to 2e-5."""
    jm, pm, convert = _model_pair(kind, n_layers=2)
    batches = [_cloud_batch(seed=s) for s in range(3)]
    jr = JaxRoutine(model=jm, N=16, optimizer=jax_make_optimizer(lr=1e-3, weight_decay=1e-4))
    js = jr.init(jax.random.PRNGKey(0), batches[0])
    pr = PointCloudRoutine(model=pm, N=16, optimizer=make_optimizer(lr=1e-3, weight_decay=1e-4))
    ps = pr.init(0, batches[0], "cpu")
    ps.model.load_state_dict(convert(jax.tree.map(np.asarray, js.params)))
    for batch in batches:
        js, jmet = jr.train_step(js, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        ps, pmet = pr.train_step(ps, batch)
        assert float(pmet["train_loss"]) == pytest.approx(float(jmet["train_loss"]), rel=1e-5)
        assert float(pmet["train_loss_reg"]) == float(jmet["train_loss_reg"]) == 0.0
    assert ps.step == int(js.step) == 3
    want = convert(jax.tree.map(np.asarray, js.params))
    for name, p in ps.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)
    assert float(pr.valid_step(ps, batches[0])["loss"]) > 0


def test_routine_regularisation_draws_from_the_generator():
    """The IPhi term on N points of [-1, 2)^2 from the routine's generator:
    logged as ``train_loss_reg`` and weighted by ``reg_weight`` in the
    gradients; the grad norm logged when asked for."""
    batch = _cloud_batch()
    results = []
    for reg_weight in (0.0, 0.5):
        pr = PointCloudRoutine(model=models.FNOFactorizedPointCloud2D(**KW, n_layers=2),
                               iphi=models.IPhi(8), N=32, reg_weight=reg_weight,
                               track_grad_norm=True)
        state = pr.init(0, batch, "cpu")
        samples = torch.rand(2, 32, 2, generator=torch.Generator().manual_seed(4)) * 3 - 1
        want = lp_loss_rel(state.model.iphi(samples, torch.from_numpy(batch["rr"])),
                           samples).detach()
        loss_data, loss_reg, grads = pr.loss_and_grads(state, batch,
                                                       torch.Generator().manual_seed(4))
        assert float(loss_reg) == pytest.approx(float(want), rel=1e-6) and float(loss_reg) > 0
        _, metrics = pr.train_step(state, batch, torch.Generator().manual_seed(4))
        assert float(metrics["grad_norm"]) == pytest.approx(float(pr.grad_norm(grads)), rel=1e-5)
        results.append(grads)
    iphi_grad = lambda grads: grads[-1]  # iphi.fc4.bias, the last parameter
    assert not torch.equal(iphi_grad(results[0]), iphi_grad(results[1]))


# --- the builder and the commands -----------------------------------------------------
def _write_elasticity_files(root, n, n_points=30, seed=0):
    """rr ``[42, n]``, sigma ``[n_points, n]`` and XY ``[n_points, 2, n]`` as
    float64 .npy files under the registry's names."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for key, name, shape in (("rr_path", "rr", (42, n)), ("sigma_path", "sigma", (n_points, n)),
                             ("xy_path", "XY", (n_points, 2, n))):
        paths[key] = str(root / f"Random_UnitCell_{name}_10.npy")
        np.save(paths[key], rng.rand(*shape))
    return paths


def test_elasticity_builder_matches_jax(tmp_path):
    """Train the first, valid the ones before the test split, test the last;
    element for element, float32."""
    paths = _write_elasticity_files(tmp_path, 13)
    kw = dict(train_size=5, valid_size=3, test_size=4, batch_size=2)
    got, want = ElasticityBuilder(**paths, **kw), JaxElasticityBuilder(**paths, **kw)
    for split in ("train", "valid", "test"):
        a, b = getattr(got, f"{split}_data"), getattr(want, f"{split}_data")
        for k in ("xy", "rr", "sigma"):
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split} {k}")
    assert got.train_data["xy"].shape == (5, 30, 2) and got.valid_data["rr"].shape == (3, 42)
    assert got.test_data["sigma"].shape == (4, 30, 1)
    np.testing.assert_array_equal(got.valid_data["rr"],
                                  np.load(paths["rr_path"]).T[-7:-4].astype(np.float32))
    for k, v in got.inference_data().items():
        np.testing.assert_array_equal(v, want.inference_data()[k])
    assert got.batches_per_epoch == 3


@pytest.mark.parametrize("target,port", [
    ("fourierflow_tpu.models.FNOFactorizedPointCloud2D", models.FNOFactorizedPointCloud2D),
    ("fourierflow_tpu.models.FNOPointCloud2D", models.FNOPointCloud2D),
    ("fourierflow_tpu.models.FNOFullyFactorizedMesh2D", models.FNOFullyFactorizedMesh2D),
    ("fourierflow_tpu.models.IPhi", models.IPhi),
    ("fourierflow_tpu.routines.PointCloudRoutine", PointCloudRoutine),
    ("fourierflow_tpu.builders.ElasticityBuilder", ElasticityBuilder),
    ("fourierflow.modules.FNOFactorizedPointCloud2D", models.FNOFactorizedPointCloud2D),
    ("fourierflow.modules.IPhi", models.IPhi),
    ("fourierflow.routines.PointCloudExperiment", PointCloudRoutine),
    ("fourierflow.builders.ElasticityBuilder", ElasticityBuilder),
])
def test_targets_resolve_to_the_port(target, port):
    assert import_string(translate(target)) is port


SHRINK = ["builder.train_size=4", "builder.valid_size=2", "builder.test_size=2",
          "builder.batch_size=2", "routine.model.n_layers=2", "routine.model.width=8",
          "routine.iphi.width=8", "routine.model.modes1=3", "routine.model.modes2=3",
          "routine.model.s1=12", "routine.model.s2=12", "routine.N=16", "trainer.max_epochs=2"]


@pytest.mark.parametrize("name", ["elasticity/ffno/24_layers", "elasticity/geo-fno/4_layers"])
def test_train_test_predict_elasticity_by_name(name, tmp_path, monkeypatch):
    """The registry's files, tiny, under DATA_ROOT: ``train`` (4 steps,
    metrics with the IPhi term), ``test`` on its checkpoint (the same test
    loss) and ``predict``."""
    root = tmp_path / "data"
    _write_elasticity_files(root / "geo-fno/elasticity/Meshes", 8)
    monkeypatch.setenv("DATA_ROOT", str(root))
    run = str(tmp_path / "run")
    trainer, state = train.main(name, SHRINK, config_dir=run, device="cpu")
    assert trainer.global_step == state.step == 4
    rows = [json.loads(line) for line in next((tmp_path / "run/checkpoints").iterdir())
            .joinpath("metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(rows[0]["train_loss"]) and rows[0]["train_loss_reg"] > 0
    logs = test_command.main(name, overrides=SHRINK, config_dir=run, device="cpu")
    assert logs["test_loss"] == pytest.approx(trainer.logs["test_loss"], rel=1e-6)
    assert predict.main(name, overrides=SHRINK, device="cpu") > 0
