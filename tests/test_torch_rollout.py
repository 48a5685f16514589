"""The port's rollout slice against the JAX package's, on the CPU.

A tiny trajectory file [8, 16, 16, 6] goes through ``NSMarkovBuilder`` ->
the normalizer's ``accumulate_step`` -> a 3-step ``rollout`` ->
``compute_losses`` in both packages with the same weights. Then the port's
``infer`` entry point runs the flagship config, shrunk by overrides, on
the CPU, from a checkpoint written by the port.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu.builders import NSMarkovBuilder as JaxBuilder
from fourierflow_tpu.builders.base import iterate_batches as jax_iterate_batches
from fourierflow_tpu.models import FNOFactorized2DBlock as JaxBlock
from fourierflow_tpu.routines import Grid2DMarkovRoutine as JaxRoutine
from fourierflow_tpu_torch.builders import NSMarkovBuilder, iterate_batches
from fourierflow_tpu_torch.commands import infer
from fourierflow_tpu_torch.config import instantiate, load_config, translate
from fourierflow_tpu_torch.models import FNOFactorized2DBlock
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.utils.checkpoint import load_state, save_state
from fourierflow_tpu_torch.utils.weights import state_dict_from_flax

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs/torus_li/markov/24_layers.yaml")
MODEL = dict(modes=4, width=16, input_dim=3, n_layers=4, share_weight=True, factor=4,
             ff_weight_norm=True, gain=0.1)
SHRINK = ["routine.conv.n_layers=2", "routine.conv.width=8", "routine.conv.modes=4"]


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    rng = np.random.RandomState(11)
    t = np.arange(6)[None, None, None, :]
    base = rng.randn(8, 16, 16, 1).astype(np.float32)
    drift = rng.randn(8, 16, 16, 1).astype(np.float32)
    path = tmp_path_factory.mktemp("data") / "traj.npy"
    np.save(path, (base + 0.1 * t * drift).astype(np.float32))
    return str(path)


def _accumulate(routine, state, builder, batches):
    for batch in batches(builder.train_data, 4):
        state = routine.accumulate_step(state, batch)
    return state


@pytest.fixture(scope="module")
def both(data_path):
    """(jax routine, jax state, port routine, port state, test batch)."""
    jb = JaxBuilder(data_path, train_size=4, test_size=4, batch_size=4)
    jr = JaxRoutine(model=JaxBlock(**MODEL), n_steps=3, max_accumulations=1000)
    js = _accumulate(jr, jr.init(jax.random.PRNGKey(0), jb.sample_batch()), jb,
                     jax_iterate_batches)

    pb = NSMarkovBuilder(data_path, train_size=4, test_size=4, batch_size=4)
    for k in jb.train_data:
        np.testing.assert_array_equal(pb.train_data[k], jb.train_data[k])
    pr = Grid2DMarkovRoutine(model=FNOFactorized2DBlock(**MODEL), n_steps=3, max_accumulations=1000)
    ps = pr.init(0, pb.sample_batch(), "cpu")
    ps.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params),
                                                  MODEL["n_layers"]))
    ps = _accumulate(pr, ps, pb, iterate_batches)
    return jr, js, pr, ps, next(pb.test_batches())


def test_normalizer_matches_jax(both):
    _, js, _, ps, _ = both
    for f in ("mean", "std"):
        np.testing.assert_allclose(getattr(ps.normalizer, f).numpy(),
                                   np.asarray(getattr(js.normalizer, f)), rtol=1e-5)
    assert ps.normalizer.count.item() == float(js.normalizer.count)


def test_rollout_and_metrics_match_jax(both):
    jr, js, pr, ps, batch = both
    jpreds, jlosses, jyy = jr.rollout(js, {"data": jnp.asarray(batch["data"])})
    want = jax.tree.map(np.asarray, jr.compute_losses(jpreds, jlosses, jyy))
    preds, losses, yy = pr.rollout(ps, {"data": torch.from_numpy(batch["data"])})
    assert preds.shape == (4, 16, 16, 3)
    jpreds = np.asarray(jpreds)
    err = np.max(np.abs(preds.numpy() - jpreds))
    assert err <= 1e-4 * np.max(np.abs(jpreds)), err
    np.testing.assert_array_equal(yy.numpy(), np.asarray(jyy))
    got = pr.compute_losses(preds, losses, yy)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    valid = pr.valid_step(ps, {"data": torch.from_numpy(batch["data"])})
    np.testing.assert_allclose(valid["loss"].numpy(), want["loss"], rtol=1e-4)


def test_learn_difference_rollout_matches_jax(both):
    jr, js, pr, ps, batch = both
    jr.learn_difference = pr.learn_difference = True
    try:
        jpreds, jlosses, _ = jr.rollout(js, {"data": jnp.asarray(batch["data"])})
        preds, losses, _ = pr.rollout(ps, {"data": torch.from_numpy(batch["data"])})
    finally:
        jr.learn_difference = pr.learn_difference = False
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)


def test_compute_losses_reads_nan_as_9999(both):
    _, _, pr, _, _ = both
    preds = torch.full((2, 4, 4, 3), float("nan"))
    m = pr.compute_losses(preds, torch.full((3,), float("nan")), torch.ones(2, 4, 4, 3))
    assert m["loss"].item() == pytest.approx(9999.9) and m["loss_avg"].item() == pytest.approx(9999.9)


def test_rollout_clamps_the_horizon(both):
    _, _, pr, ps, batch = both
    pr.n_steps = 50
    try:
        preds, losses, _ = pr.rollout(ps, {"data": torch.from_numpy(batch["data"])})
    finally:
        pr.n_steps = 3
    assert preds.shape[-1] == losses.shape[0] == 5


def test_config_translates_jax_targets_once():
    assert translate("fourierflow_tpu.models.FNOFactorized2DBlock") == \
        "fourierflow_tpu_torch.models.FNOFactorized2DBlock"
    assert translate("fourierflow_tpu_torch.models.FNOFactorized2DBlock") == \
        "fourierflow_tpu_torch.models.FNOFactorized2DBlock"
    assert translate("fourierflow_tpuX.a") == "fourierflow_tpuX.a"
    assert translate("fourierflow.routines.Grid2DMarkovExperiment") == \
        "fourierflow_tpu_torch.routines.Grid2DMarkovRoutine"


def test_flagship_config_builds_port_objects(data_path):
    cfg = load_config(CONFIG, [f"builder.data_path={data_path}", "builder.train_size=4",
                               "builder.test_size=4", *SHRINK])
    assert cfg["routine"]["conv"]["n_layers"] == 2
    assert isinstance(instantiate(cfg["builder"]), NSMarkovBuilder)
    model = instantiate(cfg["routine"]["conv"])
    assert isinstance(model, FNOFactorized2DBlock) and len(model.spectral_layers) == 2


def test_infer_on_cpu_from_a_port_checkpoint(data_path, tmp_path, capsys):
    overrides = [f"builder.data_path={data_path}", "builder.train_size=4", "builder.test_size=4",
                 "builder.batch_size=4", *SHRINK]
    first = infer.main(CONFIG, overrides=overrides, n_steps=3, device="cpu")
    with torch.no_grad():
        for p in first.state.model.parameters():
            p.mul_(1.5)
    ckpt = str(tmp_path / "state.pt")
    save_state(ckpt, first.state)

    run = infer.main(CONFIG, ckpt, overrides=overrides, n_steps=3, device="cpu")
    printed = capsys.readouterr().out
    assert "'shape': (4, 16, 16, 3)" in printed and "inference_time" in printed
    assert run.result["shape"] == (4, 16, 16, 3) and run.result["elapsed"] > 0
    assert run.result["kernel_launches"] == {"fused_ff": 0, "fused_ff_bwd": 0, "fused_mix_2d": 0,
                                             "fused_mix_2d_adjoint": 0}
    restored = load_state(ckpt, run.state)
    want, _, _ = run.routine.rollout(restored, run.batch)
    torch.testing.assert_close(run.result["preds"], want)
    assert torch.isfinite(run.result["preds"]).all()


def test_infer_cli_on_cpu(data_path, capsys):
    from fourierflow_tpu_torch.commands.__main__ import main

    main(["infer", CONFIG, f"builder.data_path={data_path}", "builder.train_size=4",
          "builder.test_size=4", "builder.batch_size=2", *SHRINK, "--n-steps", "8",
          "--device", "cpu"])
    assert "'shape': (2, 16, 16, 8)" in capsys.readouterr().out
