"""The port's ``test``, ``predict``, ``sample`` and ``export`` commands, and
``infer --torch-checkpoint``, on the CPU at a tiny size.

One small h5 file of trajectories and one reference (Lightning) F-FNO
checkpoint go through the JAX package's ``test`` command and the port's;
the port's checkpoint search, its inference timing with and without a
config, its sample pickle and its export command end to end; and each
command's refusal to run on the CPU unless asked.
"""

import os
import pickle

import h5py
import numpy as np
import pytest
import torch
import yaml

from fourierflow_tpu.commands.test import main as jax_test_main
from fourierflow_tpu_torch.commands import export, infer, predict, sample
from fourierflow_tpu_torch.commands import test as test_command
from fourierflow_tpu_torch.commands.__main__ import main as cli
from fourierflow_tpu_torch.commands.train import build_routine, restore_state
from fourierflow_tpu_torch.config import instantiate, load_config
from fourierflow_tpu_torch.utils.checkpoint import save_state
from fourierflow_tpu_torch.utils.serving import load_exported, make_rollout_fn
from test_torch_serving import FFNO, GRID, ffno_reference_state_dict

LOSS_RTOL = 1e-4  # the test loss through both packages, float32 on the CPU
ARTIFACT_RTOL = 1e-6  # the exported rollout against the live serving module
N_STEPS = 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(config path, reference checkpoint path): 12 trajectories [16, 16, 10]
    in an h5 file, a config that both packages read (the port translates
    the JAX package's targets), and a Lightning checkpoint."""
    tmp = tmp_path_factory.mktemp("commands")
    rng = np.random.RandomState(0)
    t = np.arange(10)[None, None, None, :]
    data = rng.randn(12, GRID, GRID, 1) + 0.1 * t * rng.randn(12, GRID, GRID, 1)
    with h5py.File(tmp / "ns.h5", "w") as f:
        f.create_dataset("u", data=data.astype(np.float32))
    cfg = {
        "builder": {"_target_": "fourierflow_tpu.builders.NSMarkovBuilder",
                    "data_path": str(tmp / "ns.h5"), "train_size": 8, "test_size": 4, "ssr": 1,
                    "batch_size": 4},
        "routine": {"_target_": "fourierflow_tpu.routines.Grid2DMarkovRoutine",
                    "conv": {"_target_": "fourierflow_tpu.models.FNOFactorized2DBlock", **FFNO},
                    "n_steps": N_STEPS, "max_accumulations": 100},
        "trainer": {"max_epochs": 1},
    }
    os.makedirs(tmp / "exp")
    cfg_path = tmp / "exp" / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    ckpt = tmp / "ref.ckpt"
    torch.save({"state_dict": ffno_reference_state_dict(), "epoch": 3}, ckpt)
    return str(cfg_path), str(ckpt)


def _state(cfg_path, **restore):
    cfg = load_config(cfg_path)
    builder = instantiate(cfg["builder"])
    routine = build_routine(cfg["routine"], builder)
    return builder, routine, restore_state(routine, builder, "cpu", **restore)


def test_test_command_on_reference_checkpoint_matches_jax(files):
    cfg_path, ckpt = files
    want = jax_test_main(cfg_path, torch_checkpoint=ckpt)
    got = test_command.main(cfg_path, torch_checkpoint=ckpt, device="cpu")
    assert np.isfinite(got["test_loss"])
    for k in ("test_loss", "test_loss_avg"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=LOSS_RTOL, err_msg=k)


def test_find_checkpoint_prefers_best_and_raises_without_one(files, tmp_path):
    cfg_path, _ = files
    with pytest.raises(FileNotFoundError, match="trial-0"):
        test_command.find_checkpoint(cfg_path, 0, config_dir=str(tmp_path))
    older, newer = (tmp_path / "checkpoints" / f"trial-0-{t}" for t in (100, 200))
    for d in (older, newer):
        os.makedirs(d)
        (d / "last.ckpt").write_bytes(b"")
    assert test_command.find_checkpoint(cfg_path, 0, str(tmp_path)) == str(newer / "last.ckpt")
    (older / "best.ckpt").write_bytes(b"")
    assert test_command.find_checkpoint(cfg_path, 0, str(tmp_path)) == str(older / "best.ckpt")
    with pytest.raises(FileNotFoundError):
        test_command.find_checkpoint(cfg_path, 1, str(tmp_path))


def test_test_command_port_checkpoint_equals_reference_checkpoint(files, tmp_path):
    """The same weights through the port's checkpoint (found by
    find_checkpoint) and through the Lightning file give the same logs."""
    cfg_path, ckpt = files
    _, _, state = _state(cfg_path, torch_checkpoint=ckpt)
    save_state(str(tmp_path / "checkpoints" / "trial-0-1" / "last.ckpt"), state)
    got = test_command.main(cfg_path, config_dir=str(tmp_path), device="cpu")
    want = test_command.main(cfg_path, torch_checkpoint=ckpt, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_predict_with_and_without_config(files):
    cfg_path, _ = files
    per = predict.main(cfg_path, device="cpu")
    assert np.isfinite(per) and per > 0
    dns = predict.time_dns_baseline(n_samples=2, s=16, steps=2, inner=5, device="cpu")
    assert np.isfinite(dns) and dns > 0


def test_predict_without_config_times_the_dns_baseline(monkeypatch):
    calls = []
    monkeypatch.setattr(predict, "time_dns_baseline", lambda device=None: calls.append(device))
    cli(["predict", "--device", "cpu"])
    assert calls == ["cpu"]


def test_sample_writes_a_pickle_that_loads(files, tmp_path):
    cfg_path, _ = files
    out = sample.main(cfg_path, out_path=str(tmp_path / "s.pkl"), device="cpu")
    with open(out, "rb") as f:
        batch, preds = pickle.load(f)
    assert batch["data"].shape == (4, GRID, GRID, 10)
    assert preds.shape == (4, GRID, GRID, N_STEPS) and np.isfinite(preds).all()


def test_export_cli_end_to_end(files, tmp_path, capsys):
    cfg_path, ckpt = files
    path = str(tmp_path / "rollout.pt2")
    cli(["export", cfg_path, path, "--torch-checkpoint", ckpt, "--n-steps", "3", "--batch-size",
         "2", "--size", str(GRID), "--precision", "highest", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"'out_path': '{path}', 'n_steps': 3, 'batch_size': 2, 'size': {GRID}" in printed
    _, routine, state = _state(cfg_path, torch_checkpoint=ckpt)
    w0 = torch.from_numpy(np.random.RandomState(2).randn(2, GRID, GRID, 1).astype(np.float32))
    with torch.no_grad():
        live = make_rollout_fn(routine, state, 3)(w0)
    torch.testing.assert_close(load_exported(path)(w0), live, rtol=ARTIFACT_RTOL, atol=0)
    with pytest.raises(ValueError, match="precision 'default'"):
        export.main(cfg_path, path, torch_checkpoint=ckpt, n_steps=2, size=GRID,
                    precision="default", device="cpu")


def test_infer_takes_a_reference_checkpoint(files):
    cfg_path, ckpt = files
    run = infer.main(cfg_path, torch_checkpoint=ckpt, n_steps=3, device="cpu")
    assert run.result["preds"].shape == (4, GRID, GRID, 3)
    assert float(run.state.normalizer.count) == 37.0
    assert torch.equal(run.state.model.in_proj.weight_v,
                       ffno_reference_state_dict()["conv.in_proj.weight_v"])


@pytest.mark.parametrize("command", ["test", "predict", "sample", "export"])
def test_commands_raise_without_gpu_unless_cpu_requested(command, files, monkeypatch, tmp_path):
    cfg_path, ckpt = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"test": ["test", cfg_path, "--torch-checkpoint", ckpt],
            "predict": ["predict"],
            "sample": ["sample", cfg_path, "--out-path", str(tmp_path / "s.pkl")],
            "export": ["export", cfg_path, str(tmp_path / "a.pt2"), "--size", str(GRID)]}[command]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(args)
    assert not (tmp_path / "s.pkl").exists() and not (tmp_path / "a.pt2").exists()

