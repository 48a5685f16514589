"""The port's ``plot`` command (``commands/plot.py``) and heatmaps
(``viz/heatmap.py``) against the JAX package's, on the CPU.

Synthetic run trees (groups of ``checkpoints/trial-*/metrics.jsonl``, the
records written by the port's ``JSONLogger``), campaign logs, the timing
and super-resolution JSON files, HDF5 trajectories in both layouts and a
small ``sample.pkl``. What is held:

- ``table`` and ``reference_table`` (every dataset, markdown and
  ``--latex``): the JAX module's strings, to the character;
- ``_group_summary``, ``_correlation_curves``, the depth series behind
  ``layers`` and ``parameters``, ``_load_vorticity`` (with h5py and with the
  port's own HDF5 reader), ``_energy_spectrum``, ``midpoint_norm`` and the
  rows behind ``ablation``, ``stepsize``, ``tradeoff`` and
  ``superresolution`` (their printed tables to the character): JAX's to
  1e-12;
- every figure command writes its PNG (matplotlib is installed here), the
  ``plot`` subcommand runs them by name, and without matplotlib a figure
  stops with an error that names it while the tables still print;
- the modules import neither JAX, the JAX package nor matplotlib.
"""

import ast
import builtins
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from fourierflow_tpu.commands import plot as jax_plot
from fourierflow_tpu.viz import heatmap as jax_heatmap
from fourierflow_tpu_torch.commands import plot
from fourierflow_tpu_torch.commands.__main__ import main as cli
from fourierflow_tpu_torch.trainers.callbacks import JSONLogger
from fourierflow_tpu_torch.viz import heatmap

REPO = Path(__file__).resolve().parents[1]
PNG = b"\x89PNG"


class _Logs:
    def __init__(self):
        self.logs = {}


def _write_run(root, group, trial, rows):
    """``rows`` of logs, each written by a ``JSONLogger`` as an epoch's."""
    path = os.path.join(root, group, "checkpoints", f"trial-{trial}-{1000 + trial}",
                        "metrics.jsonl")
    logger, trainer = JSONLogger(path), _Logs()
    for row in rows:
        trainer.logs.update(row)
        logger.on_epoch_end(trainer, None, None)


def _campaign(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A run tree under ``root``, campaign logs, a tradeoff data directory,
    the step-size DNS and super-resolution JSON files."""
    base = tmp_path_factory.mktemp("plot")
    root = str(base / "runs")
    rng = np.random.RandomState(0)
    for dataset in ("airfoil", "elasticity"):
        for family, depths in (("ffno", (4, 8, 24)), ("geo-fno", (4, 12)),
                               ("ffno-shared", (16,))):
            for d in depths:
                for trial in range(1 + d % 3):
                    rows = [{"n_params": 1000 * d + trial, "train_loss": float(rng.rand()),
                             "valid_loss": float(rng.rand()), "epoch": e} for e in range(3)]
                    if family != "geo-fno":
                        rows.append({"test_loss": float(rng.rand()) / 10,
                                     "test_time_until": float(rng.rand())})
                    _write_run(root, f"{dataset}/{family}/{d}_layers", trial, rows)
    _write_run(root, "airfoil/ffno/20_layers", 0, [{"train_loss": 0.5}])  # no loss to summarise
    for group, prefix in (("torus_li/markov/4_layers", "test"),
                          ("torus_li/zongyi/8_layers", "valid"),
                          ("torus_li/ablation/teacher_forcing/12_layers", "test")):
        _write_run(root, group, 0, [{
            "n_params": 5000, f"{prefix}_loss": float(rng.rand()),
            f"{prefix}_correlations": list(np.linspace(1, 0.8, 10)),
            f"{prefix}_times": list(np.arange(1.0, 11.0)),
            f"{prefix}_step_losses": list(rng.rand(10)), "test_corr": 0.9}])
    for i, name in enumerate(("ffno_k1", "ffno_k4")):
        _campaign(os.path.join(root, "campaigns", name, "campaign_log.jsonl"),
                  [{"step": s, "train_loss": float(rng.rand()),
                    "valid_time_until": float(s + i), "valid_loss": float(rng.rand()),
                    "correlations": list(np.linspace(1, 0.5 + 0.1 * s, 6))} for s in range(3)])
    data_dir = str(base / "kochkov")
    timings = []
    for tag, arch, layers in (("ffno", "ffno", 4), ("ffno_8", "ffno", 8), ("zongyi_4", "zongyi", 4),
                              ("orphan", "ffno", 12)):
        timings.append({"tag": tag, "arch": arch, "n_layers": layers,
                        "inference_time": float(rng.rand())})
        if tag == "ffno":
            _campaign(os.path.join(data_dir, "campaign_log.jsonl"),
                      [{"valid_loss": float(rng.rand())}])
        elif tag != "orphan":
            _campaign(os.path.join(data_dir, "runs", tag, "campaign_log.jsonl"),
                      [{"valid_loss": float(rng.rand())}, {"valid_loss": float(rng.rand())}])
    timings.append(dict(timings[0], inference_time=0.25))  # the last timing of a tag counts
    with open(os.path.join(data_dir, "runs", "inference_times.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(t) for t in timings) + "\n")
    dns = str(base / "stepsize_dns.json")
    with open(dns, "w") as f:
        json.dump([{"step_size": s, "time_until": 4.0 / s} for s in (0.02, 0.01, 0.04)], f)
    superres = str(base / "superres.json")
    with open(superres, "w") as f:
        json.dump({str(n): {"corr": 1 - n / 1000, "time_until": n / 10,
                            "correlations": list(np.linspace(1, 0.7, 5)),
                            "times": list(np.arange(5.0))} for n in (128, 32, 64)}, f)
    campaigns = [f"{v}={os.path.join(root, 'campaigns', n, 'campaign_log.jsonl')}"
                 for v, n in ((0.28, "ffno_k4"), (0.07, "ffno_k1"))]
    return {"root": root, "base": str(base), "data_dir": data_dir, "dns": dns,
            "superres": superres, "campaigns": campaigns}


@pytest.fixture(scope="module")
def h5_files(tree):
    """Predictions (``[sample, x, y, time]`` with axis vectors) and
    generated trajectories (``[traj, time, x, y]`` with ``elapsed``; one
    with velocities), written by h5py."""
    rng = np.random.RandomState(1)
    out = {}
    pred = os.path.join(tree["base"], "pred.h5")
    with h5py.File(pred, "w") as f:
        f["vorticity"] = rng.randn(2, 16, 16, 24).astype(np.float32)
        f["vx"] = rng.randn(2, 16, 16, 24).astype(np.float32)
        f["vy"] = rng.randn(2, 16, 16, 24).astype(np.float32)
        f["x"] = f["y"] = np.arange(16, dtype=np.float32)
        f["time"] = np.arange(24, dtype=np.float32)
    out["pred"] = pred
    gen = os.path.join(tree["base"], "dns.h5")
    with h5py.File(gen, "w") as f:
        f["vorticity"] = rng.randn(3, 16, 16, 16).astype(np.float32)  # time == grid size
        f["elapsed"] = np.float64(1.0)
        f["time"] = np.arange(16, dtype=np.float32)
    out["dns"] = gen
    return out


# --- the tables ---------------------------------------------------------------------------
@pytest.mark.parametrize("latex", [False, True])
@pytest.mark.parametrize("dataset", sorted(plot.REFERENCE_TABLES))
def test_reference_table_equals_jax(tree, dataset, latex, capsys):
    want = jax_plot.reference_table(dataset, tree["root"], latex=latex)
    printed = capsys.readouterr().out
    got = plot.reference_table(dataset, tree["root"], latex=latex)
    assert got == want and capsys.readouterr().out == printed
    assert plot.REFERENCE_TABLES[dataset] == jax_plot.REFERENCE_TABLES[dataset]


@pytest.mark.parametrize("keys", [None, ["test_loss", "n_params", "test_corr", "missing"]])
def test_table_equals_jax(tree, keys, tmp_path):
    want = jax_plot.table(tree["root"], keys=keys, out_path=str(tmp_path / "jax.md"))
    got = plot.table(tree["root"], keys=keys, out_path=str(tmp_path / "port.md"))
    assert got == want and "airfoil/ffno/4_layers" in got
    assert (tmp_path / "port.md").read_text() == (tmp_path / "jax.md").read_text()
    assert plot.table(tree["root"], dataset="airfoil", latex=True) == jax_plot.reference_table(
        "airfoil", tree["root"], latex=True)


def test_unknown_reference_table_raises(tree):
    with pytest.raises(SystemExit, match="unknown table 'torus'"):
        plot.reference_table("torus", tree["root"])


# --- the data behind the figures ------------------------------------------------------------
def _close(got, want, what=""):
    """Nested dicts, lists and tuples of numbers equal to 1e-12 (NaN to NaN)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)) and not np.isscalar(want):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{what}[{i}]")
    elif want is None or isinstance(want, str):
        assert got == want, what
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=1e-12, atol=0, err_msg=what)


def test_group_summary_equals_jax(tree):
    groups = plot.collect_groups(tree["root"])
    assert groups.keys() == jax_plot.collect_groups(tree["root"]).keys() and len(groups) > 10
    for group, trials in groups.items():
        _close(plot._group_summary(trials), jax_plot._group_summary(trials), group)
    assert plot._group_summary(groups["airfoil/ffno/20_layers"]) is None


def test_depth_series_equal_jax(tree):
    def stats(trials):
        s = jax_plot._group_summary(trials)
        return None if s is None else (s["nmse_mean"], s["nmse_min"], s["nmse_max"])

    def count(trials):
        s = jax_plot._group_summary(trials)
        return s["n_params"] if s and s["n_params"] else None

    _close(plot._layers_series(tree["root"]), jax_plot._depth_series(tree["root"], stats))
    _close(plot._parameters_series(tree["root"]), jax_plot._depth_series(tree["root"], count))
    assert "airfoil/ffno" in plot._layers_series(tree["root"])


def test_correlation_curves_equal_jax(tree):
    got = plot._correlation_curves(tree["root"])
    _close(got, jax_plot._correlation_curves(tree["root"]))
    assert any(k.endswith("campaign_log.jsonl") for k in got) and len(got) == 5


def _without_h5py(monkeypatch):
    real_import = builtins.__import__

    def refuse(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", refuse)


@pytest.mark.parametrize("reader", ["h5py", "port"])
@pytest.mark.parametrize("which", ["pred", "dns"])
def test_load_vorticity_and_energy_spectrum_equal_jax(h5_files, which, reader, monkeypatch):
    want = jax_plot._load_vorticity(h5_files[which])
    if reader == "port":
        _without_h5py(monkeypatch)
    got = plot._load_vorticity(h5_files[which])
    monkeypatch.undo()
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    assert got[0].shape == ((2, 16, 16, 24) if which == "pred" else (3, 16, 16, 16))
    for args in (got, got[:1]):  # with the velocities where the file has them, and recovered
        k, e = plot._energy_spectrum(*args)
        want_k, want_e = jax_plot._energy_spectrum(*[a for a in want[:len(args)]])
        np.testing.assert_array_equal(k, want_k)
        np.testing.assert_allclose(e, want_e, rtol=1e-12, atol=0)


def test_energy_curves_equal_jax(h5_files, tmp_path):
    inputs = [f"dns={h5_files['dns']}", h5_files["pred"], f"dns={h5_files['dns']}"]
    got = plot._energy_curves(inputs, tail=8)
    assert list(got) == ["dns", "pred.h5", "dns'"]
    want = jax_plot.energy(inputs, out_path=str(tmp_path / "jax.png"), tail=8)
    # JAX's energy returns its curves only without matplotlib: recompute them as it does.
    assert want == str(tmp_path / "jax.png")
    for name, path in (("dns", h5_files["dns"]), ("pred.h5", h5_files["pred"])):
        w, vx, vy = jax_plot._load_vorticity(path)
        k, e = jax_plot._energy_spectrum(w[..., -8:], *(None if v is None else v[..., -8:]
                                                        for v in (vx, vy)))
        np.testing.assert_allclose(got[name][1], k[1:] ** 5.0 * e[1:], rtol=1e-12, atol=0)


@pytest.mark.parametrize("midpoint", [0.0, 0.3, -2.0])
def test_midpoint_norm_equals_jax(midpoint):
    x = np.random.RandomState(2).randn(7, 5) * 3
    np.testing.assert_allclose(heatmap.midpoint_norm(x, midpoint),
                               jax_heatmap.midpoint_norm(x, midpoint), rtol=1e-12, atol=0)
    np.testing.assert_allclose(heatmap.midpoint_norm(np.zeros(3)),
                               jax_heatmap.midpoint_norm(np.zeros(3)), rtol=1e-12, atol=0)


def test_ablation_rows_and_table_equal_jax(tree, tmp_path, capsys):
    metrics = ["valid_time_until", "train_loss", "valid_loss"]
    jax_plot.ablation(tree["campaigns"], str(tmp_path / "jax.png"), xlabel="dt", metrics=metrics)
    want = capsys.readouterr().out
    assert plot.ablation(tree["campaigns"], str(tmp_path / "port.png"), xlabel="dt",
                         metrics=metrics) == str(tmp_path / "port.png")
    assert capsys.readouterr().out == want and "| 0.07 |" in want
    rows = plot._ablation_rows(tree["campaigns"], metrics)
    _close(rows, sorted(((float(i.split("=")[0]), jax_plot._final_campaign_metrics(
        i.split("=", 1)[1], metrics)) for i in tree["campaigns"]), key=lambda r: r[0]))


def test_stepsize_rows_and_table_equal_jax(tree, tmp_path, capsys):
    jax_plot.stepsize(tree["campaigns"], tree["dns"], str(tmp_path / "jax.png"))
    want = capsys.readouterr().out
    plot.stepsize(tree["campaigns"], tree["dns"], str(tmp_path / "port.png"))
    assert capsys.readouterr().out == want
    model_rows, dns_rows = plot._stepsize_rows(tree["campaigns"], tree["dns"])
    _close(model_rows, [(0.07, 2.0), (0.28, 3.0)])
    _close(dns_rows, [(0.01, 400.0), (0.02, 200.0), (0.04, 100.0)])


def test_tradeoff_rows_and_table_equal_jax(tree, tmp_path, capsys):
    jax_plot.tradeoff(tree["data_dir"], str(tmp_path / "jax.png"), dns=["spectral=3.5"])
    want = capsys.readouterr().out
    plot.tradeoff(tree["data_dir"], str(tmp_path / "port.png"), dns=["spectral=3.5"])
    assert capsys.readouterr().out == want
    rows = plot._tradeoff_rows(tree["data_dir"])
    assert [r["tag"] for r in rows] == ["ffno", "ffno_8", "zongyi_4"]
    assert rows[0]["inference_time"] == 0.25
    for r in rows:
        log = (os.path.join(tree["data_dir"], "campaign_log.jsonl") if r["tag"] == "ffno" else
               os.path.join(tree["data_dir"], "runs", r["tag"], "campaign_log.jsonl"))
        _close(r["nmse_pct"], 100.0 * jax_plot._final_campaign_metrics(log, ["valid_loss"])[
            "valid_loss"])


def test_superresolution_rows_and_table_equal_jax(tree, tmp_path, capsys):
    jax_plot.superresolution(tree["superres"], str(tmp_path / "jax.png"), train_size=64)
    want = capsys.readouterr().out
    plot.superresolution(tree["superres"], str(tmp_path / "port.png"), train_size=64)
    assert capsys.readouterr().out == want and "64² (train)" in want
    sizes, corr, tu, _ = plot._superresolution_rows(tree["superres"])
    assert sizes == [32, 64, 128]
    _close(corr, [0.968, 0.936, 0.872])
    _close(tu, [3.2, 6.4, 12.8])


# --- the figures ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sample_pkl(tree):
    """A ``sample`` command's pickle: ``[batch, preds]``, numpy."""
    rng = np.random.RandomState(3)
    path = os.path.join(tree["base"], "sample.pkl")
    with open(path, "wb") as f:
        pickle.dump([{"data": rng.randn(2, 16, 16, 5).astype(np.float32)},
                     rng.randn(2, 16, 16, 5).astype(np.float32)], f)
    return path


def _figures(tree, h5_files, sample_pkl, out):
    """``{command: a call of it writing into out}``."""
    root = tree["root"]
    inputs = [f"dns={h5_files['dns']}", f"model={h5_files['pred']}"]
    return {
        "layers": lambda: plot.layers(root, out_path=out),
        "parameters": lambda: plot.parameters(root, out_path=out),
        "correlation": lambda: plot.correlation(root, out_path=out),
        "step_losses": lambda: plot.step_losses(root, out_path=out),
        "energy": lambda: plot.energy(inputs, out_path=out, tail=8),
        "flows": lambda: plot.flows(inputs, out_path=out, times=[0, 3, 30]),
        "ablation": lambda: plot.ablation(tree["campaigns"], out_path=out),
        "stepsize": lambda: plot.stepsize(tree["campaigns"], tree["dns"], out_path=out),
        "tradeoff": lambda: plot.tradeoff(tree["data_dir"], out_path=out, dns=["dns=2.0"]),
        "superresolution": lambda: plot.superresolution(tree["superres"], out_path=out),
        "heatmap": lambda: plot.heatmap(sample_pkl, out_prefix=out[:-4])[0],
    }


FIGURES = ["layers", "parameters", "correlation", "step_losses", "energy", "flows", "ablation",
           "stepsize", "tradeoff", "superresolution", "heatmap"]


@pytest.mark.parametrize("name", FIGURES)
def test_figure_writes_its_png(tree, h5_files, sample_pkl, tmp_path, name, capsys):
    out = str(tmp_path / f"{name}.png")
    written = _figures(tree, h5_files, sample_pkl, out)[name]()
    path = written if name != "heatmap" else str(tmp_path / f"{name}_pred.png")
    assert written == path and Path(path).read_bytes()[:4] == PNG


def test_heatmap_writes_prediction_and_target(sample_pkl, tmp_path):
    outs = plot.heatmap(sample_pkl, step=2, out_prefix=str(tmp_path / "f"))
    assert outs == [str(tmp_path / "f_pred.png"), str(tmp_path / "f_target.png")]
    assert all(Path(p).read_bytes()[:4] == PNG for p in outs)
    with pytest.raises(SystemExit, match="--sample-path"):
        plot.heatmap(None)


@pytest.mark.parametrize("name", FIGURES)
def test_figure_without_matplotlib_stops_and_says_so(tree, h5_files, sample_pkl, tmp_path, name,
                                                     monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises ImportError
    with pytest.raises(SystemExit, match="needs matplotlib"):
        _figures(tree, h5_files, sample_pkl, str(tmp_path / "x.png"))[name]()
    assert not (tmp_path / "x.png").exists()


def test_tables_run_without_matplotlib(tree, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plot.reference_table("airfoil", tree["root"]) == jax_plot.reference_table(
        "airfoil", tree["root"])
    assert "| run |" in plot.table(tree["root"])


# --- the subcommand -------------------------------------------------------------------------
def test_plot_subcommand_table(tree, capsys):
    cli(["plot", "table", "elasticity", "--root", tree["root"], "--latex"])
    assert capsys.readouterr().out.strip() == jax_plot.reference_table(
        "elasticity", tree["root"], latex=True).strip()


@pytest.mark.parametrize("args,out", [
    (["layers"], "layers.png"), (["step-losses"], "step_losses.png"),
    (["parameters"], "parameters.png"), (["correlation"], "correlation.png"),
    (["heatmap"], "field_pred.png"), (["superresolution"], "superresolution.png"),
    (["stepsize"], "stepsize.png"), (["tradeoff"], "tradeoff.png"),
    (["energy"], "energy.png"), (["flows"], "samples.png"), (["ablation"], "ablation.png")])
def test_plot_subcommand_figures(tree, h5_files, sample_pkl, tmp_path, monkeypatch, args, out):
    monkeypatch.chdir(tmp_path)
    extra = {"heatmap": ["--sample-path", sample_pkl],
             "superresolution": [tree["superres"]],
             "stepsize": [tree["dns"], "--inputs", *tree["campaigns"]],
             "tradeoff": [tree["data_dir"], "--inputs", "dns=2.0"],
             "energy": ["--inputs", h5_files["dns"], "--tail", "4"],
             "flows": ["--inputs", h5_files["pred"], "--times", "0", "5"],
             "ablation": ["--inputs", *tree["campaigns"], "--metrics", "train_loss"]}
    cli(["plot", *args, "--root", tree["root"], *extra.get(args[0], [])])
    assert (tmp_path / out).read_bytes()[:4] == PNG


# --- the import guard -----------------------------------------------------------------------
NEW_MODULES = ["fourierflow_tpu_torch/commands/plot.py", "fourierflow_tpu_torch/viz/__init__.py",
               "fourierflow_tpu_torch/viz/heatmap.py"]


@pytest.mark.parametrize("path", NEW_MODULES)
def test_module_imports_no_jax_and_no_matplotlib_at_import(path):
    """No import of JAX, flax, the JAX package or matplotlib outside a
    function (matplotlib is imported when a figure is drawn)."""
    tree = ast.parse((REPO / path).read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    every = [n for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = lambda nodes: [a.name if isinstance(n, ast.Import) else (n.module or "")
                           for n in nodes for a in (n.names if isinstance(n, ast.Import) else [n])]
    forbidden = ("jax", "flax", "optax", "fourierflow_tpu")
    assert not [m for m in names(every)
                if m.split(".")[0] in forbidden and not m.startswith("fourierflow_tpu_torch")]
    assert not [m for m in names(top) if m.split(".")[0] == "matplotlib"]


def test_importing_plot_loads_no_matplotlib():
    code = ("import sys, fourierflow_tpu_torch.commands.plot, fourierflow_tpu_torch.viz; "
            "print('matplotlib' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.stdout.split() == ["False", "False"]
