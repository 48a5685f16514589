"""``plot`` command: the paper's figures and tables from local run logs
(counterpart of ``fourierflow_tpu/commands/plot.py``).

Every number comes from files that runs leave on disk: the
``metrics.jsonl`` that the ``JSONLogger`` callback writes into each run's
``<group>/checkpoints/trial-<n>-<time>/`` (``commands/train.py``), the
``campaign_log.jsonl`` of long campaigns, the predictions and trajectories
of ``save_predictions`` and ``generate kolmogorov`` (HDF5), the pickle of
the ``sample`` command (``sample.pkl`` in the experiment's directory, or
wherever ``--out-path`` put it), and the JSON files of the timing and
super-resolution scripts. The reference reads its numbers from a Weights &
Biases account instead.

- ``table torus_li|airfoil|elasticity|plasticity|pipe``: the paper's Tables
  A.3-A.6 (per model family and depth: parameters, N-MSE (%) mean, min and
  max over the trials, train hours), as markdown or with ``--latex`` the
  reference's LaTeX rows; ``table`` alone: the final metrics of every run.
- ``layers``, ``parameters``: N-MSE (with its min-max band) and the
  parameter count against depth, per family.
- ``correlation``, ``step-losses``: the logged rho(t) curves (campaign logs
  too) and per-step N-MSE curves.
- ``energy``, ``flows``: k^5 E(k) spectra and vorticity snapshots of
  ``name=path.h5`` files.
- ``heatmap``: prediction and target of a ``sample.pkl``.
- ``ablation``, ``stepsize``, ``tradeoff``, ``superresolution``: a table
  printed and a figure of campaign logs and the scripts' JSON files.

This is host code in numpy: nothing runs on a device. matplotlib is
imported when a figure is drawn (``viz.heatmap.pyplot``); without it a
figure command stops with an error that says so, after printing its table
where it has one. The tables need no matplotlib, and the HDF5 files are
read with h5py or, where it is missing, with ``utils.hdf5``.
"""

import glob
import json
import logging
import os
import pickle
import re
from typing import List, Optional

import numpy as np

from ..viz.heatmap import log_imshow, pyplot

logger = logging.getLogger(__name__)

__all__ = ["collect_runs", "collect_groups", "layers", "correlation", "step_losses",
           "parameters", "table", "reference_table", "heatmap", "energy", "flows",
           "superresolution", "ablation", "tradeoff", "stepsize"]

# The reference's Tables A.3-A.6: rows are (display name, registry family,
# depths); the families carry the reference's group names.
_LAYERS_SHORT = [4, 8, 12, 16, 20]
_LAYERS_FULL = [4, 8, 12, 16, 20, 24]
_GEO_ROWS = [
    ("geo-FNO (reproduced)", "geo-fno", [4, 8, 12]),
    ("F-FNO (with weight sharing)", "ffno-shared", _LAYERS_FULL),
    ("F-FNO (without weight sharing)", "ffno", _LAYERS_FULL),
]
REFERENCE_TABLES = {
    # Table A.3
    "torus_li": [
        ("FNO (reproduced)", "zongyi", _LAYERS_SHORT),
        ("FNO-TF (FNO with teacher forcing)", "ablation/teacher_forcing", _LAYERS_SHORT),
        ("FNO-M (FNO-TF with Markov assumption)", "ablation/zongyi_markov", _LAYERS_SHORT),
        ("FNO-R (FNO-M with improved residuals)", "ablation/zongyi_markov_residual", _LAYERS_FULL),
        ("FNO++ (FNO-R with bags of tricks)", "ablation/no_factorization", _LAYERS_FULL),
        ("F-FNO (FNO++ with Fourier factorization)", "ablation/no_sharing", _LAYERS_FULL),
        ("F-FNO-WS (F-FNO with weight sharing)", "markov", _LAYERS_FULL),
    ],
    # Tables A.4-A.6 share one layout
    "airfoil": _GEO_ROWS,
    "elasticity": _GEO_ROWS,
    "plasticity": _GEO_ROWS,
    "pipe": _GEO_ROWS,
}


def _read_metrics(run_dir: str):
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def collect_runs(root: str, pattern: str = "**/checkpoints/trial-*"):
    """The logged records of every run directory under ``root`` that has
    any, keyed by its path relative to ``root``."""
    runs = {}
    for run_dir in sorted(glob.glob(os.path.join(root, pattern), recursive=True)):
        records = _read_metrics(run_dir)
        if records:
            runs[os.path.relpath(run_dir, root)] = records
    return runs


def collect_groups(root: str):
    """The runs by experiment (the directory above ``checkpoints/``):
    ``{group: {trial: records}}``."""
    groups = {}
    for rel, records in collect_runs(root).items():
        parts = rel.split(os.sep)
        # <group...>/checkpoints/trial-{n}-{ts}
        try:
            ci = parts.index("checkpoints")
        except ValueError:
            continue
        group = "/".join(parts[:ci])
        m = re.match(r"trial-(\d+)-", parts[ci + 1])
        trial = int(m.group(1)) if m else 0
        groups.setdefault(group, {})[trial] = records
    return groups


def _final_scalars(records):
    out = {}
    for rec in records:
        for k, v in rec.items():
            if isinstance(v, (int, float)):
                out[k] = v
    return out


def _group_summary(trials):
    """One experiment group over its trials, as the reference's
    ``get_summary`` makes it: N-MSE x100 mean, std, min and max, the
    parameter count and the mean train hours; None without a loss."""
    losses, params, hours = [], [], []
    extras = {}
    for records in trials.values():
        finals = _final_scalars(records)
        loss = finals.get("test_loss", finals.get("valid_loss"))
        if loss is not None:
            losses.append(loss * 100.0)
        if "n_params" in finals:
            params.append(int(finals["n_params"]))
        times = [r["time"] for r in records if "time" in r]
        if len(times) >= 2:
            hours.append((times[-1] - times[0]) / 3600.0)
        for k in ("test_time_until", "valid_time_until", "test_corr"):
            if k in finals:
                extras.setdefault(k, []).append(finals[k])
    if not losses:
        return None
    out = {
        "n_trials": len(losses),
        "nmse_mean": float(np.mean(losses)),
        "nmse_std": float(np.std(losses)),
        "nmse_min": float(np.min(losses)),
        "nmse_max": float(np.max(losses)),
        "n_params": params[0] if params else 0,
        "train_hours": float(np.mean(hours)) if hours else float("nan"),
    }
    for k, v in extras.items():
        out[k] = float(np.mean(v))
    return out


def reference_table(dataset: str, root: str = "configs",
                    out_path: Optional[str] = None, latex: bool = False) -> str:
    """One of the paper's Tables A.3-A.6 from local runs. A row with no
    results shows dashes, so the table keeps the reference's shape."""
    if dataset not in REFERENCE_TABLES:
        raise SystemExit(
            f"unknown table {dataset!r}; one of {sorted(REFERENCE_TABLES)}")
    groups = collect_groups(root)
    lines = []
    if not latex:
        lines += [
            f"### {dataset} (reference Table A.x layout)",
            "| model | layers | params | N-MSE mean±std (%) | min | max | train h |",
            "|---|---|---|---|---|---|---|",
        ]
    for display, family, depths in REFERENCE_TABLES[dataset]:
        if latex:
            lines.append(f"\\multirow{{{len(depths)}}}{{*}}{{{display}}}")
        for d in depths:
            group = f"{dataset}/{family}/{d}_layers"
            s = _group_summary(groups.get(group, {}))
            if latex:
                if s is None:
                    lines.append(f" & {d} & --- & --- & --- & --- & --- \\\\")
                else:
                    h = s["train_hours"]
                    ht = "---" if np.isnan(h) else (f"{h:.1f}" if h < 1 else f"{h:.0f}")
                    lines.append(
                        f" & {d} & {s['n_params']:,} & {s['nmse_mean']:.2f} & "
                        f"{s['nmse_min']:.2f} & {s['nmse_max']:.2f} &  {ht} \\\\")
            else:
                if s is None:
                    lines.append(f"| {display} | {d} | — | — | — | — | — |")
                else:
                    h = s["train_hours"]
                    ht = "—" if np.isnan(h) else f"{h:.2g}"
                    mean = (f"{s['nmse_mean']:.2f} ± {s['nmse_std']:.2f}"
                            if s["n_trials"] > 1 else f"{s['nmse_mean']:.2f}")
                    lines.append(
                        f"| {display} | {d} | {s['n_params']:,} | "
                        f"{mean} | {s['nmse_min']:.2f} | "
                        f"{s['nmse_max']:.2f} | {ht} |")
        if latex:
            lines.append("\\midrule")
    if latex and lines and lines[-1] == "\\midrule":
        lines.pop()
    text = "\n".join(lines)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text + "\n")
        logger.info("wrote %s", out_path)
    print(text)
    return text


def table(root: str = "configs", keys: Optional[List[str]] = None,
          out_path: Optional[str] = None, dataset: Optional[str] = None,
          latex: bool = False) -> str:
    """With ``dataset``: the corresponding reference table (A.3-A.6).
    Without: a generic markdown table of final metrics per run."""
    if dataset:
        return reference_table(dataset, root, out_path=out_path, latex=latex)
    runs = collect_runs(root)
    keys = keys or ["test_loss", "valid_loss", "test_time_until", "train_loss"]
    lines = ["| run | " + " | ".join(keys) + " |",
             "|---|" + "---|" * len(keys)]
    for name, records in runs.items():
        finals = _final_scalars(records)
        row = [f"{finals[k]:.5g}" if k in finals else "—" for k in keys]
        lines.append(f"| {name} | " + " | ".join(row) + " |")
    text = "\n".join(lines)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text + "\n")
    print(text)
    return text


def _depth_series(root, value_fn):
    """``{family: [(depth, value)]}`` over the ``<family>/<d>_layers``
    groups for which ``value_fn`` gives a value."""
    series = {}
    for group, trials in collect_groups(root).items():
        m = re.match(r"(.+)/(\d+)_layers$", group)
        if not m:
            continue
        v = value_fn(trials)
        if v is None:
            continue
        series.setdefault(m.group(1), []).append((int(m.group(2)), v))
    return {k: sorted(v) for k, v in series.items()}


def _layers_series(root):
    """``{family: [(depth, (N-MSE mean, min, max))]}``, what ``layers`` draws."""

    def stats(trials):
        s = _group_summary(trials)
        if s is None:
            return None
        return (s["nmse_mean"], s["nmse_min"], s["nmse_max"])

    return _depth_series(root, stats)


def _save(fig, plt, out_path: str) -> str:
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    logger.info("wrote %s", out_path)
    return out_path


def layers(root: str = "configs", metric: str = "test_loss", out_path: str = "layers.png"):
    """N-MSE (%) against depth per family: the mean over the trials and
    their min-max band (the reference's ``plot_performance_vs_layer``)."""
    series = _layers_series(root)
    plt = pyplot("plot layers")
    fig, ax = plt.subplots(figsize=(5, 4))
    for family, pts in sorted(series.items()):
        xs = [p[0] for p in pts]
        (line,) = ax.plot(xs, [p[1][0] for p in pts], marker="o", label=family[:50])
        ax.fill_between(xs, [p[1][1] for p in pts], [p[1][2] for p in pts], alpha=0.15,
                        color=line.get_color())
    ax.set_xlabel("Number of layers")
    ax.set_ylabel("Normalized MSE (%)")
    ax.set_yscale("log")
    ax.set_xticks([0, 4, 8, 12, 16, 20, 24])
    ax.legend(fontsize=6)
    return _save(fig, plt, out_path)


def _parameters_series(root):
    """``{family: [(depth, parameter count)]}``, what ``parameters`` draws."""

    def count(trials):
        s = _group_summary(trials)
        return s["n_params"] if s and s["n_params"] else None

    return _depth_series(root, count)


def parameters(root: str = "configs", out_path: str = "parameters.png"):
    """Parameter count against depth per family (the reference's
    ``plot_parameters``)."""
    series = _parameters_series(root)
    plt = pyplot("plot parameters")
    fig, ax = plt.subplots(figsize=(5, 4))
    for family, pts in sorted(series.items()):
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=family[:50])
    ax.set_xlabel("Number of layers")
    ax.set_ylabel("Parameter count")
    ax.set_yscale("log")
    ax.set_xticks([0, 4, 8, 12, 16, 20, 24])
    ax.legend(fontsize=6)
    return _save(fig, plt, out_path)


def _correlation_curves(root):
    """``{run: (times or None, rho(t))}`` from the runs' logged
    correlations and from campaign logs (their last record with
    correlations)."""
    curves = {}
    for name, records in collect_runs(root).items():
        for rec in records:
            for key, tkey in (("test_correlations", "test_times"),
                              ("valid_correlations", "valid_times")):
                if isinstance(rec.get(key), list):
                    curves[name] = (rec.get(tkey), rec[key])
    for path in sorted(glob.glob(os.path.join(root, "**/campaign_log.jsonl"), recursive=True)):
        with open(path) as f:
            last = None
            for line in f:
                rec = json.loads(line)
                if isinstance(rec.get("correlations"), list):
                    last = rec["correlations"]
        if last:
            curves[os.path.relpath(path, root)] = (None, last)
    return curves


def correlation(root: str = "configs", out_path: str = "correlation.png"):
    """rho(t) curves from the logged correlations (the reference's
    ``plot_correlation_over_time``)."""
    curves = _correlation_curves(root)
    plt = pyplot("plot correlation")
    fig, ax = plt.subplots(figsize=(5, 4))
    for name, (times, rho) in sorted(curves.items()):
        ax.plot(times if times is not None else list(range(len(rho))), rho, label=name[:50])
    ax.axhline(0.95, color="grey", ls="--", lw=0.8)
    ax.set_xlabel("simulation time")
    ax.set_ylabel("vorticity correlation")
    ax.legend(fontsize=6)
    return _save(fig, plt, out_path)


def _step_loss_curves(root):
    """``{run: per-step losses}`` from the logged step losses."""
    curves = {}
    for name, records in collect_runs(root).items():
        for rec in records:
            for key in ("test_step_losses", "valid_step_losses"):
                if isinstance(rec.get(key), list):
                    curves[name] = rec[key]
    return curves


def step_losses(root: str = "configs", out_path: str = "step_losses.png"):
    """Per-rollout-step N-MSE (%) curves (the reference's
    ``plot_step_loss_curves``)."""
    curves = _step_loss_curves(root)
    plt = pyplot("plot step-losses")
    fig, ax = plt.subplots(figsize=(5, 4))
    for name, ls in sorted(curves.items()):
        ax.plot(range(1, len(ls) + 1), np.asarray(ls) * 100.0, label=name[:50])
    ax.set_xlabel("Rollout step")
    ax.set_ylabel("Normalized MSE (%)")
    ax.legend(fontsize=6)
    return _save(fig, plt, out_path)


def _h5_arrays(path: str, keys):
    """``{key: array}`` of the datasets of ``keys`` that the file holds (h5py,
    or ``utils.hdf5`` where h5py is not installed), and ``time``'s length
    (None without it)."""
    try:
        import h5py
    except ImportError:
        from ..utils.hdf5 import read_dataset

        out = {}
        for key in keys:
            try:
                out[key] = np.asarray(read_dataset(path, key))
            except KeyError:
                pass
        try:
            t_len = read_dataset(path, "time", mmap=True).shape[0]
        except KeyError:
            t_len = None
        return out, t_len
    with h5py.File(path, "r") as f:
        return ({key: np.asarray(f[key]) for key in keys if key in f},
                f["time"].shape[0] if "time" in f else None)


def _load_vorticity(path: str):
    """``(vorticity, vx, vy)`` ``[sample, x, y, time]`` (``vx``, ``vy`` None
    where the file has none) from either layout: rollout predictions
    (``save_predictions``: ``[sample, x, y, time]`` with ``x`` / ``y`` axis
    vectors) or generated Kolmogorov trajectories (``generate``: ``[traj,
    time, x, y]`` with ``elapsed``)."""
    arrays, t_len = _h5_arrays(path, ("vorticity", "vx", "vy", "elapsed", "x"))
    w, vx, vy = arrays["vorticity"], arrays.get("vx"), arrays.get("vy")
    # The writers' own datasets tell the layouts apart (a time length equal to
    # the grid size would not).
    if "elapsed" in arrays:
        time_first = True
    elif "x" in arrays:
        time_first = False
    else:
        time_first = w.ndim == 4 and t_len is not None and w.shape[1] == t_len != w.shape[-1]
    if time_first:
        w = np.moveaxis(w, 1, -1)
        vx = np.moveaxis(vx, 1, -1) if vx is not None else None
        vy = np.moveaxis(vy, 1, -1) if vy is not None else None
    return w, vx, vy


def _energy_spectrum(w, vx=None, vy=None):
    """The shell-averaged kinetic energy spectrum E(k) of ``w [sample, x, y,
    time]``, the mean over samples and times; the velocities recovered
    spectrally from the vorticity where not given (on the periodic torus
    ``u_hat = i k_perp w_hat / k^2``)."""
    n = w.shape[1]
    kx = np.fft.fftfreq(n, 1.0 / n)[:, None]
    ky = np.fft.fftfreq(n, 1.0 / n)[None, :]
    if vx is None or vy is None:
        k2 = kx**2 + ky**2
        k2[0, 0] = 1.0
        w_hat = np.fft.fftn(w, axes=(1, 2))
        psi_hat = w_hat / k2[None, :, :, None]
        u_hat = 1j * ky[None, :, :, None] * psi_hat
        v_hat = -1j * kx[None, :, :, None] * psi_hat
    else:
        u_hat = np.fft.fftn(vx, axes=(1, 2))
        v_hat = np.fft.fftn(vy, axes=(1, 2))
    # E(kx, ky) per sample and time, normalised so that E does not depend on the grid size
    e2d = 0.5 * (np.abs(u_hat) ** 2 + np.abs(v_hat) ** 2) / n**4
    shell = np.round(np.sqrt(kx**2 + ky**2)).astype(int)
    n_shells = n // 2
    e_mean = e2d.mean(axis=(0, 3))
    spectrum = np.bincount(shell.ravel(), weights=e_mean.ravel(),
                           minlength=n_shells)[:n_shells]
    return np.arange(n_shells), spectrum


def _named_inputs(inputs: List[str], command: str):
    """``[(name, path)]`` of ``name=path`` (or ``path``, named by its file)."""
    if not inputs:
        raise ValueError(f"plot {command} requires --inputs name=path.h5 ...")
    out = []
    for spec in inputs:
        name, _, path = spec.partition("=")
        if not path:
            name, path = os.path.basename(spec), spec
        out.append((name, path))
    return out


def _energy_curves(inputs: List[str], tail: int = 80, scale_power: int = 5):
    """``{name: (k, k^scale_power E(k))}`` of each file, over its last
    ``tail`` times (all with 0), k from 1."""
    curves = {}
    for name, path in _named_inputs(inputs, "energy"):
        while name in curves:  # a repeated name keeps both curves
            name += "'"
        w, vx, vy = _load_vorticity(path)
        sl = slice(-tail, None) if tail else slice(None)
        w = w[..., sl]
        vx = vx[..., sl] if vx is not None else None
        vy = vy[..., sl] if vy is not None else None
        k, e = _energy_spectrum(w, vx, vy)
        curves[name] = (k[1:], (k[1:] ** float(scale_power)) * e[1:])
    return curves


def energy(inputs: List[str], out_path: str = "energy.png", tail: int = 80,
           scale_power: int = 5):
    """Scaled energy spectra ``k^scale_power E(k)`` of ``name=path.h5``
    trajectory or prediction files, log-log, over their last ``tail`` times
    (the reference's ``plot_energy_spectrum``)."""
    curves = _energy_curves(inputs, tail, scale_power)
    plt = pyplot("plot energy")
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, (k, e) in curves.items():
        ax.plot(k, e, "-" if "dns" in name.lower() else "--", label=name, linewidth=2)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("Wavenumber")
    ax.set_ylabel(f"Scaled energy spectrum $k^{scale_power} E(k)$")
    ax.legend(fontsize=7)
    return _save(fig, plt, out_path)


def flows(inputs: List[str], out_path: str = "samples.png", sample: int = 0,
          times: Optional[List[int]] = None):
    """Vorticity snapshots: a row for each file, a column for each time (the
    reference's ``flows``: times 0, 10 and 21)."""
    rows = [(name, _load_vorticity(path)[0][sample])
            for name, path in _named_inputs(inputs, "flows")]
    times = times or [0, 10, 21]
    plt = pyplot("plot flows")
    fig, axes = plt.subplots(len(rows), len(times), figsize=(2.3 * len(times), 2.3 * len(rows)),
                             squeeze=False)
    for i, (name, w) in enumerate(rows):
        vmax = np.percentile(np.abs(w), 98)
        for j, t in enumerate(times):
            t_idx = min(t, w.shape[-1] - 1)
            ax = axes[i][j]
            ax.imshow(w[..., t_idx].T, cmap="RdBu_r", vmin=-vmax, vmax=vmax, origin="lower")
            ax.set_xticks([])
            ax.set_yticks([])
            if i == 0:
                ax.set_title(f"t = {t_idx}", fontsize=8)
        axes[i][0].set_ylabel(name, fontsize=8)
    fig.tight_layout()
    return _save(fig, plt, out_path)


def _final_campaign_metrics(path: str, metrics: List[str]) -> dict:
    """The last recorded value of each metric in a ``campaign_log.jsonl``."""
    final = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            for m in metrics:
                if m in r:
                    final[m] = r[m]
    return final


def _ablation_rows(inputs: List[str], metrics: List[str]):
    """``[(swept value, {metric: final value})]`` of ``value=path`` campaign
    logs, by value."""
    rows = []
    for item in inputs:
        val, path = item.split("=", 1)
        rows.append((float(val), _final_campaign_metrics(path, metrics)))
    rows.sort(key=lambda r: r[0])
    return rows


def ablation(inputs: List[str], out_path: str = "ablation.png", xlabel: str = "parameter",
             metrics: Optional[List[str]] = None):
    """A sweep: each metric's final value in ``value=campaign_log.jsonl``
    files against the swept value (default ``valid_time_until`` and
    ``train_loss``), printed as a table and drawn."""
    metrics = metrics or ["valid_time_until", "train_loss"]
    rows = _ablation_rows(inputs, metrics)
    print("| " + xlabel + " | " + " | ".join(metrics) + " |")
    print("|" + "---|" * (len(metrics) + 1))
    for val, final in rows:
        cells = [f"{final.get(m, float('nan')):.4g}" for m in metrics]
        print(f"| {val:g} | " + " | ".join(cells) + " |")

    plt = pyplot("plot ablation")
    fig, axes = plt.subplots(1, len(metrics), figsize=(4 * len(metrics), 3.2), squeeze=False)
    xs = [r[0] for r in rows]
    for ax, m in zip(axes[0], metrics):
        ax.plot(xs, [r[1].get(m, float("nan")) for r in rows], "o-", color="#335C81")
        ax.set_xlabel(xlabel)
        ax.set_ylabel(m)
        if len(xs) > 2 and xs[0] > 0 and xs[-1] / xs[0] >= 8:
            ax.set_xscale("log")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    return _save(fig, plt, out_path)


def _stepsize_rows(inputs: List[str], dns_path: Optional[str] = None):
    """``(model rows, DNS rows)``, each ``[(step size, time until)]`` by step
    size: the surrogate's from ``step_size=campaign_log.jsonl`` pairs, the
    DNS's from ``stepsize_dns.json``."""
    model_rows = []
    for item in inputs:
        val, path = item.split("=", 1)
        final = _final_campaign_metrics(path, ["valid_time_until"])
        if "valid_time_until" in final:
            model_rows.append((float(val), final["valid_time_until"]))
    model_rows.sort()
    dns_rows = []
    if dns_path:
        with open(dns_path) as f:
            dns_rows = sorted((r["step_size"], r["time_until"]) for r in json.load(f))
    return model_rows, dns_rows


def stepsize(inputs: List[str], dns_path: Optional[str] = None, out_path: str = "stepsize.png",
             threshold: float = 0.95):
    """The varying-step-size figure (the reference's
    ``plot_varying_step_size``): the time until the correlation drops below
    ``threshold`` against the step size, for the F-FNO's k sweep and the
    pseudo-spectral DNS at growing multiples of its dt."""
    model_rows, dns_rows = _stepsize_rows(inputs, dns_path)
    print("| source | step size (sim-s) | time_until (sim-s) |")
    print("|---|---|---|")
    for s, t in model_rows:
        print(f"| F-FNO | {s:g} | {t:g} |")
    for s, t in dns_rows:
        print(f"| DNS | {s:g} | {t:g} |")

    plt = pyplot("plot stepsize")
    fig, ax = plt.subplots(figsize=(4.2, 3.4))
    if model_rows:
        ax.plot([r[0] for r in model_rows], [r[1] for r in model_rows], "o-", color="#335C81",
                label="F-FNO")
    if dns_rows:
        ax.plot([r[0] for r in dns_rows], [r[1] for r in dns_rows], "x-", color="#2E933C",
                label="DNS (pseudo-spectral)")
    ax.set_xscale("log")
    ax.set_xlabel("Step size (sim-s)")
    ax.set_ylabel(f"Time until correlation < {threshold:g}")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    return _save(fig, plt, out_path)


def _tradeoff_rows(data_dir: str, metric: str = "valid_loss"):
    """One row a timed run: its tag, architecture, depth, final N-MSE (%)
    from its campaign log and inference time from
    ``<data_dir>/runs/inference_times.jsonl`` (the last timing of a tag)."""
    runs = []
    with open(os.path.join(data_dir, "runs", "inference_times.jsonl")) as f:
        for line in f:
            line = line.strip()
            if line:
                runs.append(json.loads(line))
    by_tag = {r["tag"]: r for r in runs}
    rows = []
    for tag, rec in sorted(by_tag.items()):
        log_path = os.path.join(data_dir, "runs", tag, "campaign_log.jsonl")
        if not os.path.exists(log_path) and tag == "ffno":
            # the older layout: the default run's log at the data directory's root
            log_path = os.path.join(data_dir, "campaign_log.jsonl")
        if not os.path.exists(log_path):
            logger.warning("no campaign log for %s; skipped", tag)
            continue
        final = _final_campaign_metrics(log_path, [metric])
        if metric not in final:
            continue
        rows.append({"tag": tag, "arch": rec["arch"], "n_layers": rec["n_layers"],
                     "nmse_pct": 100.0 * final[metric],
                     "inference_time": rec["inference_time"]})
    return rows


def tradeoff(data_dir: str, out_path: str = "tradeoff.png", dns: Optional[List[str]] = None,
             metric: str = "valid_loss"):
    """N-MSE (%) against the inference time per sample and simulated second,
    a line for each architecture across depths (the reference's
    ``plot_pde_inference_performance_tradeoff``), with ``dns``
    ``label=runtime`` points of numerical solvers at N-MSE 0."""
    rows = _tradeoff_rows(data_dir, metric)
    print("| run | arch | layers | N-MSE (%) | s / sample / sim-s |")
    print("|---|---|---|---|---|")
    for r in sorted(rows, key=lambda r: (r["arch"], r["n_layers"])):
        print(f"| {r['tag']} | {r['arch']} | {r['n_layers']} | "
              f"{r['nmse_pct']:.2f} | {r['inference_time']:.4g} |")
    for item in dns or []:
        label, val = item.split("=", 1)
        print(f"| {label} (DNS) | — | — | 0 | {float(val):.4g} |")

    plt = pyplot("plot tradeoff")
    fig, ax = plt.subplots(figsize=(4.2, 3.4))
    palette = {"ffno": "#335C81", "zongyi": "#A23B72", "ffno_plus": "#E08E45"}
    for arch in sorted({r["arch"] for r in rows}):
        pts = sorted((r for r in rows if r["arch"] == arch), key=lambda r: r["n_layers"])
        ax.plot([p["nmse_pct"] for p in pts], [p["inference_time"] for p in pts], "o-",
                color=palette.get(arch, "#444444"), label=arch)
        for p in pts:
            ax.annotate(str(p["n_layers"]), (p["nmse_pct"], p["inference_time"]),
                        textcoords="offset points", xytext=(4, 4), fontsize=7)
    for item in dns or []:
        label, val = item.split("=", 1)
        ax.scatter([0], [float(val)], marker="x", color="#2E933C")
        ax.annotate(label, (0, float(val)), textcoords="offset points", xytext=(4, 4),
                    fontsize=7)
    ax.set_xlabel("Normalized MSE (%)")
    ax.set_ylabel("Runtime per sim-second (s)")
    ax.set_yscale("log")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    return _save(fig, plt, out_path)


def _superresolution_rows(results_path: str):
    """``(sizes, rollout correlations, times until, results)`` of a
    ``superres_results.json`` (``{size: {"corr", "time_until"[,
    "correlations", "times"]}}``), by evaluation grid size."""
    with open(results_path) as f:
        results = json.load(f)
    sizes = sorted(int(s) for s in results)
    return (sizes, [results[str(s)]["corr"] for s in sizes],
            [results[str(s)]["time_until"] for s in sizes], results)


def superresolution(results_path: str, out_path: str = "superresolution.png",
                    train_size: int = 64):
    """A checkpoint trained at one grid, evaluated at others: the rollout
    correlation and the time until rho < 0.95 against the evaluation grid,
    and each grid's rho(t) where the results have it (the reference's
    ``superresolution`` and
    ``plot_correlation_vs_time_of_different_grid_sizes``)."""
    sizes, corr, tu, results = _superresolution_rows(results_path)
    print("| eval grid | rollout corr | time_until (rho>=0.95) |")
    print("|---|---|---|")
    for s, c, t in zip(sizes, corr, tu):
        mark = " (train)" if s == train_size else ""
        print(f"| {s}²{mark} | {c:.3f} | {t:.2f} sim-s |")

    plt = pyplot("plot superresolution")
    has_curves = all("correlations" in results[str(s)] for s in sizes)
    n_panels = 3 if has_curves else 2
    fig, axes = plt.subplots(1, n_panels, figsize=(4 * n_panels, 3.2))
    ax1, ax2 = axes[0], axes[1]
    for ax, ys, label in ((ax1, corr, "mean rollout correlation"),
                          (ax2, tu, "time until rho<0.95 (sim-s)")):
        ax.plot(sizes, ys, "o-", color="#335C81")
        ax.axvline(train_size, color="#888", ls="--", lw=1, label=f"training res {train_size}²")
        ax.set_xscale("log", base=2)
        ax.set_xticks(sizes)
        ax.set_xticklabels([f"{s}²" for s in sizes])
        ax.set_xlabel("evaluation grid")
        ax.set_ylabel(label)
        ax.grid(alpha=0.3)
    if has_curves:
        ax3 = axes[2]
        palette = ["#2E933C", "#335C81", "#B4656F", "#E0A458", "#6B4E9B"]
        for i, s in enumerate(sizes):
            r = results[str(s)]
            ts = r.get("times") or list(range(1, len(r["correlations"]) + 1))
            ax3.plot(ts, r["correlations"], color=palette[i % len(palette)],
                     label=f"{s}²" + (" (train)" if s == train_size else ""))
        ax3.axhline(0.95, color="#888", ls=":", lw=1)
        ax3.set_xlabel("rollout time (sim-s)")
        ax3.set_ylabel("vorticity correlation rho(t)")
        ax3.grid(alpha=0.3)
        ax3.legend(frameon=False, fontsize=8)
    ax1.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    return _save(fig, plt, out_path)


def heatmap(sample_path: str, step: int = -1, out_prefix: str = "field"):
    """Heatmaps of the first sample's prediction (``<out_prefix>_pred.png``)
    and target (``<out_prefix>_target.png``, where the batch has ``data``)
    at time ``step`` from a ``sample`` command's pickle; returns the paths."""
    if not sample_path:
        raise SystemExit("plot heatmap needs --sample-path: the sample command's pickle "
                         "(sample.pkl in the experiment's directory by default)")
    with open(sample_path, "rb") as f:
        batch, preds = pickle.load(f)
    preds = np.asarray(preds)
    pred = preds[0, ..., step] if preds.ndim == 4 else preds[0]
    outs = [log_imshow(pred, "prediction", f"{out_prefix}_pred.png")]
    data = batch.get("data") if isinstance(batch, dict) else None
    if data is not None:
        outs.append(log_imshow(np.asarray(data)[0, ..., step], "target",
                               f"{out_prefix}_target.png"))
    return outs
