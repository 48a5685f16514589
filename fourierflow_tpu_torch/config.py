"""Config system: YAML or the experiment registry, plus ``_target_``
instantiation (counterpart of ``fourierflow_tpu/config.py``), reading the
repo's experiment configs unchanged:

- ``${oc.env:VAR}`` / ``${oc.env:VAR,default}`` environment values
- ``${eval: expr}`` arithmetic (math names) and ``${import: dotted.path}``
  constants, nested innermost first (``${eval:2 * ${import:numpy.pi}}``)
- ``${node.path}`` references to another node of the config (``${sim_grid}``)
- ``${get_method: dotted.path}`` callables, resolved at instantiation
- ``_target_`` instantiation with recursive kwargs, ``_args_`` positionals
  and ``functools.partial``
- dotted-path overrides (``routine.conv.n_layers=8``)

Targets of the JAX package (prefix ``fourierflow_tpu.``) resolve to their
counterparts in this package (prefix ``fourierflow_tpu_torch.``); the
reference's own names (``fourierflow.*``) go through ``TARGET_TRANSLATION``,
where a Lightning-only callback maps to ``None`` and is dropped.
``torch.optim.AdamW`` stays itself: ``commands/train.py`` reads its
``functools.partial``.
"""

import ast
import importlib
import math
import os
import re
from functools import partial
from typing import Any, Dict, List, Optional

import yaml

__all__ = ["load_config", "instantiate", "import_string", "apply_overrides", "translate"]


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader with YAML 1.2 floats: ``1e-3`` is a float, not a string."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:
            [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
           |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
           |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
           |[-+]?\.(?:inf|Inf|INF)
           |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)

_JAX_PREFIX = "fourierflow_tpu."
_PORT_PREFIX = "fourierflow_tpu_torch."

# The reference's names for what this package has ported.
TARGET_TRANSLATION = {
    "fourierflow.builders.NSContextualBuilder": "fourierflow_tpu_torch.builders.NSContextualBuilder",
    "fourierflow.builders.NSMarkovBuilder": "fourierflow_tpu_torch.builders.NSMarkovBuilder",
    "fourierflow.builders.NSZongyiBuilder": "fourierflow_tpu_torch.builders.NSZongyiBuilder",
    "fourierflow.builders.StructuredMesh2DBuilder":
        "fourierflow_tpu_torch.builders.StructuredMesh2DBuilder",
    "fourierflow.builders.PlasticityBuilder": "fourierflow_tpu_torch.builders.PlasticityBuilder",
    "fourierflow.builders.ElasticityBuilder": "fourierflow_tpu_torch.builders.ElasticityBuilder",
    "fourierflow.modules.FNOFactorized2DBlock": "fourierflow_tpu_torch.models.FNOFactorized2DBlock",
    "fourierflow.modules.FNOZongyi2DBlock": "fourierflow_tpu_torch.models.FNOZongyi2DBlock",
    "fourierflow.modules.FNOPlus2DBlock": "fourierflow_tpu_torch.models.FNOPlus2DBlock",
    "fourierflow.modules.FNOFactorizedMesh2D": "fourierflow_tpu_torch.models.FNOFactorizedMesh2D",
    "fourierflow.modules.FNOFactorizedMesh3D": "fourierflow_tpu_torch.models.FNOFactorizedMesh3D",
    "fourierflow.modules.FNOFactorizedPointCloud2D":
        "fourierflow_tpu_torch.models.FNOFactorizedPointCloud2D",
    "fourierflow.modules.CNOFactorized2DBlock": "fourierflow_tpu_torch.models.CNOFactorized2DBlock",
    "fourierflow.modules.IPhi": "fourierflow_tpu_torch.models.IPhi",
    "fourierflow.routines.Grid2DMarkovExperiment": "fourierflow_tpu_torch.routines.Grid2DMarkovRoutine",
    "fourierflow.routines.Grid2DRolloutExperiment": "fourierflow_tpu_torch.routines.Grid2DRolloutRoutine",
    "fourierflow.routines.StructuredMeshExperiment":
        "fourierflow_tpu_torch.routines.StructuredMeshRoutine",
    "fourierflow.routines.PointCloudExperiment": "fourierflow_tpu_torch.routines.PointCloudRoutine",
    "fourierflow.schedulers.CosineWithWarmupScheduler": "fourierflow_tpu_torch.schedulers.cosine_with_warmup",
    "fourierflow.schedulers.LinearWithWarmupScheduler": "fourierflow_tpu_torch.schedulers.linear_with_warmup",
    "fourierflow.schedulers.ExponentialWithWarmupScheduler":
        "fourierflow_tpu_torch.schedulers.exponential_with_warmup",
    "torch.optim.lr_scheduler.StepLR": "fourierflow_tpu_torch.schedulers.step_lr",
    "fourierflow.callbacks.CustomModelCheckpoint": "fourierflow_tpu_torch.trainers.ModelCheckpoint",
    # The Kolmogorov pipeline: jax-cfd's targets and the reference's.
    "fourierflow.builders.KolmogorovBuilder": "fourierflow_tpu_torch.builders.KolmogorovBuilder",
    "fourierflow.builders.KolmogorovTorchDataset":
        "fourierflow_tpu_torch.builders.kolmogorov.KolmogorovMarkovDataset",
    "fourierflow.builders.kolmogorov.KolmogorovTorchDataset":
        "fourierflow_tpu_torch.builders.kolmogorov.KolmogorovMarkovDataset",
    "fourierflow.builders.kolmogorov.KolmogorovTrajectoryDataset":
        "fourierflow_tpu_torch.builders.kolmogorov.KolmogorovTrajectoryDataset",
    "fourierflow.builders.kolmogorov.downsample_vorticity":
        "fourierflow_tpu_torch.builders.kolmogorov.downsample_vorticity_snapshot",
    "fourierflow.builders.kolmogorov.downsample_velocity":
        "fourierflow_tpu_torch.builders.kolmogorov.downsample_velocity_snapshot",
    "fourierflow.utils.Grid": "fourierflow_tpu_torch.utils.Grid",
    "fourierflow.utils.equations.NavierStokes2D": "fourierflow_tpu_torch.utils.equations.NavierStokes2D",
    "fourierflow.utils.forcings.kolmogorov_forcing_fn":
        "fourierflow_tpu_torch.utils.forcings.kolmogorov_forcing_fn",
    "jax_cfd.base.grids.Grid": "fourierflow_tpu_torch.utils.Grid",
    "jax_cfd.base.equations.stable_time_step": "fourierflow_tpu_torch.utils.equations.stable_time_step",
    "jax_cfd.base.forcings.simple_turbulence_forcing":
        "fourierflow_tpu_torch.utils.forcings.simple_turbulence_forcing",
    "jax_cfd.spectral.time_stepping.crank_nicolson_rk4":
        "fourierflow_tpu_torch.utils.equations.crank_nicolson_rk4",
    "jax_cfd.base.equations.semi_implicit_navier_stokes":
        "fourierflow_tpu_torch.utils.finite_volume.semi_implicit_navier_stokes",
    "jax_cfd.base.time_stepping.classic_rk4": "fourierflow_tpu_torch.utils.finite_volume.classic_rk4",
    "jax_cfd.base.time_stepping.forward_euler":
        "fourierflow_tpu_torch.utils.finite_volume.forward_euler",
    "pytorch_lightning.callbacks.LearningRateMonitor": None,
    "pytorch_lightning.callbacks.ModelSummary": None,
}


def translate(target: str) -> Optional[str]:
    """Map a config target onto this package (``None``: drop the node);
    anything else is unchanged."""
    if target in TARGET_TRANSLATION:
        return TARGET_TRANSLATION[target]
    if target.startswith(_JAX_PREFIX):
        return _PORT_PREFIX + target[len(_JAX_PREFIX):]
    return target


def import_string(path: str):
    """Import ``pkg.mod.attr``."""
    module_path, _, attr = path.rpartition(".")
    if not module_path:
        raise ImportError(f"cannot import {path!r}")
    return getattr(importlib.import_module(module_path), attr)


_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")
_EVAL_NS = {"pi": math.pi, "e": math.e, "math": math}


def _resolve_value(expr: str, root: Optional[Dict] = None) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        body = expr[len("oc.env:"):]
        if "," in body:
            var, default = body.split(",", 1)
            return os.environ.get(var.strip(), default.strip())
        val = os.environ.get(body.strip())
        if val is None:
            raise KeyError(f"environment variable {body!r} not set")
        return val
    if expr.startswith("eval:"):
        return eval(expr[len("eval:"):], {"__builtins__": {}}, dict(_EVAL_NS))
    if expr.startswith("import:"):
        return import_string(expr[len("import:"):].strip())
    if expr.startswith("get_method:"):
        return expr  # kept symbolic; resolved at instantiation
    # A reference to another node of the config (``${sim_grid}``, ``${a.b}``).
    node: Any = root
    for part in expr.split("."):
        if not isinstance(node, dict) or part not in node:
            raise ValueError(f"unknown resolver in ${{{expr}}}")
        node = node[part]
    return _interpolate(node, root)


def _resolve_str(s: str, root: Optional[Dict] = None) -> Any:
    """A string with ``${...}`` interpolations, resolved innermost first; a
    string that is one interpolation takes the value's type."""
    for _ in range(10):
        m = _INTERP_RE.fullmatch(s.strip())
        if m:
            return _resolve_value(m.group(1), root)
        if not _INTERP_RE.search(s):
            return s
        s = _INTERP_RE.sub(lambda mm: str(_resolve_value(mm.group(1), root)), s)
    return s


def _interpolate(obj: Any, root: Optional[Dict] = None) -> Any:
    if isinstance(obj, str):
        return _resolve_str(obj, root)
    if isinstance(obj, dict):
        return {k: _interpolate(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_interpolate(v, root) for v in obj]
    return obj


def apply_overrides(cfg: Dict, overrides: List[str]) -> Dict:
    """Dotted-path overrides; integer segments index lists."""
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node[int(p)] if isinstance(node, list) else node.setdefault(p, {})
        if isinstance(node, list):
            node[int(parts[-1])] = value
        else:
            node[parts[-1]] = value
    return cfg


def load_config(path: str, overrides: Optional[List[str]] = None) -> Dict:
    """Load an experiment config from a YAML file, or, when ``path`` is not
    a file, from the experiment registry by name (``torus_vis/01_baseline``;
    see ``experiments.py``), and apply overrides."""
    if os.path.isfile(path):
        with open(path) as f:
            cfg = yaml.load(f, Loader=_YamlLoader)
    else:
        from .experiments import get_experiment

        cfg = get_experiment(path)
    cfg = apply_overrides(cfg, overrides or [])
    return _interpolate(cfg, root=cfg)


def instantiate(cfg: Any, **extra_kwargs):
    """Recursively instantiate a ``_target_`` config node; ``extra_kwargs``
    go to the top node's call. Dropped nodes leave lists."""
    if isinstance(cfg, list):
        return [o for o in (instantiate(c) for c in cfg) if o is not None]
    if not isinstance(cfg, dict):
        if isinstance(cfg, str) and cfg.startswith("get_method:"):
            return import_string(translate(cfg[len("get_method:"):].strip()))
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()}
    target = translate(cfg["_target_"])
    if target is None:
        return None
    args = [instantiate(a) for a in cfg.get("_args_", [])]
    kwargs = {k: instantiate(v) for k, v in cfg.items() if k not in ("_target_", "_args_")}
    kwargs.update(extra_kwargs)
    if target == "functools.partial":
        return partial(args[0], *args[1:], **kwargs)
    return import_string(target)(*args, **kwargs)
