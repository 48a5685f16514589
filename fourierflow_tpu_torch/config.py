"""Config system: YAML plus ``_target_`` instantiation (counterpart of
``fourierflow_tpu/config.py``), reading the repo's experiment configs
unchanged:

- ``${oc.env:VAR}`` / ``${oc.env:VAR,default}`` environment values
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
    "fourierflow.builders.NSMarkovBuilder": "fourierflow_tpu_torch.builders.NSMarkovBuilder",
    "fourierflow.modules.FNOFactorized2DBlock": "fourierflow_tpu_torch.models.FNOFactorized2DBlock",
    "fourierflow.routines.Grid2DMarkovExperiment": "fourierflow_tpu_torch.routines.Grid2DMarkovRoutine",
    "fourierflow.schedulers.CosineWithWarmupScheduler": "fourierflow_tpu_torch.schedulers.cosine_with_warmup",
    "fourierflow.callbacks.CustomModelCheckpoint": "fourierflow_tpu_torch.trainers.ModelCheckpoint",
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


def _resolve_value(expr: str) -> Any:
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
    if expr.startswith("get_method:"):
        return expr  # kept symbolic; resolved at instantiation
    raise ValueError(f"unknown resolver in ${{{expr}}}")


def _resolve_str(s: str) -> Any:
    m = _INTERP_RE.fullmatch(s.strip())
    if m:
        return _resolve_value(m.group(1))
    return _INTERP_RE.sub(lambda mm: str(_resolve_value(mm.group(1))), s)


def _interpolate(obj: Any) -> Any:
    if isinstance(obj, str):
        return _resolve_str(obj)
    if isinstance(obj, dict):
        return {k: _interpolate(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_interpolate(v) for v in obj]
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
    """Load an experiment config from a YAML file and apply overrides."""
    with open(path) as f:
        cfg = yaml.load(f, Loader=_YamlLoader)
    cfg = apply_overrides(cfg, overrides or [])
    return _interpolate(cfg)


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
