"""Experiment registry, the torus part: the JAX package's config-as-code
experiments of the torus families, by the same path-like names
(counterpart of ``fourierflow_tpu/experiments.py``, its ``torus_li`` and
``torus_vis*`` families)::

    python -m fourierflow_tpu_torch.commands train torus_vis/01_baseline

``get_experiment(name)`` returns a config dict in the reference schema
(wandb / builder / routine / trainer / callbacks) that
``config.load_config`` reads when ``name`` is not a file;
``experiment_names()`` lists them (``commands configs list``). Targets name
this package. The other families join the registry with the slices that
port their targets.

Hyperparameters mirror the reference configs (file citations inline).
"""

import copy
from typing import Dict, List

__all__ = ["experiment_names", "get_experiment", "materialize"]

LAYERS = [4, 8, 12, 16, 20, 24]
DATA = "${oc.env:DATA_ROOT,./data}"


# --- shared nodes ---------------------------------------------------------

def _adamw(lr=0.001, weight_decay=0.0001):
    return {
        "_target_": "functools.partial",
        "_args_": ["${get_method: torch.optim.AdamW}"],
        "lr": lr,
        "weight_decay": weight_decay,
    }


def _cosine(num_training_steps, num_warmup_steps=500):
    return {
        "scheduler": {
            "_target_": "functools.partial",
            "_args_": ["${get_method: fourierflow_tpu_torch.schedulers.cosine_with_warmup}"],
            "num_warmup_steps": num_warmup_steps,
            "num_training_steps": num_training_steps,
            "num_cycles": 0.5,
        },
        "name": "learning_rate",
    }


def _step_lr(step_size, gamma=0.5):
    return {
        "scheduler": {
            "_target_": "functools.partial",
            "_args_": ["${get_method: torch.optim.lr_scheduler.StepLR}"],
            "step_size": step_size,
            "gamma": gamma,
        },
        "name": "learning_rate",
        "interval": "epoch",
    }


def _ckpt(monitor="valid_loss"):
    return [{
        "_target_": "fourierflow_tpu_torch.trainers.ModelCheckpoint",
        "save_last": True,
        "monitor": monitor,
        "mode": "min",
    }]


def _wandb(project, group):
    return {"project": project, "group": group}


# --- torus_li -------------------------------------------------------------

def _torus_li_markov(n_layers, **routine_over):
    """reference:experiments/torus_li/markov/{n}_layers/config.yaml"""
    conv = {
        "_target_": "fourierflow_tpu_torch.models.FNOFactorized2DBlock",
        "modes": 16, "width": 64, "n_layers": n_layers, "input_dim": 3,
        "share_weight": True, "factor": 4, "ff_weight_norm": True,
        "gain": 0.1, "dropout": 0.0, "in_dropout": 0.0,
    }
    routine = {
        "_target_": "fourierflow_tpu_torch.routines.Grid2DMarkovRoutine",
        "conv": conv, "n_steps": 10, "max_accumulations": 1000,
        "noise_std": 0.01,
        "optimizer": _adamw(lr=0.0025),
        "scheduler": _cosine(100000),
    }
    routine.update(routine_over)
    return {
        "wandb": _wandb("torus_li", f"markov/{n_layers}_layers"),
        "builder": {
            "_target_": "fourierflow_tpu_torch.builders.NSMarkovBuilder",
            "data_path": f"{DATA}/zongyi/NavierStokes_V1e-5_N1200_T20.mat",
            "train_size": 1000, "test_size": 200, "ssr": 1, "batch_size": 19,
        },
        "routine": routine,
        "trainer": {"max_epochs": 101, "log_every_n_steps": 100},
        "callbacks": _ckpt(),
    }


def _torus_li_zongyi(n_layers):
    """reference:experiments/torus_li/zongyi/{n}_layers/config.yaml"""
    return {
        "wandb": _wandb("torus_li", f"zongyi/{n_layers}_layers"),
        "builder": {
            "_target_": "fourierflow_tpu_torch.builders.NSZongyiBuilder",
            "data_path": f"{DATA}/zongyi/NavierStokes_V1e-5_N1200_T20.mat",
            "train_size": 1000, "test_size": 200, "ssr": 1, "n_steps": 10,
            "batch_size": 20,
        },
        "routine": {
            "_target_": "fourierflow_tpu_torch.routines.Grid2DRolloutRoutine",
            "conv": {
                "_target_": "fourierflow_tpu_torch.models.FNOZongyi2DBlock",
                "modes1": 12, "modes2": 12, "width": 20, "n_layers": n_layers,
            },
            "n_steps": 10,
            "optimizer": _adamw(lr=0.0025),
            "scheduler": _step_lr(100),
        },
        "trainer": {"max_epochs": 500},
        "callbacks": _ckpt(),
    }


def _torus_li_ablations() -> Dict[str, dict]:
    """reference:experiments/torus_li/ablation/*/{n}_layers/config.yaml —
    each is a delta on the markov flagship."""
    out = {}
    for n in LAYERS:
        def markov(**over):
            cfg = _torus_li_markov(n, **over)
            return cfg

        def conv_over(cfg, **kw):
            cfg["routine"]["conv"].update(kw)
            return cfg

        abl = {}
        abl["all_weights_shared"] = conv_over(markov(), share_fork=True)
        abl["learn_difference"] = markov(learn_difference=True)
        abl["no_sharing"] = conv_over(markov(), share_weight=False)
        abl["shared_fork"] = conv_over(markov(), share_fork=True, use_fork=True)
        abl["no_positional_features"] = conv_over(
            markov(use_position=False), input_dim=1)
        abl["with_velocity"] = conv_over(markov(use_velocity=True), input_dim=5)
        abl["shuffle_xy_grid"] = markov(use_position=True, shuffle_grid=True)

        for key, share_w, share_f in [
            ("no_factorization", False, False),
            ("no_factorization_shared_weights", True, False),
            ("no_factorization_shared_all", True, True),
        ]:
            cfg = markov()
            cfg["routine"]["conv"]["_target_"] = "fourierflow_tpu_torch.models.FNOPlus2DBlock"
            cfg["routine"]["conv"]["share_weight"] = share_w
            cfg["routine"]["conv"]["share_fork"] = share_f
            abl[key] = cfg

        for key in ("zongyi_markov", "zongyi_markov_residual"):
            cfg = markov()
            cfg["builder"]["batch_size"] = 190
            cfg["routine"]["conv"] = {
                "_target_": "fourierflow_tpu_torch.models.FNOZongyi2DBlock",
                "modes1": 12, "modes2": 12, "width": 20, "n_layers": n,
                "residual": key.endswith("residual"),
            }
            # reference ablation/zongyi_markov*/config.yaml: max_epochs 500
            cfg["trainer"]["max_epochs"] = 500
            abl[key] = cfg

        # reference ablation/teacher_forcing/*/config.yaml: the ZONGYI
        # rollout config (FNOZongyi2DBlock 12/12/20) + teacher_forcing.
        tf = _torus_li_zongyi(n)
        tf["routine"]["teacher_forcing"] = True
        abl["teacher_forcing"] = tf

        for key, cfg in abl.items():
            cfg["wandb"] = _wandb("torus_li", f"ablation/{key}/{n}_layers")
            out[f"torus_li/ablation/{key}/{n}_layers"] = cfg
    # The reference ships learn_difference and shared_fork only at the bare
    # (24-layer) path — register those exact names too
    # (reference:experiments/torus_li/ablation/{learn_difference,
    # shared_fork}/config.yaml).
    for key in ("learn_difference", "shared_fork"):
        cfg = copy.deepcopy(out[f"torus_li/ablation/{key}/24_layers"])
        cfg["wandb"] = _wandb("torus_li", f"ablation/{key}")
        out[f"torus_li/ablation/{key}"] = cfg
    return out


# --- torus_vis(_force) ------------------------------------------------------

def _torus_vis(project, variant) -> dict:
    """reference:experiments/torus_vis*/{variant}/config.yaml"""
    fname = "torus_vis.h5" if project == "torus_vis" else "torus_vis_force.h5"
    input_dim = {"01_baseline": 5, "02_no_mu": 4, "03_no_mu_force": 3,
                 "06_shared_all_no_fork": 5}[variant]
    routine = {
        "_target_": "fourierflow_tpu_torch.routines.Grid2DMarkovRoutine",
        "conv": {
            "_target_": "fourierflow_tpu_torch.models.FNOFactorized2DBlock",
            "modes": 16, "width": 64, "n_layers": 24, "input_dim": input_dim,
            "share_weight": True, "factor": 4, "ff_weight_norm": True,
            "gain": 0.1, "dropout": 0.0, "in_dropout": 0.0,
        },
        "n_steps": 10, "max_accumulations": 10000, "noise_std": 0.01,
        "append_force": variant in ("01_baseline", "02_no_mu", "06_shared_all_no_fork"),
        "append_mu": variant in ("01_baseline", "06_shared_all_no_fork"),
        "optimizer": _adamw(lr=0.0025),
        "scheduler": _cosine(100000),
    }
    if variant == "06_shared_all_no_fork":
        routine["conv"]["share_fork"] = True
        routine["noise_std"] = 0.02
    return {
        "wandb": _wandb(project, variant),
        "builder": {
            "_target_": "fourierflow_tpu_torch.builders.NSContextualBuilder",
            "data_path": f"{DATA}/torus/{fname}",
            "ssr": 4, "k": 10, "batch_size": 19,
        },
        "routine": routine,
        "trainer": {"max_epochs": 11, "log_every_n_steps": 100},
        "callbacks": _ckpt(),
    }


# --- registry ---------------------------------------------------------------

def _build_registry() -> Dict[str, dict]:
    reg: Dict[str, dict] = {}
    for n in LAYERS:
        reg[f"torus_li/markov/{n}_layers"] = _torus_li_markov(n)
        reg[f"torus_li/zongyi/{n}_layers"] = _torus_li_zongyi(n)
    reg.update(_torus_li_ablations())
    for v in ("01_baseline", "02_no_mu", "03_no_mu_force"):
        reg[f"torus_vis/{v}"] = _torus_vis("torus_vis", v)
    for v in ("01_baseline", "02_no_mu", "03_no_mu_force", "06_shared_all_no_fork"):
        reg[f"torus_vis_force/{v}"] = _torus_vis("torus_vis_force", v)
    return reg


_REGISTRY = None


def _registry() -> Dict[str, dict]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _build_registry()
    return _REGISTRY


def experiment_names() -> List[str]:
    return sorted(_registry())


def get_experiment(name: str) -> dict:
    """Return a deep copy of the named experiment config."""
    reg = _registry()
    key = (name.strip("/").removesuffix("/config.yaml").removeprefix("experiments/")
           .removeprefix("configs/"))
    if key not in reg:
        import difflib

        close = difflib.get_close_matches(key, reg, n=3)
        raise KeyError(f"unknown experiment {name!r}; close matches: {close}")
    return copy.deepcopy(reg[key])


def materialize(name: str, out_dir: str = "configs") -> str:
    """Write the named experiment to ``<out_dir>/<name>.yaml`` and return
    the path (for users who want an editable file)."""
    import os

    import yaml

    cfg = get_experiment(name)
    path = os.path.join(out_dir, f"{name}.yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path
