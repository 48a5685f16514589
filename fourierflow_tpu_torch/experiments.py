"""Experiment registry: the JAX package's config-as-code experiments, by
the same path-like names (counterpart of ``fourierflow_tpu/experiments.py``,
all 342 of its names: the ``torus_li``, ``torus_vis*`` and ``torus_kochkov``
F-FNO, CNO and learned-interpolation families, the Kolmogorov data configs
``data/kolmogorov/**`` of both methods, the ``airfoil``, ``pipe`` and
``plasticity`` F-FNO, Geo-FNO and CNO experiments, the ``elasticity``
point-cloud ones and MeshGraphNet's ``cylinder_flow/baseline``)::

    python -m fourierflow_tpu_torch.commands train torus_vis/01_baseline
    python -m fourierflow_tpu_torch.commands train airfoil/ffno/24_layers
    python -m fourierflow_tpu_torch.commands generate kolmogorov \
        data/kolmogorov/re_1000/initial_conditions/train

``get_experiment(name)`` returns a config dict in the reference schema
(wandb / builder / routine / trainer / callbacks) that
``config.load_config`` reads when ``name`` is not a file;
``experiment_names()`` lists them (``commands configs list``). Targets name
this package; an unknown name raises a ``KeyError`` with close matches.

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


def _adam(lr=0.001, weight_decay=0.0001):
    """The reference's Adam; ``commands/train.py`` builds it as AdamW with this
    decoupled weight decay, as the JAX package does."""
    return {
        "_target_": "functools.partial",
        "_args_": ["${get_method: torch.optim.Adam}"],
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


# --- torus_kochkov ----------------------------------------------------------

KOCH_STEP = 0.0002191401125550916  # stable_time_step for re_1000 sim


def _kochkov_builder(size, k=20, train_paths=None, test_size=None, end=None,
                     cadence=4, valid_size=None):
    """reference:experiments/torus_kochkov/ffno/grid_sizes/{size}/config.yaml
    ``cadence`` picks the file suffix: _4 = 64*dt recording cadence, _1 =
    16*dt (the sub-snapshot step_sizes configs, step_sizes/64/0.{25,5}).
    ``valid_size`` defaults to ``test_size``; the superresolution configs
    keep validation at the training grid while testing at the eval grid
    (superresolution/*/config.yaml), and ``end`` applies to the TEST split
    only (ditto)."""
    test_size = test_size or size
    valid_size = valid_size or test_size
    train_paths = train_paths or [
        f"{DATA}/kolmogorov/re_1000/trajectories/train_{size}_{cadence}.nc"]
    if len(train_paths) == 1:
        train_ds = {
            "_target_": "fourierflow_tpu_torch.builders.KolmogorovMarkovDataset",
            "path": train_paths[0], "k": k,
        }
    else:
        train_ds = {
            "_target_": "fourierflow_tpu_torch.builders.KolmogorovMultiDataset",
            "paths": train_paths, "k": k, "batch_size": 32,
        }
    def traj(split, sz, with_end):
        d = {
            "_target_": "fourierflow_tpu_torch.builders.KolmogorovTrajectoryDataset",
            "init_path": f"{DATA}/kolmogorov/re_1000/initial_conditions/{split}_{sz}.nc",
            "path": f"{DATA}/kolmogorov/re_1000/trajectories/{split}_{sz}_{cadence}.nc",
            "corr_path": f"{DATA}/kolmogorov/re_1000/trajectories/{split}_32_{cadence}.nc",
            "k": k,
        }
        if end and with_end:
            d["end"] = end
        return d
    return {
        "_target_": "fourierflow_tpu_torch.builders.KolmogorovBuilder",
        "train_dataset": train_ds,
        "valid_dataset": traj("valid", valid_size, False),
        "test_dataset": traj("test", test_size, True),
        "batch_size": 32,
    }


# Per-grid reference specs (grid_sizes/{size}/config.yaml): batch size,
# spectral modes, accumulation batches (= batches/epoch), epochs. The
# cosine schedule always decays over exactly the 10 training epochs
# (num_training_steps = 10 x max_accumulations in every config).
KOCH_GRID_SPEC = {
    64: dict(batch=32, modes=16, acc=2421, epochs=11),
    128: dict(batch=8, modes=32, acc=9684, epochs=11),
    256: dict(batch=2, modes=64, acc=38736, epochs=21),
}


def _kochkov_ffno(size=64, k=20, n_layers=24, batch=None, modes=None,
                  acc=None, epochs=None, **routine_over):
    spec = KOCH_GRID_SPEC[size]
    batch = batch or spec["batch"]
    modes = modes or spec["modes"]
    acc = acc or spec["acc"]
    epochs = epochs or spec["epochs"]
    conv = {
        "_target_": "fourierflow_tpu_torch.models.FNOFactorized2DBlock",
        "modes": modes, "width": 64, "n_layers": n_layers, "input_dim": 5,
        "share_weight": True, "factor": 4, "ff_weight_norm": True,
        "gain": 0.1, "dropout": 0.0, "in_dropout": 0.0,
    }
    routine = {
        "_target_": "fourierflow_tpu_torch.routines.Grid2DMarkovRoutine",
        "conv": conv,
        # Simulation time per model step; grid-independent
        # (reference grid_sizes/*/config.yaml:45 uses 64 * k for all sizes).
        "step_size": KOCH_STEP * 64 * k,
        "max_accumulations": acc,
        "noise_std": 0.01,
        "use_velocity": True,
        "domain": [[0, "${eval:2 * ${import:numpy.pi}}"],
                   [0, "${eval:2 * ${import:numpy.pi}}"]],
        "optimizer": _adamw(lr=0.0025),
        "scheduler": _cosine(acc * (epochs - 1 if epochs else 10)),
    }
    routine.update(routine_over)
    builder = _kochkov_builder(size, k)
    builder["batch_size"] = batch
    if builder["train_dataset"].get("batch_size"):
        builder["train_dataset"]["batch_size"] = batch
    return {
        "wandb": _wandb("torus_kochkov", ""),
        "builder": builder,
        "routine": routine,
        "trainer": {"max_epochs": epochs, "log_every_n_steps": 100},
        "callbacks": _ckpt("valid_time_until"),
    }


def _kochkov_family() -> Dict[str, dict]:
    out = {}
    for size in (64, 128, 256):
        out[f"torus_kochkov/ffno/grid_sizes/{size}"] = _kochkov_ffno(size)
    # predictions/* reuse grid-trained checkpoints for rollout dumps; the
    # reference runs 128/256 eval with the modes-32 checkpoint and its
    # OWN batch/accumulation counts (predictions/{size}/config.yaml).
    out["torus_kochkov/ffno/predictions/64"] = _kochkov_ffno(64)
    out["torus_kochkov/ffno/predictions/128"] = _kochkov_ffno(
        128, batch=32, modes=32, acc=2421)
    out["torus_kochkov/ffno/predictions/256"] = _kochkov_ffno(
        256, batch=12, modes=32, acc=6456, epochs=11)
    for n in LAYERS:
        out[f"torus_kochkov/ffno/layers/64/{n}_layers"] = _kochkov_ffno(n_layers=n)
    # step_sizes/64/{k}: sub-snapshot sizes (0.25, 0.5) switch to the
    # fine-cadence _1 files (16*dt recording) at dataset k=1/2; the
    # accumulation counts are the reference's literal values
    # (step_sizes/64/{k}/config.yaml — incl. its k=40 quirk of 2421).
    STEP_SIZE_SPEC = {0.25: (1, 1, 2440), 0.5: (2, 1, 2440),
                      1: (1, 4, 2440), 2: (2, 4, 2439), 5: (5, 4, 2436),
                      10: (10, 4, 2431), 20: (20, 4, 2421),
                      40: (40, 4, 2421), 80: (80, 4, 2361)}
    for k, (dataset_k, cadence, acc) in STEP_SIZE_SPEC.items():
        cfg = _kochkov_ffno(64, k=dataset_k, acc=acc)
        cfg["builder"] = _kochkov_builder(64, k=dataset_k, cadence=cadence)
        cfg["routine"]["step_size"] = KOCH_STEP * 64 * k
        if k == 40:
            # The reference's k=40 config keeps max_accumulations at 2421
            # but pins the cosine to 24010 steps ("2401 per epoch" quirk,
            # step_sizes/64/40/config.yaml:64) instead of acc*(epochs-1).
            cfg["routine"]["scheduler"] = _cosine(24010)
        out[f"torus_kochkov/ffno/step_sizes/64/{k}"] = cfg
    # Superresolution evaluation: train grids -> eval grid.
    for train_key, train_sizes in {
        "train_with_x64": [64],
        "train_with_x32_x64": [32, 64],
        "train_with_x32_x128": [32, 128],
        "train_with_x64_x128": [64, 128],
    }.items():
        for eval_size in (32, 64, 128, 256):
            paths = [f"{DATA}/kolmogorov/re_1000/trajectories/train_{s}_4.nc"
                     for s in train_sizes]
            cfg = _kochkov_ffno(64)
            cfg["builder"] = _kochkov_builder(
                64, train_paths=paths, test_size=eval_size, valid_size=64,
                end=800)
            out[f"torus_kochkov/ffno/superresolution/{train_key}/{eval_size}"] = cfg
    for sizes in ([32, 64], [32, 128], [64, 128]):
        key = "_".join(f"x{s}" for s in sizes)
        paths = [f"{DATA}/kolmogorov/re_1000/trajectories/train_{s}_4.nc"
                 for s in sizes]
        # reference multi_resolution/*/config.yaml: modes 16 and acc 2421
        # at every pair; pairs containing 128 drop to batch 8 and
        # stretch the cosine to 96,840 steps.
        has128 = 128 in sizes
        cfg = _kochkov_ffno(max(sizes), batch=8 if has128 else 32,
                            modes=16, acc=2421, epochs=11)
        cfg["routine"]["scheduler"] = _cosine(96840 if has128 else 24210)
        # Eval grid per reference literals: x32_x64 and x64_x128 evaluate
        # at 64^2, but x32_x128 evaluates at 128^2 (its config.yaml reads
        # valid_128_4.nc/test_128_4.nc with init valid_128).
        eval_size = 128 if sizes == [32, 128] else 64
        cfg["builder"] = _kochkov_builder(eval_size, train_paths=paths)
        cfg["builder"]["batch_size"] = 8 if has128 else 32
        cfg["builder"]["train_dataset"]["batch_size"] = 8 if has128 else 32
        out[f"torus_kochkov/ffno/multi_resolution/{key}"] = cfg
    # Ablations.
    out["torus_kochkov/ffno/ablation/no_positional"] = _kochkov_ffno(
        use_position=False)
    out["torus_kochkov/ffno/ablation/no_positional"]["routine"]["conv"]["input_dim"] = 3
    sin = _kochkov_ffno(use_fourier_position=True)
    sin["routine"]["conv"]["input_dim"] = 37
    out["torus_kochkov/ffno/ablation/sinusoidal"] = sin
    sf = _kochkov_ffno()
    sf["routine"]["conv"]["share_fork"] = True
    out["torus_kochkov/ffno/ablation/shared_feedforward"] = sf
    vc = _kochkov_ffno(n_layers=16, learn_difference=True, use_velocity=False)
    vc["routine"]["conv"]["input_dim"] = 3
    out["torus_kochkov/ffno/ablation/vorticity_change"] = vc
    nv = _kochkov_ffno(use_velocity=False)
    nv["routine"]["conv"]["input_dim"] = 3
    out["torus_kochkov/ffno/ablation/no_velocity"] = nv
    nvp = _kochkov_ffno(use_velocity=False, use_position=False)
    nvp["routine"]["conv"]["input_dim"] = 2
    out["torus_kochkov/ffno/ablation/no_velocity_positional"] = nvp
    for size in (64, 128, 256):
        nw = _kochkov_ffno(size)
        nw["routine"]["conv"]["share_weight"] = False
        out[f"torus_kochkov/ffno/ablation/ffno-nw/{size}"] = nw
        # fno++ halves the batch (the unfactorized block is heavier):
        # reference ablation/fno++/{128,256}/config.yaml.
        pp_spec = {64: {}, 128: dict(batch=4, acc=19368),
                   256: dict(batch=1, acc=77472)}[size]
        pp = _kochkov_ffno(size, **pp_spec)
        pp["routine"]["conv"]["_target_"] = "fourierflow_tpu_torch.models.FNOPlus2DBlock"
        pp["routine"]["conv"]["share_weight"] = False
        out[f"torus_kochkov/ffno/ablation/fno++/{size}"] = pp
    # FCNO on the Kolmogorov task.
    for size in (64, 128):
        fc = _kochkov_ffno(size)
        fc["routine"]["conv"]["_target_"] = "fourierflow_tpu_torch.models.CNOFactorized2DBlock"
        out[f"torus_kochkov/fcno/grid_sizes/{size}"] = fc
    # Learned interpolation rollouts (Kochkov et al. 2021 reproduction).
    # Per-size reference params (learned_interpolation/rollout/x*/config
    # .yaml): the model step dt halves per grid doubling (always ~32x the
    # grid's DNS-stable step), the file stride k tracks it on the
    # 16*dt-cadence _1 files, and inner_steps keeps the validation
    # snapshot cadence.
    # x256 reads the short_trajectories/ files (incl. the 32^2 corr files)
    # and its ROUTINE steps 64 inner sub-steps per recorded snapshot while
    # the dataset cadence stays 32 (rollout/x256/config.yaml:13-31,41).
    LI_SPEC = {32: (0.014024967203525862, 4, 8, 8),
               64: (0.007012483601762931, 2, 16, 16),
               128: (0.0035062418008814655, 1, 32, 32),
               256: (0.001753121, 1, 32, 64)}
    for size, (li_dt, li_k, li_inner, li_routine_inner) in LI_SPEC.items():
        traj_dir = "short_trajectories" if size == 256 else "trajectories"
        out[f"torus_kochkov/learned_interpolation/rollout/x{size}"] = {
            "wandb": _wandb("torus_kochkov", f"learned_interpolation/x{size}"),
            "builder": {
                "_target_": "fourierflow_tpu_torch.builders.KolmogorovBuilder",
                "train_dataset": {
                    "_target_": "fourierflow_tpu_torch.builders.KolmogorovVelocityDataset",
                    "path": f"{DATA}/kolmogorov/re_1000/{traj_dir}/train_{size}_1.nc",
                    "k": li_k, "unroll_length": 32,
                },
                "valid_dataset": {
                    "_target_": "fourierflow_tpu_torch.builders.KolmogorovVelocityTrajectoryDataset",
                    "init_path": f"{DATA}/kolmogorov/re_1000/initial_conditions/valid_{size}.nc",
                    "corr_path": f"{DATA}/kolmogorov/re_1000/{traj_dir}/valid_32_1.nc",
                    "k": li_k, "inner_steps": li_inner, "outer_steps": 100,
                },
                "test_dataset": {
                    "_target_": "fourierflow_tpu_torch.builders.KolmogorovVelocityTrajectoryDataset",
                    "init_path": f"{DATA}/kolmogorov/re_1000/initial_conditions/test_{size}.nc",
                    "corr_path": f"{DATA}/kolmogorov/re_1000/{traj_dir}/test_32_1.nc",
                    "k": li_k, "inner_steps": li_inner, "outer_steps": 100,
                },
                "batch_size": 4,
            },
            "routine": {
                "_target_": "fourierflow_tpu_torch.routines.LearnedInterpolatorRoutine",
                "size": size,
                "dt": li_dt,
                "inner_steps": li_routine_inner, "outer_steps": 100, "unroll_length": 32,
                "optimizer": _adamw(lr=0.001),
            },
            "trainer": {"max_epochs": 10, "limit_train_batches": 4000},
            "callbacks": [{
                "_target_": "fourierflow_tpu_torch.trainers.ModelCheckpoint",
                "save_last": True,
                "monitor": "valid_reduced_time_until",
                "mode": "max",
            }],
        }
    return out


# --- data-generation configs (reference:data/kolmogorov/**) -----------------

KOL_DOMAIN = [[0, "${eval:2 * ${import:numpy.pi}}"],
              [0, "${eval:2 * ${import:numpy.pi}}"]]


def _kol_data(sim_size, n_traj, seed, inner, outer, warmup, out_sizes,
              time_step=None, init_path=None):
    """One Kolmogorov generation config (reference:data/kolmogorov/re_1000/
    trajectories/train.yaml etc.). ``time_step=None`` uses the CFL-stable
    step for the sim grid."""
    cfg = {
        "domain": KOL_DOMAIN,
        "sim_grid": {"_target_": "fourierflow_tpu_torch.utils.Grid",
                     "shape": [sim_size, sim_size], "domain": "${domain}"},
        "time_step": time_step if time_step is not None else {
            "_target_": "jax_cfd.base.equations.stable_time_step",
            "max_velocity": 7.0, "max_courant_number": 0.5,
            "viscosity": 1e-3, "grid": "${sim_grid}",
        },
        "method": "pseudo_spectral",
        "step_fn": {
            "_target_": "jax_cfd.spectral.time_stepping.crank_nicolson_rk4",
            "equation": {
                "_target_": "fourierflow.utils.equations.NavierStokes2D",
                "grid": "${sim_grid}", "viscosity": 1e-3, "drag": 0.1,
                "smooth": True,
                "forcing_fn": {
                    "_target_": "functools.partial",
                    "_args_": ["${get_method:jax_cfd.base.forcings.simple_turbulence_forcing}"],
                    "constant_magnitude": 1, "constant_wavenumber": 4,
                    "linear_coefficient": 0,
                },
            },
            "time_step": "${time_step}",
        },
        "downsample_fn": "${get_method:fourierflow.builders.kolmogorov.downsample_vorticity}",
        "out_sizes": out_sizes,
        "n_trajectories": n_traj, "density": 1, "max_velocity": 7.0,
        "peak_wavenumber": 4.0, "seed": seed,
        "inner_steps": inner, "outer_steps": outer, "warmup_steps": warmup,
    }
    if init_path:
        cfg["init_path"] = init_path
    return cfg


def _kolmogorov_data_configs():
    """reference:data/kolmogorov/re_1000/** — initial conditions (2048^2,
    40 warmup time units), ML training trajectories, short trajectories,
    per-resolution DNS baselines, time-step sweeps, learned-interpolation
    data."""
    out = {}
    ic_sizes = [{"size": s, "k": 1} for s in (32, 64, 128, 256, 512, 1024, 2048)]
    traj_sizes = ([{"size": s, "k": 1} for s in (32, 64, 128)]
                  + [{"size": s, "k": 4} for s in (32, 64, 128, 256)])
    seeds = {"train": 73714, "valid": 819242, "test": 19422}
    for split, seed in seeds.items():
        out[f"data/kolmogorov/re_1000/initial_conditions/{split}"] = _kol_data(
            2048, 32, seed, inner=64, outer=0, warmup=2852, out_sizes=ic_sizes)
        init = f"{DATA}/kolmogorov/re_1000/initial_conditions/{split}_2048.nc"
        out[f"data/kolmogorov/re_1000/trajectories/{split}"] = _kol_data(
            2048, 32, seed, inner=16, outer=9764, warmup=0,
            out_sizes=traj_sizes, init_path=init)
        out[f"data/kolmogorov/re_1000/short_trajectories/{split}"] = _kol_data(
            2048, 32, seed, inner=8, outer=7000, warmup=0,
            out_sizes=traj_sizes, init_path=init)
    # DNS baselines: simulate directly at each resolution with its own
    # stable step (the reference's accuracy-vs-cost reference points).
    for size in (32, 64, 128, 256, 512, 1024):
        out[f"data/kolmogorov/re_1000/baselines/{size}"] = _kol_data(
            size, 4, 83816, inner=1, outer=2441, warmup=0,
            out_sizes=[{"size": min(size, 32), "k": 1}],
            init_path=f"{DATA}/kolmogorov/re_1000/initial_conditions/test_{size}.nc")
    # Time-step sensitivity sweep at 64^2: dt = x * stable(2048).
    base_dt = 0.0002191401125550916
    for mult in (1, 2, 4, 8, 16, 32, 64, 128):
        out[f"data/kolmogorov/re_1000/time_steps/x{mult}"] = _kol_data(
            64, 4, 83816, inner=max(1, 32 // mult), outer=2441, warmup=0,
            out_sizes=[{"size": 32, "k": 1}], time_step=base_dt * mult,
            init_path=f"{DATA}/kolmogorov/re_1000/initial_conditions/test_64.nc")
    # Learned-interpolation training data (fine snapshots at the model grid).
    for size in (64, 128):
        out[f"data/kolmogorov/re_1000/learned_interpolation/{size}"] = _kol_data(
            size, 4, 83816, inner=2, outer=2441, warmup=0,
            out_sizes=[{"size": size, "k": 1}, {"size": 32, "k": 1}],
            init_path=f"{DATA}/kolmogorov/re_1000/initial_conditions/test_{size}.nc")
    # reference:data/kolmogorov/re_1000/learned_interpolation/control.yaml —
    # the un-learned 64^2 projection DNS the interpolation model is
    # compared against (same cadence/ICs as the 64^2 training data).
    ctrl = _kol_projection_3d(
        64, 4, 83816, inner=2, outer=2441, warmup=0, ndim=2,
        init_path=f"{DATA}/kolmogorov/re_1000/initial_conditions/test_64.nc")
    ctrl["out_sizes"] = [{"size": 32, "k": 1}, {"size": 64, "k": 1}]
    out["data/kolmogorov/re_1000/learned_interpolation/control"] = ctrl
    # 3D projection-method datasets (reference data/kolmogorov/
    # three_dimensions/*: 512^3 finite-volume simulations).
    for split, seed in (("train", 97820), ("valid", 97821), ("test", 97823)):
        cfg = _kol_projection_3d(512, 4, seed, inner=64, outer=200,
                                 warmup=0,
                                 init_path=f"{DATA}/kolmogorov/three_dimensions/initial_conditions/{split}_512.nc")
        out[f"data/kolmogorov/three_dimensions/trajectories/{split}"] = cfg
        ic = _kol_projection_3d(512, 4, seed, inner=64, outer=0, warmup=1000)
        out[f"data/kolmogorov/three_dimensions/initial_conditions/{split}"] = ic
    # Method-comparison configs (spectral vs projection at the same IC).
    out["data/kolmogorov/compare_methods/drag/spectral"] = _kol_data(
        256, 2, 111, inner=8, outer=200, warmup=50,
        out_sizes=[{"size": 64, "k": 1}])
    proj2d = _kol_projection_3d(256, 2, 111, inner=8, outer=200, warmup=50,
                                ndim=2)
    out["data/kolmogorov/compare_methods/drag/projection"] = proj2d
    # reference:data/kolmogorov/compare_methods/kolmogorov/*.yaml — three
    # forcing formulations of the same Re=1000 flow at 1024^2 from the
    # shared test IC: projection-method linear drag (-0.1 coefficient),
    # spectral with the drag inside the forcing term (spectral_coeff),
    # and spectral with the separate implicit drag term (spectral_drag).
    cmp_ic = f"{DATA}/kolmogorov/re_1000/initial_conditions/test_1024.nc"
    cmp_kw = dict(inner=128, outer=100, warmup=0,
                  out_sizes=[{"size": 512, "k": 1}], init_path=cmp_ic)
    proj_k = _kol_projection_3d(1024, 1, 2308, inner=128, outer=100,
                                warmup=0, ndim=2, init_path=cmp_ic)
    proj_k["out_sizes"] = [{"size": 512, "k": 1}]
    out["data/kolmogorov/compare_methods/kolmogorov/projection"] = proj_k
    coeff = _kol_data(1024, 1, 2308, **cmp_kw)
    coeff["step_fn"]["equation"]["drag"] = 0.0
    coeff["step_fn"]["equation"]["forcing_fn"]["linear_coefficient"] = -0.1
    out["data/kolmogorov/compare_methods/kolmogorov/spectral_coeff"] = coeff
    out["data/kolmogorov/compare_methods/kolmogorov/spectral_drag"] = _kol_data(
        1024, 1, 2308, **cmp_kw)
    # reference:data/kolmogorov/compare_methods/decaying/*.yaml — unforced
    # decay from the same IC, spectral vs projection.
    dec_s = _kol_data(1024, 1, 2308, **cmp_kw)
    dec_s["step_fn"]["equation"]["drag"] = 0.0
    dec_s["step_fn"]["equation"]["forcing_fn"] = None
    out["data/kolmogorov/compare_methods/decaying/spectral"] = dec_s
    dec_p = _kol_projection_3d(1024, 1, 2308, inner=128, outer=100,
                               warmup=0, ndim=2, init_path=cmp_ic)
    dec_p["out_sizes"] = [{"size": 512, "k": 1}]
    dec_p["step_fn"]["forcing"] = None
    out["data/kolmogorov/compare_methods/decaying/projection"] = dec_p
    # reference:data/kolmogorov/compare_methods/downsampling/** — the same
    # trajectory simulated at several resolutions and downsampled to 64^2,
    # once per method (spectral CN-RK4, projection forward-Euler,
    # projection classic-RK4).
    for size in (128, 512, 2048):
        ds_ic = f"{DATA}/kolmogorov/re_1000/initial_conditions/test_{size}.nc"
        out[f"data/kolmogorov/compare_methods/downsampling/spectral/{size}"] = \
            _kol_data(size, 1, 2308, inner=8, outer=200, warmup=0,
                      out_sizes=[{"size": 64, "k": 1}], init_path=ds_ic)
        for stepper, key in ((None, "projection_euler"),
                             ("${get_method:jax_cfd.base.time_stepping.classic_rk4}",
                              "projection_rk4")):
            proj = _kol_projection_3d(size, 1, 2308, inner=8, outer=200,
                                      warmup=0, ndim=2, init_path=ds_ic)
            proj["out_sizes"] = [{"size": 64, "k": 1}]
            if stepper is not None:
                proj["step_fn"]["time_stepper"] = stepper
            out[f"data/kolmogorov/compare_methods/downsampling/{key}/{size}"] = proj
    # Re=4000 variant: 4096^2 sims, half viscosity, drag 0.05, forcing
    # wavenumber 2 (reference data/kolmogorov/re_4000/**).
    for split, seed in (("train", 42001), ("valid", 42002), ("test", 42003)):
        for kind, outer, inner, warmup in (
            ("initial_conditions", 0, 64, 2852), ("trajectories", 9764, 16, 0),
        ):
            cfg = _kol_data(
                4096, 4, seed, inner=inner, outer=outer, warmup=warmup,
                out_sizes=([{"size": s_, "k": 1} for s_ in (32, 64, 128, 256)]
                           if outer else
                           [{"size": s_, "k": 1} for s_ in (32, 64, 128, 256, 4096)]),
                init_path=(f"{DATA}/kolmogorov/re_4000/initial_conditions/{split}_4096.nc"
                           if outer else None))
            eq = cfg["step_fn"]["equation"]
            eq["viscosity"] = 5e-4
            eq["drag"] = 0.05
            eq["forcing_fn"]["constant_wavenumber"] = 2
            cfg["time_step"]["viscosity"] = 5e-4
            out[f"data/kolmogorov/re_4000/{kind}/{split}"] = cfg
    # Decaying turbulence (no forcing, no drag): spectral baselines at
    # several resolutions + projection-method counterparts
    # (reference data/kolmogorov/decaying/**).
    for size, inner in ((64, 2), (256, 8), (2048, 64)):
        cfg = _kol_data(size, 4, 2308, inner=inner, outer=1426, warmup=0,
                        out_sizes=[{"size": min(size, 64), "k": 1}],
                        init_path=(f"{DATA}/kolmogorov/decaying/initial_conditions/test_{size}.nc"
                                   if size == 2048 else None))
        eq = cfg["step_fn"]["equation"]
        eq["drag"] = 0.0
        eq["forcing_fn"] = None
        out[f"data/kolmogorov/decaying/baselines/{size}"] = cfg
        proj = _kol_projection_3d(size, 4, 2308, inner=inner, outer=1426,
                                  warmup=0, ndim=2)
        proj["step_fn"]["forcing"] = None
        proj["out_sizes"] = [{"size": min(size, 64), "k": 1}]
        out[f"data/kolmogorov/decaying/projection/{size}"] = proj
    out["data/kolmogorov/decaying/initial_conditions/test"] = _kol_data(
        2048, 4, 2308, inner=64, outer=0, warmup=1426,
        out_sizes=[{"size": s_, "k": 1} for s_ in (64, 256, 2048)])
    # reference:data/kolmogorov/decaying/trajectories/test.yaml — full
    # unforced 2048^2 decay trajectories from the warmed ICs.
    dec_t = _kol_data(
        2048, 4, 2308, inner=64, outer=1426, warmup=0,
        out_sizes=[{"size": s_, "k": 1} for s_ in (32, 64, 128, 256)],
        init_path=f"{DATA}/kolmogorov/decaying/initial_conditions/test_2048.nc")
    dec_t["step_fn"]["equation"]["drag"] = 0.0
    dec_t["step_fn"]["equation"]["forcing_fn"] = None
    out["data/kolmogorov/decaying/trajectories/test"] = dec_t
    # Large-domain variant: 4x domain length at the same resolution
    # density (reference data/kolmogorov/large_domain/**).
    big = "${eval:8 * ${import:numpy.pi}}"
    for kind, outer, warmup in (("initial_conditions", 0, 2852),
                                ("trajectories", 9764, 0)):
        cfg = _kol_data(8192, 4, 55101, inner=16 if outer else 64,
                        outer=outer, warmup=warmup,
                        out_sizes=[{"size": s_, "k": 1} for s_ in (128, 256)],
                        init_path=(f"{DATA}/kolmogorov/large_domain/initial_conditions/test_8192.nc"
                                   if outer else None))
        cfg["domain"] = [[0, big], [0, big]]
        out[f"data/kolmogorov/large_domain/{kind}/test"] = cfg
    return out


def _kol_projection_3d(sim_size, n_traj, seed, inner, outer, warmup,
                       init_path=None, ndim=3):
    """Finite-volume projection-method generation config (reference:data/
    kolmogorov/three_dimensions/trajectories/*.yaml and
    compare_methods/**/projection*.yaml)."""
    domain = KOL_DOMAIN[:1] * ndim
    cfg = {
        "domain": domain,
        "sim_grid": {"_target_": "fourierflow_tpu_torch.utils.Grid",
                     "shape": [sim_size] * ndim, "domain": "${domain}"},
        "time_step": {
            "_target_": "jax_cfd.base.equations.stable_time_step",
            "max_velocity": 7.0, "max_courant_number": 0.5,
            "viscosity": 1e-3, "grid": "${sim_grid}",
        },
        "method": "projection",
        "step_fn": {
            "_target_": "jax_cfd.base.equations.semi_implicit_navier_stokes",
            "density": 1, "viscosity": 1e-3, "dt": "${time_step}",
            "grid": "${sim_grid}",
            "forcing": {
                "_target_": "jax_cfd.base.forcings.simple_turbulence_forcing",
                "grid": "${sim_grid}",
                "constant_magnitude": 1, "constant_wavenumber": 4,
                "linear_coefficient": -0.1,
            },
        },
        "downsample_fn": "${get_method:fourierflow.builders.kolmogorov.downsample_velocity}",
        "out_sizes": [{"size": s, "k": 1} for s in (32, 64, 128) if s <= sim_size],
        "n_trajectories": n_traj, "density": 1, "max_velocity": 7.0,
        "peak_wavenumber": 4.0, "seed": seed,
        "inner_steps": inner, "outer_steps": outer, "warmup_steps": warmup,
    }
    if init_path:
        cfg["init_path"] = init_path
    return cfg


# --- structured meshes (airfoil / pipe / plasticity) -----------------------

def _structured_mesh(project, paths, output_dim, model, batch_size=10, optimizer=None,
                     scheduler=None, max_epochs=200, loss_scale=None, group=""):
    routine = {
        "_target_": "fourierflow_tpu_torch.routines.StructuredMeshRoutine",
        "model": model,
        "optimizer": optimizer or _adamw(),
        "scheduler": scheduler or _cosine(20000),
    }
    if loss_scale:
        routine["loss_scale"] = loss_scale
    return {
        "wandb": _wandb(project, group),
        "builder": {
            "_target_": "fourierflow_tpu_torch.builders.StructuredMesh2DBuilder",
            **paths, "output_dim": output_dim,
            "train_size": 1000, "valid_size": 200, "test_size": 200,
            "batch_size": batch_size,
        },
        "routine": routine,
        "trainer": {"max_epochs": max_epochs},
        "callbacks": _ckpt(),
    }


AIRFOIL_PATHS = {
    "x1_path": f"{DATA}/geo-fno/airfoil/naca/NACA_Cylinder_X.npy",
    "x2_path": f"{DATA}/geo-fno/airfoil/naca/NACA_Cylinder_Y.npy",
    "sigma_path": f"{DATA}/geo-fno/airfoil/naca/NACA_Cylinder_Q.npy",
}
PIPE_PATHS = {
    "x1_path": f"{DATA}/geo-fno/pipe/Pipe_X.npy",
    "x2_path": f"{DATA}/geo-fno/pipe/Pipe_Y.npy",
    "sigma_path": f"{DATA}/geo-fno/pipe/Pipe_Q.npy",
}


def _geo_mesh_family(project, paths, output_dim) -> Dict[str, dict]:
    """airfoil/pipe experiment families (reference:experiments/airfoil/*,
    experiments/pipe/*). Modes: airfoil ffno (32, 16), pipe ffno (16, 16);
    geo-fno (24, 12) / -big (32, 16); airfoil fcno (CNO) at ffno's."""
    out = {}
    big_x, big_y = (32, 16) if project == "airfoil" else (16, 16)
    for n in LAYERS:
        def ffno_model(modes_x, modes_y, width, share):
            return {
                "_target_": "fourierflow_tpu_torch.models.FNOFactorizedMesh2D",
                "modes_x": modes_x, "modes_y": modes_y, "width": width,
                "input_dim": 4, "n_layers": n, "share_weight": share,
                "factor": 4, "ff_weight_norm": True, "n_ff_layers": 2,
                "layer_norm": False,
            }

        variants = {
            "ffno": ffno_model(big_x, big_y, 64, False),
            "ffno-shared": ffno_model(big_x, big_y, 64, True),
        }
        if project == "airfoil":
            variants["ffno-small"] = ffno_model(24, 12, 32, False)
            fcno = dict(ffno_model(big_x, big_y, 64, False))
            fcno["_target_"] = "fourierflow_tpu_torch.models.CNOFactorizedMesh2D"
            variants["fcno"] = fcno
        for name, model in variants.items():
            out[f"{project}/{name}/{n}_layers"] = _structured_mesh(
                project, paths, output_dim, model, group=f"{name}/{n}_layers")

        # Geo-FNO baselines (Li et al. 2022 reproduction): Adam + StepLR.
        # Reference modes: airfoil geo-fno (24, 12, 32) / -big (32, 16, 64)
        # (airfoil/geo-fno*/*/config.yaml); pipe geo-fno (12, 12, 32)
        # (pipe/geo-fno/*/config.yaml).
        geo_variants = {"geo-fno": (24, 12, 32) if project == "airfoil" else (12, 12, 32)}
        if project == "airfoil":
            geo_variants["geo-fno-big"] = (32, 16, 64)
        for name, (m1, m2, w) in geo_variants.items():
            model = {
                "_target_": "fourierflow_tpu_torch.models.FNOMesh2D",
                "modes1": m1, "modes2": m2, "width": w, "n_layers": n,
            }
            out[f"{project}/{name}/{n}_layers"] = _structured_mesh(
                project, paths, output_dim, model, batch_size=20,
                optimizer=_adam(), scheduler=_step_lr(100), max_epochs=501,
                loss_scale=20, group=f"{name}/{n}_layers")
    return out


def _plasticity_family() -> Dict[str, dict]:
    """reference:experiments/plasticity/*"""
    out = {}
    builder = {
        "_target_": "fourierflow_tpu_torch.builders.PlasticityBuilder",
        "data_path": f"{DATA}/geo-fno/plasticity/plas_N987_T20.mat",
        "s1": 101, "s2": 31, "t": 20,
        "train_size": 827, "valid_size": 80, "test_size": 80, "batch_size": 2,
    }
    for n in LAYERS:
        def ffno3d(mx, my, mz, w, share=False, target="FNOFactorizedMesh3D"):
            return {
                "_target_": f"fourierflow_tpu_torch.models.{target}",
                "modes_x": mx, "modes_y": my, "modes_z": mz, "width": w,
                "input_dim": 4, "output_dim": 4, "n_layers": n,
                "share_weight": share, "factor": 4, "ff_weight_norm": True,
                "n_ff_layers": 2, "layer_norm": False,
            }

        # Reference schedule: cosine num_training_steps 82800
        # ("414 batches per epoch" x 200, plasticity/ffno/*/config.yaml).
        variants = {
            "ffno": (ffno3d(32, 12, 8, 64), _adamw(), _cosine(82800), 200, 2),
            "ffno-small": (ffno3d(12, 12, 8, 32), _adamw(), _cosine(82800), 200, 2),
            "ffno-shared": (ffno3d(32, 12, 8, 64, share=True), _adamw(), _cosine(82800), 200, 2),
            "fcno": (ffno3d(32, 12, 8, 64, target="CNOFactorizedMesh3D"), _adamw(),
                     _cosine(82800), 200, 2),
        }
        for name, (m1, m2, m3, w) in {"geo-fno": (12, 12, 8, 32),
                                      "geo-fno-big": (32, 12, 8, 64)}.items():
            model = {
                "_target_": "fourierflow_tpu_torch.models.FNOMesh3D",
                "modes1": m1, "modes2": m2, "modes3": m3, "width": w,
                "n_layers": n,
            }
            variants[name] = (model, _adam(), _step_lr(100), 501, 20)

        for name, (model, opt, sch, epochs, bs) in variants.items():
            out[f"plasticity/{name}/{n}_layers"] = {
                "wandb": _wandb("plasticity", f"{name}/{n}_layers"),
                "builder": dict(builder, batch_size=bs),
                "routine": {
                    "_target_": "fourierflow_tpu_torch.routines.StructuredMeshRoutine",
                    "model": model, "optimizer": opt, "scheduler": sch,
                },
                "trainer": {"max_epochs": epochs},
                "callbacks": _ckpt(),
            }
    return out


# --- point clouds (elasticity) ----------------------------------------------

ELASTICITY_PATHS = {
    "sigma_path": f"{DATA}/geo-fno/elasticity/Meshes/Random_UnitCell_sigma_10.npy",
    "xy_path": f"{DATA}/geo-fno/elasticity/Meshes/Random_UnitCell_XY_10.npy",
    "rr_path": f"{DATA}/geo-fno/elasticity/Meshes/Random_UnitCell_rr_10.npy",
}


def _elasticity_family() -> Dict[str, dict]:
    """reference:experiments/elasticity/*"""
    out = {}
    for n in LAYERS:
        def point_cloud(target, m, s, w, optimizer, scheduler, max_epochs, name):
            return {
                "wandb": _wandb("elasticity", f"{name}/{n}_layers"),
                "builder": {
                    "_target_": "fourierflow_tpu_torch.builders.ElasticityBuilder",
                    **ELASTICITY_PATHS, "train_size": 1000, "valid_size": 200,
                    "test_size": 200, "batch_size": 20,
                },
                "routine": {
                    "_target_": "fourierflow_tpu_torch.routines.PointCloudRoutine",
                    "model": {
                        "_target_": f"fourierflow_tpu_torch.models.{target}",
                        "modes1": m, "modes2": m, "s1": s, "s2": s,
                        "width": w, "in_channels": 2, "out_channels": 1,
                        "n_layers": n,
                    },
                    "iphi": {"_target_": "fourierflow_tpu_torch.models.IPhi", "width": w},
                    "N": 1000,
                    "optimizer": optimizer,
                    "scheduler": scheduler,
                },
                "trainer": {"max_epochs": max_epochs},
                "callbacks": _ckpt(),
            }

        ffno, geo = "FNOFactorizedPointCloud2D", "FNOPointCloud2D"
        # Reference schedules: cosine num_training_steps 10000
        # ("50 batches per epoch" x 200, elasticity/ffno/*/config.yaml).
        for name, args in {
            "ffno": (ffno, 16, 64, 64, _adamw(), _cosine(10000), 200),
            "ffno-small": (ffno, 12, 40, 32, _adamw(), _cosine(10000), 200),
            "geo-fno": (geo, 12, 40, 32, _adam(), _step_lr(50), 501),
            "geo-fno-big": (geo, 16, 64, 64, _adam(), _step_lr(50), 501),
            "ffno-shared": (ffno, 16, 64, 64, _adamw(), _cosine(10000), 200),
        }.items():
            cfg = point_cloud(*args, name)
            if name == "ffno-shared":
                cfg["routine"]["model"]["share_weight"] = True
            out[f"elasticity/{name}/{n}_layers"] = cfg
    return out


# --- registry ---------------------------------------------------------------

def _build_registry() -> Dict[str, dict]:
    reg: Dict[str, dict] = {}
    for n in LAYERS:
        reg[f"torus_li/markov/{n}_layers"] = _torus_li_markov(n)
        reg[f"torus_li/zongyi/{n}_layers"] = _torus_li_zongyi(n)
    reg.update(_torus_li_ablations())
    reg.update(_geo_mesh_family("airfoil", AIRFOIL_PATHS, 4))
    reg.update(_geo_mesh_family("pipe", PIPE_PATHS, 0))
    reg.update(_plasticity_family())
    reg.update(_elasticity_family())
    for v in ("01_baseline", "02_no_mu", "03_no_mu_force"):
        reg[f"torus_vis/{v}"] = _torus_vis("torus_vis", v)
    for v in ("01_baseline", "02_no_mu", "03_no_mu_force", "06_shared_all_no_fork"):
        reg[f"torus_vis_force/{v}"] = _torus_vis("torus_vis_force", v)
    reg.update(_kochkov_family())
    reg.update(_kolmogorov_data_configs())
    reg["cylinder_flow/baseline"] = {
        "wandb": _wandb("cylinder_flow", "baseline"),
        "builder": {
            "_target_": "fourierflow_tpu_torch.builders.CylinderFlowBuilder",
            "path": f"{DATA}/meshgraphnets/cylinder_flow/cylinder_flow.h5",
            "batch_size": 4,
        },
        "routine": {
            "_target_": "fourierflow_tpu_torch.routines.MeshGraphNetRoutine",
            "clip_val": 0.1,
            "optimizer": _adamw(lr=0.001),
            "scheduler": _cosine(150000),
        },
        "trainer": {"max_epochs": 10, "limit_train_batches": 150,
                    "limit_val_batches": 20},
        "callbacks": _ckpt(),
    }
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
