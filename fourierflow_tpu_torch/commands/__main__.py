"""CLI entry point: ``python -m fourierflow_tpu_torch.commands <cmd> ...``.

Commands: ``train``, ``test``, ``predict``, ``infer``, ``export``,
``sample``, ``plot``, ``generate navier-stokes``, ``generate kolmogorov``,
``convert cylinder-flow`` and ``configs list|export``, with the JAX package's flags (``export``
without ``--platforms``). An experiment is a YAML file or a name of the registry
(``configs list``). Each runs on CUDA unless ``--device cpu`` is given, and
raises when no GPU is present and the CPU was not asked for; ``plot``, the
configs and the converter run on the host only.
"""

import argparse
import logging
import os
import sys


def _add_common(p):
    p.add_argument("config_path", help="experiment config YAML or registry name")
    p.add_argument("overrides", nargs="*", help="dotted-path overrides key=value")
    p.add_argument("--trial", type=int, default=0)


def _add_device(p):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(prog="fourierflow_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train (and test) one trial of an experiment")
    _add_common(p_train)
    p_train.add_argument("--checkpoint-path", default=None,
                         help="start from this checkpoint of the port: weights, normalizer, "
                              "optimizer, schedule and step")
    p_train.add_argument("--force", action="store_true", help="train again over existing results")
    p_train.add_argument("--resume", action="store_true",
                         help="start from the trial's newest last.ckpt")
    p_train.add_argument("--profile-dir", default=None,
                         help="write a torch.profiler trace of the fit into this directory")
    p_train.add_argument("--no-test", action="store_true", help="skip the test pass")
    p_train.add_argument("--config-dir", default=None,
                         help="where checkpoints/ goes (default: the YAML's directory, or the "
                              "registry name as a directory)")
    _add_device(p_train)

    p_test = sub.add_parser("test", help="evaluate a checkpoint on the test split")
    _add_common(p_test)
    p_test.add_argument("--checkpoint-path", default=None,
                        help="defaults to the newest trial checkpoint")
    p_test.add_argument("--torch-checkpoint", default=None,
                        help="reference (PyTorch Lightning) .ckpt to evaluate instead")
    p_test.add_argument("--config-dir", default=None,
                        help="where checkpoints/ is (default: as in train)")
    _add_device(p_test)

    p_predict = sub.add_parser("predict", help="inference time (s/sample/sim-second)")
    p_predict.add_argument("config_path", nargs="?", default=None,
                           help="experiment config (omit to time the DNS baseline)")
    p_predict.add_argument("overrides", nargs="*")
    p_predict.add_argument("--trial", type=int, default=0)
    p_predict.add_argument("--checkpoint-path", default=None)
    _add_device(p_predict)

    p_infer = sub.add_parser("infer", help="timed autoregressive rollout")
    _add_common(p_infer)
    p_infer.add_argument("--checkpoint-path", default=None)
    p_infer.add_argument("--torch-checkpoint", default=None,
                         help="reference (PyTorch Lightning) .ckpt to load instead of a port "
                              "checkpoint")
    p_infer.add_argument("--n-steps", type=int, default=100)
    _add_device(p_infer)

    p_export = sub.add_parser("export", help="write the rollout as a torch.export artifact")
    p_export.add_argument("config_path", help="experiment config YAML or registry name")
    p_export.add_argument("out_path")
    p_export.add_argument("overrides", nargs="*", help="dotted-path overrides key=value")
    p_export.add_argument("--trial", type=int, default=0)
    p_export.add_argument("--checkpoint-path", default=None)
    p_export.add_argument("--torch-checkpoint", default=None)
    p_export.add_argument("--n-steps", type=int, default=20)
    p_export.add_argument("--batch-size", type=int, default=1)
    p_export.add_argument("--size", type=int, default=64)
    p_export.add_argument("--precision", default=None, choices=["highest"],
                          help="float32 matmul precision of the artifact; the port computes at "
                               "'highest' only (the JAX export's 'default' and 'high' would make "
                               "the artifact differ from the live model)")
    _add_device(p_export)

    p_sample = sub.add_parser("sample", help="pickle one (batch, pred) pair")
    _add_common(p_sample)
    p_sample.add_argument("--checkpoint-path", default=None)
    p_sample.add_argument("--out-path", default=None)
    _add_device(p_sample)

    p_plot = sub.add_parser("plot", help="figures and tables from local run logs")
    p_plot.add_argument("kind", choices=["layers", "correlation", "step-losses", "parameters",
                                         "table", "heatmap", "energy", "flows", "superresolution",
                                         "ablation", "tradeoff", "stepsize"])
    p_plot.add_argument("dataset", nargs="?", default=None,
                        help="for 'table': one of torus_li/airfoil/elasticity/plasticity/pipe "
                             "-> the paper's Table A.3-A.6 layout; for 'superresolution': the "
                             "results JSON; for 'tradeoff': the data directory; for "
                             "'stepsize': the DNS JSON")
    p_plot.add_argument("--root", default="configs")
    p_plot.add_argument("--sample-path", default=None)
    p_plot.add_argument("--out-path", default=None)
    p_plot.add_argument("--latex", action="store_true",
                        help="emit the reference's LaTeX rows for tables")
    p_plot.add_argument("--inputs", nargs="+", default=None,
                        help="for 'energy'/'flows': name=path.h5 prediction/trajectory files; "
                             "for 'ablation'/'stepsize': value=campaign_log.jsonl; for "
                             "'tradeoff': label=runtime DNS baseline points")
    p_plot.add_argument("--times", type=int, nargs="+", default=None,
                        help="for 'flows': time indices (columns)")
    p_plot.add_argument("--tail", type=int, default=80,
                        help="for 'energy': trailing time window to average")
    p_plot.add_argument("--sample", type=int, default=0, help="for 'flows': sample index")
    p_plot.add_argument("--train-size", type=int, default=64,
                        help="for 'superresolution': the checkpoint's training grid size "
                             "(marks the figure)")
    p_plot.add_argument("--xlabel", default="parameter",
                        help="for 'ablation': swept-parameter axis label")
    p_plot.add_argument("--metrics", nargs="+", default=None,
                        help="for 'ablation': campaign_log.jsonl keys to plot (default "
                             "valid_time_until, train_loss)")

    p_gen = sub.add_parser("generate", help="generate datasets")
    gen_sub = p_gen.add_subparsers(dest="generator", required=True)
    p_ns = gen_sub.add_parser("navier-stokes", help="torus Navier-Stokes trajectories (h5)")
    p_ns.add_argument("path")
    for name, typ, default in [
        ("n-train", int, 1000), ("n-valid", int, 200), ("n-test", int, 200),
        ("s", int, 256), ("t", float, 20.0), ("steps", int, 20),
        ("mu", float, 1e-5), ("mu-min", float, 1e-5), ("mu-max", float, 1e-5),
        ("seed", int, 23893), ("delta", float, 1e-4), ("batch-size", int, 50),
        ("force", str, "li"), ("cycles", int, 2), ("scaling", float, 0.1),
        ("t-scaling", float, 0.2),
    ]:
        p_ns.add_argument(f"--{name}", type=typ, default=default)
    p_ns.add_argument("--varying-force", action="store_true")
    _add_device(p_ns)
    p_kol = gen_sub.add_parser("kolmogorov", help="Kolmogorov flow data from a data config (h5)")
    p_kol.add_argument("config_path", help="data config YAML or registry name")
    p_kol.add_argument("overrides", nargs="*", help="dotted-path overrides key=value")
    p_kol.add_argument("--out-dir", default=None,
                       help="where the files go (default: the config's directory, or the "
                            "registry name's parent as a directory)")
    _add_device(p_kol)

    p_conv = sub.add_parser("convert", help="convert MeshGraphNets TFRecords to HDF5")
    conv_sub = p_conv.add_subparsers(dest="converter", required=True)
    p_cf = conv_sub.add_parser("cylinder-flow")
    p_cf.add_argument("--data-dir", default="data/meshgraphnets/cylinder_flow")
    p_cf.add_argument("--out", default="data/meshgraphnets/cylinder_flow/cylinder_flow.h5")

    p_cfg = sub.add_parser("configs", help="list or export registry experiments")
    p_cfg.add_argument("action", choices=["list", "export"])
    p_cfg.add_argument("name", nargs="?", default=None)
    p_cfg.add_argument("--out-dir", default="configs")

    args = parser.parse_args(argv)
    if args.command == "train":
        from .train import main as train_main

        train_main(args.config_path, args.overrides, trial=args.trial,
                   checkpoint_path=args.checkpoint_path, no_test=args.no_test, force=args.force,
                   resume=args.resume, profile_dir=args.profile_dir,
                   config_dir=args.config_dir, device=args.device)
    elif args.command == "test":
        from .test import main as test_main

        test_main(args.config_path, args.checkpoint_path, overrides=args.overrides,
                  trial=args.trial, torch_checkpoint=args.torch_checkpoint,
                  config_dir=args.config_dir, device=args.device)
    elif args.command == "predict":
        from .predict import main as predict_main

        predict_main(args.config_path, args.checkpoint_path, overrides=args.overrides,
                     trial=args.trial, device=args.device)
    elif args.command == "infer":
        from .infer import main as infer_main

        infer_main(args.config_path, args.checkpoint_path, overrides=args.overrides,
                   n_steps=args.n_steps, trial=args.trial, device=args.device,
                   torch_checkpoint=args.torch_checkpoint)
    elif args.command == "export":
        from .export import main as export_main

        export_main(args.config_path, args.out_path, checkpoint_path=args.checkpoint_path,
                    torch_checkpoint=args.torch_checkpoint, overrides=args.overrides,
                    n_steps=args.n_steps, batch_size=args.batch_size, size=args.size,
                    trial=args.trial, precision=args.precision, device=args.device)
    elif args.command == "sample":
        from .sample import main as sample_main

        sample_main(args.config_path, args.checkpoint_path, overrides=args.overrides,
                    trial=args.trial, out_path=args.out_path, device=args.device)
    elif args.command == "plot":
        plot(args)
    elif args.command == "generate" and args.generator == "navier-stokes":
        from .generate import navier_stokes

        navier_stokes(args.path, n_train=args.n_train, n_valid=args.n_valid, n_test=args.n_test,
                      s=args.s, t=args.t, steps=args.steps, mu=args.mu, mu_min=args.mu_min,
                      mu_max=args.mu_max, seed=args.seed, delta=args.delta,
                      batch_size=args.batch_size, force=args.force, cycles=args.cycles,
                      scaling=args.scaling, t_scaling=args.t_scaling,
                      varying_force=args.varying_force, device=args.device)
    elif args.command == "generate" and args.generator == "kolmogorov":
        from .generate import kolmogorov

        kolmogorov(args.config_path, args.overrides, device=args.device, out_dir=args.out_dir)
    elif args.command == "convert":
        from .convert import cylinder_flow

        cylinder_flow(args.data_dir, args.out)
    elif args.command == "configs":
        from ..experiments import experiment_names, materialize

        if args.action == "list":
            for name in experiment_names():
                print(name)
        else:
            if args.name is None:
                raise SystemExit("export needs an experiment name")
            print(materialize(args.name, args.out_dir))


def plot(args) -> None:
    """The ``plot`` subcommand: ``args.kind`` with its options."""
    from . import plot as plot_mod

    out = args.out_path
    if args.kind == "heatmap":
        plot_mod.heatmap(args.sample_path)
    elif args.kind == "table":
        plot_mod.table(args.root, out_path=out, dataset=args.dataset, latex=args.latex)
    elif args.kind == "layers":
        plot_mod.layers(args.root, out_path=out or "layers.png")
    elif args.kind == "step-losses":
        plot_mod.step_losses(args.root, out_path=out or "step_losses.png")
    elif args.kind == "parameters":
        plot_mod.parameters(args.root, out_path=out or "parameters.png")
    elif args.kind == "energy":
        plot_mod.energy(args.inputs or [], out_path=out or "energy.png", tail=args.tail)
    elif args.kind == "flows":
        plot_mod.flows(args.inputs or [], out_path=out or "samples.png", sample=args.sample,
                       times=args.times)
    elif args.kind == "superresolution":
        plot_mod.superresolution(args.dataset or "superres_results.json",
                                 out_path=out or "superresolution.png",
                                 train_size=args.train_size)
    elif args.kind == "ablation":
        plot_mod.ablation(args.inputs or [], out_path=out or "ablation.png", xlabel=args.xlabel,
                          metrics=args.metrics)
    elif args.kind == "tradeoff":
        plot_mod.tradeoff(args.dataset or os.path.join("data", "kochkov512"),
                          out_path=out or "tradeoff.png", dns=args.inputs)
    elif args.kind == "stepsize":
        plot_mod.stepsize(args.inputs or [], dns_path=args.dataset,
                          out_path=out or "stepsize.png")
    else:
        plot_mod.correlation(args.root, out_path=out or "correlation.png")


if __name__ == "__main__":
    main(sys.argv[1:])
