"""CLI entry point: ``python -m fourierflow_tpu_torch.commands <cmd> ...``.

Commands ported so far: ``train`` and ``infer``. Both run on CUDA unless
``--device cpu`` is given, and raise when no GPU is present and the CPU
was not asked for.
"""

import argparse
import logging
import sys


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(prog="fourierflow_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train (and test) one trial of an experiment")
    p_train.add_argument("config_path", help="experiment config YAML")
    p_train.add_argument("overrides", nargs="*", help="dotted-path overrides key=value")
    p_train.add_argument("--trial", type=int, default=0)
    p_train.add_argument("--force", action="store_true", help="train again over existing results")
    p_train.add_argument("--no-test", action="store_true", help="skip the test pass")
    p_train.add_argument("--config-dir", default=None,
                         help="where checkpoints/ goes (default: the config's directory)")
    p_train.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    p_infer = sub.add_parser("infer", help="timed autoregressive rollout")
    p_infer.add_argument("config_path", help="experiment config YAML")
    p_infer.add_argument("overrides", nargs="*", help="dotted-path overrides key=value")
    p_infer.add_argument("--trial", type=int, default=0)
    p_infer.add_argument("--checkpoint-path", default=None)
    p_infer.add_argument("--n-steps", type=int, default=100)
    p_infer.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    args = parser.parse_args(argv)
    if args.command == "train":
        from .train import main as train_main

        train_main(args.config_path, args.overrides, trial=args.trial, no_test=args.no_test,
                   force=args.force, config_dir=args.config_dir, device=args.device)
    elif args.command == "infer":
        from .infer import main as infer_main

        infer_main(args.config_path, args.checkpoint_path, overrides=args.overrides,
                   n_steps=args.n_steps, trial=args.trial, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
