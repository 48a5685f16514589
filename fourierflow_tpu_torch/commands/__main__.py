"""CLI entry point: ``python -m fourierflow_tpu_torch.commands <cmd> ...``.

Commands ported so far: ``infer``. It runs on CUDA unless ``--device cpu``
is given, and raises when no GPU is present and the CPU was not asked for.
"""

import argparse
import logging
import sys


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(prog="fourierflow_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_infer = sub.add_parser("infer", help="timed autoregressive rollout")
    p_infer.add_argument("config_path", help="experiment config YAML")
    p_infer.add_argument("overrides", nargs="*", help="dotted-path overrides key=value")
    p_infer.add_argument("--trial", type=int, default=0)
    p_infer.add_argument("--checkpoint-path", default=None)
    p_infer.add_argument("--n-steps", type=int, default=100)
    p_infer.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    args = parser.parse_args(argv)
    if args.command == "infer":
        from .infer import main as infer_main

        infer_main(args.config_path, args.checkpoint_path, overrides=args.overrides,
                   n_steps=args.n_steps, trial=args.trial, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
