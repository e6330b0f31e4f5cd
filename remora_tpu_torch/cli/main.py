"""``remora_tpu_torch`` command line entry point.

Counterpart of ``remora_tpu/cli/main.py`` (reference ``src/remora/main.py``
+ ``parsers.py``): five sub-command groups (dataset, model, infer,
validate, analyze). Heavy modules are imported lazily inside each runner
so ``--help`` is fast. Optional whole-command cProfile via
REMORA_TPU_PROFILE_FILE. ``run(argv)`` takes an argument list, so the
CLI can be driven in-process.
"""

import argparse
import os
import sys

from remora_tpu_torch import __version__


def build_parser():
    parser = argparse.ArgumentParser(
        prog="remora_tpu_torch",
        description="modified-base calling framework (PyTorch, CUDA)",
    )
    parser.add_argument(
        "--version", action="version",
        version=f"remora_tpu_torch {__version__}",
    )
    subparsers = parser.add_subparsers(dest="command", title="commands")

    from remora_tpu_torch.cli import parsers

    parsers.register_dataset(subparsers)
    parsers.register_model(subparsers)
    parsers.register_infer(subparsers)
    parsers.register_validate(subparsers)
    parsers.register_analyze(subparsers)
    return parser


def run(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        sys.exit(1)
    profile_file = os.getenv("REMORA_TPU_PROFILE_FILE")
    if profile_file:
        import cProfile

        prof = cProfile.Profile()
        try:
            prof.runcall(args.func, args)
        finally:
            prof.dump_stats(profile_file)
    else:
        args.func(args)


if __name__ == "__main__":
    run()
