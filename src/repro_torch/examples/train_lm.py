"""End-to-end training driver: train an LM for a few hundred steps with
checkpointing + resume (the port of `examples/train_lm.py`).

Default is CPU-friendly (reduced xlstm-125m, 200 steps). For the full
~168M parameter xlstm-125m run:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --full
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

This is a thin veneer over the production launcher
(repro_torch.launch.train), which is the same code path the
fault-tolerance tests exercise. Runs on the card unless `--device cpu` is
given; raises without a card.
"""

from __future__ import annotations

import argparse

from repro_torch.launch.train import main as train_main

CKPT_DIR = "/tmp/train_lm_ckpt"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="full 168M-param xlstm-125m (accelerator scale)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    return ap


def launcher_argv(args, ckpt_dir: str = CKPT_DIR) -> list[str]:
    """The launcher's argv for the example's parsed flags: the JAX
    script's, with `--device` added when one is given."""
    argv = [
        "--arch", args.arch,
        "--steps", str(args.steps),
        "--batch", "8" if not args.full else "64",
        "--seq", "128" if not args.full else "1024",
        "--ckpt-dir", ckpt_dir,
        "--ckpt-every", "50",
        "--resume",
        "--log-every", "10",
    ]
    if not args.full:
        argv.append("--reduced")
    if args.device is not None:
        argv += ["--device", args.device]
    return argv


def main(argv: list[str] | None = None, *, ckpt_dir: str = CKPT_DIR
         ) -> dict:
    """Train as the flags say, checkpointing into (and resuming from)
    `ckpt_dir`; returns the launcher's result (the last step's metrics,
    "steps", and each step's "history")."""
    return train_main(launcher_argv(parser().parse_args(argv), ckpt_dir))


if __name__ == "__main__":
    main()
