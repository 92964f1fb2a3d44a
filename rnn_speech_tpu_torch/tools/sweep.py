"""Hyperparameter sweep driver: one CLI training run per grid point.

    python -m rnn_speech_tpu_torch.tools.sweep --config config.ini \
        [--max_steps 200] [--device cuda|cpu] [--out sweep_runs] [--dry_run] \
        --set acoustic_network_params.signal_processing=mfcc,fbank \
        --set training.batch_normalization=True,False

The port's counterpart of ``tools/sweep.py``: it writes each combination
of the ``--set`` values into its own copy of the base config (with its
own ``checkpoint_dir``) under ``--out`` and runs ``python -m
rnn_speech_tpu_torch.cli --train_acoustic`` on it, with ``--device``
passed through (default cuda).
"""

from __future__ import annotations

import argparse
import configparser
import itertools
import os
import subprocess
import sys


def parse_grid(specs):
    """["section.key=v1,v2", ...] -> list of (section, key, [values])."""
    grid = []
    for spec in specs:
        target, _, values = spec.partition("=")
        section, _, key = target.partition(".")
        if not values or not key:
            raise SystemExit(f"Bad --set spec: {spec!r} "
                             "(want section.key=v1,v2)")
        grid.append((section, key, values.split(",")))
    return grid


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="config.ini")
    parser.add_argument("--set", action="append", default=[],
                        help="section.key=value1,value2 (repeatable)")
    parser.add_argument("--out", default="sweep_runs",
                        help="Directory for per-run configs/checkpoints")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--max_epoch", type=int, default=1)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device each training run uses (default cuda)")
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    grid = parse_grid(args.set)
    if not grid:
        raise SystemExit("Provide at least one --set section.key=v1,v2")

    combos = list(itertools.product(*(values for _, _, values in grid)))
    os.makedirs(args.out, exist_ok=True)
    results = []
    for combo in combos:
        name = "_".join(
            f"{key}-{value}" for (_, key, _), value in zip(grid, combo)
        ).replace("/", "-")
        run_dir = os.path.join(args.out, name)
        os.makedirs(run_dir, exist_ok=True)

        cp = configparser.ConfigParser()
        cp.read(args.config)
        for (section, key, _), value in zip(grid, combo):
            if not cp.has_section(section):
                cp.add_section(section)
            cp.set(section, key, value)
        cp.set("general", "checkpoint_dir", os.path.join(run_dir, "ckpt"))
        run_config = os.path.join(run_dir, "config.ini")
        with open(run_config, "w") as fh:
            cp.write(fh)

        cmd = [sys.executable, "-m", "rnn_speech_tpu_torch.cli", "--train_acoustic",
               "--config", run_config, "--max_epoch", str(args.max_epoch),
               "--tb_name", name, "--device", args.device]
        if args.max_steps:
            cmd += ["--max_steps", str(args.max_steps)]
        print(f"[sweep] {name}: {' '.join(cmd)}", flush=True)
        if args.dry_run:
            continue
        proc = subprocess.run(cmd)
        results.append((name, proc.returncode))

    for name, rc in results:
        print(f"[sweep] {name}: exit {rc}")
    return 1 if any(rc for _, rc in results) else 0


if __name__ == "__main__":
    sys.exit(main())
