#!/usr/bin/env python3
"""The host-bound numbers of two checkouts of the port, in turns on one card.

    python3 scripts/torch_host_turns.py DIR_A DIR_B [--duration 8] [--steps 5]

Builds each checkout's kernels first, then runs turns A/B/B/A; each turn
runs, from that checkout's root, as processes of their own:
  * `python3 -m mvropose_torch.cli.main serve --duration D` (its defaults:
    4 synthetic 720x1280 cameras, ViT-B/16 at 512 px, bf16);
  * the same with `--model-size 768` (the flash forward at T = 2305);
  * `python3 scripts/torch_train_profile.py --steps S` (the unfrozen 768-px
    train step, its flash kernels profiled).
It prints each run's summary lines under its checkout's label and turn. A
change that both checkouts show in one call is the host's, not the code's.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

KEEP = ("served ", "overlap:", "train step ", "card:")


def run(label: str, root: Path, argv: list, timeout: float) -> None:
    proc = subprocess.run([sys.executable, *argv], cwd=root, capture_output=True, text=True,
                          timeout=timeout, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(KEEP)]
    for line in lines:
        print(f"[{label}] {line}", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"[{label}] {' '.join(argv)} exited {proc.returncode}:\n"
                         f"{proc.stderr[-4000:]}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a", type=Path)
    p.add_argument("b", type=Path)
    p.add_argument("--duration", type=float, default=8.0)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args()
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}
    for label, root in trees.items():
        print(f"{label}: {root}", flush=True)
        run(f"{label} build", root, ["-c", "from mvropose_torch.ops import _build; "
                                           "_build.load_library()"], 900)
    serve = ["-m", "mvropose_torch.cli.main", "serve", "--duration", str(args.duration)]
    for turn, label in enumerate("ABBA", 1):
        root = trees[label]
        run(f"{label} turn {turn} serve 512", root, serve, 300)
        run(f"{label} turn {turn} serve 768", root, [*serve, "--model-size", "768"], 300)
        run(f"{label} turn {turn} train 768", root,
            ["scripts/torch_train_profile.py", "--steps", str(args.steps)], 600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
