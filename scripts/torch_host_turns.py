#!/usr/bin/env python3
"""The host-bound numbers of two checkouts of the port, in turns on one card.

    python3 scripts/torch_host_turns.py DIR_A DIR_B [--duration 8] [--steps 5]
                                        [--runs serve512 serve768 train768 serve768_f32
                                                train768_f32 serve512_int8]

Builds each checkout's kernels first, then runs turns A/B/B/A; each turn
runs, from that checkout's root, as processes of their own (--runs picks
them; the first three by default):
  * serve512: `python3 -m mvropose_torch.cli.main serve --duration D` (its
    defaults: 4 synthetic 720x1280 cameras, ViT-B/16 at 512 px, bf16);
  * serve768: the same with `--model-size 768` (the flash forward at T = 2305);
  * train768: `python3 scripts/torch_train_profile.py --steps S` (the
    unfrozen 768-px train step, its flash kernels profiled);
  * serve768_f32: `serve --params RUN/best_params.npz` on an f32 768-px run
    directory that this checkout writes once under build/
    (`write_f32_run_dir`: ViT-B/16 at 768 px with the backbone in f32,
    seed-0 weights), the f32 flash forward at T = 2305;
  * train768_f32: this checkout's `scripts/torch_train_profile.py --steps S
    --vit-dtype float32 --groups 1 --package-root ROOT` on each checkout's
    package (the unfrozen 768-px step with an f32 backbone: the f32 flash
    forward, dK/dV and dQ);
  * serve512_int8: `serve --params RUN/best_params.npz --int8-backbone
    --int8-attention` on a fused-LN run directory that this checkout writes
    once under build/ (`write_int8_run_dir`: ViT-B/16 at 512 px with
    `fused_ln: true`, seed-0 weights), the int8 + fused-LN serve step.
It prints each run's summary lines under its checkout's label and turn. A
change that both checkouts show in one call is the host's, not the code's.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

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


def write_f32_run_dir(run_dir) -> None:
    """`serve --model-size 768`'s model (ViT-B/16 at 768 px, 4 views) with
    its backbone in f32, seed-0 weights, as a run directory."""
    sys.path.insert(0, str(ROOT))
    from mvropose_torch.cli.main import write_run_dir
    from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
    from mvropose_torch.utils.weights import random_flat

    cfg = EstimatorConfig(vit=ViTConfig(image_size=768, dtype="float32"), max_views=4)
    write_run_dir(run_dir, cfg, 768, random_flat(MultiViewPoseEstimator(cfg, device="meta")))


def write_int8_run_dir(run_dir) -> None:
    """The serve default's model (ViT-B/16 at 512 px, 4 views) with
    `fused_ln: true`, seed-0 weights, as a run directory."""
    sys.path.insert(0, str(ROOT))
    from mvropose_torch.cli.main import write_run_dir
    from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
    from mvropose_torch.utils.weights import random_flat

    cfg = EstimatorConfig(vit=ViTConfig(image_size=512, fused_ln=True), max_views=4)
    write_run_dir(run_dir, cfg, 512, random_flat(MultiViewPoseEstimator(cfg, device="meta")))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a", type=Path)
    p.add_argument("b", type=Path)
    p.add_argument("--duration", type=float, default=8.0)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--runs", nargs="+", default=["serve512", "serve768", "train768"],
                   choices=["serve512", "serve768", "train768", "serve768_f32", "train768_f32",
                            "serve512_int8"])
    args = p.parse_args()
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}
    for label, root in trees.items():
        print(f"{label}: {root}", flush=True)
        run(f"{label} build", root, ["-c", "from mvropose_torch.ops import _build; "
                                           "_build.load_library()"], 900)
    serve = ["-m", "mvropose_torch.cli.main", "serve", "--duration", str(args.duration)]
    runs = {"serve512": (serve, 300), "serve768": ([*serve, "--model-size", "768"], 300),
            "train768": (["scripts/torch_train_profile.py", "--steps", str(args.steps)], 600),
            "train768_f32": ([str(ROOT / "scripts" / "torch_train_profile.py"), "--steps",
                              str(args.steps), "--vit-dtype", "float32", "--groups", "1",
                              "--package-root", "."], 600)}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        if "serve768_f32" in args.runs:
            write_f32_run_dir(Path(tmp) / "f32")
            params = str(Path(tmp) / "f32" / "best_params.npz")
            runs["serve768_f32"] = ([*serve, "--params", params], 300)
        if "serve512_int8" in args.runs:
            write_int8_run_dir(Path(tmp) / "int8")
            params = str(Path(tmp) / "int8" / "best_params.npz")
            runs["serve512_int8"] = ([*serve, "--params", params, "--int8-backbone",
                                      "--int8-attention"], 300)
        for turn, label in enumerate("ABBA", 1):
            for name in args.runs:
                argv, timeout = runs[name]
                run(f"{label} turn {turn} {name}", trees[label], argv, timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
