"""The int8 accuracy receipt on the card: PCK parity of `--int8-backbone` (and
`--int8-attention`) against float, on a checkpoint the port trains.

`python3 scripts/torch_int8_receipt.py [--seed S] [--num-workers N] [--no-freeze-backbone] [--mixed3] [--work DIR] [--out FILE]`

The twin of the reference's receipt (`runs/int8_bench.json` and
`runs/attn8_ln_bench.json`, `pck_parity`, on the converged
`runs/dream_synth_real_geom` run), all through the port's own entry points:
  1. `scripts/torch_make_dream_synthetic.py` at --focal-scale 0.96 (DREAM-real's
     angular resolution), 128 x 128: 2,400 training samples (seed 0) and 300
     held-out samples (seed 77);
  2. `cli sync dream` of each;
  3. `cli train --robot dream --single-view` at the run's architecture (a
     192-wide, 4-layer ViT/16 at 128 px, query head, frozen backbone, the
     flags' defaults otherwise) for 100 epochs; batch 66 gives the
     reference's 33 steps an epoch over the 2,160 training samples (the
     port pads the last batch: ceil(2160 / 66) = 33); `--seed` is cli
     train's (the sample order, augmentation and dropout draws; default 0)
     and `--num-workers` its loader's worker processes (default 0, the
     batches made in-process);
  4. `cli eval` on the held-out set at --batch-size 50, four times: float,
     --int8-backbone, --int8-backbone --int8-attention, and float with
     --occlusion-masks 2; for the first three also the spread of the
     per-frame rotation errors behind the pose means (`evaluate`'s
     `frames`);
  5. with --no-freeze-backbone the same twin with its backbone trained:
     the reference's receipt froze a random backbone whose LayerScale
     gammas then stay at their 1e-5, so its int8 blocks barely reach the
     heads (the JSON gives the largest |gamma| of the checkpoint);
  6. with --mixed3 also the twin of `runs/mixed3` (`eval_heldout.txt`):
     `scripts/torch_make_mixed_synthetic.py` for fr5, fr3 and meca_insertion,
     2,000 a robot (seed 0) and 300 held out (seed 99, the same cameras),
     `cli train --robot fr5,fr3,meca_insertion` at the same architecture,
     batch 64, 80 epochs, and its per-robot `cli eval`.
It writes one JSON (the reference's `pck_parity` fields for each variant,
the full reports, the reference's numbers beside them, the acceptance
checks, each step's wall time, the card's name and power limit) to --out,
and prints it. The data and runs go under --work (both default under the
ignored build/). It runs on the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# The reference's numbers (runs/int8_bench.json, runs/attn8_ln_bench.json,
# runs/dream_synth_real_geom/final_metrics.json, runs/mixed3/eval_heldout.txt).
REFERENCE = {
    "float": {"pck5": 0.9990476171175638, "kp_px_err_mean": 1.2039297223091125,
              "angle_mae": 0.3177218834559123, "pose_rot_err_deg_gt_angles": 10.043914794921875},
    "int8": {"pck5": 0.9990476171175638, "kp_px_err_mean": 1.2042400042215984,
             "angle_mae": 0.31757235030333203,
             "pose_rot_err_deg_gt_angles": 10.084552764892578},
    "int8_attn8_source": "runs/attn8_ln_bench.json: on runs/dream_geo (the geometric head), "
                         "float pck5 0.9990476171175638, kp err 1.183469553788503; "
                         "int8_attn8 0.9990476171175638, 1.1859775185585022",
    "occlusion_probe": {"occlusion_masks": 2, "pck5": 0.8019047578175863,
                        "pose_success_rate": 0.7733333110809326},
    "mixed3": {"fr5": {"pck@5.0px": 1.0, "angle_mae_native": 12.01286885579427,
                       "add_m": 0.05071386893590291},
               "fr3": {"pck@5.0px": 1.0, "angle_mae_native": 0.16055099328358968,
                       "add_m": 0.020359728137652078},
               "meca_insertion": {"pck@5.0px": 1.0, "angle_mae_native": 10.620002746582031,
                                  "add_m": 0.012026607990264893}},
}
# The receipt's parity bar: float pck5 >= 0.95; int8 pck5 no more than 0.005
# below float and kp error no more than 0.05 px above it.
FLOAT_PCK_MIN, PCK_GAP, KP_GAP = 0.95, 0.005, 0.05
ARCH = ["--image-hw", "128", "128", "--model-size", "128", "--hidden-size", "192",
        "--num-layers", "4"]
# The twin's sizes: samples generated, epochs and the training batch.
N_TRAIN, N_EVAL, EPOCHS, BATCH = 2400, 300, 100, 66
MIXED_SAMPLES, MIXED_EVAL_SAMPLES, MIXED_EPOCHS, MIXED_BATCH = 2000, 300, 80, 64
DEVICE = ["--device", "cuda"]


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def _pick(report: dict) -> dict:
    """The receipt's four numbers, under runs/int8_bench.json's names."""
    return {"pck5": report["pck@5.0px"], "kp_px_err_mean": report["kp_px_err_mean"],
            "angle_mae": report["angle_mae"],
            "pose_rot_err_deg_gt_angles": report.get("pose_rot_err_deg_gt_angles")}


def _spread(errors: list) -> dict:
    """The per-frame distribution behind a mean error."""
    v = np.sort(np.asarray(errors, np.float64))
    worst = v[-max(1, v.size // 10):]
    return {"frames": int(v.size), "mean": float(v.mean()), "median": float(np.median(v)),
            "p90": float(np.percentile(v, 90)), "p99": float(np.percentile(v, 99)),
            "max": float(v[-1]), "frames_over_30": int((v > 30).sum()),
            "worst_tenth_share_of_sum": float(worst.sum() / v.sum())}


def _gamma_max(params: Path) -> float:
    """The largest |gamma| of the backbone's LayerScales in a checkpoint."""
    with np.load(params) as flat:
        return max(float(np.abs(flat[k]).max()) for k in flat.files
                   if k.startswith("backbone/") and k.endswith("/gamma"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work", default=str(ROOT / "build" / "int8_receipt"))
    p.add_argument("--out", default=str(ROOT / "build" / "int8_receipt.json"))
    p.add_argument("--no-freeze-backbone", action="store_true",
                   help="train the twin's backbone too")
    p.add_argument("--mixed3", action="store_true", help="also the twin of runs/mixed3")
    p.add_argument("--seed", type=int, default=0, help="cli train's --seed")
    p.add_argument("--num-workers", type=int, default=0, help="cli train's --num-workers")
    args = p.parse_args(argv)
    train_flags = ["--seed", str(args.seed), "--num-workers", str(args.num_workers)]

    import torch

    from mvropose_torch.cli import eval as cli_eval
    from mvropose_torch.cli import main as cli_main

    if not torch.cuda.is_available():
        raise SystemExit("torch_int8_receipt: no CUDA device is available")
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    steps_s: dict = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        steps_s[name] = time.perf_counter() - t0
        print(f"[{name}] {steps_s[name]:.1f} s", flush=True)
        return out

    def script(name):
        import importlib.util

        spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def evaluate(argv, frames=None):
        return cli_eval.evaluate(cli_main.build_parser().parse_args(["eval", *argv, *DEVICE]),
                                 frames=frames)

    gen = script("torch_make_dream_synthetic")
    for name, n, seed in (("dream5", N_TRAIN, 0), ("dream5_eval", N_EVAL, 77)):
        timed(f"generate {name}", lambda: gen.main(
            ["--out-dir", str(work / name), "--n-samples", str(n), "--seed", str(seed),
             "--image-hw", "128", "128", "--focal-scale", "0.96", *DEVICE]))
        timed(f"sync {name}", lambda: cli_main.main(
            ["sync", "dream", "--base-dirs", str(work / name / "panda_synth"), "--out",
             str(work / f"{name}.csv"), "--strict"]))
    run = work / "dream_run"
    result = timed("train", lambda: cli_main.train(cli_main.build_parser().parse_args(
        ["train", "--robot", "dream", "--single-view", "--csv", str(work / "dream5.csv"),
         "--dream-dirs", str(work / "dream5" / "panda_synth"), "--workdir", str(run),
         *ARCH, "--batch-size", str(BATCH), "--epochs", str(EPOCHS), *DEVICE, *train_flags,
         *(["--no-freeze-backbone"] if args.no_freeze_backbone else [])])))
    records = [json.loads(line) for line in (run / "logs" / "metrics.jsonl").read_text()
               .splitlines()]
    eval_argv = ["--robot", "dream", "--single-view", "--csv", str(work / "dream5_eval.csv"),
                 "--dream-dirs", str(work / "dream5_eval" / "panda_synth"), "--params",
                 str(run / "best_params.npz"), "--image-hw", "128", "128", "--batch-size", "50"]
    variants = {"float": [], "int8": ["--int8-backbone"],
                "int8_attn8": ["--int8-backbone", "--int8-attention"],
                "occlusion_probe": ["--occlusion-masks", "2"]}
    frames = {name: {} for name in variants}
    reports = {name: timed(f"eval {name}", lambda extra=extra, name=name: evaluate(
        [*eval_argv, *extra], frames[name])) for name, extra in variants.items()}
    f, checks = reports["float"], {}
    checks["float_pck5_at_least_0.95"] = f["pck@5.0px"] >= FLOAT_PCK_MIN
    for name in ("int8", "int8_attn8"):
        r = reports[name]
        checks[f"{name}_pck5_within_0.005"] = r["pck@5.0px"] >= f["pck@5.0px"] - PCK_GAP
        checks[f"{name}_kp_err_within_0.05px"] = (r["kp_px_err_mean"]
                                                  <= f["kp_px_err_mean"] + KP_GAP)
    out = {
        "card": _card(),
        "torch": torch.__version__,
        "checkpoint": f"{run / 'best_params.npz'} (cli train, {result.epochs_run} epochs run "
                      f"in this call, {len(records)} recorded)",
        "train": {"epochs": EPOCHS, "batch_size": BATCH, "seed": args.seed,
                  "num_workers": args.num_workers,
                  "backbone": "trained" if args.no_freeze_backbone else "frozen",
                  "layerscale_gamma_max": _gamma_max(run / "best_params.npz"),
                  "steps_per_epoch": records[0]["step"] if records else None,
                  "train_samples": int(N_TRAIN * 0.9), "best_val_loss": result.best_val_loss,
                  "last_record": records[-1] if records else None},
        **{name: _pick(r) for name, r in reports.items()},
        "eval_cmd": "cli eval --robot dream --single-view --batch-size 50 [--int8-backbone "
                    "[--int8-attention]] [--occlusion-masks 2] on the 300 held-out samples",
        "checks": checks,
        "rotation_error_spread_deg": {
            name: {key: _spread(v) for key, v in frames[name].items() if "_deg" in key}
            for name in ("float", "int8", "int8_attn8")},
        "reference": REFERENCE,
        "reports": reports,
        "steps_s": steps_s,
    }
    if args.mixed3:
        mixed, held = work / "mixed3", work / "mixed3_eval"
        mgen = script("torch_make_mixed_synthetic")
        robots = ["fr5", "fr3", "meca_insertion"]
        timed("generate mixed3", lambda: mgen.main(
            ["--out-dir", str(mixed), "--robots", *robots, "--n-samples",
             str(MIXED_SAMPLES), "--seed", "0", *DEVICE]))
        timed("generate mixed3_eval", lambda: mgen.main(
            ["--out-dir", str(held), "--robots", *robots, "--n-samples",
             str(MIXED_EVAL_SAMPLES), "--seed", "99", "--calib-from", str(mixed), *DEVICE]))
        sums = [str(mixed / f"{'pose1' if r == 'fr3' else r}_aruco_pose_summary.json")
                for r in robots]
        common = ["--robot", ",".join(robots), "--calib-dir", str(mixed / "calib"),
                  "--aruco-summary", *sums, *ARCH]
        mrun = work / "mixed3_run"
        timed("train mixed3", lambda: cli_main.train(cli_main.build_parser().parse_args(
            ["train", *common, "--csv", *(str(mixed / f"{r}.csv") for r in robots),
             "--workdir", str(mrun), "--batch-size", str(MIXED_BATCH), "--epochs",
             str(MIXED_EPOCHS), *DEVICE, *train_flags])))
        out["mixed3"] = timed("eval mixed3", lambda: evaluate(
            [*common, "--csv", *(str(held / f"{r}.csv") for r in robots), "--params",
             str(mrun / "best_params.npz"), "--batch-size", "50"]))
        out["steps_s"] = steps_s
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "reports"}, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
