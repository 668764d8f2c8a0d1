"""The DREAM twin's gt-angle pose tail: does the port's `cli train` make it?

`python scripts/torch_dream_gap.py` (no options: the sizes, seeds and
paths are the module's constants)

A CPU comparison of the two packages' `cli train`. The port runs in this
process; the JAX package runs in subprocesses (its command line, `python
-m mvropose_tpu.cli --backend cpu train`, and `REFERENCE_INIT`), so this
script imports none of it and runs only where both are installed. On the
DREAM twin's data (the port's `scripts/torch_make_dream_synthetic.py` at
--focal-scale 0.96, 128 x 128:
N_TRAIN samples from seed 0, N_EVAL held out from seed 77) and
architecture (a 192-wide, 4-layer ViT/16 at 128 px, the query head, a
frozen backbone, augmentation on), cut in samples and epochs to fit the CPU:
  1. the reference's initial weights: its `SingleViewPoseEstimator` from
     the model_config.json its `cli train` wrote, initialized as that
     command does (`model.init(jax.random.PRNGKey(0), zeros)`), saved by
     its `save_params_npz` (`REFERENCE_INIT`, run as `python -c` in a
     subprocess);
  2. for each of SEEDS, the reference's `cli train --robot dream
     --single-view` and the port's with the same flags on the same CSV, the
     port starting from those weights (`utils/weights.py::load_jax_params`
     in place of its own seed-0 init), both loading in-process: the same
     data, split, shuffle order and batches; the dropout and augmentation
     draws are each package's own, as its --seed sets them;
  3. every checkpoint scored by one eval, the port's `cli eval` on the
     held-out set (`cli.eval.evaluate(..., frames=)` gives the per-frame
     rotation errors behind the gt-angle pose mean), so the run-to-run
     spread of each package stands beside the gap between them.
It writes one JSON (per run: the report's keys, the gt-angle rotation
errors' mean, median, p90, largest and count over 30 degrees; the gaps and
spreads) to OUT and prints it. The data and runs go under WORK.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ARCH = ["--image-hw", "128", "128", "--model-size", "128", "--hidden-size", "192",
        "--num-layers", "4"]
# The cut that fits the CPU: samples, epochs, batch and the seeds of the
# run-to-run spread.
N_TRAIN, N_EVAL, EPOCHS, BATCH, SEEDS = 960, 150, 30, 48, (0, 1)
WORK, OUT = ROOT / "build" / "dream_gap", ROOT / "build" / "dream_gap.json"
GT_KEY = "pose_rot_err_deg_gt_angles"
REPORT_KEYS = ("pck@5.0px", "kp_px_err_mean", "angle_mae", "pose_rot_err_deg",
               GT_KEY, "pose_trans_err_m_gt_angles", "pose_success_rate")


def _script(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tail(errors) -> dict:
    """The spread of per-frame rotation errors (degrees); {"n": 0} where no
    view was solved."""
    e = np.asarray(errors, np.float64)
    if not e.size:
        return {"n": 0}
    return {"n": int(e.size), "mean": float(e.mean()), "median": float(np.median(e)),
            "p90": float(np.percentile(e, 90)), "max": float(e.max()),
            "over_30": int((e > 30.0).sum())}


def reference_train(argv: list) -> None:
    """The reference's `cli train` on the CPU, as its own command line,
    loading in-process as the port does (`--num-workers 0`: its grain
    workers would drop the last partial batch and shuffle in their own
    order)."""
    cmd = [sys.executable, "-m", "mvropose_tpu.cli", "--backend", "cpu", "train", *argv,
           "--num-workers", "0"]
    subprocess.run(cmd, cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"}, check=True)


# The reference's single-view model from a run's model_config.json
# (argv[1]: a file beside it), initialized as its `cli train` does, saved to
# argv[2] in its flat checkpoint layout.
REFERENCE_INIT = """
import sys
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from mvropose_tpu.cli.main import _read_model_config
from mvropose_tpu.models import SingleViewPoseEstimator
from mvropose_tpu.train.checkpoint import save_params_npz
cfg, size, kind = _read_model_config(sys.argv[1])
assert kind == "single_view", kind
v = SingleViewPoseEstimator(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
save_params_npz(sys.argv[2], v["params"], v["batch_stats"])
"""


def reference_init(run: Path, out: Path) -> None:
    cmd = [sys.executable, "-c", REFERENCE_INIT, str(run / "best_params.npz"), str(out)]
    subprocess.run(cmd, cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"}, check=True)


def port_train(argv: list, init_path: Path):
    """The port's `cli train` on the CPU from the weights in `init_path`."""
    from mvropose_torch.cli import main as cli_main
    from mvropose_torch.utils.weights import load_jax_params

    real = cli_main.flax_init_state

    def from_reference(model, seed=0):
        load_jax_params(model, init_path)
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    cli_main.flax_init_state = from_reference
    try:
        return cli_main.train(cli_main.build_parser().parse_args(["train", *argv, "--device",
                                                                   "cpu", "--num-workers", "0"]))
    finally:
        cli_main.flax_init_state = real


def main() -> int:
    from mvropose_torch.cli import eval as cli_eval
    from mvropose_torch.cli import main as cli_main

    WORK.mkdir(parents=True, exist_ok=True)
    gen = _script("torch_make_dream_synthetic")
    for name, n, seed in (("train", N_TRAIN, 0), ("eval", N_EVAL, 77)):
        if not (WORK / f"{name}.csv").exists():
            gen.main(["--out-dir", str(WORK / name), "--n-samples", str(n), "--seed", str(seed),
                      "--image-hw", "128", "128", "--focal-scale", "0.96", "--device", "cpu"])
            cli_main.main(["sync", "dream", "--base-dirs", str(WORK / name / "panda_synth"),
                           "--out", str(WORK / f"{name}.csv"), "--strict"])
    common = ["--robot", "dream", "--single-view", "--csv", str(WORK / "train.csv"),
              "--dream-dirs", str(WORK / "train" / "panda_synth"), *ARCH, "--batch-size",
              str(BATCH)]
    init = WORK / "reference_init.npz"
    runs = {}
    for seed in SEEDS:
        for package in ("reference", "port"):
            run = WORK / f"{package}_seed{seed}"
            argv = [*common, "--epochs", str(EPOCHS), "--seed", str(seed), "--workdir",
                    str(run)]
            t0 = time.perf_counter()
            if package == "reference":
                reference_train(argv)
                if not init.exists():
                    reference_init(run, init)
            else:
                port_train(argv, init)
            frames: dict = {}
            report = cli_eval.evaluate(cli_main.build_parser().parse_args(
                ["eval", "--robot", "dream", "--single-view", "--csv", str(WORK / "eval.csv"),
                 "--dream-dirs", str(WORK / "eval" / "panda_synth"), "--params",
                 str(run / "best_params.npz"), "--image-hw", "128", "128", "--batch-size", "50",
                 "--device", "cpu"]), frames=frames)
            runs[f"{package}_seed{seed}"] = {
                **{k: report.get(k) for k in REPORT_KEYS},
                "gt_angle_rotation_frames": tail(frames.get(GT_KEY, [])),
                "seconds": time.perf_counter() - t0}
            print(json.dumps({f"{package}_seed{seed}": runs[f"{package}_seed{seed}"]}),
                  flush=True)
    means = {k: v[GT_KEY] if v[GT_KEY] is not None else float("nan") for k, v in runs.items()}
    out = {
        "setup": {"n_train": N_TRAIN, "n_eval": N_EVAL, "epochs": EPOCHS, "batch": BATCH,
                  "seeds": list(SEEDS), "arch": " ".join(ARCH),
                  "device": "cpu", "eval": "the port's cli eval on both checkpoints"},
        "runs": runs,
        "gap_port_minus_reference": {s: means[f"port_seed{s}"] - means[f"reference_seed{s}"]
                                     for s in SEEDS},
        "spread_between_seeds": {pkg: max(means[f"{pkg}_seed{s}"] for s in SEEDS)
                                 - min(means[f"{pkg}_seed{s}"] for s in SEEDS)
                                 for pkg in ("reference", "port")},
    }
    OUT.write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
