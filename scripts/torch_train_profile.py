#!/usr/bin/env python3
"""Where the unfrozen 768-px train step spends its time on the GPU.

    python3 scripts/torch_train_profile.py [--steps 3] [--rows 25] [--trace-dir DIR]
        [--vit-dtype bfloat16|float32] [--groups G] [--package-root DIR]

The step of `chip_smoke.py`'s unfrozen 768-px phase (ViT-B/16 at 768 px,
backbone trained, fr3, 2 groups x 4 views, 128x128 heatmaps, bf16,
`flax_init_state` seed 1) on one resident batch, with the flash-attention
kernels at d = 64, forward and backward (`ops/attention.py`: the "wgmma"
route; with --vit-dtype float32 the backbone in f32 and its split-TF32
route; --groups sets the groups of 4 views). --package-root imports the
port and `chip_smoke.py` from another checkout (unpacked with git archive),
so that two checkouts' packages are timed by this one script:
  * step time: CUDA events around each of --steps steps, the median;
  * under torch.profiler, over --steps more steps: the device busy time per
    step (summed kernel and copy durations), the host wall time per step
    (host clock around the steps, ending in a synchronize) and the busy
    share, busy / wall;
  * the flash kernels' device time per step, and the operators by device
    time.
With --trace-dir, a chrome trace is written there. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]


def package_root() -> Path:
    """The checkout whose port this run imports: --package-root, else this one."""
    if "--package-root" in sys.argv[:-1]:
        return Path(sys.argv[sys.argv.index("--package-root") + 1]).resolve()
    return ROOT


sys.path.insert(0, str(package_root()))

import chip_smoke  # noqa: E402
from mvropose_torch.data.synthetic import (  # noqa: E402
    make_rig,
    rig_tuple,
    synthesize_multiview_batch,
)
from mvropose_torch.geometry.robots import get_robot  # noqa: E402
from mvropose_torch.models import MultiViewPoseEstimator  # noqa: E402
from mvropose_torch.ops import attention  # noqa: E402
from mvropose_torch.train import (  # noqa: E402
    TrainConfig,
    create_train_state,
    make_multi_view_train_step,
)
from mvropose_torch.utils.weights import flax_init_state  # noqa: E402

# Substrings of the flash kernels' symbols (the f32 route's pre-pass: "flash_split").
FLASH_NAMES = ("flash_fwd", "flash_dkv", "flash_dq", "flash_split")


def profile_turn(run, steps: int, trace: Path | None) -> dict:
    """Step times, then a profiled window of `steps` steps of `run`."""
    for _ in range(2):
        run()
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps
    flash = {name: sum(e.time_range.elapsed_us() for e in device if name in e.name) / 1e3 / steps
             for name in FLASH_NAMES}
    return {"step_ms": statistics.median(times), "wall_ms": wall_ms, "busy_ms": busy_ms,
            "flash_ms": flash, "prof": prof}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--rows", type=int, default=25, help="operators listed")
    p.add_argument("--trace-dir", default=None, help="write a chrome trace here")
    p.add_argument("--vit-dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   help="the backbone's compute dtype")
    p.add_argument("--groups", type=int, default=chip_smoke.TRAIN_768_GROUPS,
                   help="groups of 4 views a batch")
    p.add_argument("--package-root", default=None, help="import the port from this checkout")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    base = chip_smoke.UNFROZEN_768
    cfg = dataclasses.replace(base, vit=dataclasses.replace(base.vit, dtype=args.vit_dtype))
    model = MultiViewPoseEstimator(cfg, device=dev)
    model.load_state_dict(flax_init_state(model, seed=1))
    state = create_train_state(model, TrainConfig(freeze_backbone=False))
    step = make_multi_view_train_step(state.cfg)
    rig = rig_tuple(make_rig(n_views=4, image_hw=(768, 768)), dev)
    batch = synthesize_multiview_batch(get_robot("fr3"), rig, torch.Generator(dev).manual_seed(0),
                                       args.groups, image_hw=(768, 768),
                                       heatmap_hw=(128, 128))
    dropout = torch.Generator(dev).manual_seed(1)
    trace_dir = Path(args.trace_dir) if args.trace_dir else None
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)

    print(f"card: {chip_smoke._script('torch_bench_attention_fusion').card()}")
    got = profile_turn(lambda: step(state, batch, dropout), args.steps,
                       trace_dir / "train_768.json" if trace_dir else None)
    flash = ", ".join(f"{k} {v:.3f}" for k, v in got["flash_ms"].items())
    routes = [attention.kernel_route(64, cfg.vit.compute_dtype, part)
              for part in attention.FLASH_PARTS]
    print(f"train step 768 px unfrozen [{args.groups} groups x 4 views, backbone {args.vit_dtype}; "
          f"flash kernels {routes}; port of {package_root()}]: step {got['step_ms']:.3f} ms (CUDA "
          f"events, median of {args.steps}); profiled: host wall {got['wall_ms']:.3f} ms/step, "
          f"device busy {got['busy_ms']:.3f} ms/step, busy share "
          f"{min(1.0, got['busy_ms'] / got['wall_ms']):.3f}; flash kernels ms/step: {flash}",
          flush=True)
    print(got["prof"].key_averages().table(sort_by="self_device_time_total", row_limit=args.rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
