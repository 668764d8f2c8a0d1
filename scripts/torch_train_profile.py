#!/usr/bin/env python3
"""Where the unfrozen 768-px train step spends its time on the GPU.

    python3 scripts/torch_train_profile.py [--steps 3] [--rows 25] [--trace-dir DIR]

The step of `chip_smoke.py`'s unfrozen 768-px phase (ViT-B/16 at 768 px,
backbone trained, fr3, 2 groups x 4 views, 128x128 heatmaps, bf16,
`flax_init_state` seed 1) on one resident batch, with the flash-attention
kernels at d = 64, forward and backward (`ops/attention.py`: the "wgmma"
route):
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
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

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

FLASH_NAMES = ("flash_fwd", "flash_dkv", "flash_dq")  # substrings of the kernels' symbols


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
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = MultiViewPoseEstimator(chip_smoke.UNFROZEN_768, device=dev)
    model.load_state_dict(flax_init_state(model, seed=1))
    state = create_train_state(model, TrainConfig(freeze_backbone=False))
    step = make_multi_view_train_step(state.cfg)
    rig = rig_tuple(make_rig(n_views=4, image_hw=(768, 768)), dev)
    batch = synthesize_multiview_batch(get_robot("fr3"), rig, torch.Generator(dev).manual_seed(0),
                                       chip_smoke.TRAIN_768_GROUPS, image_hw=(768, 768),
                                       heatmap_hw=(128, 128))
    dropout = torch.Generator(dev).manual_seed(1)
    trace_dir = Path(args.trace_dir) if args.trace_dir else None
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)

    print(f"card: {chip_smoke._script('torch_bench_attention_fusion').card()}")
    got = profile_turn(lambda: step(state, batch, dropout), args.steps,
                       trace_dir / "train_768.json" if trace_dir else None)
    flash = ", ".join(f"{k} {v:.3f}" for k, v in got["flash_ms"].items())
    print(f"train step 768 px unfrozen [{chip_smoke.TRAIN_768_GROUPS} groups x 4 views, bf16; "
          f"flash kernels {attention.kernel_route(64)}]: step {got['step_ms']:.3f} ms (CUDA "
          f"events, median of {args.steps}); profiled: host wall {got['wall_ms']:.3f} ms/step, "
          f"device busy {got['busy_ms']:.3f} ms/step, busy share "
          f"{min(1.0, got['busy_ms'] / got['wall_ms']):.3f}; flash kernels ms/step: {flash}",
          flush=True)
    print(got["prof"].key_averages().table(sort_by="self_device_time_total", row_limit=args.rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
