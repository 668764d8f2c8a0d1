#!/usr/bin/env python3
"""Where the port's serve step spends its time on the GPU.

    python3 scripts/torch_serve_profile.py [--steps 20] [--trace trace.json]
                                           [--int8] [--int8-matmul kernel|int_mm]
                                           [--model-size 512] [--vit-dtype bfloat16]

Runs `mvropose_torch.cli.main.serve_step` (bf16, ViT-B/16 at 512 px, 4
resident 720x1280 uint8 frames, random weights from seed 0; with
--model-size and --vit-dtype the backbone at that size and in that dtype,
e.g. 768 and float32, the f32 flash forward's serve path; with --int8 the
same weights as `serve --int8-backbone --int8-attention` serves them on a
fused-LN run directory, the attention on the fused kernels of
`ops/int8_attention.py` (bf16, or f32 with --vit-dtype float32); its int8
matmuls on the route --int8-matmul gives of
`ops/int8_matmul.py`: "kernel", the kernels of `csrc/int8_gemm.cu`, or
"int_mm", the plain chain around `torch._int_mm`) and prints the card and
its power limit, then:
  * wall time per step: host clock around `--steps` steps ending in a
    synchronize, without the profiler;
  * device busy time per step: the summed durations of the GPU kernels and
    copies that `torch.profiler` records over the same number of steps, and
    from the two the device's idle share;
  * the operators by device time.
With --trace, the profiler's chrome trace is written there. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mvropose_torch.cli.main import serve_step  # noqa: E402
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig  # noqa: E402
from mvropose_torch.ops import int8_attention, int8_matmul  # noqa: E402
from mvropose_torch.utils.weights import (  # noqa: E402
    export_jax_params,
    int8ify,
    load_jax_params,
    random_state,
)


def int8_model(cfg: EstimatorConfig, dev) -> MultiViewPoseEstimator:
    """The seed-0 weights in f32 as a checkpoint's flat dict, loaded into a
    fused-LN model and quantized from it, as `serve --params RUN/best_params.npz
    --int8-backbone --int8-attention` does."""
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, fused_ln=True))
    meta = MultiViewPoseEstimator(cfg, device="meta")
    meta.load_state_dict(random_state(meta, seed=0), assign=True)
    flat = export_jax_params(meta)
    model = MultiViewPoseEstimator(cfg, device=dev).eval()
    load_jax_params(model, flat)
    int8ify(model, flat, attn=True)
    return model


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--trace", default=None, help="write the chrome trace to this path")
    p.add_argument("--int8", action="store_true",
                   help="profile the int8 + fused-LN step (the fused int8 attention)")
    p.add_argument("--int8-matmul", choices=["kernel", "int_mm"], default="kernel",
                   help="with --int8: the route of its int8 matmuls")
    p.add_argument("--model-size", type=int, default=512)
    p.add_argument("--vit-dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   help="the backbone's compute dtype (the heads stay bf16)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: needs a CUDA GPU")
    dev = torch.device("cuda")
    cfg = EstimatorConfig(
        vit=ViTConfig(image_size=args.model_size, patch_size=16, hidden_size=768, num_layers=12,
                      num_heads=12, dtype=args.vit_dtype),
        num_joints=8, num_angles=7, max_views=4,
    )
    if args.int8:
        model = int8_model(cfg, dev)
    else:
        model = MultiViewPoseEstimator(cfg, device=dev).eval()
        model.load_state_dict(random_state(model, seed=0))
    frames = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(4, 720, 1280, 3), dtype=np.uint8)
    ).to(dev)
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    step = lambda: serve_step(model, frames, mask, args.model_size, (720, 1280))  # noqa: E731

    mm_route = (int8_matmul.int_mm_route() if args.int8 and args.int8_matmul == "int_mm"
                else contextlib.nullcontext())
    with torch.inference_mode(), mm_route:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()

    device_events = [
        e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / args.steps
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    label = (f"int8 + fused LN, attention route "
             f"{int8_attention.int8_route('cuda', cfg.vit.compute_dtype, 64)}, int8 matmul route "
             f"{args.int8_matmul}"
             if args.int8 else "bf16") + f", {args.model_size} px, backbone {args.vit_dtype}"
    print(f"serve step [{label}]: wall {wall_ms:.3f} ms/step (host clock, {args.steps} steps, "
          f"no profiler); device busy {busy_ms:.3f} ms/step over {len(device_events) / args.steps:.0f} "
          f"device events/step (profiler); idle share "
          f"{max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
    print(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
