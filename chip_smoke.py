#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, in order; any failure exits non-zero and no phase's failure is caught:
  1. device: require CUDA (there is no CPU fallback), print the card and its
     power limit, turn TF32 off for the comparisons;
  2. build: compile `mvropose_torch/csrc/*.cu` with nvcc for sm_90a;
  3. kernel vs plain: the peak-decode kernel against its plain-torch version
     on the card (serve shape, a non-multiple M, planted ties), then both
     timed with CUDA events at the serve shape (32 maps of 128x128), as
     eager calls and as CUDA-graph replays (device time, in the JSON line);
  4. the slice: the `serve` subcommand of `mvropose_torch.cli`, parsed by the
     CLI's own parser at its defaults (4 synthetic 720x1280 cameras, ViT-B/16
     at 512 px, random weights from seed 0), for a few seconds, with the
     kernel's launches counted over that run only; the bare serve step timed
     on a resident batch and checked to never synchronize with the host; the
     same weights in f32 for the bf16 gap; and a small model on the card
     against the same model on the CPU;
  5. a JSON line per kernel, the card and its power limit, then the last line
     `{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mvropose_torch.cli.main import build_parser, preprocess, serve, serve_step
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
from mvropose_torch.ops import _build, peak_decode
from mvropose_torch.utils.weights import random_state

SERVE_SECONDS = 8.0
REPLACES = "mvropose_tpu/ops/peak_decode.py:28"  # _decode_kernel
# The serve default: ViT-B/16 at 512 px (T = 1024 + 1), 4 views, J=8, A=7.
FULL = EstimatorConfig(
    vit=ViTConfig(image_size=512, patch_size=16, hidden_size=768, num_layers=12, num_heads=12),
    num_joints=8, num_angles=7, max_views=4,
)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int, samples: int = 50) -> float:
    """Median over `samples` CUDA-event windows of `iters` calls, in ms per call."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph,
    replayed in CUDA-event windows, so Python launch overhead is excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, 1) / iters


def phase_device() -> dict:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    return {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    seconds = time.perf_counter() - t0
    lib = _build.library_path()
    print(f"build: {lib.relative_to(Path(__file__).resolve().parent)} in {seconds:.2f} s")
    log = lib.with_name(lib.name + ".log")
    if log.exists():
        print(log.read_text().strip())


def _tie_maps(rng) -> np.ndarray:
    maps = rng.normal(size=(4, 64, 64)).astype(np.float32)
    maps[0, 40, 3] = maps[0, 7, 60] = 9.0  # the earlier raster index wins
    maps[1] = 0.5  # constant map: index 0
    maps[2, 5, 10] = maps[2, 5, 11] = maps[2, 5, 12] = 7.0
    maps[3, 63, 63] = maps[3, 0, 63] = 8.0
    return maps


def phase_kernel() -> dict:
    """Kernel vs plain on the card. Argmax exact, confidence 1e-6, soft-argmax
    1e-3 px (f32 sums in another order), raw peak exact."""
    rng = np.random.default_rng(0)
    serve_maps = 4.0 * rng.normal(size=(32, 128, 128)).astype(np.float32)
    cases = [
        ("serve_t1", serve_maps, 1.0),
        ("serve_t2", serve_maps, 2.0),
        ("nonmultiple_m", rng.normal(size=(5, 32, 32)).astype(np.float32), 1.0),
        ("ties", _tie_maps(rng), 1.0),
    ]
    max_err = 0.0
    for name, maps, temperature in cases:
        x = torch.from_numpy(maps).cuda()
        got = peak_decode.peak_decode_cuda(x, temperature)
        torch.cuda.synchronize()
        want = peak_decode.peak_decode_reference(x, temperature)
        err = (got - want).abs().amax(dim=0).cpu().numpy()
        check(err[0] == 0 and err[1] == 0, f"{name}: argmax differs ({err[:2]})")
        check(err[4] <= 1e-6, f"{name}: confidence differs by {err[4]}")
        check(err[2] <= 1e-3 and err[3] <= 1e-3, f"{name}: soft-argmax differs by {err[2:4]}")
        check(err[5] == 0 and err[6] == 0 and err[7] == 0, f"{name}: peak/padding differ")
        max_err = max(max_err, float(err.max()))
        print(f"kernel vs plain [{name} {tuple(maps.shape)} T={temperature}]: "
              f"max abs err per column {np.array2string(err, precision=9)}")
    x = torch.from_numpy(serve_maps).cuda()
    kernel = lambda: peak_decode.peak_decode_cuda(x)  # noqa: E731
    plain = lambda: peak_decode.peak_decode_reference(x)  # noqa: E731
    # Each timing in turns: plain, kernel, kernel, plain.
    eager = [cuda_ms(f, iters=20) for f in (plain, kernel, kernel, plain)]
    graph = [graph_ms(f) for f in (plain, kernel, kernel, plain)]
    us = lambda v: "/".join(f"{1e3 * t:.2f}" for t in v)  # noqa: E731
    print(f"peak decode (32, 128, 128), median of 50 CUDA-event windows, in turns "
          f"plain/kernel/kernel/plain: eager calls {us(eager)} us per call; "
          f"CUDA-graph replay (device time) {us(graph)} us per call")
    return {"max_abs_err": max_err,
            "ms": statistics.median(graph[1:3]), "plain_ms": statistics.median(graph[0::3])}


def _model(cfg: EstimatorConfig, device, state) -> MultiViewPoseEstimator:
    model = MultiViewPoseEstimator(cfg, device=device).eval()
    model.load_state_dict(state)
    return model


def phase_serve() -> int:
    """`cli serve` at its defaults -> the kernel launches of that run alone."""
    args = build_parser().parse_args(["serve", "--views", "4", "--duration", str(SERVE_SECONDS)])
    peak_decode.launches = 0
    stats, last = serve(args)
    launches = peak_decode.launches
    check(last is not None, "serve returned no result")
    xy, conf, ang = last
    check(xy.shape == (4, 8, 2) and conf.shape == (4, 8) and ang.shape == (1, 7),
          f"serve output shapes {xy.shape}, {conf.shape}, {ang.shape}")
    check(all(np.isfinite(a).all() for a in last), "serve output is not finite")
    check(stats.ticks >= 10, f"served only {stats.ticks} ticks")
    check(launches > 0, "the serve run launched no peak-decode kernel")
    print(f"serve: {stats.ticks} ticks ({stats.frames_processed} camera frames) in "
          f"{SERVE_SECONDS:.0f} s: {stats.fps:.2f} tick/s = {stats.camera_fps:.2f} "
          f"camera-frames/s; peak-decode launches {launches}; host "
          f"{1e3 * stats.total_step_time_s / stats.ticks:.2f} ms/tick, fetch "
          f"{1e3 * stats.total_fetch_time_s / stats.ticks:.2f} ms/tick")
    return launches


def phase_step() -> None:
    """The bare serve step on a resident batch (bf16), then the same weights
    in f32 with TF32 off: the bf16 heatmap gap and argmax agreement."""
    dev = torch.device("cuda")
    state = random_state(MultiViewPoseEstimator(FULL, device="meta"), seed=0)
    frames = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(4, 720, 1280, 3), dtype=np.uint8)
    ).to(dev)
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    view_ids = torch.arange(4, device=dev)[None]
    bf16 = _model(FULL, dev, state)
    with torch.inference_mode():
        step = lambda: serve_step(bf16, frames, mask, 512, (720, 1280))  # noqa: E731
        step_ms = cuda_ms(step, 1, samples=30)
        # The double-buffered serve loop overlaps host and device only if the
        # step never waits for the device (no pageable copy, no .item()).
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        imgs = preprocess(frames, 512)[None]
        hm16, ang16 = bf16(imgs, view_ids, mask[None])
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del bf16
        f32_cfg = dataclasses.replace(FULL, dtype="float32",
                                      vit=dataclasses.replace(FULL.vit, dtype="float32"))
        f32 = _model(f32_cfg, dev, state)
        hm32, ang32 = f32(imgs, view_ids, mask[None])
        del f32
    check(bool(torch.isfinite(hm16).all() and torch.isfinite(hm32).all()), "heatmaps not finite")
    gap = float((hm16 - hm32).abs().max())
    scale = float(hm32.abs().max())
    agree = float((hm16.flatten(3).argmax(-1) == hm32.flatten(3).argmax(-1)).float().mean())
    ang_gap = float((ang16 - ang32).abs().max())
    print(f"serve step (preprocess + model + decode, 4x720x1280 u8 resident, bf16): "
          f"{step_ms:.3f} ms/step (median of 30), no host-device sync inside; "
          f"forward peak memory {peak_gib:.2f} GiB")
    print(f"bf16 vs f32 (TF32 off), same weights: heatmap max abs diff {gap:.6g} "
          f"(f32 heatmap max abs {scale:.6g}), argmax agreement {agree:.4f} of 32 maps, "
          f"angle max abs diff {ang_gap:.6g}")


def phase_small_reference() -> None:
    """A small f32 model on the card against the same model on the CPU:
    heatmaps and angles 1e-3 (f32 convolution and matmul algorithms differ),
    keypoints equal wherever the top-2 heatmap margin is 10x that gap."""
    cfg = EstimatorConfig(
        vit=ViTConfig(image_size=64, patch_size=16, hidden_size=128, num_layers=2, num_heads=2,
                      dtype="float32"),
        num_joints=8, num_angles=7, heatmap_size=(32, 32), max_views=4, dtype="float32",
    )
    state = random_state(MultiViewPoseEstimator(cfg, device="meta"), seed=2, scale=0.2)
    for k in state:
        if k.endswith(("norm1.weight", "norm2.weight", "norm3.weight", "norm.weight")):
            state[k] = state[k] + 1.0  # LayerNorm gains near 1 keep activations O(1)
    frames = np.random.default_rng(3).integers(0, 256, size=(3, 96, 120, 3), dtype=np.uint8)
    mask = np.array([True, False, True])
    outs = {}
    for dev in ("cpu", "cuda"):
        model = _model(cfg, dev, state)
        f, m = torch.from_numpy(frames).to(dev), torch.from_numpy(mask).to(dev)
        with torch.inference_mode():
            hm, ang = model(preprocess(f, 64)[None], torch.arange(3, device=dev)[None], m[None])
            xy, _, _ = serve_step(model, f, m, 64, (96, 120))
        outs[dev] = [t.float().cpu().numpy() for t in (hm, ang, xy)]
    (hm_c, ang_c, xy_c), (hm_g, ang_g, xy_g) = outs["cpu"], outs["cuda"]
    gap = float(np.abs(hm_g - hm_c).max())
    check(gap <= 1e-3 and np.abs(ang_g - ang_c).max() <= 1e-3, f"card vs CPU gap {gap}")
    top2 = np.sort(hm_c[0].reshape(3, 8, -1), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 10 * gap
    check(bool(clear.any()), "no heatmap with a clear peak to compare")
    check(bool((xy_g[clear] == xy_c[clear]).all()), "keypoints differ between card and CPU")
    print(f"small model card vs CPU (f32, TF32 off): heatmap max abs diff {gap:.3g}, angle "
          f"max abs diff {np.abs(ang_g - ang_c).max():.3g}, keypoints equal on "
          f"{int(clear.sum())}/24 clear maps")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU")
    device = phase_device()
    phase_build()
    kernel = phase_kernel()
    launches = phase_serve()
    phase_step()
    phase_small_reference()
    print(json.dumps({"kernels": [{
        "name": "peak_decode", "route": "cuda", "source": "mvropose_torch/csrc/peak_decode.cu",
        "replaces": REPLACES, "launches": launches, **kernel,
    }]}))
    print(device["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
