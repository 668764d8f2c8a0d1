#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, in order; any failure exits non-zero and no phase's failure is caught:
  1. device: require CUDA (there is no CPU fallback), print the card and its
     power limit, turn TF32 off for the comparisons;
  2. build: compile `mvropose_torch/csrc/*.cu` with nvcc for sm_90a, one
     nvcc per source, all started together;
  3. kernels vs plain on the card, each then timed with CUDA events at the
     serve shape, as eager calls and as CUDA-graph replays (device time, in
     the JSON line), in turns plain/kernel/kernel/plain:
       * peak decode (32 maps of 128x128, a non-multiple M, planted ties);
       * LayerNorm and residual LayerNorm ((4100, 768) bf16 -> bf16 and
         bf16 -> f32, a non-multiple M, narrow and non-multiple-of-8 D);
       * int8 P@V ((48, 1025, 1025) x (48, 1025, 64), a small odd T, masked
         keys and all-zero rows, pq padded as the serve path writes it, and
         contiguous at T = 128), its int32 sums read back exactly;
       * heatmap render ((576, 128, 128) and (576, 512, 512), the full-width
         train batch; (336, 64, 64) and (336, 128, 128), the synthetic
         trainer's; a non-multiple M and W, per-map and small sigma,
         half-pixel ties, keypoints just and far outside the map);
     then every launch counter: an empty input counts nothing, one launch one;
  4. the slices, each through `mvropose_torch.cli`'s own parser, with every
     kernel's launches counted over that run only:
       * `serve` at its defaults (4 synthetic 720x1280 cameras, ViT-B/16 at
         512 px, random weights from seed 0, bf16): the peak decode;
       * `serve --params RUN/best_params.npz --int8-backbone
         --int8-attention` on a temporary run directory under build/, whose
         model_config.json says fused_ln: true (the same ViT-B/16 and seed-0
         weights, exported with `export_jax_params`): all four kernels;
  5. the bare serve steps, bf16 and int8 + fused LN, timed in turns on a
     resident batch and checked to never synchronize with the host; the
     int8 heatmaps against the bf16 model's, the bf16 ones against f32; and
     small f32 and int8 + fused-LN models on the card against the CPU;
  6. training, with the render's launches counted over each run only:
       * the full-width multi-view train step (frozen ViT-B/16 at 512 px,
         fr3, 18 groups x 4 views, 128x128 heatmaps, bf16) on batches made
         by `synthesize_multiview_batch`: finite losses, the backbone
         bit-identical, heads and BatchNorm statistics moved, no host-device
         sync; step time, peak memory and the device's busy share;
       * `scripts/torch_train_synthetic.py --mode multi` at its defaults for
         a few hundred steps: the loss must fall;
  7. a JSON line per kernel, the card and its power limit, then the last line
     `{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from torch.profiler import ProfilerActivity, profile

from mvropose_torch.cli.main import build_parser, preprocess, serve, serve_step
from mvropose_torch.data.synthetic import make_rig, rig_tuple, synthesize_multiview_batch
from mvropose_torch.geometry.robots import get_robot
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
from mvropose_torch.ops import _build, heatmap_render, int8_attention, layernorm, peak_decode
from mvropose_torch.train import TrainConfig, create_train_state, make_multi_view_train_step
from mvropose_torch.train.state import ANG_MODULES, KPT_MODULES
from mvropose_torch.utils.weights import (
    export_jax_params,
    flax_init_state,
    int8ify,
    load_jax_params,
    random_state,
)

ROOT = Path(__file__).resolve().parent
SERVE_SECONDS = 8.0
# name: (wrapper module, its launch counter, source, the TPU kernel it replaces)
KERNELS = {
    "peak_decode": (peak_decode, "launches", "mvropose_torch/csrc/peak_decode.cu",
                    "mvropose_tpu/ops/peak_decode.py:28"),  # _decode_kernel
    "layernorm": (layernorm, "launches", "mvropose_torch/csrc/layernorm.cu",
                  "mvropose_tpu/ops/layernorm.py:30"),  # _ln_kernel
    "residual_layernorm": (layernorm, "residual_launches", "mvropose_torch/csrc/layernorm.cu",
                           "mvropose_tpu/ops/layernorm.py:39"),  # _res_ln_kernel
    "int8_pv": (int8_attention, "launches", "mvropose_torch/csrc/int8_pv.cu",
                "mvropose_tpu/ops/attention.py:29"),  # int8_prob_attention's P@V
    "heatmap_render": (heatmap_render, "launches", "mvropose_torch/csrc/heatmap_render.cu",
                       "mvropose_tpu/ops/heatmap_render.py:25"),  # _render_kernel
}
SERVE_KERNELS = ["peak_decode", "layernorm", "residual_layernorm", "int8_pv"]
# The serve default: ViT-B/16 at 512 px (T = 1024 + 1), 4 views, J=8, A=7.
FULL = EstimatorConfig(
    vit=ViTConfig(image_size=512, patch_size=16, hidden_size=768, num_layers=12, num_heads=12),
    num_joints=8, num_angles=7, max_views=4,
)
FULL_LN = dataclasses.replace(FULL, vit=dataclasses.replace(FULL.vit, fused_ln=True))


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


def graph_ms(fn, iters: int = 20, samples: int = 50) -> float:
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
    return cuda_ms(graph.replay, 1, samples) / iters


def time_in_turns(name: str, shape: str, plain, kernel, iters: int = 20, samples: int = 50):
    """Eager and graph-replay times in turns plain/kernel/kernel/plain ->
    (kernel ms, plain ms), the medians of the graph-replay (device) times."""
    eager = [cuda_ms(f, iters, samples) for f in (plain, kernel, kernel, plain)]
    graph = [graph_ms(f, iters, samples) for f in (plain, kernel, kernel, plain)]
    us = lambda v: "/".join(f"{1e3 * t:.2f}" for t in v)  # noqa: E731
    print(f"{name} {shape}, median of {samples} CUDA-event windows, in turns "
          f"plain/kernel/kernel/plain: eager calls {us(eager)} us per call; "
          f"CUDA-graph replay (device time) {us(graph)} us per call")
    return statistics.median(graph[1:3]), statistics.median(graph[0::3])


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
    print(f"build: {lib.relative_to(ROOT)} in {seconds:.2f} s")
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


def phase_peak_decode() -> dict:
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
    ms, plain_ms = time_in_turns("peak decode", "(32, 128, 128)",
                                 lambda: peak_decode.peak_decode_reference(x),
                                 lambda: peak_decode.peak_decode_cuda(x))
    return {"peak_decode": {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}}


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor, slack: float = 1e-5) -> float:
    """The largest gap beyond `slack`, in bf16 ulps of the larger of the two
    values. The slack is the f32 outputs' bound: near y = 0 the f32 results
    (bias minus a near-equal product) differ by f32 rounding of their
    operands, which is many bf16 ulps of y itself."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    gap = ((g - w).abs() - slack).clamp_min(0.0)
    return float((gap / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _ln_operands(M: int, D: int, dtype, seed: int):
    gen = torch.Generator().manual_seed(seed)
    x = (0.5 + 3.0 * torch.randn(M, D, generator=gen)).to(dtype)
    h = torch.randn(M, D, generator=gen).to(dtype)
    g = 1.0 + 0.1 * torch.randn(D, generator=gen)
    b = 0.1 * torch.randn(D, generator=gen)
    return [t.cuda() for t in (x, h, g, b)]


def phase_layernorm() -> dict:
    """LayerNorm and residual LayerNorm kernels vs their plain versions on
    the card: f32 outputs within 1e-5 abs, bf16 outputs within one bf16 ulp
    beyond that, the residual x + h exact."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("serve", 4100, 768, bf16, bf16), ("serve_final", 4100, 768, bf16, f32),
             ("nonmultiple_m", 37, 768, bf16, bf16), ("narrow_d", 4100, 192, bf16, bf16),
             ("tail_d", 37, 100, bf16, f32), ("f32", 37, 768, f32, f32)]
    err = {"layernorm": 0.0, "residual_layernorm": 0.0}
    for i, (name, M, D, inp, out) in enumerate(cases):
        x, h, g, b = _ln_operands(M, D, inp, seed=10 + i)
        y = layernorm.layernorm_cuda(x, g, b, 1e-6, out)
        xn, yr = layernorm.residual_layernorm_cuda(x, h, g, b, 1e-6, out)
        torch.cuda.synchronize()
        xn_ref, yr_ref = layernorm.residual_layernorm_reference(x, h, g, b, 1e-6, out)
        check(torch.equal(xn, xn_ref), f"{name}: the residual x + h is not exact")
        gaps = []
        y_ref = layernorm.layernorm_reference(x, g, b, 1e-6, out)
        for kname, got, want in (("layernorm", y, y_ref), ("residual_layernorm", yr, yr_ref)):
            gap = float((got.float() - want.float()).abs().max())
            if out == bf16:
                ulps = _bf16_ulps(got, want)
                check(ulps <= 1.0, f"{name}: {kname} is {ulps} bf16 ulps from the plain version")
            else:
                check(gap <= 1e-5, f"{name}: {kname} differs by {gap}")
            err[kname] = max(err[kname], gap)
            gaps.append(gap)
        print(f"kernel vs plain [{name} ({M}, {D}) {inp} -> {out}]: LayerNorm max abs err "
              f"{gaps[0]:.3g}, residual LayerNorm {gaps[1]:.3g}, residual sum exact")
    x, h, g, b = _ln_operands(4100, 768, bf16, seed=20)
    def two_pass():  # the float path's LayerNorm: another function, timed for scale
        return torch.nn.functional.layer_norm(x.float(), (768,), g, b, 1e-6).to(bf16)

    print(f"for scale: torch F.layer_norm (two-pass variance, f32 in, bf16 out; the float "
          f"path's LayerNorm) {1e3 * graph_ms(two_pass):.2f} us per call (CUDA-graph replay)")
    out = {}
    for kname, plain, kernel in (
        ("layernorm", lambda: layernorm.layernorm_reference(x, g, b, 1e-6),
         lambda: layernorm.layernorm_cuda(x, g, b, 1e-6)),
        ("residual_layernorm", lambda: layernorm.residual_layernorm_reference(x, h, g, b, 1e-6),
         lambda: layernorm.residual_layernorm_cuda(x, h, g, b, 1e-6)),
    ):
        ms, plain_ms = time_in_turns(kname, "(4100, 768) bf16 -> bf16", plain, kernel)
        out[kname] = {"max_abs_err": err[kname], "ms": ms, "plain_ms": plain_ms}
    return out


def _pv_operands(BH: int, T: int, seed: int, masked: float = 0.0, zero_rows: int = 0,
                 padded: bool = True):
    """pq in the padded row layout the serve path writes (`padded_probs`), or
    contiguous (which the kernel reads as it is when T is a multiple of 64)."""
    gen = torch.Generator().manual_seed(seed)
    pq = torch.randint(0, 128, (BH, T, T), generator=gen, dtype=torch.int8)
    if masked:
        pq[:, :, torch.rand(T, generator=gen) < masked] = 0  # masked keys: probability 0
    if zero_rows:
        pq[:, T - zero_rows:] = 0
    vq = torch.randint(-127, 128, (BH, T, 64), generator=gen, dtype=torch.int8)
    z = 1.0 + 100.0 * torch.rand(BH, T, generator=gen)
    sv = 1e-4 + torch.rand(BH, 64, generator=gen) / 127.0
    pq = int8_attention.padded_probs(BH, T, "cuda").copy_(pq) if padded else pq.cuda()
    return [pq, *(t.cuda() for t in (vq, z, sv))]


def phase_int8_pv() -> dict:
    """int8 P@V kernel vs its plain version on the card. With z = 1/127 and
    sv = 1 the dequant multiplies by exactly 1, so the f32 output is the int32
    sums themselves (< 2**24 here): they must equal the f64 sums. With real z
    and sv the output must be within 1e-6 relative (the same f32 multiplies
    in the same order: expected equal)."""
    cases = [("serve", 48, 1025, 0.0, 0, True), ("odd_t", 6, 37, 0.0, 0, True),
             ("masked_zero_rows", 12, 1025, 0.3, 5, True),
             ("t_128_contiguous", 4, 128, 0.0, 0, False)]
    max_abs = max_rel = 0.0
    for i, (name, BH, T, masked, zero_rows, padded) in enumerate(cases):
        pq, vq, z, sv = _pv_operands(BH, T, seed=30 + i, masked=masked, zero_rows=zero_rows,
                                     padded=padded)
        sums = int8_attention.int8_pv_cuda(pq, vq, torch.full_like(z, 1.0 / 127.0),
                                           torch.ones_like(sv), torch.float32)
        torch.cuda.synchronize()
        exact = torch.bmm(pq.double(), vq.double())
        check(bool((sums.double() == exact).all()), f"{name}: int32 sums differ")
        rels = []
        for dtype in (torch.float32, torch.bfloat16):
            got = int8_attention.int8_pv_cuda(pq, vq, z, sv, dtype)
            want = int8_attention.int8_pv_reference(pq, vq, z, sv, dtype)
            gap = (got.float() - want.float()).abs()
            rel = float((gap / want.float().abs().clamp_min(1e-30)).max())
            check(rel <= 1e-6, f"{name} {dtype}: dequantized output {rel} relative apart")
            rels.append(rel)
            max_abs = max(max_abs, float(gap.max()))
        max_rel = max(max_rel, *rels)
        print(f"kernel vs plain [{name} pq ({BH}, {T}, {T}) masked {masked} zero rows "
              f"{zero_rows}]: int32 sums exact; max relative err f32 {rels[0]:.3g}, "
              f"bf16 {rels[1]:.3g}")
    pq, vq, z, sv = _pv_operands(48, 1025, seed=40)
    ms, plain_ms = time_in_turns(
        "int8 P@V", "(48, 1025, 1025) x (48, 1025, 64) -> bf16",
        lambda: int8_attention.int8_pv_reference(pq, vq, z, sv, torch.bfloat16),
        lambda: int8_attention.int8_pv_cuda(pq, vq, z, sv, torch.bfloat16), samples=20,
    )
    print(f"int8 P@V kernel vs plain: max abs err {max_abs:.3g}, max relative err {max_rel:.3g}")
    return {"int8_pv": {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}}


def _render_rows(M: int, H: int, W: int, seed: int, sigma=(2.0, 2.0), ties: bool = False,
                 outside: bool = False) -> torch.Tensor:
    """(M, 3) rows [x, y, 1/(2 sigma^2)] on the card, made as the dispatcher
    makes them: keypoints anywhere in the map and up to 8 px past its edge;
    sigma uniform in the given range (per map when it is a range); optional
    half-pixel ties and points just and far outside."""
    rng = np.random.default_rng(seed)
    kp = np.stack([rng.uniform(-8, W + 8, M), rng.uniform(-8, H + 8, M)], -1).astype(np.float32)
    if ties:
        kp[: M // 2] = np.floor(kp[: M // 2]) + 0.5  # (c - x)^2 equal for c = x -/+ 0.5
    if outside:
        edge = np.array([[-0.5, H / 2], [W - 0.3, H / 2], [W / 2, -1.7], [-1000.0, -1000.0],
                         [1e4, 30.0], [W / 2, 1e5]], np.float32)
        kp[: len(edge)] = edge
    sig = torch.from_numpy(rng.uniform(*sigma, M).astype(np.float32))
    inv = 1.0 / (2.0 * (sig * sig))
    return torch.cat([torch.from_numpy(kp), inv[:, None]], dim=1).cuda()


def phase_heatmap_render() -> dict:
    """Render kernel vs its plain version on the card. Bound: 1e-6 absolute
    on values in [0, 1] (the Pallas-vs-jnp bound of tests/test_ops.py:39);
    the kernel runs the plain version's f32 operations in the same order with
    the same expf, so it is expected to agree bit for bit, and the number of
    differing values is printed."""
    cases = [
        ("train_gt", 576, 128, 128, (2.0, 2.0), False, False),
        ("train_blob", 576, 512, 512, (3.0, 3.0), False, False),
        ("twin_gt", 336, 64, 64, (2.0, 2.0), False, False),
        ("twin_blob", 336, 128, 128, (3.0, 3.0), False, False),
        ("nonmultiple_m_w", 37, 50, 70, (2.0, 2.0), False, False),
        ("per_map_sigma_small", 64, 64, 64, (0.3, 6.0), False, False),
        ("half_pixel_ties", 40, 64, 64, (2.0, 2.0), True, False),
        ("outside", 12, 64, 64, (2.0, 5.0), False, True),
    ]
    max_err = 0.0
    for i, (name, M, H, W, sigma, ties, outside) in enumerate(cases):
        rows = _render_rows(M, H, W, seed=50 + i, sigma=sigma, ties=ties, outside=outside)
        got = heatmap_render.render_heatmaps_cuda(rows, H, W)
        torch.cuda.synchronize()
        want = heatmap_render.render_heatmaps_reference(rows, H, W)
        err = float((got - want).abs().max())
        differ = int((got != want).sum())
        check(err <= 1e-6, f"{name}: render kernel differs from the plain version by {err}")
        if outside:
            far = got[3:6].flatten(1).amax(1)
            check(bool((far == 0).all()), f"{name}: a far-outside map is not all zeros")
        max_err = max(max_err, err)
        print(f"kernel vs plain [{name} ({M}, {H}, {W}) sigma {sigma}]: max abs err {err:.3g}, "
              f"{differ} of {got.numel()} values differ; {int((got == 0).sum())} zeros")
    out = {}
    for shape, (M, H, W, s) in (("(576, 128, 128)", (576, 128, 128, 2.0)),
                                ("(576, 512, 512)", (576, 512, 512, 3.0))):
        rows = _render_rows(M, H, W, seed=60, sigma=(s, s))
        out[shape] = time_in_turns(
            "heatmap render", f"{shape} f32, sigma {s}",
            lambda: heatmap_render.render_heatmaps_reference(rows, H, W),
            lambda: heatmap_render.render_heatmaps_cuda(rows, H, W),
            iters=5 if H == 512 else 20, samples=20,
        )
    ms, plain_ms = out["(576, 512, 512)"]
    return {"heatmap_render": {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}}


def _reset_launches() -> None:
    for module, counter, _, _ in KERNELS.values():
        setattr(module, counter, 0)


def _read_launches() -> dict:
    return {name: getattr(module, counter) for name, (module, counter, _, _) in KERNELS.items()}


def phase_counters() -> None:
    """Each wrapper counts where it launches its kernel and nowhere else: an
    empty input launches nothing and counts nothing, one launch counts one."""
    g, b = torch.ones(8, device="cuda"), torch.zeros(8, device="cuda")
    calls = {
        "peak_decode": lambda n: peak_decode.peak_decode_cuda(torch.ones(n, 4, 4, device="cuda")),
        "layernorm": lambda n: layernorm.layernorm_cuda(torch.ones(n, 8, device="cuda"), g, b),
        "residual_layernorm": lambda n: layernorm.residual_layernorm_cuda(
            torch.ones(n, 8, device="cuda"), torch.ones(n, 8, device="cuda"), g, b),
        "int8_pv": lambda n: int8_attention.int8_pv_cuda(
            int8_attention.padded_probs(2, n, "cuda").zero_(),
            torch.zeros(2, n, 64, dtype=torch.int8, device="cuda"),
            torch.ones(2, n, device="cuda"), torch.ones(2, 64, device="cuda"), torch.float32),
        "heatmap_render": lambda n: heatmap_render.render_heatmaps_cuda(
            torch.zeros(n, 3, device="cuda"), 4, 4),
    }
    for name, call in calls.items():
        for n, want in ((0, 0), (3, 1)):
            _reset_launches()
            call(n)
            got = _read_launches()
            check(got == {k: want if k == name else 0 for k in KERNELS},
                  f"{name} on {n} rows counted {got}")
    torch.cuda.synchronize()
    print("launch counters: an empty input counts nothing, one launch counts one, "
          "for every kernel")


def _serve(argv: list, label: str, kernels: list) -> dict:
    """`cli serve` through the CLI's parser -> every kernel's launches in that run."""
    args = build_parser().parse_args(["serve", "--views", "4", "--duration", str(SERVE_SECONDS),
                                      *argv])
    _reset_launches()
    stats, last = serve(args)
    launches = _read_launches()
    check(last is not None, f"{label}: serve returned no result")
    xy, conf, ang = last
    check(xy.shape == (4, 8, 2) and conf.shape == (4, 8) and ang.shape == (1, 7),
          f"{label}: serve output shapes {xy.shape}, {conf.shape}, {ang.shape}")
    check(all(np.isfinite(a).all() for a in last), f"{label}: serve output is not finite")
    check(stats.ticks >= 10, f"{label}: served only {stats.ticks} ticks")
    for name in kernels:
        check(launches[name] > 0, f"{label}: the serve run launched no {name} kernel")
    print(f"serve [{label}]: {stats.ticks} ticks ({stats.frames_processed} camera frames) in "
          f"{SERVE_SECONDS:.0f} s: {stats.fps:.2f} tick/s = {stats.camera_fps:.2f} "
          f"camera-frames/s; kernel launches {launches}; host "
          f"{1e3 * stats.total_step_time_s / stats.ticks:.2f} ms/tick, fetch "
          f"{1e3 * stats.total_fetch_time_s / stats.ticks:.2f} ms/tick")
    return launches


def seed0_flat() -> dict:
    """The serve default's seed-0 random weights as a reference checkpoint's
    flat dict (f32): `random_state`'s CPU tensors assigned into a model on
    the meta device, so no other copy of the weights is made."""
    model = MultiViewPoseEstimator(FULL, device="meta")
    model.load_state_dict(random_state(model, seed=0), assign=True)
    return export_jax_params(model)


def write_run_dir(flat: dict, run: Path) -> None:
    """A run directory as training leaves it: model_config.json (fused_ln on)
    beside best_params.npz."""
    c = FULL_LN
    (run / "model_config.json").write_text(json.dumps({
        "kind": "multi_view", "model_size": 512, "vit": dataclasses.asdict(c.vit),
        "num_joints": c.num_joints, "num_angles": c.num_angles,
        "heatmap_size": list(c.heatmap_size), "max_views": c.max_views,
        "num_fusion_queries": c.num_fusion_queries, "num_angle_queries": c.num_angle_queries,
        "angle_head": c.angle_head,
    }, indent=2))
    np.savez(run / "best_params.npz", **flat)


def _int8_model(flat: dict, device) -> MultiViewPoseEstimator:
    """What `serve --int8-backbone --int8-attention` builds from the run dir."""
    model = MultiViewPoseEstimator(FULL_LN, device=device).eval()
    load_jax_params(model, flat)
    int8ify(model, flat, attn=True)
    return model


def _model(cfg: EstimatorConfig, device, state) -> MultiViewPoseEstimator:
    model = MultiViewPoseEstimator(cfg, device=device).eval()
    model.load_state_dict(state)
    return model


def _never_syncs(step) -> None:
    # The double-buffered serve loop overlaps host and device only if the
    # step never waits for the device (no pageable copy, no .item()).
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_step(flat: dict) -> None:
    """The bare serve steps on a resident batch, bf16 and int8 + fused LN,
    timed in turns; the int8 backbone tokens and heatmaps against the bf16
    model's on the same weights, and the bf16 heatmaps against the same
    weights in f32 (TF32 off). With random N(0, 0.02) weights the blocks
    add little to the residual stream, so these gaps are small by
    construction: accuracy against the reference is held by the CPU tests."""
    dev = torch.device("cuda")
    state = random_state(MultiViewPoseEstimator(FULL, device="meta"), seed=0)
    frames = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(4, 720, 1280, 3), dtype=np.uint8)
    ).to(dev)
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    view_ids = torch.arange(4, device=dev)[None]
    bf16, int8 = _model(FULL, dev, state), _int8_model(flat, dev)
    with torch.inference_mode():
        steps = {name: (lambda m=m: serve_step(m, frames, mask, 512, (720, 1280)))
                 for name, m in (("bf16", bf16), ("int8_ln", int8))}
        turns = [(n, cuda_ms(steps[n], 1, samples=30))
                 for n in ("bf16", "int8_ln", "int8_ln", "bf16")]
        for step in steps.values():
            _never_syncs(step)
        graph = {name: graph_ms(step, iters=1, samples=30) for name, step in steps.items()}
        torch.cuda.synchronize()
        imgs = preprocess(frames, 512)[None]
        outs, tokens = {}, {}
        for name, model in (("bf16", bf16), ("int8_ln", int8)):
            torch.cuda.reset_peak_memory_stats()
            outs[name] = model(imgs, view_ids, mask[None])
            print(f"forward peak memory [{name}]: "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            tokens[name] = model.backbone(imgs[0].permute(0, 3, 1, 2))["patch_tokens"]
        del bf16, int8
        f32_cfg = dataclasses.replace(FULL, dtype="float32",
                                      vit=dataclasses.replace(FULL.vit, dtype="float32"))
        f32 = _model(f32_cfg, dev, state)
        outs["f32"] = f32(imgs, view_ids, mask[None])
        del f32
    print("serve step (preprocess + model + decode, 4x720x1280 u8 resident), ms/step, "
          "median of 30, in turns: " + ", ".join(f"{n} {t:.3f}" for n, t in turns)
          + "; CUDA-graph replay (device time): "
          + ", ".join(f"{n} {t:.3f}" for n, t in graph.items())
          + "; no host-device sync inside either step")
    a, b = tokens["int8_ln"], tokens["bf16"]
    check(bool(torch.isfinite(a).all()), "int8 backbone tokens not finite")
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    print(f"int8 + fused-LN vs bf16 backbone, same weights: patch-token cosine min "
          f"{float(cos.min()):.6f}, mean {float(cos.mean()):.6f}; max abs diff "
          f"{float((a - b).abs().max()):.6g} (bf16 tokens max abs {float(b.abs().max()):.6g})")
    for name, ref in (("bf16 vs f32 (TF32 off)", "f32"), ("int8 + fused LN vs bf16", "bf16")):
        a = "bf16" if ref == "f32" else "int8_ln"
        hm, ang = outs[a]
        hm_ref, ang_ref = outs[ref]
        check(bool(torch.isfinite(hm).all() and torch.isfinite(ang).all()), f"{a} not finite")
        gap = float((hm.float() - hm_ref.float()).abs().max())
        agree = float((hm.flatten(3).argmax(-1) == hm_ref.flatten(3).argmax(-1)).float().mean())
        print(f"{name}, same weights: heatmap max abs diff {gap:.6g} ({ref} heatmap max abs "
              f"{float(hm_ref.abs().max()):.6g}), argmax agreement {agree:.4f} of 32 maps, "
              f"angle max abs diff {float((ang - ang_ref).abs().max()):.6g}")


def _small_reference(label: str, cfg: EstimatorConfig, scale: float, int8: bool,
                     hm_tol: float, ang_tol: float) -> None:
    state = random_state(MultiViewPoseEstimator(cfg, device="meta"), seed=2, scale=scale)
    for k in state:
        if k.endswith(("norm1.weight", "norm2.weight", "norm3.weight", "norm.weight")):
            state[k] = state[k] + 1.0  # LayerNorm gains near 1 keep activations O(1)
    frames = np.random.default_rng(3).integers(0, 256, size=(3, 96, 120, 3), dtype=np.uint8)
    mask = np.array([True, False, True])
    outs = {}
    for dev in ("cpu", "cuda"):
        model = _model(cfg, dev, state)
        if int8:
            int8ify(model, attn=True)
        f, m = torch.from_numpy(frames).to(dev), torch.from_numpy(mask).to(dev)
        with torch.inference_mode():
            hm, ang = model(preprocess(f, 64)[None], torch.arange(3, device=dev)[None], m[None])
            xy, _, _ = serve_step(model, f, m, 64, (96, 120))
        outs[dev] = [t.float().cpu().numpy() for t in (hm, ang, xy)]
    (hm_c, ang_c, xy_c), (hm_g, ang_g, xy_g) = outs["cpu"], outs["cuda"]
    gap, ang_gap = float(np.abs(hm_g - hm_c).max()), float(np.abs(ang_g - ang_c).max())
    check(gap <= hm_tol and ang_gap <= ang_tol, f"{label}: card vs CPU gap {gap}, {ang_gap}")
    top2 = np.sort(hm_c[0].reshape(3, 8, -1), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 10 * gap
    check(bool(clear.any()), f"{label}: no heatmap with a clear peak to compare")
    check(bool((xy_g[clear] == xy_c[clear]).all()), f"{label}: keypoints differ, card vs CPU")
    print(f"small {label} model card vs CPU (f32, TF32 off): heatmap max abs diff {gap:.3g} "
          f"(bound {hm_tol:g}), angle max abs diff {ang_gap:.3g} (bound {ang_tol:g}), "
          f"keypoints equal on {int(clear.sum())}/24 clear maps")


def phase_small_reference() -> None:
    """Small models on the card against the same models on the CPU, in f32.
    Float: heatmaps and angles 1e-3 (f32 convolution and matmul algorithms
    differ). int8 + fused LN (hidden 128 and M = 51 rows, as torch._int_mm
    wants on the card): heatmaps 1e-4 and angles 1e-2, about 10x and 3x what
    a value on an int8 rounding boundary rounding the other way can move them
    (on the CPU alone, a 1e-4 relative input perturbation moved this model's
    heatmaps by 9e-6 and its angles by 3.5e-3). Keypoints equal wherever the
    top-2 heatmap margin is 10x the gap."""
    vit = ViTConfig(image_size=64, patch_size=16, hidden_size=128, num_layers=2, num_heads=2,
                    dtype="float32")
    cfg = EstimatorConfig(vit=vit, num_joints=8, num_angles=7, heatmap_size=(32, 32),
                          max_views=4, dtype="float32")
    _small_reference("float", cfg, 0.2, False, 1e-3, 1e-3)
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(vit, fused_ln=True))
    _small_reference("int8 + fused-LN", cfg, 0.1, True, 1e-4, 1e-2)


# The reference's FR3 training shape (bench_train.py:178-191): frozen ViT-B/16
# at 512 px (= FULL), 18 groups x 4 views, fr3 (J = 8, A = 7), 128x128 heatmaps.
TRAIN_GROUPS = 18
TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED = 3, 10, 3
# The trainer run: scripts/torch_train_synthetic.py --mode multi at its
# defaults (fr5, 3 views, 128 px, batch 64, lr 1e-3), for TRAINER_STEPS steps.
TRAINER_STEPS = 300
TRAINER_EVAL_BATCHES = 4  # the script's default --eval-batches
TRAINER_LOSS_DROP = 0.7  # the last logged loss must be below this share of the first


def phase_train_step(device: dict) -> int:
    """The full-width multi-view train step on the card, its batches made by
    the port's `synthesize_multiview_batch` (image 512, heatmaps 128): a few
    warm steps, one step and one batch under the no-sync check, timed steps
    (CUDA events), a profiled window. Checks: finite losses, the backbone
    bit-identical, every head module and BatchNorm running statistic moved,
    two render launches per batch and no other kernel. -> render launches."""
    dev = torch.device("cuda")
    robot = get_robot("fr3")
    rig = rig_tuple(make_rig(n_views=4, image_hw=(512, 512)), dev)
    model = MultiViewPoseEstimator(FULL, device=dev)
    model.load_state_dict(flax_init_state(model, seed=1))
    state = create_train_state(model, TrainConfig())
    step = make_multi_view_train_step(state.cfg)
    data_gen = torch.Generator(dev).manual_seed(0)
    dropout_gen = torch.Generator(dev).manual_seed(1)
    batches = [0]

    def make_batch() -> dict:
        batches[0] += 1
        return synthesize_multiview_batch(robot, rig, data_gen, TRAIN_GROUPS,
                                          image_hw=(512, 512), heatmap_hw=(128, 128))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    _reset_launches()
    losses = [step(state, make_batch(), dropout_gen)["loss"] for _ in range(TRAIN_WARM)]
    made = {}
    _never_syncs(lambda: made.update(batch=make_batch()))
    _never_syncs(lambda: losses.append(step(state, made["batch"], dropout_gen)["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(TRAIN_TIMED)]
    t0 = time.perf_counter()
    for e in events:
        e[0].record()
        batch = make_batch()
        e[1].record()
        losses.append(step(state, batch, dropout_gen)["loss"])
        e[2].record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    render_ms = statistics.median(e[0].elapsed_time(e[1]) for e in events)
    step_ms = statistics.median(e[1].elapsed_time(e[2]) for e in events)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRAIN_PROFILED):
            losses.append(step(state, make_batch(), dropout_gen)["loss"])
        torch.cuda.synchronize()
    launches = _read_launches()
    check(launches == {k: 2 * batches[0] if k == "heatmap_render" else 0 for k in KERNELS},
          f"train step: {batches[0]} batches launched {launches}, not 2 renders each")
    loss = torch.stack(losses).cpu()
    check(bool(torch.isfinite(loss).all()), f"train step: loss not finite: {loss.tolist()}")
    after = model.state_dict()
    moved = {k for k, v in after.items() if not torch.equal(v, before[k])}
    check(not any(k.startswith("backbone.") for k in moved), "train step: the frozen backbone moved")
    for name in KPT_MODULES + ANG_MODULES:
        check(any(k.startswith(name + ".") and "running_" not in k for k in moved),
              f"train step: no parameter of {name} moved")
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    check(stats and all(k in moved for k in stats), "train step: a BatchNorm statistic did not move")
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / TRAIN_PROFILED
    print(f"train step [{device['nvidia_smi']}; frozen ViT-B/16 at 512 px, fr3, "
          f"{TRAIN_GROUPS} groups x 4 views, 128x128 heatmaps, bf16]: train step "
          f"{step_ms:.3f} ms (CUDA events, median of {TRAIN_TIMED}) = "
          f"{1e3 * TRAIN_GROUPS / step_ms:.2f} groups/s; batch render {render_ms:.3f} ms; "
          f"host wall {wall_ms:.3f} ms per batch + step; peak memory {peak_gib:.2f} GiB; device "
          f"busy {busy_ms:.3f} ms per batch + step over {len(device_events) / TRAIN_PROFILED:.0f} "
          f"device events (profiler), busy share {min(1.0, busy_ms / wall_ms):.3f}; no host-device "
          f"sync in the batch render or the step; losses {[round(v, 4) for v in loss.tolist()]}; "
          f"backbone bit-identical, {len(moved)} head tensors and all {len(stats)} BatchNorm "
          f"statistics moved; render launches {launches['heatmap_render']} for {batches[0]} batches")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
    return launches["heatmap_render"]


def phase_trainer() -> int:
    """`scripts/torch_train_synthetic.py --mode multi` at its defaults for
    TRAINER_STEPS steps: finite losses, the last logged loss below
    TRAINER_LOSS_DROP of the first, two render launches per batch made
    (the eval batches and one per step). -> render launches."""
    spec = importlib.util.spec_from_file_location(
        "torch_train_synthetic", ROOT / "scripts" / "torch_train_synthetic.py")
    trainer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trainer)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        _reset_launches()
        final = trainer.main(["--mode", "multi", "--steps", str(TRAINER_STEPS), "--workdir", work])
        launches = _read_launches()
        log = [json.loads(line) for line in
               (Path(work) / "logs" / "metrics.jsonl").read_text().splitlines()]
    want = 2 * (TRAINER_STEPS + TRAINER_EVAL_BATCHES)
    check(launches == {k: want if k == "heatmap_render" else 0 for k in KERNELS},
          f"trainer: launched {launches}, want {want} renders")
    curve = [(int(r["step"]), r["loss"], r["pck5"]) for r in log]
    print(f"trainer ({TRAINER_STEPS} steps at its defaults): (step, loss, pck5) {curve}; "
          f"final pck5 {final['pck5']}, angle_mae {final['angle_mae']}, "
          f"{final['train_samples_per_sec']} samples/s; render launches "
          f"{launches['heatmap_render']}")
    check(all(np.isfinite(r["loss"]) for r in log), "trainer: a logged loss is not finite")
    check(log[-1]["loss"] < TRAINER_LOSS_DROP * log[0]["loss"],
          f"trainer: loss {log[0]['loss']} -> {log[-1]['loss']}, not below "
          f"{TRAINER_LOSS_DROP} of the first")
    return launches["heatmap_render"]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU")
    device = phase_device()
    phase_build()
    measured = {**phase_peak_decode(), **phase_layernorm(), **phase_int8_pv(),
                **phase_heatmap_render()}
    phase_counters()
    launches = {"peak_decode": _serve([], "bf16", ["peak_decode"])["peak_decode"]}
    flat = seed0_flat()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as run:  # ~350 MB of weights
        write_run_dir(flat, Path(run))
        int8_launches = _serve(
            ["--params", str(Path(run) / "best_params.npz"), "--int8-backbone",
             "--int8-attention"], "int8 + fused LN", SERVE_KERNELS,
        )
    launches.update({k: v for k, v in int8_launches.items() if k != "peak_decode"})
    phase_step(flat)
    phase_small_reference()
    launches["heatmap_render"] = phase_train_step(device) + phase_trainer()
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], **measured[name],
    } for name, (_, _, source, replaces) in KERNELS.items()]}))
    print(device["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
