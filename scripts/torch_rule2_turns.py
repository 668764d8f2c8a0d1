#!/usr/bin/env python3
"""The peak decode and the f32 int8 attention of this checkout and another's, in turns.

    python3 scripts/torch_rule2_turns.py OTHER_DIR

OTHER_DIR is a checkout of the port from before the cluster peak decode and
the f32 fused int8 attention (unpack it with `git archive` under build/).
Builds both checkouts' kernels (the other's in a process of its own, from
its own root) and loads the other's library beside this one's, calling its
`peak_decode_f32` (one block a map) and `int8_pv` (the P@V kernel of its f32
route) by their own C arguments. By CUDA-graph replay in turns
other/this/this/other, with the two checkouts' outputs compared:
  * the peak decode at the serve shape (32, 128, 128) f32: argmax and peak
    equal, soft-argmax within 1e-3 px, confidence within 1e-6;
  * the f32 int8 attention at (4, 1025, 12, 64): the other's "pv" route (the
    plain logits, exponent and probabilities written into rows padded to 64
    keys, then its P@V kernel) against this checkout's `int8_prob_attention`
    (the values' quantization, the pre-pass and the fused kernel), within
    one value step of each other; and the other's P@V kernel alone against
    this checkout's pre-pass + fused kernel alone, each on its own inputs;
  * the int8 + fused-LN serve step with the backbone in
    f32 (ViT-B/16 at 512 px, 4 resident 720x1280 frames, seed-0 weights), in
    processes of their own from each root, turns other/this/this/other: its
    device time by CUDA-graph replay.
This checkout's f32 route is also profiled: each of its kernels' device
duration a call. First, this checkout's peak decode alone at the serve
shape and on one 4x4 map with each cluster size C in {1, 2, 4, 8} forced,
and the other's on the same maps, beside a one-element `zero_` (a graph's
per-node floor): CUDA-graph replay per call, and each kernel's own device
duration from `torch.profiler`. Prints one line a comparison, then a JSON
line of them all (~3 min with both builds). Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mvropose_torch.ops import _build, int8_attention, peak_decode  # noqa: E402

ASK = ("from mvropose_torch.ops import _build\n"
       "_build.load_library()\n"
       "print(_build.library_path())\n")
PTR, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
MAPS = (32, 128, 128)
ATTN = (4, 1025, 12, 64)
PV_KEY_TILE = 64  # the other's P@V kernel reads rows padded to this many keys

# The f32 int8 + fused-LN serve step, timed by a process from a checkout's
# root with that checkout's package: only names both checkouts have.
STEP = r"""
import statistics
import numpy as np
import torch
from mvropose_torch.cli.main import serve_step
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
from mvropose_torch.utils.weights import int8ify, load_jax_params, random_flat
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
vit = ViTConfig(image_size=512, patch_size=16, hidden_size=768, num_layers=12, num_heads=12,
                dtype="float32", fused_ln=True)
cfg = EstimatorConfig(vit=vit, num_joints=8, num_angles=7, max_views=4)
flat = random_flat(MultiViewPoseEstimator(cfg, device="meta"))
model = MultiViewPoseEstimator(cfg, device="cuda").eval()
load_jax_params(model, flat)
int8ify(model, flat, attn=True)
frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(4, 720, 1280, 3),
                                                            dtype=np.uint8)).cuda()
mask = torch.ones(4, dtype=torch.bool, device="cuda")
with torch.inference_mode():
    step = lambda: serve_step(model, frames, mask, 512, (720, 1280))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        step()
    for _ in range(5):
        graph.replay()
    times = []
    for _ in range(30):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
print("step_ms", statistics.median(times))
"""


def other_library(root: Path) -> ctypes.CDLL:
    """The other checkout's kernels, built from its own root."""
    out = subprocess.run([sys.executable, "-c", ASK], cwd=root, capture_output=True, text=True,
                         timeout=900, check=False)
    if out.returncode != 0:
        raise SystemExit(f"{root}: could not build its kernels:\n{out.stderr[-4000:]}")
    lib = ctypes.CDLL(out.stdout.strip().splitlines()[-1])
    lib.peak_decode_f32.argtypes = [PTR, PTR, I32, I32, I32, F32, PTR]
    lib.int8_pv.argtypes = [PTR] * 5 + [I32] * 3 + [I64] * 2 + [I32, PTR]
    for fn in (lib.peak_decode_f32, lib.int8_pv):
        fn.restype = ctypes.c_int
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"the other checkout's {what} returned {err}")


class OtherPv:
    """The other checkout's f32 "pv" route at one shape, on buffers it keeps:
    the plain logits, exponent and probabilities (written into rows padded to
    64 keys, as its `padded_probs`), then its P@V kernel on the values
    transposed into (B H, 64, Tp) zero past T, writing f32."""

    def __init__(self, lib, B: int, T: int, H: int, d: int):
        self.lib, self.shape = lib, (B, T, H, d)
        self.Tp = -(-T // PV_KEY_TILE) * PV_KEY_TILE
        self.pq = torch.empty((B * H, T, self.Tp), dtype=torch.int8, device="cuda")[:, :, :T]
        self.vt = torch.zeros((B * H, d, self.Tp), dtype=torch.int8, device="cuda")
        self.out = torch.empty((B * H, T, d), device="cuda")

    def kernel(self, z, sv):
        """Its P@V kernel alone on the probabilities and values in place."""
        B, T, H, _ = self.shape
        checked(self.lib.int8_pv(self.pq.data_ptr(), self.vt.data_ptr(), z.data_ptr(),
                                 sv.data_ptr(), self.out.data_ptr(), B * H, T, self.Tp,
                                 self.pq.stride(1), self.pq.stride(0), 0, stream()), "int8_pv")

    def route(self, q, k, v):
        B, T, H, d = self.shape
        vq, sv = int8_attention.quantize_v_reference(v)
        qh, kh = q.transpose(1, 2), k.transpose(1, 2)
        logits = (qh * 0.125) @ kh.transpose(-2, -1)
        ef = torch.exp(logits - logits.amax(dim=-1, keepdim=True)).float()
        z = ef.sum(dim=-1).reshape(B * H, T)
        self.pq.copy_(torch.round(ef * 127.0).reshape(B * H, T, T))
        self.vt[:, :, :T] = vq.transpose(1, 2)
        self.kernel(z, sv)
        return self.out.reshape(B, H, T, d).transpose(1, 2)


def step_times(other: Path, timeout: float) -> dict:
    """The f32 int8 serve step's device time from each root, in turns
    other/this/this/other -> {"this": [ms, ms], "other": [ms, ms]}."""
    times = {"this": [], "other": []}
    for label in ("other", "this", "this", "other"):
        root = other if label == "other" else ROOT
        out = subprocess.run([sys.executable, "-c", STEP], cwd=root, capture_output=True,
                             text=True, timeout=timeout, check=False)
        if out.returncode != 0:
            raise SystemExit(f"[{label}] the f32 int8 step failed:\n{out.stderr[-4000:]}")
        ms = float(out.stdout.split("step_ms")[-1])
        times[label].append(ms)
        print(f"[{label}] f32 int8 + fused-LN serve step, CUDA-graph replay: {ms:.3f} ms",
              flush=True)
    return times


def profiled_by_kernel(fn, calls: int = 100) -> dict:
    """Each kernel's mean device duration a call of `fn`, by the profiler,
    in us, keyed by the kernel's name (its first 60 characters)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return by_name


def profiled_us(fn) -> float:
    """The device duration of the kernels `fn` launches, a call."""
    return sum(profiled_by_kernel(fn).values())


def decode_sweep(timer, lib) -> list:
    """The peak decode at (32, 128, 128) and on one 4x4 map with each
    cluster size forced, and the other checkout's kernel on the same maps,
    and a one-element zero_, by graph replay and by the profiler's kernel
    durations."""
    gen = torch.Generator().manual_seed(1)
    rows = []
    one = torch.zeros(1, device="cuda")
    floor = {"graph_us": 1e3 * timer(one.zero_), "kernel_us": profiled_us(one.zero_)}
    rows.append({"case": "zero_ (1 element)", **floor})
    print(f"one-element zero_: graph replay {floor['graph_us']:.2f} us a call, kernel "
          f"{floor['kernel_us']:.2f} us (profiler)", flush=True)
    for shape in (MAPS, (1, 4, 4)):
        maps = torch.randn(*shape, generator=gen).cuda()
        out = torch.empty(shape[0], 8, device="cuda")
        for C in (1, 2, 4, 8):
            def call(C=C):
                checked(peak_decode._kernel()(maps.data_ptr(), out.data_ptr(), *shape, C, 1.0,
                                              stream()), f"peak_decode_f32 C={C}")
            row = {"case": f"peak_decode {shape} C={C}", "graph_us": 1e3 * timer(call),
                   "kernel_us": profiled_us(call)}
            rows.append(row)
            print(f"peak decode {shape}, {C} blocks a map (cluster of {C}): graph replay "
                  f"{row['graph_us']:.2f} us a call, kernel {row['kernel_us']:.2f} us (profiler)",
                  flush=True)

        def other(maps=maps, out=out, shape=shape):
            checked(lib.peak_decode_f32(maps.data_ptr(), out.data_ptr(), *shape, 1.0, stream()),
                    "peak_decode_f32")
        row = {"case": f"other peak_decode {shape}", "graph_us": 1e3 * timer(other),
               "kernel_us": profiled_us(other)}
        rows.append(row)
        print(f"the other checkout's peak decode {shape} (one block a map): graph replay "
              f"{row['graph_us']:.2f} us a call, kernel {row['kernel_us']:.2f} us (profiler)",
              flush=True)
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_rule2_turns: needs a CUDA GPU")
    device = chip_smoke.phase_device()
    _build.load_library()
    lib = other_library(args.other.resolve())

    def timer(fn):
        return chip_smoke.graph_ms(fn, iters=10, samples=30)

    rows = decode_sweep(timer, lib)
    gen = torch.Generator().manual_seed(0)
    maps = (4.0 * torch.randn(*MAPS, generator=gen)).cuda()
    other_out = torch.empty(MAPS[0], 8, device="cuda")

    def other_decode():
        checked(lib.peak_decode_f32(maps.data_ptr(), other_out.data_ptr(), *MAPS, 1.0, stream()),
                "peak_decode_f32")

    new, old = chip_smoke._in_turns(timer, other_decode, lambda: peak_decode.peak_decode_cuda(maps))
    mine = peak_decode.peak_decode_cuda(maps)
    other_decode()
    torch.cuda.synchronize()
    gap = (mine - other_out).abs().amax(dim=0)
    agree = bool(torch.equal(mine[:, [0, 1, 5, 6, 7]], other_out[:, [0, 1, 5, 6, 7]])
                 and gap[2:4].max() <= 1e-3 and gap[4] <= 1e-6)
    b = chip_smoke.bound(maps.numel() * 4 + MAPS[0] * 8 * 4)
    rows.append({"case": f"peak_decode {MAPS}", "ms": new, "other_ms": old, **b, "agree": agree})
    print(f"peak decode {MAPS} f32, us per call, CUDA-graph replay, in turns other/this/this/"
          f"other: "
          f"this {1e3 * new:.2f}, other {1e3 * old:.2f} ({old / new:.2f}x); bound "
          f"{1e3 * b['bound_ms']:.2f} ({b['bound_by']}); outputs agree: {agree}", flush=True)
    chip_smoke.check(agree, f"peak decode: the two checkouts' outputs differ ({gap.tolist()})")

    B, T, H, d = ATTN
    q, k, v = (s * torch.randn(B, T, H, d, generator=gen) for s in (2.0, 2.0, 1.0))
    q, k, v = (x.cuda() for x in (q, k, v))
    pv = OtherPv(lib, B, T, H, d)
    kb = chip_smoke.int8_attention_bound(B, T, H, d, torch.float32)
    new, old = chip_smoke._in_turns(timer, lambda: pv.route(q, k, v),
                                    lambda: int8_attention.int8_prob_attention(q, k, v))
    mine, theirs = int8_attention.int8_prob_attention(q, k, v), pv.route(q, k, v)
    torch.cuda.synchronize()
    _, sv = int8_attention.quantize_v_reference(v)
    within = bool(((mine - theirs).abs() <= sv.reshape(B, 1, H, d)).all())
    rows.append({"case": f"int8 attention route f32 {ATTN}", "ms": new, "other_ms": old,
                 "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"], "agree": within})
    print(f"int8 attention f32 {ATTN}, the whole route, ms per call, CUDA-graph replay, in turns "
          f"other (pv route: plain chain + P@V kernel) / this (fused f32): this {new:.4f}, other "
          f"{old:.4f} ({old / new:.2f}x); bound {chip_smoke.fmt_bound(kb)}; outputs within one "
          f"value step: {within}", flush=True)
    chip_smoke.check(within, "int8 attention: the two routes differ by more than a value step")

    parts = profiled_by_kernel(lambda: int8_attention.int8_prob_attention(q, k, v))
    rows.append({"case": f"route f32 {ATTN} by kernel (profiler, us)", **parts})
    print(f"int8 attention f32 {ATTN}, this route's kernels by the profiler, us a call: "
          + "; ".join(f"{n} {t:.2f}" for n, t in sorted(parts.items(), key=lambda x: -x[1])),
          flush=True)
    vt, sv8 = int8_attention.int8_quantize_v_cuda(v)
    pv.route(q, k, v)  # the other's probabilities, values and z in place for its kernel alone
    vq, sv_ref = int8_attention.quantize_v_reference(v)
    _, z = int8_attention._probabilities(q, k, None)
    new, old = chip_smoke._in_turns(timer, lambda: pv.kernel(z, sv_ref),
                                    lambda: int8_attention.int8_attention_cuda(q, k, vt, sv8))
    rows.append({"case": f"kernel alone f32 {ATTN}", "ms": new, "other_ms": old})
    print(f"int8 attention f32 {ATTN}, kernels alone, ms per call, CUDA-graph replay, in turns "
          f"other (int8_pv_kernel on its padded probabilities) / this (pre-pass + fused kernel): "
          f"this {new:.4f}, other {old:.4f}", flush=True)
    del pv, q, k, v, vt, vq, z

    times = step_times(args.other.resolve(), timeout=600)
    print(f"f32 int8 + fused-LN serve step, device time (CUDA-graph replay), in turns: this "
          f"{statistics.mean(times['this']):.3f} ms, other {statistics.mean(times['other']):.3f} "
          f"ms", flush=True)
    print(json.dumps({"card": device["nvidia_smi"], "turns": rows, "f32_int8_step_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
