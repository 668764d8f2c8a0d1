#!/usr/bin/env python3
"""The int8 GEMM of this checkout against another's, in turns on one card.

    python3 scripts/torch_int8_gemm_turns.py OTHER_DIR

OTHER_DIR is another checkout of the port (unpack it with `git archive`
under build/). Builds both checkouts' kernels (the other's in a process of
its own, from its own root) and loads the other's library beside this one's:
its `int8_gemm_sm90` takes the same C arguments in both. Each product's
output is compared bit for bit between the two checkouts and held to the
plain version (`int8_gemm_reference`), and each is timed by CUDA-graph
replay in turns other/this/this/other:
  * the int8 serve step's products at M = 4100 token rows (ViT-B/16 at 512
    px, 4 views), bf16 out: 768 -> 768 (q, k, v, out), fc1 768 -> 3072, fc2
    3072 -> 768, and a block's six (4 x 768 -> 768, fc1, fc2) in one graph;
  * fc1 with f32 out (the f32 int8 serve);
  * the eval capture's products at M = 16400 (16 views), bf16 out;
each beside its bound (the larger of the bytes, each input read once and the
output written once, over 3.35 TB/s and the int8 operations over 1979 TOP/s)
and `torch._int_mm` alone (int32 out). Two timings a case:
  * back to back: ten calls in one graph. A kernel launched with
    programmatic dependent launch runs its set-up and its weights' first
    loads under the call before, which on the main path is mostly not a
    GEMM: so this favours such a kernel;
  * in the main path's order: each product after the kernel that writes
    its x_q and s_x (`int8_quantize_rows_cuda` on its x; in the block, q,
    out, fc1 and fc2 after one, k and v straight after q and k, as the
    serve step runs them), less the quantizations timed alone: the GEMM's
    own time, with no more overlap than the main path gives it. Then the int8 + fused-LN serve step
(ViT-B/16, 512 px, 4 resident 720x1280 frames, seed-0 weights, bf16), in
processes of their own from each root, in turns other/this/this/other: its
device time by CUDA-graph replay, the GEMM's launches a step, and the
GEMM's, the int8 attention's and the values' quantization's shares of the
step's kernel time (torch.profiler over replays).
Prints one line a comparison, then a JSON line of them all. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mvropose_torch.models.quantize import int8_gemm_reference  # noqa: E402
from mvropose_torch.ops import _build, int8_matmul  # noqa: E402

ASK = ("from mvropose_torch.ops import _build\n"
       "_build.load_library()\n"
       "print(_build.library_path())\n")
PTR, I32 = ctypes.c_void_p, ctypes.c_int
SERVE_M, EVAL_M = 4 * 1025, 16 * 1025
PRODUCTS = {"768->768": (768, 768), "fc1": (768, 3072), "fc2": (3072, 768)}
BLOCK = ["768->768"] * 4 + ["fc1", "fc2"]  # a block's six products, in the order it runs them
# Which of them the serve step runs straight after the kernel that writes
# their x_q (an int8 LayerNorm or the rows quantization): all but k and v,
# which follow q's and k's GEMMs on q's x_q.
BLOCK_QUANTIZED = [True, False, False, True, True, True]

# The bf16 int8 + fused-LN serve step, timed by a process from a checkout's
# root with that checkout's package: only names both checkouts have.
STEP = r"""
import json
import statistics
import numpy as np
import torch
from mvropose_torch.cli.main import serve_step
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
from mvropose_torch.ops import int8_matmul
from mvropose_torch.utils.weights import int8ify, load_jax_params, random_flat
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
vit = ViTConfig(image_size=512, patch_size=16, hidden_size=768, num_layers=12, num_heads=12,
                dtype="bfloat16", fused_ln=True)
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
        before = int8_matmul.launches
        step()
        launches = int8_matmul.launches - before
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
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0 and e.key != "cudaGraphLaunch"]
    busy = sum(e.self_device_time_total for e in kernels) / 10 / 1e3
    def kernel_ms(name):
        return sum(e.self_device_time_total for e in kernels if name in e.key) / 10 / 1e3
print("step " + json.dumps({"ms": statistics.median(times), "busy_ms": busy,
                            "gemm_ms": kernel_ms("int8_gemm_sm90"), "gemm_launches": launches,
                            "attention_ms": kernel_ms("int8_attention_sm90"),
                            "quantize_v_ms": kernel_ms("int8_quantize_v")}))
"""


def other_library(root: Path) -> ctypes.CDLL:
    """The other checkout's kernels, built from its own root."""
    out = subprocess.run([sys.executable, "-c", ASK], cwd=root, capture_output=True, text=True,
                         timeout=900, check=False)
    if out.returncode != 0:
        raise SystemExit(f"{root}: could not build its kernels:\n{out.stderr[-4000:]}")
    lib = ctypes.CDLL(out.stdout.strip().splitlines()[-1])
    lib.int8_gemm_sm90.argtypes = [PTR] * 6 + [I32] * 4 + [PTR]
    lib.int8_gemm_sm90.restype = ctypes.c_int
    return lib


class Product:
    """One product's operands (`chip_smoke._int8_mm_operands`: rows over many
    binades, a zero row, a quantized N(0, 0.02) weight and bias), quantized
    once, with an output buffer for the other checkout's kernel."""

    def __init__(self, M: int, din: int, dout: int, out_dtype, seed: int):
        self.x, self.kq, self.scale, self.bias = chip_smoke._int8_mm_operands(
            M, din, dout, torch.bfloat16, seed)
        self.xq, self.sx = int8_matmul.int8_quantize_rows_cuda(self.x)
        self.out_dtype, self.shape = out_dtype, (M, din, dout)
        self.out = torch.empty(M, dout, dtype=out_dtype, device="cuda")

    def quantize(self) -> tuple:
        return int8_matmul.int8_quantize_rows_cuda(self.x)

    def this(self, xs=None) -> torch.Tensor:
        xq, sx = xs or (self.xq, self.sx)
        return int8_matmul.int8_gemm_cuda(xq, sx, self.kq, self.scale, self.bias, self.out_dtype)

    def other(self, lib, xs=None) -> torch.Tensor:
        M, din, dout = self.shape
        xq, sx = xs or (self.xq, self.sx)
        err = lib.int8_gemm_sm90(xq.data_ptr(), self.kq.data_ptr(), sx.data_ptr(),
                                 self.scale.data_ptr(), self.bias.data_ptr(), self.out.data_ptr(),
                                 M, dout, din, int(self.out_dtype == torch.float32),
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other checkout's int8_gemm_sm90 returned {err}")
        return self.out

    def plain(self) -> torch.Tensor:
        return int8_gemm_reference(self.xq, self.sx, self.kq, self.scale, self.bias,
                                   self.out_dtype)

    def work(self) -> tuple:
        """(bytes: x_q, s_x, W_q, s_w, bias read once, y written once; int8 operations)."""
        M, din, dout = self.shape
        out_bytes = M * dout * torch.empty(0, dtype=self.out_dtype).element_size()
        return M * din + 4 * M + din * dout + 8 * dout + out_bytes, 2 * M * din * dout


def step_times(other: Path, timeout: float) -> dict:
    """The bf16 int8 + fused-LN serve step from each root, in turns
    other/this/this/other -> {"this": [..], "other": [..]} of its readings."""
    runs = {"this": [], "other": []}
    for label in ("other", "this", "this", "other"):
        root = other if label == "other" else ROOT
        out = subprocess.run([sys.executable, "-c", STEP], cwd=root, capture_output=True,
                             text=True, timeout=timeout, check=False)
        if out.returncode != 0:
            raise SystemExit(f"[{label}] the int8 step failed:\n{out.stderr[-4000:]}")
        reading = json.loads(out.stdout.split("step ")[-1])
        runs[label].append(reading)
        print(f"[{label}] int8 + fused-LN serve step (bf16, ViT-B/16 512 px, 4 views), "
              f"CUDA-graph replay: {reading['ms']:.4f} ms; profiler: kernels "
              f"{reading['busy_ms']:.4f} ms a step, int8 GEMM {reading['gemm_ms']:.4f} ms "
              f"({reading['gemm_launches']} launches), int8 attention "
              f"{reading['attention_ms']:.4f} ms, values' quantization "
              f"{reading['quantize_v_ms']:.4f} ms", flush=True)
    return runs


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path)
    p.add_argument("--no-step", action="store_true", help="skip the serve step's turns")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_int8_gemm_turns: needs a CUDA GPU")
    device = chip_smoke.phase_device()
    _build.load_library()
    lib = other_library(args.other.resolve())

    def timer(fn):
        return chip_smoke.graph_ms(fn, iters=10, samples=20)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = {f"{name} M={SERVE_M}": [Product(SERVE_M, din, dout, bf16, seed=700 + i)]
             for i, (name, (din, dout)) in enumerate(PRODUCTS.items())}
    serve = {name: cases[f"{name} M={SERVE_M}"][0] for name in PRODUCTS}
    cases[f"block of six M={SERVE_M}"] = [serve[name] for name in BLOCK]
    cases[f"fc1 M={SERVE_M} f32 out"] = [Product(SERVE_M, 768, 3072, f32, seed=710)]
    for i, (name, (din, dout)) in enumerate(PRODUCTS.items()):
        cases[f"{name} M={EVAL_M}"] = [Product(EVAL_M, din, dout, bf16, seed=720 + i)]
    rows = []
    for name, products in cases.items():
        quantized = BLOCK_QUANTIZED if len(products) > 1 else [True]

        def in_order(gemm, products=products, quantized=quantized):
            """The products in the main path's order, each quantized x_q
            written by the kernel just before its GEMM (or k's and v's, q's)."""
            for pr, fresh in zip(products, quantized):
                xs = pr.quantize() if fresh else xs
                gemm(pr, xs)

        def quantizations(products=products, quantized=quantized):
            for pr, fresh in zip(products, quantized):
                if fresh:
                    pr.quantize()

        new, old = chip_smoke._in_turns(
            timer, lambda: [pr.other(lib) for pr in products], lambda: [pr.this() for pr in products])
        new_seq, old_seq = chip_smoke._in_turns(
            timer, lambda: in_order(lambda pr, xs: pr.other(lib, xs)),
            lambda: in_order(lambda pr, xs: pr.this(xs)))
        quant = timer(quantizations)
        new_own, old_own = new_seq - quant, old_seq - quant
        equal = plain = True
        for pr in products:
            mine, theirs, want = pr.this(), pr.other(lib).clone(), pr.plain()
            torch.cuda.synchronize()
            equal &= torch.equal(mine, theirs)
            plain &= torch.equal(mine, want)
        int_mm = timer(lambda: [torch._int_mm(pr.xq.view(-1, pr.shape[1]), pr.kq) for pr in products])
        nbytes = sum(pr.work()[0] for pr in products)
        ops = sum(pr.work()[1] for pr in products)
        b = chip_smoke.bound(nbytes, ops, "int8")
        l2 = sum(int8_matmul.gemm_l2_bytes(*pr.shape) for pr in products)
        rows.append({"case": name, "ms": new_own, "other_ms": old_own, "back_to_back_ms": new,
                     "other_back_to_back_ms": old, "in_order_ms": new_seq,
                     "other_in_order_ms": old_seq, "quantizations_ms": quant,
                     "int_mm_ms": int_mm, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                     "bit_equal": equal, "plain_equal": plain, "l2_bytes": l2})
        print(f"int8 GEMM {name}, us per call (CUDA-graph replay, in turns other/this/this/"
              f"other): in the main path's order this {1e3 * new_own:.2f}, other "
              f"{1e3 * old_own:.2f} ({old_own / new_own:.3f}x; with the quantizations "
              f"{1e3 * new_seq:.2f} / {1e3 * old_seq:.2f}, they alone {1e3 * quant:.2f}); back to "
              f"back this {1e3 * new:.2f}, other {1e3 * old:.2f} ({old / new:.3f}x); bound "
              f"{1e3 * b['bound_ms']:.2f} ({b['bound_by']}), this at {b['bound_ms'] / new_own:.3f} "
              f"of it in the main path's order; torch._int_mm alone {1e3 * int_mm:.2f}; operand "
              f"bytes from L2 (this) {l2 / 1e6:.1f} MB; outputs bit-equal between the checkouts: "
              f"{equal}, to the plain version: {plain}", flush=True)
        chip_smoke.check(equal and plain, f"{name}: the outputs differ")
    edges = chip_smoke.gemm_graph_edges()
    result = {"card": device["nvidia_smi"], "gemm_turns": rows, "graph_edges": edges}
    if not args.no_step:
        result["int8_step"] = step_times(args.other.resolve(), timeout=600)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
