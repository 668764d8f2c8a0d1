#!/usr/bin/env python3
"""Variants of the fused int8 attention's source, built side by side and timed in turns on one card.

    python3 scripts/torch_int8_attention_variants.py [VARIANTS] [--source CSRC_DIR] [--widths] [--step]

VARIANTS is a JSON object, or a file holding one, mapping a label to a list
of [regex, replacement] pairs applied in order to a copy of
`mvropose_torch/csrc/int8_attention.cu` (or of CSRC_DIR's, another
checkout's sources, with its headers); a pattern that matches nothing stops
the script. The default, `{"as_is": []}`, builds this checkout's source
unchanged; `scripts/int8_attention_variants.json` holds the decomposition
of this kernel, `scripts/int8_attention_variants_v1.json` that of its first
design, a block a query tile with serial passes (its patterns match that
source: pass `--source` with the csrc directory of a checkout that has
it). A label
ending in `_x` marks a variant whose outputs are not expected to be right
(one without its first pass, say): its outputs are not checked. Each
variant is compiled with the build's nvcc flags into a library of its own
under build/attention_variants/ (all compiles started together), beside the
parent's library, built from its own root at build/parent (unpack the
parent commit there with `git archive`). Every library is called through its
own `int8_quantize_v`, `int8_attention_sm90` and `int8_attention_f32_sm90`
(on a scratch buffer of `int8_attention_f32_scratch` elements). Cases: the int8 serve step's attention, (4,
1025, 12, 64) bf16 and f32; with --widths also (2, 1025, 768 / d, d) at d =
32, 48, 96, 128, in both. Each checked library's output is held within
`chip_smoke._int8_bound` of the plain version (`int8_attention_reference`),
and its count of outputs not bit-equal to the parent's is printed. Then each
library is timed by CUDA-graph replay, twice in turns (the order reversed
the second time), the medians printed in us a call:
  * alone: the attention's entry point back to back (programmatic launch,
    where a library has it, overlaps a call with the one before);
  * route: the values' quantization, then the attention, as the main path
    runs them; less the quantization timed alone, the attention's own time
    in the main path's order.
With --step, then the bf16 int8 + fused-LN serve step from each root in
turns (`torch_int8_gemm_turns.step_times`: graph replay, the kernels' time
by torch.profiler, the attention's share). One line a case, then a JSON
line of them all. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import torch_int8_gemm_turns as turns  # noqa: E402
import torch_int8_gemm_variants as gemm_variants  # noqa: E402
from mvropose_torch.ops import _build, int8_attention  # noqa: E402

OUT = ROOT / "build" / "attention_variants"
PARENT = ROOT / "build" / "parent"
ROUNDS = 2
PTR, I32 = ctypes.c_void_p, ctypes.c_int


class Library:
    """One build's three entry points, each call on this case's buffers."""

    def __init__(self, lib: ctypes.CDLL):
        self.quantize, self.bf16, self.f32 = (lib.int8_quantize_v, lib.int8_attention_sm90,
                                              lib.int8_attention_f32_sm90)
        self.scratch_size = lib.int8_attention_f32_scratch
        self.quantize.argtypes = [PTR] + [I32] * 4 + [PTR] * 3 + [I32, I32, PTR]
        self.bf16.argtypes = [PTR] * 6 + [I32] * 5 + [PTR, ctypes.c_float, PTR]
        self.f32.argtypes = [PTR] * 6 + [I32] * 5 + [PTR, ctypes.c_float, PTR, PTR]
        self.scratch_size.argtypes = [I32] * 4
        self.scratch_size.restype = ctypes.c_int64
        for fn in (self.quantize, self.bf16, self.f32):
            fn.restype = ctypes.c_int


class Case:
    """(B, T, H, d) q, k, v in one dtype (`chip_smoke._int8_operands`, the
    projections' layout) and, for each library, its quantized values,
    scratch and output."""

    def __init__(self, B: int, T: int, H: int, d: int, dname: str):
        self.dtype = chip_smoke.INT8_DTYPES[dname]
        self.name = f"{(B, T, H, d)} {dname}"
        self.q, self.k, self.v, _ = chip_smoke._int8_operands(B, T, H, "proj", seed=300,
                                                                dtype=self.dtype, d=d)
        self.shape, self.Tp = (B, T, H, d), int8_attention._fused_tp(T)
        self.buffers: dict = {}

    def _buffers(self, lib: Library) -> tuple:
        if id(lib) not in self.buffers:
            B, T, H, d = self.shape
            dev = self.q.device
            scratch = None
            if self.dtype == torch.float32:
                scratch = torch.empty(lib.scratch_size(B, H, self.Tp, d), dtype=torch.float32,
                                      device=dev)
            self.buffers[id(lib)] = (
                torch.empty((B * H, d, self.Tp), dtype=torch.int8, device=dev),
                torch.empty((B * H, d), dtype=torch.float32, device=dev),
                torch.empty(self.shape, dtype=self.dtype, device=dev), scratch)
        return self.buffers[id(lib)]

    def quantize(self, lib: Library) -> None:
        vt, sv, _, _ = self._buffers(lib)
        B, T, H, d = self.shape
        strides = (ctypes.c_int64 * 3)(*self.v.stride()[:3])
        err = lib.quantize(self.v.data_ptr(), B, H, T, d, strides, vt.data_ptr(), sv.data_ptr(),
                           self.Tp, int(self.dtype == torch.float32),
                           torch.cuda.current_stream().cuda_stream)
        chip_smoke.check(err == 0, f"int8_quantize_v returned {err}")

    def attention(self, lib: Library) -> torch.Tensor:
        vt, sv, out, scratch = self._buffers(lib)
        B, T, H, d = self.shape
        strides = (ctypes.c_int64 * 6)(*self.q.stride()[:3], *self.k.stride()[:3])
        args = [self.q.data_ptr(), self.k.data_ptr(), None, vt.data_ptr(), sv.data_ptr(),
                out.data_ptr(), B, H, T, d, self.Tp, strides,
                int8_attention.sm_scale(d, self.dtype)]
        if self.dtype == torch.float32:
            fn = lib.f32
            args.append(scratch.data_ptr())
        else:
            fn = lib.bf16
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        chip_smoke.check(err == 0, f"the int8 attention returned {err}")
        return out

    def route(self, lib: Library) -> torch.Tensor:
        self.quantize(lib)
        return self.attention(lib)


def load_variants(arg: str | None) -> dict:
    if arg is None:
        return {"as_is": []}
    path = Path(arg)
    return json.loads(path.read_text() if path.is_file() else arg)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("variants", nargs="?", help="a JSON object or a file holding one")
    p.add_argument("--source", type=Path, default=_build.CSRC_DIR,
                   help="the csrc directory whose int8_attention.cu the variants patch")
    p.add_argument("--widths", action="store_true", help="also the other head widths")
    p.add_argument("--step", action="store_true", help="then the serve step from each root")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_int8_attention_variants: needs a CUDA GPU")
    variants = load_variants(args.variants)
    paths = gemm_variants.build_variants(variants, args.source.resolve(), "int8_attention.cu",
                                         "int8_attention_sm90_kernel", OUT)
    device = chip_smoke.phase_device()
    libs = {"parent": Library(turns.other_library(PARENT))}
    libs.update({label: Library(ctypes.CDLL(str(path))) for label, path in paths.items()})

    shapes = [(chip_smoke.INT8_SERVE, dname) for dname in chip_smoke.INT8_DTYPES]
    if args.widths:
        shapes += [((2, 1025, 768 // d, d), dname) for dname in chip_smoke.INT8_DTYPES
                   for d in chip_smoke.INT8_WIDTHS]

    def timer(fn):
        return chip_smoke.graph_ms(fn, iters=10, samples=20)

    result = {}
    for shape, dname in shapes:
        case = Case(*shape, dname)
        vq, _ = int8_attention.quantize_v_reference(case.v)
        parent = case.route(libs["parent"]).clone()
        for label, lib in libs.items():
            out = case.route(lib)
            torch.cuda.synchronize()
            if label == "parent" or label.endswith("_x"):
                continue
            sv = case._buffers(lib)[1]
            want = int8_attention.int8_attention_reference(case.q, case.k, vq, sv)
            gap = (out.float() - want.float()).abs() / chip_smoke._int8_bound(out, want, sv)
            differ = int((out != parent).sum())
            print(f"{case.name} {label}: {float(gap.max()):.3f} of the bound from the plain "
                  f"version; {differ} of {out.numel()} outputs not bit-equal to the parent's",
                  flush=True)
            chip_smoke.check(bool(torch.isfinite(out).all()) and float(gap.max()) <= 1.0,
                             f"{case.name}: {label}'s output leaves the bound")
        times = {label: {"alone": [], "route": [], "quantize": []} for label in libs}
        for r in range(ROUNDS):
            for label in list(libs) if r % 2 == 0 else list(libs)[::-1]:
                lib = libs[label]
                times[label]["alone"].append(timer(lambda lib=lib: case.attention(lib)))
                times[label]["route"].append(timer(lambda lib=lib: case.route(lib)))
                times[label]["quantize"].append(timer(lambda lib=lib: case.quantize(lib)))
        us = {label: {k: 1e3 * statistics.median(v) for k, v in t.items()}
              for label, t in times.items()}
        for t in us.values():
            t["in_order"] = t["route"] - t["quantize"]
        result[case.name] = us
        print(f"int8 attention {case.name}, us a call (CUDA-graph replay, {ROUNDS} rounds in "
              f"turns): " + "; ".join(
                  f"{label} alone {t['alone']:.2f}, route {t['route']:.2f} (values' kernel "
                  f"{t['quantize']:.2f}, the attention in the main path's order "
                  f"{t['in_order']:.2f})" for label, t in us.items()), flush=True)
    out = {"card": device["nvidia_smi"], "variants": variants, "us": result}
    if args.step:
        out["int8_step"] = turns.step_times(PARENT.resolve(), timeout=600)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
