#!/usr/bin/env python3
"""Variants of the int8 GEMM's source, built side by side and timed in turns on one card.

    python3 scripts/torch_int8_gemm_variants.py VARIANTS_JSON [--source CSRC_DIR]

VARIANTS_JSON maps a label to a list of [regex, replacement] pairs applied
in order to a copy of `mvropose_torch/csrc/int8_gemm.cu` (or of CSRC_DIR's,
another checkout's sources, with its headers; a pattern that
matches nothing stops the script; a label ending in `_x` marks a variant
whose outputs are not expected to be right, e.g. one without its epilogue:
its outputs are not checked). `{"as_is": []}` builds the source unchanged.
Each variant is compiled with the build's nvcc flags into a library of its
own under build/gemm_variants/ (all compiles started together), beside the
parent's library, built from its own root at build/parent (unpack the
parent commit there with `git archive`). Every library is called through `int8_gemm_sm90`,
whose C arguments are the same in all. At M = 4100 (bf16 out unless named):
768 -> 768, fc1, fc2, a block's six, fc1 f32 out; at M = 16400: fc2 and fc1.
Each case's outputs are held bit-equal to the plain version
(`int8_gemm_reference`), then each library is timed by CUDA-graph replay,
twice in turns (the order reversed the second time); the median
a call in us is printed, one line a case, then a JSON line of them all.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import torch_int8_gemm_turns as turns  # noqa: E402
from mvropose_torch.ops import _build  # noqa: E402

OUT = ROOT / "build" / "gemm_variants"
HEADERS = ("sm90_common.cuh", "int8_quantize.cuh")
PARENT = ROOT / "build" / "parent"
ROUNDS = 2


def build_variants(variants: dict, csrc: Path, source: str = "int8_gemm.cu",
                   kernel: str = "int8_gemm_sm90_kernel", out: Path = OUT) -> dict:
    """label -> the path of its library, compiled in parallel from csrc's
    `source`, patched; nvcc's registers and spills of `kernel` printed, and
    how many of its instantiations ptxas serialized the wgmma products of."""
    shutil.rmtree(out, ignore_errors=True)
    nvcc, procs, libs = _build.find_nvcc(), {}, {}
    flags = [f for f in _build.COMPILE_FLAGS if f != "-c"]
    for label, subs in variants.items():
        d = out / label
        d.mkdir(parents=True)
        for name in HEADERS:
            shutil.copy(csrc / name, d / name)
        src = (csrc / source).read_text()
        for pattern, replacement in subs:
            new = re.sub(pattern, replacement, src)
            if new == src:
                raise SystemExit(f"variant {label}: {pattern!r} matches nothing")
            src = new
        (d / source).write_text(src)
        libs[label] = d / "lib.so"
        procs[label] = subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", str(libs[label]), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for label, proc in procs.items():
        log = proc.communicate()[0]
        used = [(name.split(kernel)[1][:24], re.findall(r"Used \d+ registers|\d+ bytes spill "
                                                         r"stores", part))
                for name, part in (p.split("'", 1) for p in log.split("entry function '")[1:])
                if kernel in name]
        serialized = sum(kernel in line for line in log.splitlines()
                         if "wgmma.mma_async instructions are serialized" in line)
        print(f"variant {label}: nvcc rc {proc.returncode}; {serialized} instantiations with "
              f"serialized wgmma; " + " | ".join(f"{args} {'; '.join(found)}" for args, found in used),
              flush=True)
        if proc.returncode:
            raise SystemExit(log[-4000:])
    return libs


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("variants", type=json.loads)
    p.add_argument("--source", type=Path, default=_build.CSRC_DIR,
                   help="the csrc directory whose int8_gemm.cu the variants patch")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_int8_gemm_variants: needs a CUDA GPU")
    libs = build_variants(args.variants, args.source.resolve())
    device = chip_smoke.phase_device()
    impl = {"parent": turns.other_library(PARENT)}
    for label, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.int8_gemm_sm90.argtypes = [turns.PTR] * 6 + [turns.I32] * 4 + [turns.PTR]
        lib.int8_gemm_sm90.restype = ctypes.c_int
        impl[label] = lib

    bf16 = torch.bfloat16
    cases = {name: [turns.Product(turns.SERVE_M, din, dout, bf16, seed=700 + i)]
             for i, (name, (din, dout)) in enumerate(turns.PRODUCTS.items())}
    cases["block of six"] = [cases[name][0] for name in turns.BLOCK]
    cases["fc1 f32 out"] = [turns.Product(turns.SERVE_M, 768, 3072, torch.float32, seed=710)]
    cases["fc2 M=16400"] = [turns.Product(turns.EVAL_M, 3072, 768, bf16, seed=722)]
    cases["fc1 M=16400"] = [turns.Product(turns.EVAL_M, 768, 3072, bf16, seed=721)]

    def timer(fn):
        return chip_smoke.graph_ms(fn, iters=10, samples=20)

    result = {}
    for case, products in cases.items():
        want = [pr.plain() for pr in products]
        for label, lib in impl.items():
            got = [pr.other(lib).clone() for pr in products]
            torch.cuda.synchronize()
            if not label.endswith("_x"):
                chip_smoke.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                                 f"{case}: {label}'s outputs differ from the plain version")
        times = {label: [] for label in impl}
        for r in range(ROUNDS):
            for label in list(impl) if r % 2 == 0 else list(impl)[::-1]:
                times[label].append(timer(lambda lib=impl[label]: [pr.other(lib) for pr in products]))
        result[case] = {label: 1e3 * statistics.median(t) for label, t in times.items()}
        print(f"{case}, us a call (CUDA-graph replay, {ROUNDS} rounds in turns): "
              + ", ".join(f"{label} {us:.2f}" for label, us in result[case].items()), flush=True)
    print(json.dumps({"card": device["nvidia_smi"], "variants": args.variants, "us": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
