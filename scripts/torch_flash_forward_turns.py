#!/usr/bin/env python3
"""The flash forward of this checkout against another checkout's, in turns on one card.

    python3 scripts/torch_flash_forward_turns.py OTHER_DIR [--dtypes bf16 f16 f32]

Builds both checkouts' kernels (the other's in a process of its own, from
its own root), asks the other checkout which forward entry point its
`kernel_route` takes at each head width and dtype, and loads its library
beside this one's (the other's forward entry points take flash_attention.cu's
common C arguments, as every forward did before the split-TF32 one, which
this checkout calls through `attention.flash_forward_cuda`). Then, per case,
the forward alone (no statistics saved) by CUDA-graph replay in turns
other/this/this/other, beside SDPA in the same dtype
(`scaled_dot_product_attention`, the library yardstick), the bound
(`chip_smoke._flash_bounds`: the larger of the products' time, three TF32
products per product for f32, and the B H T^2 exponentials' at the card's
ex2 rate; for f32 also the same work at the f32 rate); and the two
outputs' largest difference. Cases, no mask, operands contiguous (B, T, H,
d) as a projection's: (8, 2305, 768 / d, d) in bf16 and f16 at every width,
(2, 2305, 12, 64) f16, and (2, 2305, 768 / d, d) f32 at every width. Needs
a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mvropose_torch.ops import _build, attention  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
# What the other checkout reports: its library and each (d, dtype)'s forward entry point.
ASK = ("import json, torch\n"
       "from mvropose_torch.ops import _build, attention\n"
       "_build.load_library()\n"
       "print(json.dumps({'lib': str(_build.library_path()), 'entry': {\n"
       "    f'{d} {n}': attention.ENTRY_POINTS[attention.kernel_route(d, getattr(torch, n))][0]\n"
       "    for d in attention.HEAD_DIMS for n in ('bfloat16', 'float16', 'float32')}}))\n")


def other_forwards(root: Path) -> dict:
    """{(d, "bf16" | "f16" | "f32"): the other checkout's forward, a ctypes function}."""
    out = subprocess.run([sys.executable, "-c", ASK], cwd=root, capture_output=True, text=True,
                         timeout=900, check=False)
    if out.returncode != 0:
        raise SystemExit(f"{root}: could not build or query its kernels:\n{out.stderr[-4000:]}")
    found = json.loads(out.stdout.strip().splitlines()[-1])
    lib = ctypes.CDLL(found["lib"])
    fns = {}
    for key, name in found["entry"].items():
        d, torch_name = key.split()
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tag = {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}[torch_name]
        fns[int(d), tag] = (name, fn)
    return fns


def call(fn, q, k, v, o) -> None:
    """One launch of a forward entry point on (B, T, H, d) q, k, v into o."""
    B, T, H, d = q.shape
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v) for s in t.stride()[:3]), 0, 0, 0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), None, None, B, H, T, d,
             strides, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the other checkout's forward returned {err}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path)
    p.add_argument("--dtypes", nargs="+", choices=DTYPES, default=list(DTYPES))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_forward_turns: needs a CUDA GPU")
    device = chip_smoke.phase_device()
    _build.load_library()
    others = other_forwards(args.other.resolve())
    cases = [(8, 2305, 768 // d, d, ty) for ty in ("bf16", "f16") for d in attention.HEAD_DIMS]
    cases.append((2, 2305, 12, 64, "f16"))
    cases += [(2, 2305, 768 // d, d, "f32") for d in attention.HEAD_DIMS]
    cases = [case for case in cases if case[-1] in args.dtypes]

    def timer(fn):
        return chip_smoke.graph_ms(fn, iters=2, samples=10)

    sdpa = chip_smoke._script("torch_bench_attention_fusion").sdpa
    rows = []
    for B, T, H, d, ty in cases:
        dtype = DTYPES[ty]
        gen = torch.Generator().manual_seed(d)
        q, k, v = (torch.randn(B, T, H, d, generator=gen).to("cuda", dtype) for _ in range(3))
        o_other = torch.empty_like(q)
        name, fn = others[d, ty]

        def this():
            attention.flash_forward_cuda(q, k, v, None, save_stats=False)

        def other():
            call(fn, q, k, v, o_other)

        new, old = chip_smoke._in_turns(timer, other, this)
        library = timer(lambda: sdpa(q, k, v))
        other()
        gap = float((attention.flash_forward_cuda(q, k, v, None, save_stats=False)[0].float()
                     - o_other.float()).abs().max())
        bound = chip_smoke._flash_bounds(B, T, H, d, None, dtype)["flash_fwd"]
        row = {"shape": [B, T, H, d], "dtype": ty, "ms": new, "other_ms": old, "other": name,
               "sdpa_ms": library, "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
               "f32_rate_bound_ms": bound.get("f32_rate_bound_ms"), "max_abs_diff": gap}
        rows.append(row)
        print(f"flash forward {(B, T, H, d)} {ty}, ms per call, CUDA-graph replay, in turns "
              f"other/this/this/other: this {new:.4f}, other ({name}) {old:.4f} "
              f"({old / new:.2f}x), SDPA {library:.4f} (this / SDPA {new / library:.3f}); "
              f"bound {chip_smoke.fmt_bound(bound)}"
              + (f", at the f32 rate {bound['f32_rate_bound_ms']:.4f}" if ty == "f32" else "")
              + f"; outputs differ by at most {gap:.3g}",
              flush=True)
        del q, k, v, o_other
    print(json.dumps({"card": device["nvidia_smi"], "forward_turns": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
