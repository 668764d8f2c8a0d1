#!/usr/bin/env python3
"""The flash forward or backward pair of this checkout against another's, in turns on one card.

    python3 scripts/torch_flash_forward_turns.py OTHER_DIR [--dtypes bf16 f16 f32] [--backward]

Builds both checkouts' kernels (the other's in a process of its own, from
its own root), asks the other checkout which forward, dK/dV and dQ entry
points its `kernel_route` takes at each head width and dtype, and loads its
library beside this one's (the other's entry points take flash_attention.cu's
common C arguments, and the split-TF32 ones a scratch buffer after them,
sized by its library; this checkout's kernels are called through
`attention.flash_forward_cuda` and the backward wrappers). With
--backward, per case (the f32 cases by default): the dK/dV kernel, the dQ
kernel and the pair alone, on this checkout's forward's m and l (the same
split-TF32 forward in both checkouts since the f32 forward's redesign), by
CUDA-graph replay in turns other/this/this/other, beside SDPA's backward
alone in the same dtype (`torch.autograd.grad` on a saved
`scaled_dot_product_attention`, the pair's three gradients), each kernel's
bound (`chip_smoke._flash_bounds`, for f32 at TF32's rate and at the f32
rate) and the two pairs' largest gradient difference. Without it, per case,
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
# What the other checkout reports: its library and each (d, dtype, part)'s route and entry point.
ASK = ("import json, torch\n"
       "from mvropose_torch.ops import _build, attention\n"
       "_build.load_library()\n"
       "routes = {f'{d} {n} {i}': attention.kernel_route(d, getattr(torch, n), part)\n"
       "          for d in attention.HEAD_DIMS for n in ('bfloat16', 'float16', 'float32')\n"
       "          for i, part in enumerate(attention.FLASH_PARTS)}\n"
       "print(json.dumps({'lib': str(_build.library_path()), 'entry': {\n"
       "    key: [r, attention.ENTRY_POINTS[r][int(key.split()[2])]]\n"
       "    for key, r in routes.items()}}))\n")
PTR, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The common C arguments of each part (flash_attention.cu's entry points).
ARGTYPES = ([PTR] * 7 + [I32] * 4 + [PTR, F32, PTR], [PTR] * 10 + [I32] * 4 + [PTR, F32, PTR],
            [PTR] * 9 + [I32] * 4 + [PTR, F32, PTR])


def other_kernels(root: Path) -> dict:
    """{(d, "bf16" | "f16" | "f32", part index): (entry point name, ctypes
    function, scratch elements as a function of (B, H, T, d) or None)} of
    the other checkout."""
    out = subprocess.run([sys.executable, "-c", ASK], cwd=root, capture_output=True, text=True,
                         timeout=900, check=False)
    if out.returncode != 0:
        raise SystemExit(f"{root}: could not build or query its kernels:\n{out.stderr[-4000:]}")
    found = json.loads(out.stdout.strip().splitlines()[-1])
    lib = ctypes.CDLL(found["lib"])
    fns = {}
    for key, (route, name) in found["entry"].items():
        d, torch_name, part = key.split()
        fn = getattr(lib, name)
        scratch = None
        if route == "wgmma_tf32":  # a trailing scratch buffer for the split operands
            size = getattr(lib, "flash_attention_forward_tf32_scratch" if part == "0"
                           else "flash_attention_backward_tf32_scratch")
            size.argtypes, size.restype = [I32] * 4, ctypes.c_int64
            scratch = size
        fn.argtypes = ARGTYPES[int(part)] + ([PTR] if scratch else [])
        fn.restype = ctypes.c_int
        tag = {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}[torch_name]
        fns[int(d), tag, int(part)] = (name, fn, scratch)
    return fns


def scratch_args(size, q) -> tuple:
    """A scratch buffer for an entry point that takes one (size: its library's sizer), else ()."""
    if size is None:
        return ()
    B, T, H, d = q.shape
    return (torch.empty(size(B, H, T, d), dtype=torch.float32, device=q.device).data_ptr(),)


def call(kernel, q, k, v, o) -> None:
    """One launch of a forward entry point on (B, T, H, d) q, k, v into o."""
    _, fn, size = kernel
    B, T, H, d = q.shape
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v) for s in t.stride()[:3]), 0, 0, 0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), None, None, B, H, T, d,
             strides, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
             *scratch_args(size, q))
    if err:
        raise RuntimeError(f"the other checkout's forward returned {err}")


def call_backward(dkv, dq, args, outs) -> None:
    """The other checkout's dK/dV then dQ entry points (either None: not
    called) on `args` (q, k, v, mask_u8, dO, m, l, di, as the backward
    wrappers take them) into outs (dQ, dK, dV)."""
    q, k, v, _, do, m, l, di = args
    B, T, H, d = q.shape
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, do) for s in t.stride()[:3]))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, do.data_ptr(), m.data_ptr(),
            l.data_ptr(), di.data_ptr())
    dims = (B, H, T, d, strides, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    for kernel, out in ((dkv, outs[1:]), (dq, outs[:1])):
        if kernel is None:
            continue
        name, fn, size = kernel
        err = fn(*ptrs, *(t.data_ptr() for t in out), *dims, *scratch_args(size, q))
        if err:
            raise RuntimeError(f"the other checkout's {name} returned {err}")


def backward_turns(others: dict, cases: list, timer, sdpa) -> list:
    """Per case the dK/dV, dQ and pair times of the two checkouts in turns,
    SDPA's backward alone, the bounds and the gradients' largest gap."""
    rows = []
    for B, T, H, d, ty in cases:
        dtype = DTYPES[ty]
        gen = torch.Generator().manual_seed(d)
        q, k, v, do = (torch.randn(B, T, H, d, generator=gen).to("cuda", dtype) for _ in range(4))
        o, m, l = attention.flash_forward_cuda(q, k, v, None)
        args = (q, k, v, None, do, m, l, attention.row_dot(do, o))
        outs = [torch.empty_like(q) for _ in range(3)]
        dkv, dq = others[d, ty, 1], others[d, ty, 2]
        this = {"flash_bwd_dkv": lambda: attention.flash_backward_dkv_cuda(*args),
                "flash_bwd_dq": lambda: attention.flash_backward_dq_cuda(*args),
                "pair": lambda: (attention.flash_backward_dkv_cuda(*args),
                                 attention.flash_backward_dq_cuda(*args))}
        other = {"flash_bwd_dkv": lambda: call_backward(dkv, None, args, outs),
                 "flash_bwd_dq": lambda: call_backward(None, dq, args, outs),
                 "pair": lambda: call_backward(dkv, dq, args, outs)}
        times = {key: chip_smoke._in_turns(timer, other[key], this[key]) for key in this}
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            saved = sdpa(*leaves)
        library = chip_smoke.graph_ms(
            lambda: torch.autograd.grad(saved, leaves, do, retain_graph=True), iters=2,
            samples=10, stream=side)
        other["pair"]()
        mine = (attention.flash_backward_dq_cuda(*args), *attention.flash_backward_dkv_cuda(*args))
        gap = max(float((a.float() - b.float()).abs().max()) for a, b in zip(mine, outs))
        bounds = chip_smoke._flash_bounds(B, T, H, d, None, dtype)
        row = {"shape": [B, T, H, d], "dtype": ty, "other": [dkv[0], dq[0]], "sdpa_bwd_ms": library,
               "max_abs_diff": gap}
        for key, (new, old) in times.items():
            row[key] = {"ms": new, "other_ms": old}
            if key in bounds:
                row[key].update(bound_ms=bounds[key]["bound_ms"],
                                f32_rate_bound_ms=bounds[key].get("f32_rate_bound_ms"))
        rows.append(row)
        pair_new, pair_old = times["pair"]
        print(f"flash backward {(B, T, H, d)} {ty}, ms per call, CUDA-graph replay, in turns "
              f"other/this/this/other: "
              + "; ".join(f"{key} this {row[key]['ms']:.4f}, other {row[key]['other_ms']:.4f} "
                          f"({row[key]['other_ms'] / row[key]['ms']:.2f}x)"
                          + (f", bound {row[key]['bound_ms']:.4f}" if "bound_ms" in row[key]
                             else "")
                          + (f", at the f32 rate {row[key]['f32_rate_bound_ms']:.4f}"
                             if row[key].get("f32_rate_bound_ms") else "")
                          for key in this)
              + f"; SDPA's backward alone {library:.4f} (this pair / SDPA "
              f"{pair_new / library:.3f}, other pair / SDPA {pair_old / library:.3f}); gradients "
              f"differ by at most {gap:.3g}", flush=True)
        del q, k, v, do, o, m, l, args, outs, leaves, saved
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path)
    p.add_argument("--dtypes", nargs="+", choices=DTYPES, default=None,
                   help="the cases' dtypes (default: all; with --backward f32)")
    p.add_argument("--backward", action="store_true", help="time the dK/dV and dQ kernels")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_forward_turns: needs a CUDA GPU")
    device = chip_smoke.phase_device()
    _build.load_library()
    others = other_kernels(args.other.resolve())
    dtypes = args.dtypes or (["f32"] if args.backward else list(DTYPES))
    cases = [(8, 2305, 768 // d, d, ty) for ty in ("bf16", "f16") for d in attention.HEAD_DIMS]
    cases.append((2, 2305, 12, 64, "f16"))
    cases += [(2, 2305, 768 // d, d, "f32") for d in attention.HEAD_DIMS]
    cases = [case for case in cases if case[-1] in dtypes]

    def timer(fn):
        return chip_smoke.graph_ms(fn, iters=2, samples=10)

    sdpa = chip_smoke._script("torch_bench_attention_fusion").sdpa
    if args.backward:
        rows = backward_turns(others, cases, timer, sdpa)
        print(json.dumps({"card": device["nvidia_smi"], "backward_turns": rows}))
        return 0
    rows = []
    for B, T, H, d, ty in cases:
        dtype = DTYPES[ty]
        gen = torch.Generator().manual_seed(d)
        q, k, v = (torch.randn(B, T, H, d, generator=gen).to("cuda", dtype) for _ in range(3))
        o_other = torch.empty_like(q)
        name = others[d, ty, 0][0]

        def this():
            attention.flash_forward_cuda(q, k, v, None, save_stats=False)

        def other():
            call(others[d, ty, 0], q, k, v, o_other)

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
