#!/usr/bin/env python3
"""The int8 serve step's quantizations of this checkout against another's, in turns on one card.

    python3 scripts/torch_int8_quantize_turns.py OTHER_DIR

Builds both checkouts' kernels (the other's in a process of its own, from
its own root) and loads the other's library beside this one's: its
`layernorm_fwd`, `int8_quantize_rows` and `int8_quantize_v` take the same C
arguments in both. By CUDA-graph replay in turns other/this/this/other, at
the int8 serve step's shapes (ViT-B/16 at 512 px, 4 views: M = 4100 token
rows of 768, values (4, 1025, 12, 64)), bf16:
  * the LayerNorm feeding q/k/v: the other's LayerNorm kernel then its row
    quantization kernel, against this checkout's LayerNorm with its int8
    output (`layernorm_int8_cuda`); the same for the residual LayerNorm
    feeding fc1;
  * the row quantization alone at (4100, 768) and (4100, 3072);
  * the values' quantization at (4, 1025, 12, 64);
each beside its bound (bytes over 3.35 TB/s, each input read once and each
output written once) and with the two checkouts' outputs compared bit for
bit. Prints one line a comparison and a JSON line of them all. Needs a CUDA
GPU.
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
from mvropose_torch.ops import _build, int8_attention, int8_matmul, layernorm  # noqa: E402

ASK = ("from mvropose_torch.ops import _build\n"
       "_build.load_library()\n"
       "print(_build.library_path())\n")
PTR, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
M, D, HIDDEN = 4 * 1025, 768, 3072
VALUES = (4, 1025, 12, 64)


def other_library(root: Path) -> ctypes.CDLL:
    """The other checkout's kernels, built from its own root."""
    out = subprocess.run([sys.executable, "-c", ASK], cwd=root, capture_output=True, text=True,
                         timeout=900, check=False)
    if out.returncode != 0:
        raise SystemExit(f"{root}: could not build its kernels:\n{out.stderr[-4000:]}")
    lib = ctypes.CDLL(out.stdout.strip().splitlines()[-1])
    lib.layernorm_fwd.argtypes = [PTR] * 6 + [I32, I32, F32, I32, I32, I32, PTR]
    lib.int8_quantize_rows.argtypes = [PTR, I64, I32, I32, I32, PTR, PTR, PTR]
    lib.int8_quantize_v.argtypes = [PTR] + [I32] * 3 + [PTR] * 3 + [I32, PTR]
    for fn in (lib.layernorm_fwd, lib.int8_quantize_rows, lib.int8_quantize_v):
        fn.restype = ctypes.c_int
    return lib


def flat_pair(out) -> tuple:
    """(xnew, (x_q, s_x)) -> (xnew, x_q, s_x)."""
    return (out[0], *out[1])


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"the other checkout's {what} returned {err}")


class Other:
    """The other checkout's three kernels on preallocated outputs."""

    def __init__(self, lib):
        self.lib = lib

    def layernorm(self, x, h, g, b, xnew, y):
        checked(self.lib.layernorm_fwd(
            x.data_ptr(), 0 if h is None else h.data_ptr(), g.data_ptr(), b.data_ptr(),
            0 if xnew is None else xnew.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], 1e-6,
            1, 1, int(h is not None), stream()), "layernorm_fwd")

    def rows(self, x, xq, sx):
        checked(self.lib.int8_quantize_rows(x.data_ptr(), x.stride(0), x.shape[0], x.shape[1], 0,
                                            xq.data_ptr(), sx.data_ptr(), stream()),
                "int8_quantize_rows")

    def values(self, v, vt, sv):
        B, T, H, _ = v.shape
        strides = (ctypes.c_int64 * 3)(*v.stride()[:3])
        checked(self.lib.int8_quantize_v(v.data_ptr(), B, H, T, strides, vt.data_ptr(),
                                         sv.data_ptr(), vt.shape[-1], stream()), "int8_quantize_v")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_int8_quantize_turns: needs a CUDA GPU")
    device = chip_smoke.phase_device()
    _build.load_library()
    other = Other(other_library(args.other.resolve()))

    def timer(fn):
        return chip_smoke.graph_ms(fn, iters=10, samples=20)

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    x = (0.5 + 3.0 * torch.randn(M, D, generator=gen)).to("cuda", bf16)
    h = torch.randn(M, D, generator=gen).to("cuda", bf16)
    g = (1.0 + 0.1 * torch.randn(D, generator=gen)).cuda()
    b = (0.1 * torch.randn(D, generator=gen)).cuda()
    wide = torch.randn(M, HIDDEN, generator=gen).to("cuda", bf16)
    v = torch.randn(*VALUES, generator=gen).to("cuda", bf16)
    y, xnew = torch.empty_like(x), torch.empty_like(x)
    xq, sx = torch.empty(M, D, dtype=torch.int8, device="cuda"), torch.empty(M, 1, device="cuda")
    wq = torch.empty(M, HIDDEN, dtype=torch.int8, device="cuda")
    Tp = int8_attention._fused_tp(VALUES[1])
    vt = torch.empty(VALUES[0] * VALUES[2], 64, Tp, dtype=torch.int8, device="cuda")
    sv = torch.empty(VALUES[0] * VALUES[2], 64, device="cuda")

    def other_ln():
        other.layernorm(x, None, g, b, None, y)
        other.rows(y, xq, sx)

    def other_res_ln():
        other.layernorm(x, h, g, b, xnew, y)
        other.rows(y, xq, sx)

    row, wide_bytes = 2 * M * D, 2 * M * HIDDEN  # bytes of a bf16 (M, D) and (M, 3072) tensor
    params = 2 * D * 4
    cases = {  # name: (other, this, this's outputs then the other's, bytes of the function)
        "layernorm_int8": (other_ln, lambda: layernorm.layernorm_int8_cuda(x, g, b),
                           lambda: (layernorm.layernorm_int8_cuda(x, g, b), (xq, sx)),
                           row + params + M * D + 4 * M),
        "residual_layernorm_int8": (
            other_res_ln, lambda: layernorm.residual_layernorm_int8_cuda(x, h, g, b),
            lambda: (flat_pair(layernorm.residual_layernorm_int8_cuda(x, h, g, b)),
                     (xnew, xq, sx)),
            3 * row + params + M * D + 4 * M),
        "int8_quantize_rows (4100, 768)": (
            lambda: other.rows(x, xq, sx), lambda: int8_matmul.int8_quantize_rows_cuda(x),
            lambda: (int8_matmul.int8_quantize_rows_cuda(x), (xq, sx)), row + M * D + 4 * M),
        "int8_quantize_rows (4100, 3072)": (
            lambda: other.rows(wide, wq, sx), lambda: int8_matmul.int8_quantize_rows_cuda(wide),
            lambda: (int8_matmul.int8_quantize_rows_cuda(wide), (wq, sx)),
            wide_bytes + M * HIDDEN + 4 * M),
        "int8_quantize_v (4, 1025, 12, 64)": (
            lambda: other.values(v, vt, sv), lambda: int8_attention.int8_quantize_v_cuda(v),
            lambda: (int8_attention.int8_quantize_v_cuda(v), (vt, sv)),
            2 * v.numel() + vt.numel() + 4 * sv.numel()),
    }
    rows = []
    for name, (run_other, run_this, outputs, nbytes) in cases.items():
        new, old = chip_smoke._in_turns(timer, run_other, run_this)
        mine, theirs = outputs()
        run_other()
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b_) for a, b_ in zip(mine, theirs))
        bound = chip_smoke.bound(nbytes)
        rows.append({"case": name, "ms": new, "other_ms": old, "bound_ms": bound["bound_ms"],
                     "bound_by": bound["bound_by"], "bit_equal": equal})
        print(f"{name} bf16, us per call, CUDA-graph replay, in turns other/this/this/other: "
              f"this {1e3 * new:.2f}, other {1e3 * old:.2f} ({old / new:.2f}x); bound "
              f"{1e3 * bound['bound_ms']:.2f} ({bound['bound_by']}), this at "
              f"{bound['bound_ms'] / new:.2f} of it; outputs bit-equal: {equal}", flush=True)
        chip_smoke.check(equal, f"{name}: the two checkouts' outputs differ")
    print(json.dumps({"card": device["nvidia_smi"], "quantize_turns": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
