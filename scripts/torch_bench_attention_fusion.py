"""Flash-attention kernels vs the plain branch vs SDPA at the fusion shape, on the GPU.

Port of `scripts/bench_attention_fusion.py`: `SelfAttentionFusion` attends
all V views' tokens in one self-attention, T = V * 513 (512 patch tokens +
CLS per view). For B in {1, 4} and V in {4, 8}, H = 12, d = 64, bf16, one
JSON line per configuration: the port's kernels (`ops/attention.py`), its
plain branch and torch's `scaled_dot_product_attention` (the library
yardstick; nothing in the port calls it), each forward and forward +
backward in ms (CUDA events over 20 calls after a warm-up, median of 10
windows, taken in turns plain/kernel/kernel/plain), the kernels' max abs
error against the plain branch in f32, and the card's name and power limit.

Usage: python scripts/torch_bench_attention_fusion.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mvropose_torch.ops import attention  # noqa: E402


def sdpa(q, k, v, key_mask=None):
    """torch's fused attention on the same (B, T, H, d) operands and mask."""
    mask = None if key_mask is None else key_mask[:, None, None, :]
    out = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)), attn_mask=mask)
    return out.transpose(1, 2)


PATHS = {"kernel": attention.flash_attention_cuda, "plain": attention.flash_attention_reference,
         "library": sdpa}


def event_ms(fn, iters: int = 20, samples: int = 10) -> float:
    """Median over `samples` CUDA-event windows of `iters` calls, after a
    warm-up, in ms per call."""
    for _ in range(3):
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


def attention_times(q, k, v, key_mask, do, timer=event_ms) -> dict:
    """{path: {"fwd": ms, "fwd_bwd": ms}} for the kernel, plain and library
    paths on leaf tensors q, k, v (requires_grad) and the cotangent do, each
    timed by `timer(fn) -> ms`; kernel and plain in turns
    plain/kernel/kernel/plain, the median of each pair."""
    def fwd(fn):
        def run():
            with torch.no_grad():
                fn(q, k, v, key_mask)
        return run

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(q, k, v, key_mask), (q, k, v), do)

    out = {}
    for part, make in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        turns = [timer(make(PATHS[p])) for p in ("plain", "kernel", "kernel", "plain")]
        out.setdefault("plain", {})[part] = statistics.median(turns[0::3])
        out.setdefault("kernel", {})[part] = statistics.median(turns[1:3])
        out.setdefault("library", {})[part] = timer(make(PATHS["library"]))
    return out


def operands(B: int, T: int, H: int, d: int, seed: int = 0):
    """bf16 (B, T, H, d) q, k, v (leaves that require grad) and do, N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    return [t.requires_grad_() for t in (q, k, v)], do


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_attention_fusion: this needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    H, d = 12, 64
    for B in (1, 4):
        for V in (4, 8):
            T = V * 513
            (q, k, v), do = operands(B, T, H, d)
            with torch.no_grad():
                want = attention.flash_attention_reference_f32(q, k, v)
                err = float((attention.flash_attention_cuda(q, k, v).float() - want).abs().max())
            del want
            times = attention_times(q, k, v, None, do)
            print(json.dumps({
                "B": B, "views": V, "T": T, "H": H, "d": d, "dtype": "bfloat16",
                "kernel_fwd_ms": times["kernel"]["fwd"],
                "kernel_fwd_bwd_ms": times["kernel"]["fwd_bwd"],
                "plain_fwd_ms": times["plain"]["fwd"],
                "plain_fwd_bwd_ms": times["plain"]["fwd_bwd"],
                "library_fwd_ms": times["library"]["fwd"],
                "library_fwd_bwd_ms": times["library"]["fwd_bwd"],
                "library": "torch.nn.functional.scaled_dot_product_attention",
                "max_abs_err_vs_f32_plain": err,
                "card": card(),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
