"""Heatmap peak decode: the CUDA kernel and its plain-torch version.

Port of `mvropose_tpu/ops/peak_decode.py::fused_peak_decode`. Per heatmap it
computes the first-index hard argmax (x, y), the temperature-softmax
soft-argmax (x, y), sigmoid(peak) and the raw peak, as one (M, 8) f32 row
`[ax, ay, sx, sy, sigmoid(peak), peak, 0, 0]`. A map that holds a NaN
decodes as the JAX kernel decodes it: peak NaN, argmax index H*W (x = 0, y =
H), soft sums and confidence NaN. The kernel is `csrc/peak_decode.cu` (a
thread-block cluster of `cluster_blocks` blocks a map); its source note says
what bounds it on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mvropose_torch.ops._build import current_stream, device_context, load_library

# Kernel launches made through `peak_decode_cuda`.
launches = 0


def peak_decode_reference(heatmaps: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Plain torch version: (M, H, W) -> (M, 8) f32 on the input's device."""
    M, H, W = heatmaps.shape
    flat = heatmaps.reshape(M, H * W).float()
    idx = flat.argmax(dim=-1)  # first index of the maximum; torch takes a NaN as the maximum
    peak = flat.gather(-1, idx[:, None])[:, 0]  # NaN where the map holds one
    # The JAX kernel's first index holding a value >= the peak: none where the
    # peak is NaN, so its min falls back to H*W.
    idx = torch.where(torch.isnan(flat).any(-1), H * W, idx)
    p = torch.exp((flat - peak[:, None]) * temperature)
    z = p.sum(-1)
    pos = torch.arange(H * W, device=flat.device)
    soft_x = (p * (pos % W).float()).sum(-1) / z
    soft_y = (p * (pos // W).float()).sum(-1) / z
    zero = torch.zeros_like(peak)
    return torch.stack(
        [(idx % W).float(), (idx // W).float(), soft_x, soft_y,
         torch.sigmoid(peak), peak, zero, zero],
        dim=-1,
    )


CLUSTER_SIZES = (8, 4, 2, 1)  # blocks a map the kernel takes, largest first


def cluster_blocks(M: int, sms: int) -> int:
    """Blocks a map: the largest of CLUSTER_SIZES with M of them fitting on
    `sms` SMs (1 where even one a map does not)."""
    return next((c for c in CLUSTER_SIZES if M * c <= sms), 1)


@functools.cache
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.cache
def _kernel():
    fn = load_library().peak_decode_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def peak_decode_cuda(heatmaps: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Launch the kernel on (M, H, W) CUDA maps -> (M, 8) f32, on the current
    stream: `cluster_blocks(M, SMs)` blocks a map as one cluster. Raises if
    the launch (a cluster launch the card refuses included) fails."""
    global launches
    if heatmaps.device.type != "cuda":
        raise ValueError(f"peak_decode_cuda needs a CUDA tensor, got {heatmaps.device}")
    if heatmaps.dim() != 3:
        raise ValueError(f"expected (M, H, W) maps, got shape {tuple(heatmaps.shape)}")
    M, H, W = heatmaps.shape
    if H * W == 0 or M * H * W >= 2**31:
        raise ValueError(f"maps of shape {tuple(heatmaps.shape)}: need 0 < H*W and M*H*W < 2**31")
    rows = heatmaps.float().contiguous()
    out = torch.empty((M, 8), dtype=torch.float32, device=rows.device)
    if M == 0:
        return out
    dev = rows.get_device()
    with device_context(dev):
        stream = current_stream(dev)
        err = _kernel()(rows.data_ptr(), out.data_ptr(), M, H, W, cluster_blocks(M, _sm_count(dev)),
                        float(temperature), stream)
    if err != 0:
        raise RuntimeError(f"peak_decode_f32 launch failed with CUDA error {err}")
    launches += 1
    return out


def fused_peak_decode(heatmaps: torch.Tensor, temperature: float = 1.0) -> dict:
    """Decode heatmaps (..., H, W) -> dict of per-map peak statistics.

    Returns argmax_xy (..., 2), soft_xy (..., 2), confidence (...,) =
    sigmoid(peak) and peak (...,), as the JAX function does. A CUDA tensor
    goes through the kernel; a CPU tensor through `peak_decode_reference`.
    """
    *lead, H, W = heatmaps.shape
    rows = heatmaps.reshape(-1, H, W)
    if heatmaps.device.type == "cpu":
        out = peak_decode_reference(rows, temperature)
    else:
        out = peak_decode_cuda(rows, temperature)
    out = out.reshape(*lead, 8)
    return {
        "argmax_xy": out[..., 0:2],
        "soft_xy": out[..., 2:4],
        "confidence": out[..., 4],
        "peak": out[..., 5],
    }
