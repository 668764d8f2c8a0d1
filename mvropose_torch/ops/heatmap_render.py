"""Gaussian heatmap rendering: the CUDA kernel and its plain-torch version.

Port of `mvropose_tpu/ops/heatmap_render.py::render_heatmaps_pallas`. Each map
comes from one (x, y, 1/(2 sigma^2)) row: `exp(-((col-x)^2 + (row-y)^2) * inv)`,
then 0 wherever a value is below f64_eps times the peak of its own map. The
kernel is `csrc/heatmap_render.cu`; its source note says what bounds it on the
card. `fused_render_heatmaps` has the JAX function's signature and renders the
synthetic trainer's GT heatmaps and blob images (`data/synthetic.py`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mvropose_torch.ops._build import current_stream, device_context, load_library

_F64_EPS = 2.220446049250313e-16  # np.finfo(float).eps, as the reference uses

# Kernel launches made through `render_heatmaps_cuda`.
launches = 0


def render_heatmaps_reference(rows: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Plain torch version of the Pallas body: (M, 3) f32 rows
    [x, y, 1/(2 sigma^2)] -> (M, H, W) f32 maps on the rows' device."""
    x, y, inv = (rows[:, k, None, None] for k in range(3))
    col = torch.arange(width, dtype=torch.float32, device=rows.device)[None, None, :]
    row = torch.arange(height, dtype=torch.float32, device=rows.device)[None, :, None]
    d2 = (col - x) ** 2 + (row - y) ** 2
    hm = torch.exp(-d2 * inv)
    peak = hm.amax(dim=(1, 2), keepdim=True)
    return torch.where(hm < _F64_EPS * peak, 0.0, hm)


@functools.cache
def _kernel():
    fn = load_library().render_heatmaps_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def render_heatmaps_cuda(rows: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Launch the kernel on (M, 3) f32 CUDA rows -> (M, H, W) f32, on the current stream."""
    global launches
    if rows.device.type != "cuda":
        raise ValueError(f"render_heatmaps_cuda needs a CUDA tensor, got {rows.device}")
    if rows.dim() != 2 or rows.shape[1] != 3 or rows.dtype != torch.float32:
        raise ValueError(f"expected (M, 3) f32 rows, got {tuple(rows.shape)} {rows.dtype}")
    M = rows.shape[0]
    if height <= 0 or width <= 0 or M * height * width >= 2**31 - 1024:
        raise ValueError(f"maps of ({M}, {height}, {width}): need 0 < H, W and M*H*W < 2**31 - 1024")
    rows = rows.contiguous()
    out = torch.empty((M, height, width), dtype=torch.float32, device=rows.device)
    if M == 0:
        return out
    dev = rows.get_device()
    with device_context(dev):
        stream = current_stream(dev)
        err = _kernel()(rows.data_ptr(), out.data_ptr(), M, height, width, stream)
    if err != 0:
        raise RuntimeError(f"render_heatmaps_f32 launch failed with CUDA error {err}")
    launches += 1
    return out


def _inv_two_sigma_sq(sigma, lead: list, device) -> torch.Tensor:
    """1/(2 sigma^2) in f32 for every map, (M, 1). A non-scalar sigma is per
    map: it broadcasts against the lead dims, never against W. A Python
    sigma is folded on the host (numpy f32), so no copy reaches the device."""
    M = int(np.prod(lead, dtype=np.int64))
    if isinstance(sigma, torch.Tensor):
        s = sigma.to(device=device, dtype=torch.float32)
        return (1.0 / (2.0 * (s * s))).broadcast_to(lead).reshape(M, 1)
    s = np.float32(sigma)
    inv = np.float32(1.0) / (np.float32(2.0) * (s * s))
    return torch.full((M, 1), float(inv), dtype=torch.float32, device=device)


def fused_render_heatmaps(keypoints: torch.Tensor, height: int, width: int,
                          sigma: float | torch.Tensor = 5.0) -> torch.Tensor:
    """Keypoints (..., 2) in heatmap pixels -> heatmaps (..., H, W) f32, as
    the JAX `render_heatmaps_pallas`. sigma is a scalar or per map. A CUDA
    tensor goes through the kernel, a CPU tensor through
    `render_heatmaps_reference`."""
    *lead, _ = keypoints.shape
    kp = keypoints.reshape(-1, 2).float()
    rows = torch.cat([kp, _inv_two_sigma_sq(sigma, lead, kp.device)], dim=1)
    if kp.device.type == "cpu":
        out = render_heatmaps_reference(rows, height, width)
    else:
        out = render_heatmaps_cuda(rows, height, width)
    return out.reshape(*lead, height, width)
