"""Gaussian keypoint heatmap rendering and decoding in plain torch.

Port of `mvropose_tpu/geometry/heatmap.py`. `argmax_decode` is the exact
(first-index) hard peak, `soft_argmax_decode` the full-map subpixel
expectation, `peak_refine_decode` the argmax plus a peak-local softmax
centroid. The CUDA peak-decode kernel (`ops/peak_decode.py`) is tested
against these.
"""

from __future__ import annotations

import torch

_F64_EPS = 2.220446049250313e-16  # np.finfo(float).eps, as the reference uses


def render_heatmaps(
    keypoints: torch.Tensor, height: int, width: int, sigma: float | torch.Tensor = 5.0
) -> torch.Tensor:
    """Keypoints (..., J, 2) in heatmap pixel coords -> heatmaps (..., J, H, W)."""
    kp = torch.as_tensor(keypoints, dtype=torch.float32)
    xs = torch.arange(width, dtype=torch.float32, device=kp.device)
    ys = torch.arange(height, dtype=torch.float32, device=kp.device)
    dx = (xs.reshape(1, -1) - kp[..., 0, None, None]) ** 2  # (..., J, 1, W)
    dy = (ys.reshape(-1, 1) - kp[..., 1, None, None]) ** 2  # (..., J, H, 1)
    # A non-scalar sigma is per map: it broadcasts against the lead dims,
    # never against the trailing W axis.
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=kp.device)
    if sig.dim():
        sig = sig[..., None, None]
    hm = torch.exp(-(dx + dy) / (2.0 * sig**2))
    peak = hm.amax(dim=(-2, -1), keepdim=True)
    return torch.where(hm < _F64_EPS * peak, torch.zeros_like(hm), hm)


def _grids(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    pos = torch.arange(h * w, device=device)
    return (pos % w).float(), (pos // w).float()


def argmax_decode(heatmaps: torch.Tensor, apply_sigmoid: bool = True):
    """Hard-argmax decode: (..., J, H, W) -> ((..., J, 2) xy, (..., J) score)."""
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.reshape(*heatmaps.shape[:-2], h * w)
    idx = flat.argmax(dim=-1)
    peak = flat.gather(-1, idx[..., None])[..., 0]
    if apply_sigmoid:
        peak = torch.sigmoid(peak)
    return torch.stack([(idx % w).float(), (idx // w).float()], dim=-1), peak


def soft_argmax_decode(
    heatmaps: torch.Tensor, temperature: float = 1.0, apply_sigmoid: bool = True
):
    """Sub-pixel decode by spatial softmax expectation.

    Returns ((..., J, 2) xy, (..., J) confidence = sigmoid(max))."""
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.reshape(*heatmaps.shape[:-2], h * w)
    probs = torch.softmax(flat * temperature, dim=-1)
    gx, gy = _grids(h, w, flat.device)
    xy = torch.stack([(probs * gx).sum(-1), (probs * gy).sum(-1)], dim=-1)
    peak = flat.amax(dim=-1)
    if apply_sigmoid:
        peak = torch.sigmoid(peak)
    return xy, peak


def peak_refine_decode(
    heatmaps: torch.Tensor,
    window: int = 2,
    temperature: float = 1.0,
    apply_sigmoid: bool = True,
):
    """Hard argmax + softmax centroid over the (2*window+1)^2 neighbourhood
    of the argmax (full-map soft-argmax is pulled toward the centre by the
    background's softmax mass; the window removes that pull)."""
    xy0, conf = argmax_decode(heatmaps, apply_sigmoid)
    h, w = heatmaps.shape[-2:]
    xs = torch.arange(w, dtype=torch.float32, device=heatmaps.device)
    ys = torch.arange(h, dtype=torch.float32, device=heatmaps.device)
    in_x = (xs.reshape(1, -1) - xy0[..., 0, None, None]).abs() <= window
    in_y = (ys.reshape(-1, 1) - xy0[..., 1, None, None]).abs() <= window
    logits = torch.where(in_x & in_y, heatmaps * temperature, float("-inf"))
    probs = torch.softmax(logits.reshape(*logits.shape[:-2], h * w), dim=-1)
    gx, gy = _grids(h, w, heatmaps.device)
    return torch.stack([(probs * gx).sum(-1), (probs * gy).sum(-1)], dim=-1), conf


def scale_keypoints(
    keypoints: torch.Tensor, from_hw: tuple[int, int], to_hw: tuple[int, int]
) -> torch.Tensor:
    """Rescale xy keypoints between resolutions (e.g. heatmap -> image).
    The factors stay Python floats: no host-to-device copy in a step."""
    return torch.stack(
        [keypoints[..., 0] * (to_hw[1] / from_hw[1]), keypoints[..., 1] * (to_hw[0] / from_hw[0])],
        dim=-1,
    )
