"""Heatmap -> keypoint decoding: the single entry the serve path uses.

Port of `mvropose_tpu/decode/__init__.py::decode_keypoints`. The backend is
chosen by the tensor, not by a flag: CUDA heatmaps go through the peak-decode
kernel, CPU heatmaps through its plain-torch version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mvropose_torch.geometry.heatmap import peak_refine_decode, scale_keypoints
from mvropose_torch.ops.peak_decode import fused_peak_decode


def decode_keypoints(
    heatmaps: torch.Tensor,
    image_hw: Tuple[int, int] | None = None,
    mode: str = "argmax",
    temperature: float = 1.0,
):
    """Decode heatmaps (..., J, H, W) -> (keypoints_xy (..., J, 2), conf (..., J)).

    mode: "argmax" (first-index hard peak), "soft" (full-map soft-argmax) or
    "refine" (argmax + peak-local softmax centroid). image_hw rescales the
    coordinates from heatmap pixels to image pixels.
    """
    if mode == "refine":
        xy, conf = peak_refine_decode(heatmaps, temperature=temperature)
    elif mode in ("argmax", "soft"):
        out = fused_peak_decode(heatmaps, temperature=temperature)
        xy = out["argmax_xy"] if mode == "argmax" else out["soft_xy"]
        conf = out["confidence"]
    else:
        raise ValueError(f"unknown decode mode {mode!r}")
    if image_hw is not None:
        xy = scale_keypoints(xy, tuple(heatmaps.shape[-2:]), image_hw)
    return xy, conf


__all__ = ["decode_keypoints"]
