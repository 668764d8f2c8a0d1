"""Training and QA panels: a copy of `mvropose_tpu/utils/viz.py` on the
port's decode (numpy in, numpy out, composed with cv2), held to the original
by `tests/test_torch_capture_data.py`: GT-vs-prediction heatmap overlays and
keypoint scatter panels, ready for `MetricWriter.write_image`.
"""

from __future__ import annotations

import numpy as np
import torch

from mvropose_torch.data import IMAGENET_MEAN, IMAGENET_STD
from mvropose_torch.geometry.heatmap import argmax_decode, scale_keypoints


def denormalize(img: np.ndarray) -> np.ndarray:
    """Normalized model input (H, W, 3) -> uint8 RGB."""
    x = np.asarray(img, np.float32) * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def heatmap_overlay(image_u8: np.ndarray, heatmaps: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """Composite sum-of-heatmaps (J, Hm, Wm) over an RGB image."""
    import cv2

    h, w = image_u8.shape[:2]
    comp = np.asarray(heatmaps, np.float32).sum(axis=0)
    comp = comp - comp.min()
    comp = comp / (comp.max() + 1e-8)
    comp = cv2.resize(comp, (w, h))
    colored = cv2.applyColorMap((comp * 255).astype(np.uint8), cv2.COLORMAP_JET)[:, :, ::-1]
    return cv2.addWeighted(image_u8, 1 - alpha, colored, alpha, 0)


def keypoint_panel(
    image_u8: np.ndarray,
    gt_xy: np.ndarray | None,
    pred_xy: np.ndarray | None,
    hm_hw: tuple[int, int] | None = None,
) -> np.ndarray:
    """Scatter GT (green) and predicted (red) keypoints; coordinates in
    heatmap pixels are rescaled when hm_hw is given."""
    import cv2

    out = image_u8.copy()
    h, w = out.shape[:2]

    def scale(xy):
        if hm_hw is None:
            return np.asarray(xy, np.float64)
        # In f32, as the reference's jnp computes it.
        xy = torch.from_numpy(np.array(xy, np.float32))
        return scale_keypoints(xy, hm_hw, (h, w)).numpy()

    if gt_xy is not None:
        for x, y in scale(gt_xy):
            if np.isfinite(x) and np.isfinite(y):  # skip unlabeled joints
                cv2.circle(out, (int(x), int(y)), 4, (0, 255, 0), -1)
    if pred_xy is not None:
        for x, y in scale(pred_xy):
            if np.isfinite(x) and np.isfinite(y):
                cv2.drawMarker(out, (int(x), int(y)), (255, 0, 0), cv2.MARKER_CROSS, 9, 2)
    return out


def prediction_panel(
    image_norm: np.ndarray,  # (H, W, 3) normalized model input
    gt_heatmaps: np.ndarray,  # (J, Hm, Wm)
    pred_heatmaps: np.ndarray,  # (J, Hm, Wm)
) -> np.ndarray:
    """Side-by-side [image | GT overlay | pred overlay | keypoints] panel."""
    img = denormalize(image_norm)
    gt_ov = heatmap_overlay(img, gt_heatmaps)
    pred_ov = heatmap_overlay(img, pred_heatmaps)
    gt_xy, _ = argmax_decode(torch.as_tensor(np.asarray(gt_heatmaps)), apply_sigmoid=False)
    pred_xy, _ = argmax_decode(torch.as_tensor(np.asarray(pred_heatmaps)), apply_sigmoid=False)
    kp = keypoint_panel(img, gt_xy.numpy(), pred_xy.numpy(), gt_heatmaps.shape[-2:])
    return np.hstack([img, gt_ov, pred_ov, kp])


def multi_view_panel(
    images_norm: np.ndarray,  # (V, H, W, 3)
    gt_heatmaps: np.ndarray,  # (V, J, Hm, Wm)
    pred_heatmaps: np.ndarray,
    view_mask: np.ndarray,  # (V,)
) -> np.ndarray:
    """One prediction panel row per real view, stacked vertically."""
    rows = [
        prediction_panel(images_norm[v], gt_heatmaps[v], pred_heatmaps[v])
        for v in range(len(view_mask))
        if view_mask[v]
    ]
    return np.vstack(rows) if rows else np.zeros((1, 1, 3), np.uint8)
