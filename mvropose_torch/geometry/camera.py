"""Pinhole camera with OpenCV-style lens distortion.

Port of the parts of `mvropose_tpu/geometry/camera.py` that the training
slice runs: `distort_normalized` and `project_points` (cv2.projectPoints).
Distortion coefficients are (k1, k2, p1, p2, k3).
"""

from __future__ import annotations

import torch

from mvropose_torch.geometry.rotations import rodrigues_to_matrix


def distort_normalized(xy: torch.Tensor, dist) -> torch.Tensor:
    """Radial + tangential distortion of normalized coordinates (..., 2)."""
    k1, k2, p1, p2, k3 = torch.as_tensor(dist, dtype=xy.dtype, device=xy.device).unbind(-1)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def project_points(points_3d: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor,
                   K: torch.Tensor, dist=None) -> torch.Tensor:
    """World points (..., N, 3) -> pixels (..., N, 2), as cv2.projectPoints.

    One camera is rvec (3,), tvec (3,), K (3, 3); leading dimensions on them
    give one camera per batch entry and broadcast against the points'."""
    R = rodrigues_to_matrix(rvec)  # (..., 3, 3)
    cam = points_3d @ R.transpose(-1, -2) + tvec[..., None, :]
    xy = cam[..., :2] / (cam[..., 2:3] + 1e-12)
    if dist is not None:
        xy = distort_normalized(xy, dist)
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], -1)
