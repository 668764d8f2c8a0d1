"""Pinhole camera with OpenCV-style lens distortion.

Port of the parts of `mvropose_tpu/geometry/camera.py` that the training and
pose slices run: `distort_normalized`, `project_points` (cv2.projectPoints),
`project_camera_frame` and `undistort_points` (cv2.undistortPoints). The
undistortion maps of serve (`undistort_map`, `remap_bilinear`) are ROADMAP.md
queue 1, item 7. Distortion coefficients are (k1, k2, p1, p2, k3).
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
    return project_camera_frame(cam, K, dist)


def _to_pixels(xy: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], -1)


def project_camera_frame(points_cam: torch.Tensor, K: torch.Tensor, dist=None) -> torch.Tensor:
    """Camera-frame points (..., N, 3) -> pixels (..., N, 2), no extrinsic."""
    xy = points_cam[..., :2] / (points_cam[..., 2:3] + 1e-12)
    if dist is not None:
        xy = distort_normalized(xy, dist)
    return _to_pixels(xy, K)


def undistort_points(pixels: torch.Tensor, K: torch.Tensor, dist, iters: int = 8) -> torch.Tensor:
    """Distorted pixels (..., N, 2) -> ideal pixels (..., N, 2): the fixed-point
    inversion of the distortion model that cv2.undistortPoints uses, for a
    fixed number of iterations."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    target = torch.stack([(pixels[..., 0] - cx) / fx, (pixels[..., 1] - cy) / fy], -1)
    xy = target
    for _ in range(iters):
        xy = target - (distort_normalized(xy, dist) - xy)
    return _to_pixels(xy, K)
