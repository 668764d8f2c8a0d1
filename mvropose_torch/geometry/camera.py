"""Pinhole camera with OpenCV-style lens distortion.

Port of the parts of `mvropose_tpu/geometry/camera.py` that the training,
pose and serve slices run: `distort_normalized`, `project_points`
(cv2.projectPoints), `project_camera_frame`, `undistort_points`
(cv2.undistortPoints), `undistort_map` and the dataset path's
`remap_bilinear`; and the serve's remap of uint8 frames on the device
(`RemapTaps`), which computes what the reference's serve runs on the host,
`cv2.remap(..., INTER_LINEAR)` with its default constant 0 border, not what
`remap_bilinear` computes.
Distortion coefficients are (k1, k2, p1, p2, k3).
"""

from __future__ import annotations

import dataclasses

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


def undistort_map(K: torch.Tensor, dist, height: int, width: int) -> torch.Tensor:
    """The (2, H, W) remap grid of cv2.undistort for one camera, on K's
    device: out[y, x] = in[map[0, y, x], map[1, y, x]] (row, column source
    coordinates), the forward distortion of each undistorted destination
    pixel, in f32."""
    ys = torch.arange(height, dtype=torch.float32, device=K.device)
    xs = torch.arange(width, dtype=torch.float32, device=K.device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xyd = distort_normalized(torch.stack([(grid_x - cx) / fx, (grid_y - cy) / fy], -1), dist)
    return torch.stack([fy * xyd[..., 1] + cy, fx * xyd[..., 0] + cx], 0)


def remap_bilinear(images: torch.Tensor, remaps: torch.Tensor) -> torch.Tensor:
    """The dataset path's device undistortion, `mvropose_tpu/geometry/camera.py:120`
    `remap_bilinear` over a batch: images (N, H, W, C) sampled at remaps
    (N, 2, H', W') (row, column source coordinates), bilinear on the four
    taps clamped into the frame, 0 wherever the coordinate leaves
    [0, H - 1] x [0, W - 1], cast back to the images' dtype (a truncation
    for integers). Not the serve's `RemapTaps`, which rounds and weighs
    outside taps 0 as cv2 does."""
    N, H, W, C = images.shape
    sy, sx = remaps[:, 0], remaps[:, 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0i = y0.to(torch.int64).clamp(0, H - 1)
    x0i = x0.to(torch.int64).clamp(0, W - 1)
    y1i, x1i = (y0i + 1).clamp(0, H - 1), (x0i + 1).clamp(0, W - 1)
    flat = images.reshape(N * H * W, C)
    base = torch.arange(N, device=images.device)[:, None, None] * (H * W)

    def tap(yi, xi):
        return flat.index_select(0, (base + yi * W + xi).flatten()).reshape(*yi.shape, C)

    out = (tap(y0i, x0i) * (1 - wy) * (1 - wx) + tap(y0i, x1i) * (1 - wy) * wx
           + tap(y1i, x0i) * wy * (1 - wx) + tap(y1i, x1i) * wy * wx)
    valid = ((sy >= 0) & (sy <= H - 1) & (sx >= 0) & (sx <= W - 1))[..., None]
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device)).to(
        images.dtype)


@dataclasses.dataclass
class RemapTaps:
    """Bilinear remap of (V, H, W, C) uint8 frames by per-view grids, made
    once per rig: the four taps' flat indices into the V frames, (4, V*H*W),
    and their f32 weights, (4, V*H*W, 1), a tap outside its frame weighing 0.

    Each output value is w00 v00 + w01 v01 + w10 v10 + w11 v11 in f32, the
    weights (1 - fy)(1 - fx), (1 - fy) fx, fy (1 - fx) and fy fx of the
    source coordinate's fractions, rounded to the nearest level. That is
    cv2.remap with INTER_LINEAR and BORDER_CONSTANT 0 on float maps (at most
    one level apart, on a few values in a million), the reference serve's
    undistortion."""

    index: torch.Tensor
    weight: torch.Tensor

    @classmethod
    def from_maps(cls, maps: torch.Tensor) -> "RemapTaps":
        """maps (V, 2, H, W): per view the (row, column) source coordinate of
        each destination pixel, in that view's own frame of the same size."""
        V, _, H, W = maps.shape
        sy, sx = maps[:, 0].float(), maps[:, 1].float()
        y0, x0 = torch.floor(sy), torch.floor(sx)
        fy, fx = sy - y0, sx - x0
        y0, x0 = y0.long(), x0.long()
        base = torch.arange(V, device=maps.device)[:, None, None] * (H * W)
        index, weight = [], []
        for dy, dx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                          (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            y, x = y0 + dy, x0 + dx
            inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
            index.append((base + y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).flatten())
            weight.append(torch.where(inside, w, torch.zeros_like(w)).flatten())
        return cls(torch.stack(index), torch.stack(weight)[..., None])

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        """(V, H, W, C) uint8 -> the remapped (V, H, W, C) uint8: one gather
        of the four taps, no host synchronization."""
        taps = frames.reshape(-1, frames.shape[-1]).index_select(0, self.index.flatten())
        v = taps.reshape(4, -1, frames.shape[-1]).float()
        w = self.weight
        out = v[0] * w[0] + v[1] * w[1] + v[2] * w[2] + v[3] * w[3]
        return out.round().clamp(0, 255).to(torch.uint8).reshape(frames.shape)
