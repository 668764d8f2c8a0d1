"""Synthetic multi-view rig: FK-rendered training data with exact ground truth.

Port of `mvropose_tpu/data/synthetic.py` for `render="blob"`: joint angles
-> forward kinematics -> projection into a ring of pinhole cameras -> images
(one colored gaussian blob per keypoint, plus noise, through tanh) and GT
heatmaps. Both renders go through `ops.heatmap_render.fused_render_heatmaps`,
the CUDA kernel on the card.

The random draws (`draw_multiview`: angles and image noise from a
`torch.Generator`) are split from the deterministic render of given draws
(`render_multiview_batch`), so a test can feed the render the reference's
`jax.random` draws. Everything stays on the generator's device; a batch
makes no host-device copy. A batch carries the rig's projection matrices in
heatmap pixels (`proj_mats`, the geometric3d head's input), and
`single_view_batch` slices one view out of it. Not ported yet:
`render="link"` (segment images and the tool marker; ROADMAP.md queue 1,
item 11).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from mvropose_torch.geometry.camera import project_points
from mvropose_torch.geometry.heatmap import scale_keypoints
from mvropose_torch.geometry.robots import RobotSpec, forward_kinematics
from mvropose_torch.geometry.rotations import matrix_to_rodrigues
from mvropose_torch.geometry.triangulation import heatmap_projection_matrices
from mvropose_torch.ops.heatmap_render import fused_render_heatmaps


@dataclasses.dataclass(frozen=True)
class SyntheticRig:
    """A ring of V pinhole cameras looking at the robot workspace center."""

    K: np.ndarray  # (3, 3) shared intrinsics
    rvecs: np.ndarray  # (V, 3) world->cam Rodrigues
    tvecs: np.ndarray  # (V, 3)
    image_hw: Tuple[int, int]

    @property
    def n_views(self) -> int:
        return self.rvecs.shape[0]


def _look_at(camera_center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->camera rotation, OpenCV convention (+z forward, +y down), for a
    camera at `camera_center` aimed at `target`; world up is +z."""
    fwd = target - camera_center
    fwd = fwd / np.linalg.norm(fwd)
    up_hint = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, up_hint)) > 0.99:  # looking straight down/up
        up_hint = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up_hint)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=0)


def make_rig(
    n_views: int = 3,
    image_hw: Tuple[int, int] = (128, 128),
    distance_m: float = 1.6,
    elevation_m: float = 0.9,
    target: Tuple[float, float, float] = (0.0, 0.0, 0.35),
    focal_scale: float = 0.55,
) -> SyntheticRig:
    """Cameras evenly spaced on a ring, all aimed at the workspace center;
    the focal length is `focal_scale` times the image width."""
    h, w = image_hw
    f = focal_scale * w
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], dtype=np.float32)
    tgt = np.asarray(target, dtype=np.float64)
    rvecs, tvecs = [], []
    for v in range(n_views):
        az = 2.0 * np.pi * v / max(n_views, 1)
        center = tgt + np.array(
            [distance_m * np.cos(az), distance_m * np.sin(az), elevation_m - tgt[2]]
        )
        R = _look_at(center, tgt)
        rvecs.append(matrix_to_rodrigues(torch.tensor(R, dtype=torch.float32)).numpy())
        tvecs.append((-R @ center).astype(np.float32))
    return SyntheticRig(K=K, rvecs=np.stack(rvecs).astype(np.float32),
                        tvecs=np.stack(tvecs).astype(np.float32), image_hw=image_hw)


def joint_palette(n_joints: int) -> np.ndarray:
    """(J, 3) visually distinct colors in [-1, 1] (hue wheel, full saturation)."""
    hues = np.linspace(0.0, 1.0, n_joints, endpoint=False)
    c = []
    for hue in hues:
        k = (np.array([0, 2, 4]) + hue * 6.0) % 6.0
        c.append(1.0 - np.maximum(np.minimum(np.minimum(k, 4.0 - k), 1.0), 0.0))
    return (np.stack(c) * 2.0 - 1.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _palette(n_joints: int, device: torch.device) -> torch.Tensor:
    """`joint_palette` on `device`, copied there once."""
    with torch.inference_mode(False):
        return torch.from_numpy(joint_palette(n_joints)).to(device)


def rig_tuple(rig: SyntheticRig, device="cpu"):
    """(K (3, 3), rvecs (V, 3), tvecs (V, 3)) as f32 tensors on `device`."""
    return tuple(torch.from_numpy(a).to(device) for a in (rig.K, rig.rvecs, rig.tvecs))


def render_blob_images(kp2d: torch.Tensor, image_hw: Tuple[int, int], palette: torch.Tensor,
                       blob_sigma_px: float = 3.0,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """Keypoints (..., J, 2) in image px -> images (..., H, W, 3) in ~[-1, 1]:
    a gaussian blob of each joint's palette color, summed, plus noise,
    through tanh."""
    h, w = image_hw
    blobs = fused_render_heatmaps(kp2d, h, w, sigma=blob_sigma_px)  # (..., J, H, W)
    img = torch.einsum("...jhw,jc->...hwc", blobs, palette.float())
    if noise is not None:
        img = img + noise
    return torch.tanh(img)


def draw_multiview(robot: RobotSpec, n_views: int, batch_size: int,
                   image_hw: Tuple[int, int], generator: torch.Generator,
                   angle_scale: float = 0.6, noise_std: float = 0.05):
    """The random draws of one batch, on the generator's device: joint angles
    (B, A) uniform in +-angle_scale * (90 deg or pi/2) in the robot's native
    unit, and image noise (B, V, H, W, 3) normal with std `noise_std`."""
    device = generator.device
    half_range = 90.0 if robot.angle_unit == "deg" else math.pi / 2.0
    lo, hi = -angle_scale * half_range, angle_scale * half_range
    u = torch.rand((batch_size, robot.n_joints), generator=generator, device=device)
    angles = lo + (hi - lo) * u
    noise = noise_std * torch.randn((batch_size, n_views, *image_hw, 3), generator=generator,
                                    device=device)
    return angles, noise


def render_multiview_batch(robot: RobotSpec, rig_arrays, angles: torch.Tensor,
                           noise: torch.Tensor, image_hw: Tuple[int, int] = (128, 128),
                           heatmap_hw: Tuple[int, int] = (64, 64),
                           heatmap_sigma: float = 2.0) -> dict:
    """The batch of given draws: images (B, V, H, W, 3), heatmaps
    (B, V, J, Hm, Wm), angles (B, A), keypoints_2d (B, V, J, 2) in image px,
    keypoints_3d (B, J, 3), view_ids (B, V), view_mask (B, V) and the rig's
    heatmap-pixel projection matrices proj_mats (B, V, 3, 4)."""
    K, rvecs, tvecs = rig_arrays
    B, V = angles.shape[0], rvecs.shape[0]
    kp3d = robot.keypoints_from_fk(forward_kinematics(robot, angles))  # (B, J, 3)
    kp2d = project_points(kp3d[:, None], rvecs, tvecs, K)  # (B, V, J, 2)
    images = render_blob_images(kp2d, image_hw, _palette(kp3d.shape[-2], kp2d.device),
                                noise=noise)
    heatmaps = fused_render_heatmaps(scale_keypoints(kp2d, image_hw, heatmap_hw), *heatmap_hw,
                                     sigma=heatmap_sigma)
    return {
        "images": images,
        "heatmaps": heatmaps,
        "angles": angles,
        "keypoints_2d": kp2d,
        "keypoints_3d": kp3d,
        "view_ids": torch.arange(V, device=angles.device).expand(B, V),
        "view_mask": torch.ones((B, V), dtype=torch.bool, device=angles.device),
        "proj_mats": heatmap_projection_matrices(rvecs, tvecs, K, image_hw,
                                                 heatmap_hw).expand(B, V, 3, 4),
    }


def single_view_batch(mv_batch: dict, view: int = 0) -> dict:
    """One view of a multi-view batch as a single-view batch: images
    (B, H, W, 3), heatmaps (B, J, Hm, Wm), angles, keypoints_2d (B, J, 2),
    keypoints_3d."""
    return {
        "images": mv_batch["images"][:, view],
        "heatmaps": mv_batch["heatmaps"][:, view],
        "angles": mv_batch["angles"],
        "keypoints_2d": mv_batch["keypoints_2d"][:, view],
        "keypoints_3d": mv_batch["keypoints_3d"],
    }


def synthesize_multiview_batch(robot: RobotSpec, rig_arrays, generator: torch.Generator,
                               batch_size: int, image_hw: Tuple[int, int] = (128, 128),
                               heatmap_hw: Tuple[int, int] = (64, 64), angle_scale: float = 0.6,
                               heatmap_sigma: float = 2.0, noise_std: float = 0.05,
                               render: str = "blob") -> dict:
    """One multi-view batch with exact GT, drawn from `generator` and made on
    its device (`render_multiview_batch` of `draw_multiview`)."""
    if render != "blob":
        raise NotImplementedError(
            f"render={render!r} is not ported yet (ROADMAP.md queue 1, item 11); only 'blob' runs")
    angles, noise = draw_multiview(robot, rig_arrays[1].shape[0], batch_size, image_hw,
                                   generator, angle_scale, noise_std)
    return render_multiview_batch(robot, rig_arrays, angles, noise, image_hw, heatmap_hw,
                                  heatmap_sigma)
