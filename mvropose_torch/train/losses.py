"""Training losses: port of `mvropose_tpu/train/losses.py` (heatmap MSE,
the masked multi-view heatmap MSE, SmoothL1, the FK-consistency term).
Every loss is taken in f32."""

from __future__ import annotations

import torch

from mvropose_torch.geometry.camera import project_points
from mvropose_torch.geometry.robots import RobotSpec, forward_kinematics


def heatmap_mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain MSE over all elements (single-view path)."""
    return ((pred.float() - target.float()) ** 2).mean()


def masked_multiview_heatmap_loss(pred: torch.Tensor, target: torch.Tensor,
                                  view_mask: torch.Tensor) -> torch.Tensor:
    """(B, V, J, H, W) heatmaps: the per-view MSE averaged over real views only."""
    per_view = ((pred.float() - target.float()) ** 2).mean(dim=(2, 3, 4))  # (B, V)
    w = view_mask.float()
    return (per_view * w).sum() / (w.sum() + 1e-8)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Huber / SmoothL1 with threshold beta (torch nn.SmoothL1Loss parity)."""
    d = (pred.float() - target.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def fk_reprojection_mse(spec: RobotSpec, pred_angles: torch.Tensor,
                        gt_keypoints_2d: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor,
                        K: torch.Tensor, base_rotation: torch.Tensor | None = None) -> torch.Tensor:
    """Per sample, || project(FK(pred_angles)) - gt_2d ||^2 averaged over
    points and coordinates, through the differentiable FK and projection:
    angles (B, A) in the robot's unit, keypoints (B, J, 2) pixels, one camera
    (rvec (3,), tvec (3,), K (3, 3)) or one per sample ((B, 3), (B, 3),
    (B, 3, 3)), base_rotation (3, 3) or (B, 3, 3) -> (B,). The points are the
    full FK chain, as the reference projects them."""
    pts3d = forward_kinematics(spec, pred_angles, base_rotation)  # (B, rows+1, 3)
    return ((project_points(pts3d, rvec, tvec, K) - gt_keypoints_2d) ** 2).mean(dim=(-2, -1))


def fk_consistency_loss(spec: RobotSpec, pred_angles: torch.Tensor, gt_keypoints_2d: torch.Tensor,
                        rvec: torch.Tensor, tvec: torch.Tensor, K: torch.Tensor,
                        base_rotation: torch.Tensor | None = None) -> torch.Tensor:
    """The FK-consistency loss: `fk_reprojection_mse`'s mean over samples."""
    return fk_reprojection_mse(spec, pred_angles, gt_keypoints_2d, rvec, tvec, K,
                               base_rotation).mean()
