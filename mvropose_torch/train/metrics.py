"""Evaluation metrics: port of `mvropose_tpu/train/metrics.py` (PCK@k px,
ADD, the pass-rate AUC, angle MAE, the recovered camera pose's rotation and
translation errors)."""

from __future__ import annotations

import torch

from mvropose_torch.geometry.rotations import rodrigues_to_matrix


def pck_at_k(pred_xy: torch.Tensor, gt_xy: torch.Tensor, k_px: float = 5.0,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Share of keypoints (..., J, 2) within k pixels of the truth, in [0, 1]."""
    correct = (torch.linalg.norm(pred_xy - gt_xy, dim=-1) <= k_px).float()
    if valid is None:
        return correct.mean()
    w = valid.float().broadcast_to(correct.shape)
    return (correct * w).sum() / (w.sum() + 1e-8)


def add_metric(pred_pts3d: torch.Tensor, gt_pts3d: torch.Tensor,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """ADD: mean 3D distance between corresponding points (..., J, 3), meters."""
    d = torch.linalg.norm(pred_pts3d - gt_pts3d, dim=-1)
    if valid is None:
        return d.mean()
    w = valid.float().broadcast_to(d.shape)
    return (d * w).sum() / (w.sum() + 1e-8)


def pass_rate_auc(dists: torch.Tensor, max_threshold_m: float = 0.10, n_steps: int = 50,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Area under the pass-rate curve over [0, max_threshold] (DREAM's
    headline), normalized to [0, 1]; a failed frame is passed as inf."""
    per_sample = dists.float().reshape(-1)
    ths = torch.linspace(0.0, max_threshold_m, n_steps, device=per_sample.device)
    passed = (per_sample[None, :] <= ths[:, None]).float()
    if valid is None:
        pass_rate = passed.mean(dim=1)
    else:
        w = valid.float().reshape(-1)
        pass_rate = (passed * w[None, :]).sum(dim=1) / (w.sum() + 1e-8)
    return torch.trapezoid(pass_rate, ths) / max_threshold_m


def add_auc(pred_pts3d: torch.Tensor, gt_pts3d: torch.Tensor, max_threshold_m: float = 0.10,
            n_steps: int = 50, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Area under the pass-rate curve of the per-sample mean ADD."""
    per_sample = torch.linalg.norm(pred_pts3d - gt_pts3d, dim=-1).mean(dim=-1)
    return pass_rate_auc(per_sample, max_threshold_m, n_steps, valid=valid)


def angle_mae(pred_angles: torch.Tensor, gt_angles: torch.Tensor,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean absolute angle error, per sample over the angles, then over samples."""
    err = (pred_angles - gt_angles).abs().mean(dim=-1)
    if valid is None:
        return err.mean()
    w = valid.float().broadcast_to(err.shape)
    return (err * w).sum() / (w.sum() + 1e-8)


def pose_rotation_err_deg(rvec_pred: torch.Tensor, rvec_gt: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (degrees) between recovered and true camera rotations,
    Rodrigues vectors (..., 3) that broadcast: the angle of R_pred^T R_gt by
    the trace identity, clamped."""
    Rp, Rg = rodrigues_to_matrix(rvec_pred), rodrigues_to_matrix(rvec_gt)
    cos = torch.clamp(((Rp * Rg).sum((-2, -1)) - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def pose_translation_err_m(tvec_pred: torch.Tensor, tvec_gt: torch.Tensor) -> torch.Tensor:
    """Euclidean camera-translation error (meters), broadcasting (..., 3)."""
    return torch.linalg.norm(tvec_pred - tvec_gt, dim=-1)
