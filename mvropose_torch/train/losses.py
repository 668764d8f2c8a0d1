"""Training losses: port of `mvropose_tpu/train/losses.py` (heatmap MSE,
the masked multi-view heatmap MSE, SmoothL1). Every loss is taken in f32."""

from __future__ import annotations

import torch


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
