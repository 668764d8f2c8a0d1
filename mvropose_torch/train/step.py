"""The multi-view train step and the eval step.

Port of `mvropose_tpu/train/step.py::make_multi_view_train_step` and
`make_eval_step` (multi-view). One combined backward per step: the masked
multi-view heatmap MSE times `loss_weight_kpt`, plus the per-group Huber of
the angles (a mean over angles, then a weighted mean over the groups with any
real view). The train step puts the model in train mode (batch statistics
and their running-average update in every BatchNorm, dropout in the decoder
layers, masks from `generator`) and returns its losses as device scalars: it
never waits for the device. The single-view steps wait for
`SingleViewPoseEstimator` (ROADMAP.md queue 1, item 4).
"""

from __future__ import annotations

from typing import Callable

import torch

from mvropose_torch.train.losses import masked_multiview_heatmap_loss
from mvropose_torch.train.state import TrainConfig, TrainState


def _weighted_mean(per_sample: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    """Mean over samples, weighted by validity (padded slots weigh 0)."""
    if w is None:
        return per_sample.mean()
    wf = w.float()
    return (per_sample * wf).sum() / (wf.sum() + 1e-8)


def _huber_per_sample(pred: torch.Tensor, gt: torch.Tensor, beta: float,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample Huber over the angle axis; `mask` drops padded angle slots."""
    d = (pred - gt).abs()
    hub = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    if mask is None:
        return hub.mean(dim=-1)
    m = mask.to(hub.dtype)
    return (hub * m).sum(dim=-1) / (m.sum(dim=-1) + 1e-8)


def _losses(cfg: TrainConfig, pred_hm, pred_ang, batch, angle_mask=None):
    loss_kpt = masked_multiview_heatmap_loss(pred_hm, batch["heatmaps"], batch["view_mask"])
    groups = batch["view_mask"].any(dim=1)  # padded or all-failed groups weigh 0
    loss_ang = _weighted_mean(_huber_per_sample(pred_ang, batch["angles"], cfg.angle_beta,
                                                angle_mask), groups)
    return loss_kpt * cfg.loss_weight_kpt + loss_ang, loss_kpt, loss_ang


def make_multi_view_train_step(cfg: TrainConfig) -> Callable:
    """train_step(state, batch, generator) -> {"loss", "loss_kpt", "loss_ang"}.

    batch: images (B, V, H, W, 3), view_ids (B, V), view_mask (B, V),
    heatmaps (B, V, J, Hm, Wm), angles (B, A). Updates `state` in place."""

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None) -> dict:
        model = state.model.train()
        pred_hm, pred_ang = model(batch["images"], batch["view_ids"], batch["view_mask"],
                                  generator=generator)
        total, loss_kpt, loss_ang = _losses(cfg, pred_hm, pred_ang, batch)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.apply_gradients()
        return {"loss": total.detach(), "loss_kpt": loss_kpt.detach(),
                "loss_ang": loss_ang.detach()}

    return train_step


def make_eval_step(cfg: TrainConfig) -> Callable:
    """eval_step(state, batch) -> losses (masked as in training, and by a
    batch's "angle_mask" as the reference's eval step) and the predictions,
    in eval mode (running statistics, no dropout), no grad."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        model = state.model.eval()
        pred_hm, pred_ang = model(batch["images"], batch["view_ids"], batch["view_mask"])
        total, loss_kpt, loss_ang = _losses(cfg, pred_hm, pred_ang, batch,
                                            batch.get("angle_mask"))
        return {"loss": total, "loss_kpt": loss_kpt, "loss_ang": loss_ang,
                "pred_heatmaps": pred_hm, "pred_angles": pred_ang}

    return eval_step
