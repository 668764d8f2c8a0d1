"""The single- and multi-view train steps and the eval step.

Port of `mvropose_tpu/train/step.py`: `make_single_view_train_step`,
`make_multi_view_train_step` and `make_eval_step`. One combined backward per
step. Multi-view: the masked multi-view heatmap MSE times `loss_weight_kpt`,
plus the per-group Huber of the angles (a mean over angles, then a weighted
mean over the groups with any real view). Single-view: the heatmap MSE and
the Huber, each a mean over samples weighted by the batch's `sample_weight`
where it has one (the Huber over the angles its `angle_mask` keeps), and
with `loss_weight_fk` > 0 the FK-consistency term. A train step puts the
model in train mode (batch statistics and their running-average update in
every BatchNorm, dropout in the decoder layers, masks from `generator`) and
returns its losses as device scalars: it never waits for the device.
"""

from __future__ import annotations

from typing import Callable

import torch

from mvropose_torch.geometry.robots import RobotSpec
from mvropose_torch.train.losses import (
    fk_reprojection_mse,
    heatmap_mse_loss,
    masked_multiview_heatmap_loss,
)
from mvropose_torch.train.state import TrainConfig, TrainState

# The batch fields the FK-consistency term reads.
FK_FIELDS = ("rvec", "tvec", "K", "base_rotation", "keypoints_2d")


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


def _single_view_losses(cfg: TrainConfig, pred_hm, pred_ang, batch):
    w = batch.get("sample_weight")
    if w is None:
        loss_kpt = heatmap_mse_loss(pred_hm, batch["heatmaps"])
    else:
        loss_kpt = _weighted_mean(((pred_hm - batch["heatmaps"]) ** 2).mean(dim=(1, 2, 3)), w)
    loss_ang = _weighted_mean(_huber_per_sample(pred_ang, batch["angles"], cfg.angle_beta,
                                                batch.get("angle_mask")), w)
    return loss_kpt * cfg.loss_weight_kpt + loss_ang, loss_kpt, loss_ang


def _fk_term(robot: RobotSpec | None, pred_ang, batch):
    """The per-sample FK-consistency term's weighted mean: FK of the
    predicted angles (each sample's base rotation) projected through its
    camera, against its 2D keypoints."""
    # A requested term must never silently do nothing.
    if robot is None:
        raise ValueError("loss_weight_fk > 0 requires robot=")
    missing = [k for k in FK_FIELDS if k not in batch]
    if missing:
        raise ValueError(f"loss_weight_fk > 0 but the batch lacks {missing} - "
                         "set dataset.with_extrinsics=True")
    per = fk_reprojection_mse(robot, pred_ang, batch["keypoints_2d"], batch["rvec"],
                              batch["tvec"], batch["K"], batch["base_rotation"])
    return _weighted_mean(per, batch.get("sample_weight"))


def make_single_view_train_step(cfg: TrainConfig, robot: RobotSpec | None = None) -> Callable:
    """train_step(state, batch, generator) -> {"loss", "loss_kpt", "loss_ang",
    "loss_fk"}.

    batch: images (B, H, W, 3), heatmaps (B, J, Hm, Wm), angles (B, A),
    optionally sample_weight (B,) and angle_mask (B, A); with
    `cfg.loss_weight_fk` > 0, `robot` and the batch's keypoints_2d (B, J, 2),
    rvec, tvec (B, 3), K, base_rotation (B, 3, 3) (else ValueError).
    Updates `state` in place."""

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None) -> dict:
        model = state.model.train()
        pred_hm, pred_ang = model(batch["images"], generator=generator)
        total, loss_kpt, loss_ang = _single_view_losses(cfg, pred_hm, pred_ang, batch)
        loss_fk = torch.zeros((), device=total.device)
        if cfg.loss_weight_fk > 0.0:
            loss_fk = _fk_term(robot, pred_ang, batch)
            total = total + cfg.loss_weight_fk * loss_fk
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.apply_gradients()
        return {"loss": total.detach(), "loss_kpt": loss_kpt.detach(),
                "loss_ang": loss_ang.detach(), "loss_fk": loss_fk.detach()}

    return train_step


def make_multi_view_train_step(cfg: TrainConfig) -> Callable:
    """train_step(state, batch, generator) -> {"loss", "loss_kpt", "loss_ang"}.

    batch: images (B, V, H, W, 3), view_ids (B, V), view_mask (B, V),
    heatmaps (B, V, J, Hm, Wm), angles (B, A), and for the geometric3d head
    proj_mats (B, V, 3, 4) in heatmap pixels. Updates `state` in place."""

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None) -> dict:
        model = state.model.train()
        pred_hm, pred_ang = model(batch["images"], batch["view_ids"], batch["view_mask"],
                                  generator=generator, proj_mats=batch.get("proj_mats"))
        total, loss_kpt, loss_ang = _losses(cfg, pred_hm, pred_ang, batch)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.apply_gradients()
        return {"loss": total.detach(), "loss_kpt": loss_kpt.detach(),
                "loss_ang": loss_ang.detach()}

    return train_step


def make_eval_step(cfg: TrainConfig, multi_view: bool = True) -> Callable:
    """eval_step(state, batch) -> losses (masked as in training, and by a
    batch's "angle_mask" as the reference's eval step; no FK term) and the
    predictions, in eval mode (running statistics, no dropout), no grad."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        model = state.model.eval()
        if multi_view:
            pred_hm, pred_ang = model(batch["images"], batch["view_ids"], batch["view_mask"],
                                      proj_mats=batch.get("proj_mats"))
            total, loss_kpt, loss_ang = _losses(cfg, pred_hm, pred_ang, batch,
                                                batch.get("angle_mask"))
        else:
            pred_hm, pred_ang = model(batch["images"])
            total, loss_kpt, loss_ang = _single_view_losses(cfg, pred_hm, pred_ang, batch)
        return {"loss": total, "loss_kpt": loss_kpt, "loss_ang": loss_ang,
                "pred_heatmaps": pred_hm, "pred_angles": pred_ang}

    return eval_step
