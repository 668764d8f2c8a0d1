"""Multi-view pose estimator.

Port of `mvropose_tpu/models/estimator.py::MultiViewPoseEstimator` with the
query angle head. Images keep the reference's public layout, (B, V, H, W, 3);
the backbone runs once over the folded B*V batch in NCHW. With
`freeze_backbone` the backbone runs under `torch.no_grad()`, the reference's
`stop_gradient` on its tokens. Not ported yet: the single-view estimator and
the geometric angle heads (ROADMAP.md queue 1, item 4).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch
from torch import nn

from mvropose_torch.models.fusion import MultiViewFusion
from mvropose_torch.models.heads import DecoderLayer, JointAngleHead, UNetViTKeypointHead
from mvropose_torch.models.layers import Embedding
from mvropose_torch.models.stem import LightCNNStem
from mvropose_torch.models.vit import ViTBackbone, ViTConfig


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Same fields as the reference's EstimatorConfig (model_config.json)."""

    vit: ViTConfig
    num_joints: int = 8  # heatmap channels (keypoints)
    num_angles: int = 7  # regressed joint angles
    heatmap_size: Tuple[int, int] = (128, 128)
    max_views: int = 10
    num_fusion_queries: int = 16
    num_angle_queries: int = 4
    freeze_backbone: bool = True
    dtype: str = "bfloat16"
    angle_head: str = "query"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class MultiViewPoseEstimator(nn.Module):
    """forward(images (B, V, H, W, 3) f32, view_ids (B, V) int, view_mask (B, V) bool,
    generator) -> (heatmaps (B, V, J, Hm, Wm) f32, angles (B, A) f32).

    `generator` draws the decoder layers' dropout masks in train mode.

    Backbone per view + view embedding -> masked latent-query fusion -> angle
    head on the fused queries; a per-view enricher cross-attends the fused
    queries -> UNet keypoint head per view."""

    def __init__(self, cfg: EstimatorConfig, device=None):
        super().__init__()
        if cfg.angle_head != "query":
            raise NotImplementedError(
                f"angle_head={cfg.angle_head!r} is not ported yet (ROADMAP.md queue 1, "
                "item 4: geometric angle heads); only 'query' runs"
            )
        self.cfg = cfg
        dt, D = cfg.compute_dtype, cfg.vit.hidden_size
        self.backbone = ViTBackbone(cfg.vit, device)
        self.view_embeddings = Embedding(cfg.max_views, D, dt, device)
        self.cnn_stem = LightCNNStem(dt, device)
        self.fusion_module = MultiViewFusion(D, cfg.num_fusion_queries, dtype=dt, device=device)
        self.keypoint_enricher = DecoderLayer(D, 8, dt, device)
        self.keypoint_head = UNetViTKeypointHead(
            D, cfg.num_joints, cfg.heatmap_size, dt, device
        )
        self.angle_head = JointAngleHead(
            D, cfg.num_angles, num_queries=cfg.num_fusion_queries, dtype=dt, device=device
        )

    def forward(self, images, view_ids, view_mask, generator=None):
        c = self.cfg
        B, V, H, W, _ = images.shape
        view_mask = view_mask.bool()
        # Each sample's first real view stands in for its masked slots, so the
        # (folded) BatchNorm population holds real images, not black frames;
        # masked slots are excluded downstream. All-masked samples keep theirs.
        first_valid = view_mask.to(torch.uint8).argmax(dim=1)  # (B,)
        ref = images[torch.arange(B, device=images.device), first_valid][:, None]
        images = torch.where(view_mask[:, :, None, None, None], images, ref)
        flat = images.reshape(B * V, H, W, 3).permute(0, 3, 1, 2)  # NCHW

        with torch.no_grad() if c.freeze_backbone else contextlib.nullcontext():
            out = self.backbone(flat)
        tokens = out["patch_tokens"]  # (B*V, N, D) f32
        N, D = tokens.shape[1], tokens.shape[2]
        view_embed = self.view_embeddings(view_ids.reshape(B * V))
        tokens = tokens.to(c.compute_dtype) + view_embed[:, None, :]

        stem_feats = self.cnn_stem(flat)
        fused = self.fusion_module(tokens.reshape(B, V, N, D), view_mask, generator)  # (B, Q, D)
        # jnp.repeat(fused, V, axis=0): sample b's queries for each of its V views.
        fused_per_view = fused[:, None].expand(B, V, *fused.shape[1:]).reshape(B * V, *fused.shape[1:])
        enriched = self.keypoint_enricher(tokens, fused_per_view, generator=generator)
        heatmaps = self.keypoint_head(enriched, out["grid_hw"], stem_feats)
        Hm, Wm = c.heatmap_size
        heatmaps = heatmaps.reshape(B, V, c.num_joints, Hm, Wm)
        return heatmaps, self.angle_head(fused, generator=generator)
