"""The pose estimators, single-view and multi-view, and the geometric angle head.

Port of `mvropose_tpu/models/estimator.py`: `SingleViewPoseEstimator`,
`MultiViewPoseEstimator` and `GeometricAngleHead`, with each angle head the
reference's config names ("query", "geometric", and for the multi-view model
"geometric3d"). Images keep the reference's public layout, (B, [V,] H, W, 3);
the backbone runs in NCHW, once over the folded B*V batch of the multi-view
model. With `freeze_backbone` the backbone runs under `torch.no_grad()`, the
reference's `stop_gradient` on its tokens.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvropose_torch.decode import decode_keypoints
from mvropose_torch.geometry.triangulation import triangulate_keypoints
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


ANGLE_HEADS = ("query", "geometric", "geometric3d")


class GeometricAngleHead(nn.Module):
    """Angles from the model's own decoded keypoints, the reference's
    geometric bottleneck: forward(heatmaps (B, [V,] J, h, w), view_mask (B, V),
    proj_mats (B, V, 3, 4) in heatmap pixels) -> (B, num_angles) f32.

    The heatmaps are detached (the reference's stop_gradient) and decoded in
    f32 by `decode_keypoints(mode="refine")` (plain torch on every device, as
    the reference runs it without Pallas); the features are xy normalized by
    (w - 1, h - 1) to [-1, 1] and the confidences. Multi-view (`max_views` >
    0): masked views are zeroed, the mask appended as a column and the view
    axis padded to `max_views`; with `use_triangulation` (geometric3d) the
    DLT of each keypoint over the views weighted by confidence x mask, zeroed
    where fewer than 2 views weigh > 0.05 and clipped to +-100, and that
    observer count are appended. Then DEPTH Linear + tanh-GELU layers of
    HIDDEN features (flax's `nn.gelu` default, unlike the model's other
    GELUs) and `out`, in f32 whatever the model's dtype."""

    HIDDEN, DEPTH = 256, 3  # the reference's defaults, which every caller keeps

    def __init__(self, num_angles: int, num_joints: int, max_views: int = 0,
                 use_triangulation: bool = False, device=None):
        super().__init__()
        if use_triangulation and max_views <= 0:
            raise ValueError("the triangulation branch is multi-view only")
        self.max_views, self.use_triangulation = max_views, use_triangulation
        J = num_joints
        width = max_views * (3 * J + 1) if max_views else 3 * J
        width += 4 * J if use_triangulation else 0
        for i in range(self.DEPTH):
            self.add_module(f"fc{i}", nn.Linear(width if i == 0 else self.HIDDEN, self.HIDDEN,
                                                device=device))
        self.out = nn.Linear(self.HIDDEN, num_angles, device=device)

    def forward(self, heatmaps, view_mask=None, proj_mats=None):
        hm = heatmaps.detach().float()
        xy_px, conf = decode_keypoints(hm, mode="refine")
        h, w = hm.shape[-2:]
        xy = torch.stack([xy_px[..., 0] / (w - 1.0), xy_px[..., 1] / (h - 1.0)], -1) * 2.0 - 1.0
        feats = torch.cat([xy.flatten(-2), conf], dim=-1)  # (B, [V,] 3J)
        extra = None
        if self.use_triangulation:
            pts3d, obs = self.triangulated(xy_px, conf, view_mask, proj_mats)
            extra = torch.cat([pts3d.flatten(1), obs], dim=-1)
        if self.max_views:
            B, V = feats.shape[:2]
            if V > self.max_views:
                raise ValueError(f"{V} views exceed the head's max_views {self.max_views}")
            m = (torch.ones((B, V, 1), device=feats.device) if view_mask is None
                 else view_mask.float()[..., None])
            feats = torch.cat([feats * m, m], dim=-1)
            feats = F.pad(feats, (0, 0, 0, self.max_views - V)).flatten(1)
        x = feats if extra is None else torch.cat([feats, extra], dim=-1)
        for i in range(self.DEPTH):
            x = F.gelu(getattr(self, f"fc{i}")(x), approximate="tanh")
        return self.out(x)

    @staticmethod
    def triangulated(xy_px, conf, view_mask, proj_mats):
        """The geometric3d branch: keypoints (B, V, J, 2) in heatmap pixels,
        confidences (B, V, J), mask (B, V), projection matrices (B, V, 3, 4)
        -> (points (B, J, 3), observing views (B, J)). A point seen with
        weight > 0.05 by fewer than 2 views is 0 (its DLT is rank-deficient
        and its null vector arbitrary); every point is clipped to +-100."""
        if proj_mats is None:
            raise ValueError("the geometric3d head needs proj_mats")
        wgt = conf if view_mask is None else conf * view_mask.float()[..., None]
        pts3d = triangulate_keypoints(xy_px, proj_mats, wgt)
        obs = (wgt > 0.05).float().sum(1)
        pts3d = torch.where((obs >= 2.0)[..., None], pts3d, torch.zeros_like(pts3d))
        return pts3d.clamp(-100.0, 100.0), obs


def _angle_head(cfg: "EstimatorConfig", dim: int, num_queries: int, max_views: int, device):
    """The angle head `cfg.angle_head` names, as the reference builds it."""
    if cfg.angle_head not in ANGLE_HEADS:
        raise ValueError(f"unknown angle_head {cfg.angle_head!r}; one of {ANGLE_HEADS}")
    if cfg.angle_head == "query":
        return JointAngleHead(dim, cfg.num_angles, num_queries=num_queries,
                              dtype=cfg.compute_dtype, device=device)
    return GeometricAngleHead(cfg.num_angles, cfg.num_joints, max_views=max_views,
                              use_triangulation=cfg.angle_head == "geometric3d", device=device)


class SingleViewPoseEstimator(nn.Module):
    """forward(images (B, H, W, 3) f32, generator) -> (heatmaps (B, J, Hm, Wm)
    f32, angles (B, A) f32).

    Backbone -> UNet keypoint head on the patch tokens (with the CNN stem's
    skips); the query angle head attends the patch tokens with
    `num_angle_queries` queries, the geometric head reads the heatmaps.
    "geometric3d" raises, as the reference's does: its DLT needs views."""

    def __init__(self, cfg: EstimatorConfig, device=None):
        super().__init__()
        if cfg.angle_head == "geometric3d":
            raise ValueError("angle_head='geometric3d' is multi-view only (its DLT branch "
                             "triangulates across views); use 'geometric' for single-view")
        self.cfg = cfg
        dt, D = cfg.compute_dtype, cfg.vit.hidden_size
        self.backbone = ViTBackbone(cfg.vit, device)
        self.cnn_stem = LightCNNStem(dt, device)
        self.keypoint_head = UNetViTKeypointHead(D, cfg.num_joints, cfg.heatmap_size, dt, device)
        self.angle_head = _angle_head(cfg, D, cfg.num_angle_queries, 0, device)

    def forward(self, images, generator=None):
        flat = images.permute(0, 3, 1, 2)  # NCHW
        with torch.no_grad() if self.cfg.freeze_backbone else contextlib.nullcontext():
            out = self.backbone(flat)
        tokens = out["patch_tokens"]
        heatmaps = self.keypoint_head(tokens, out["grid_hw"], self.cnn_stem(flat))
        if isinstance(self.angle_head, GeometricAngleHead):
            return heatmaps, self.angle_head(heatmaps)
        return heatmaps, self.angle_head(tokens, generator=generator)


class MultiViewPoseEstimator(nn.Module):
    """forward(images (B, V, H, W, 3) f32, view_ids (B, V) int, view_mask (B, V) bool,
    generator, proj_mats) -> (heatmaps (B, V, J, Hm, Wm) f32, angles (B, A) f32).

    `generator` draws the decoder layers' dropout masks in train mode;
    `proj_mats` (B, V, 3, 4) in heatmap pixels feed the geometric3d head's
    triangulation and are ignored by the other heads.

    Backbone per view + view embedding -> masked latent-query fusion -> angle
    head on the fused queries; a per-view enricher cross-attends the fused
    queries -> UNet keypoint head per view."""

    def __init__(self, cfg: EstimatorConfig, device=None):
        super().__init__()
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
        self.angle_head = _angle_head(cfg, D, cfg.num_fusion_queries, cfg.max_views, device)

    def forward(self, images, view_ids, view_mask, generator=None, proj_mats=None):
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
        if isinstance(self.angle_head, GeometricAngleHead):
            return heatmaps, self.angle_head(heatmaps, view_mask, proj_mats)
        return heatmaps, self.angle_head(fused, generator=generator)
