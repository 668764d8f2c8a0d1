"""Prediction heads: UNet-style keypoint heatmap head and query angle head.

Port of `mvropose_tpu/models/heads.py` (TokenFuser, FusedUpsampleBlock,
UNetViTKeypointHead, DecoderLayer, JointAngleHead), NCHW inside. As in the
reference, `module.train()` turns on batch statistics in every BatchNorm
(`stem.batch_norm`) and dropout 0.1 in the decoder layers, whose masks come
from the `generator` passed to `forward`; `module.eval()` turns both off.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvropose_torch.models.layers import Conv2d, Linear, dropout
from mvropose_torch.models.stem import batch_norm
from mvropose_torch.models.vit import MultiHeadAttention


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(..., "bilinear")` on NCHW: half-pixel centres and,
    when an axis shrinks, an antialiasing triangle filter. On an upscale
    torch's antialiased and plain bilinear paths agree, so the plain one runs."""
    hw = tuple(hw)
    if tuple(x.shape[-2:]) == hw:
        return x
    shrinks = hw[0] < x.shape[-2] or hw[1] < x.shape[-1]
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False, antialias=shrinks)


def _conv3(in_ch, out_ch, dtype, device, bias=False):
    return Conv2d(in_ch, out_ch, 3, dtype, device, padding=1, bias=bias)


class TokenFuser(nn.Module):
    """(B, D, gh, gw) token map -> refined (B, out, gh, gw) feature map."""

    def __init__(self, in_ch: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.projection = Conv2d(in_ch, out_features, 1, dtype, device)
        self.refine1 = _conv3(out_features, out_features, dtype, device)
        self.bn1 = nn.BatchNorm2d(out_features, device=device)
        self.refine2 = _conv3(out_features, out_features, dtype, device)
        self.bn2 = nn.BatchNorm2d(out_features, device=device)
        self.residual = Conv2d(in_ch, out_features, 1, dtype, device)

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        h = F.gelu(batch_norm(self.bn1, self.refine1(self.projection(x))).to(dt))
        h = batch_norm(self.bn2, self.refine2(h)).to(dt)
        return F.gelu(h + self.residual(x))


class FusedUpsampleBlock(nn.Module):
    """x2 bilinear upsample + skip concat + two conv-BN-GELU refinements."""

    def __init__(self, in_ch: int, skip_ch: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv3(in_ch + skip_ch, out_features, dtype, device)
        self.bn1 = nn.BatchNorm2d(out_features, device=device)
        self.conv2 = _conv3(out_features, out_features, dtype, device)
        self.bn2 = nn.BatchNorm2d(out_features, device=device)

    def forward(self, x, skip):
        dt = self.dtype
        H, W = x.shape[-2] * 2, x.shape[-1] * 2
        x = resize_bilinear(x.to(dt), (H, W))
        skip = resize_bilinear(skip, (H, W))
        x = torch.cat([x, skip.to(dt)], dim=1)
        x = F.gelu(batch_norm(self.bn1, self.conv1(x)).to(dt))
        return F.gelu(batch_norm(self.bn2, self.conv2(x)).to(dt))


class UNetViTKeypointHead(nn.Module):
    """(tokens (B, N, D), grid_hw, stem feats) -> f32 heatmaps (B, J, Hm, Wm).

    TokenFuser -> up(+stem 1/8) -> up(+stem 1/4) -> x2 up while below the
    heatmap size -> 3x3 conv -> bilinear to heatmap_size."""

    def __init__(self, dim: int, num_joints: int, heatmap_size: Tuple[int, int],
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.heatmap_size = tuple(heatmap_size)
        self.token_fuser = TokenFuser(dim, 256, dtype, device)
        self.decoder_block1 = FusedUpsampleBlock(256, 64, 128, dtype, device)
        self.decoder_block2 = FusedUpsampleBlock(128, 32, 64, dtype, device)
        self.heatmap_predictor = _conv3(64, num_joints, dtype, device, bias=True)

    def forward(self, tokens, grid_hw, stem_feats):
        gh, gw = grid_hw
        feat_4, feat_8 = stem_feats
        B, _, D = tokens.shape
        x = tokens[:, : gh * gw, :].transpose(1, 2).reshape(B, D, gh, gw)
        x = self.token_fuser(x)
        x = self.decoder_block1(x, feat_8)
        x = self.decoder_block2(x, feat_4)
        if x.shape[-2] < self.heatmap_size[0]:
            x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        x = self.heatmap_predictor(x)
        return resize_bilinear(x.float(), self.heatmap_size)


class DecoderLayer(nn.Module):
    """Post-LN transformer decoder layer (torch nn.TransformerDecoderLayer
    semantics, norm_first=False): self-attn -> cross-attn -> FFN. The
    LayerNorms use flax's eps, 1e-6, in f32. In train mode both attentions
    drop weights (one (Tq, Tk) mask per call) and the FFN drops elementwise
    after its GELU, at `dropout`."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, device=None,
                 dropout: float = 0.1):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype, device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.cross_attn = MultiHeadAttention(dim, num_heads, dtype, device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.ffn1 = Linear(dim, dim * 4, dtype, device)
        self.ffn2 = Linear(dim * 4, dim, dtype, device)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6, device=device)

    def forward(self, tgt, memory, memory_mask=None, generator=None):
        """memory_mask: (B, Nk) bool, False = key not attended."""
        dt = self.dtype
        rate = self.dropout if self.training else 0.0
        tgt = tgt.to(dt)
        h = self.self_attn(tgt, dropout_rate=rate, generator=generator)
        tgt = self.norm1((tgt + h).float()).to(dt)
        h = self.cross_attn(tgt, memory.to(dt), key_mask=memory_mask, dropout_rate=rate,
                            generator=generator)
        tgt = self.norm2((tgt + h).float()).to(dt)
        h = self.ffn2(dropout(F.gelu(self.ffn1(tgt)), rate, generator))
        return self.norm3((tgt + h).float()).to(dt)


class JointAngleHead(nn.Module):
    """Learnable pose queries cross-attend memory tokens -> f32 joint angles.

    (B, N, D) memory -> (B, num_angles) through num_layers decoder layers and
    a LayerNorm/Linear MLP run in f32."""

    def __init__(self, dim: int, num_angles: int, num_queries: int = 4, num_layers: int = 2,
                 num_heads: int = 8, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.pose_queries = nn.Parameter(torch.zeros(1, num_queries, dim, device=device))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(dim, num_heads, dtype, device))
        width = num_queries * dim
        self.mlp_norm0 = nn.LayerNorm(width, eps=1e-6, device=device)
        self.mlp_fc1 = nn.Linear(width, 512, device=device)
        self.mlp_norm1 = nn.LayerNorm(512, eps=1e-6, device=device)
        self.mlp_fc2 = nn.Linear(512, 256, device=device)
        self.mlp_norm2 = nn.LayerNorm(256, eps=1e-6, device=device)
        self.mlp_out = nn.Linear(256, num_angles, device=device)

    def forward(self, memory, memory_mask=None, generator=None):
        B = memory.shape[0]
        x = self.pose_queries.to(self.dtype).expand(B, -1, -1)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, memory, memory_mask=memory_mask,
                                            generator=generator)
        x = self.mlp_norm0(x.reshape(B, -1).float())
        x = self.mlp_norm1(F.gelu(self.mlp_fc1(x)))
        x = self.mlp_norm2(F.gelu(self.mlp_fc2(x)))
        return self.mlp_out(x)
