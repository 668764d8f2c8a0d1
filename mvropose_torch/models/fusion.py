"""Multi-view fusion with view masking.

Port of `mvropose_tpu/models/fusion.py`: `MultiViewFusion`, where learnable
global queries cross-attend the concatenation of all views' tokens through
decoder layers, and the ablation `SelfAttentionFusion`, one self-attention +
MLP block over all V * N view tokens, whose attention at V * N >= 2048 runs
the flash-attention kernels on the card. Keys of masked views are excluded
from attention exactly in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvropose_torch.models.heads import DecoderLayer
from mvropose_torch.models.layers import Linear
from mvropose_torch.models.vit import FusedMHA


def _key_mask(view_mask, N: int):
    """(B, V) view mask -> (B, V * N) key mask, jnp.repeat(view_mask, N,
    axis=1) written as an expand: no output-size computation that would wait
    for the device."""
    if view_mask is None:
        return None
    B, V = view_mask.shape
    return view_mask.bool()[:, :, None].expand(B, V, N).reshape(B, V * N)


class SelfAttentionFusion(nn.Module):
    """(B, V, N, D) view tokens + (B, V) mask -> (B, V, N, D) tokens, each
    attending every real view's tokens (`mvropose_tpu/models/fusion.py:27-62`):
    x + self-attention, LayerNorm, x + MLP (exact GELU), LayerNorm. Each
    residual sum is taken in the compute dtype and normalized in f32 (flax
    `nn.LayerNorm(dtype=float32)`, eps 1e-6), then cast back. Masked views'
    tokens are still queries; they attend the real views' tokens only."""

    def __init__(self, dim: int, num_heads: int = 8, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.self_attn = FusedMHA(dim, num_heads, dtype, device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.mlp1 = Linear(dim, dim * 4, dtype, device)
        self.mlp2 = Linear(dim * 4, dim, dtype, device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)

    def forward(self, view_tokens, view_mask=None):
        B, V, N, D = view_tokens.shape
        dt = self.dtype
        x = view_tokens.reshape(B, V * N, D).to(dt)
        h = self.self_attn(x, key_mask=_key_mask(view_mask, N))
        x = self.norm1((x + h).float()).to(dt)
        h = self.mlp2(F.gelu(self.mlp1(x)))
        x = self.norm2((x + h).float()).to(dt)
        return x.reshape(B, V, N, D)


class MultiViewFusion(nn.Module):
    """(B, V, N, D) view tokens + (B, V) mask -> (B, num_queries, D) summary."""

    def __init__(self, dim: int, num_queries: int = 16, num_layers: int = 2, num_heads: int = 8,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        self.global_queries = nn.Parameter(torch.zeros(1, num_queries, dim, device=device))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(dim, num_heads, dtype, device))

    def forward(self, view_tokens, view_mask=None, generator=None):
        B, V, N, D = view_tokens.shape
        memory = view_tokens.reshape(B, V * N, D)
        key_mask = _key_mask(view_mask, N)
        x = self.global_queries.to(self.dtype).expand(B, -1, -1)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, memory, memory_mask=key_mask, generator=generator)
        return x
