"""Latent-query multi-view fusion with view masking.

Port of `mvropose_tpu/models/fusion.py::MultiViewFusion`: learnable global
queries cross-attend the concatenation of all views' tokens through decoder
layers; keys of masked views are excluded from attention exactly. The
ablation `SelfAttentionFusion` is not ported yet (ROADMAP.md queue 2: it is
the path that reaches the flash-attention kernel).
"""

from __future__ import annotations

import torch
from torch import nn

from mvropose_torch.models.heads import DecoderLayer


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
        key_mask = None
        if view_mask is not None:
            # jnp.repeat(view_mask, N, axis=1), written as an expand: no
            # output-size computation that would wait for the device.
            key_mask = view_mask.bool()[:, :, None].expand(B, V, N).reshape(B, V * N)
        x = self.global_queries.to(self.dtype).expand(B, -1, -1)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, memory, memory_mask=key_mask, generator=generator)
        return x
