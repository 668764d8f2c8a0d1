"""Layers with f32 parameters that compute in a given dtype, as flax's do.

flax keeps every parameter in f32 (`param_dtype`) and casts inputs, kernel
and bias to the module's `dtype` at use. These subclasses do the same, so a
bf16 model trains f32 weights (AdamW at lr 1e-4 on bf16 storage would lose
most updates: one bf16 ulp is ~0.4 % of the value) and serves with the
bf16 copy that flax computes with. They stay `nn.Linear`, `nn.Conv2d` and
`nn.Embedding` for the weight bridge (`utils/weights.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """flax `Dense(dtype=dtype)`."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """flax `Conv(dtype=dtype)` on NCHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, dtype: torch.dtype, device=None,
                 **kwargs):
        super().__init__(in_ch, out_ch, kernel_size, device=device, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Embedding(nn.Embedding):
    """flax `Embed(dtype=dtype)`: the table is cast, then rows are taken."""

    def __init__(self, num_embeddings: int, dim: int, dtype: torch.dtype, device=None):
        super().__init__(num_embeddings, dim, device=device)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.compute_dtype))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax `nn.Dropout(rate)` in train mode: an elementwise keep mask of
    probability 1 - rate from `generator`, kept values divided by 1 - rate."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)
