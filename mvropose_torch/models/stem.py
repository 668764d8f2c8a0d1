"""Light CNN stem: multi-scale spatial features for the UNet keypoint head.

Port of `mvropose_tpu/models/stem.py`: three stride-2 conv-BN-GELU stages
giving 1/4 (32 ch) and 1/8 (64 ch) feature maps, NCHW. `batch_norm` is
flax's BatchNorm for every BatchNorm of the port: batch statistics and the
running-average update in train mode, running statistics in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvropose_torch.models.layers import Conv2d

# flax's BatchNorm default: running = momentum * running + (1 - momentum) * batch.
BN_MOMENTUM = 0.99


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """flax `BatchNorm(use_running_average=not bn.training, dtype=f32)` on
    NCHW: f32 statistics and output, whatever the input dtype.

    Train mode takes the biased batch variance as flax's fast variance,
    max(0, E[x^2] - E[x]^2) over (N, H, W), normalizes with it, and moves
    the running mean and variance toward the batch's by 1 - BN_MOMENTUM
    (torch's own train-mode batch_norm would move the running variance
    toward the unbiased variance). Eval mode uses the running statistics."""
    x = x.float()
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=False, eps=bn.eps)
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


class ConvBNGelu(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.conv = Conv2d(in_ch, features, 3, dtype, device, stride=strides, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, device=device)

    def forward(self, x):
        return F.gelu(batch_norm(self.bn, self.conv(x)).to(x.dtype))


class LightCNNStem(nn.Module):
    """images (B, 3, H, W) -> (feat_4 (B, 32, H/4, W/4), feat_8 (B, 64, H/8, W/8))."""

    def __init__(self, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvBNGelu(3, 16, 2, dtype, device)
        self.conv2 = ConvBNGelu(16, 32, 2, dtype, device)
        self.conv3 = ConvBNGelu(32, 64, 2, dtype, device)

    def forward(self, x):
        x = self.conv1(x.to(self.dtype))
        feat_4 = self.conv2(x)
        return feat_4, self.conv3(feat_4)
