"""Light CNN stem: multi-scale spatial features for the UNet keypoint head.

Port of `mvropose_tpu/models/stem.py`: three stride-2 conv-BN-GELU stages
giving 1/4 (32 ch) and 1/8 (64 ch) feature maps, NCHW. BatchNorm always uses
its running statistics (the port serves; training is a later slice).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def batch_norm_eval(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """flax BatchNorm(use_running_average=True, dtype=f32): f32 statistics
    and output, whatever the input dtype and the module's mode."""
    return F.batch_norm(
        x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
        training=False, eps=bn.eps,
    )


class ConvBNGelu(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.conv = nn.Conv2d(
            in_ch, features, 3, stride=strides, padding=1, bias=False,
            dtype=dtype, device=device,
        )
        self.bn = nn.BatchNorm2d(features, eps=1e-5, device=device)

    def forward(self, x):
        return F.gelu(batch_norm_eval(self.bn, self.conv(x)).to(x.dtype))


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
