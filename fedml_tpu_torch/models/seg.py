"""UNetLite, the segmentation model of the simulator (port of
`fedml_tpu/models/seg.py`): conv blocks with GroupNorm, 2x2 max pools, a
bottleneck block, a decoder of bilinear 2x upsampling + skip concat + conv
block, and a 1x1 head. NHWC images [B, H, W, C] -> NHWC logits
[B, H, W, num_classes]; H and W must be divisible by 2 ** len(features).

The JAX upsample is `jax.image.resize(..., "bilinear")`, which samples at
half-pixel centres; at an exact 2x upsample that is
`F.interpolate(mode="bilinear", align_corners=False)`
(tests/test_torch_models_more.py holds the two together).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .hub import Conv, GroupNorm, _compute_dtype, _device


class _ConvBlock(nn.Module):
    """Two 3x3 convs, each followed by GroupNorm(min(8, C)) and relu."""

    def __init__(self, c_in: int, features: int, dtype, device):
        super().__init__()
        g = min(8, features)
        self.Conv_0 = Conv(c_in, features, 3, 1, False, dtype, device)
        self.GroupNorm_0 = GroupNorm(g, features, dtype, device)
        self.Conv_1 = Conv(features, features, 3, 1, False, dtype, device)
        self.GroupNorm_1 = GroupNorm(g, features, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        return torch.relu(self.GroupNorm_1(self.Conv_1(x)))


def upsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW bilinear resize with half-pixel centres (jax.image.resize's
    "bilinear" when upsampling)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class UNetLite(nn.Module):
    def __init__(self, num_classes: int, input_shape: Sequence[int],
                 features: Sequence[int] = (16, 32), bottleneck: int = 64, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        dev = _device(device)
        self.levels = len(features)
        c, n = input_shape[-1], 0
        for f in features:
            setattr(self, f"_ConvBlock_{n}", _ConvBlock(c, f, dtype, dev))
            c, n = f, n + 1
        setattr(self, f"_ConvBlock_{n}", _ConvBlock(c, bottleneck, dtype,
                                                    dev))
        c, n = bottleneck, n + 1
        for f in reversed(features):
            setattr(self, f"_ConvBlock_{n}", _ConvBlock(c + f, f, dtype,
                                                        dev))
            c, n = f, n + 1
        self.Conv_0 = Conv(c, num_classes, 1, 1, True, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        down = 2 ** self.levels
        if x.shape[1] % down or x.shape[2] % down:
            raise ValueError(
                f"UNetLite input H/W {tuple(x.shape[1:3])} must be "
                f"divisible by {down} (len(features)={self.levels} pool "
                "levels)")
        x = x.permute(0, 3, 1, 2).to(_compute_dtype(self, dtype))
        block = iter(getattr(self, f"_ConvBlock_{i}")
                     for i in range(2 * self.levels + 1))
        skips = []
        for _ in range(self.levels):
            x = next(block)(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = next(block)(x)
        for skip in reversed(skips):
            x = upsample_bilinear(x, skip.shape[2:])
            x = next(block)(torch.cat([x, skip], dim=1))
        return self.Conv_0(x).permute(0, 2, 3, 1)
