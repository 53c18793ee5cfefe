"""CV model families beyond ResNet (port of `fedml_tpu/models/cv.py`):
MobileNet v1 and v3-small, EfficientNet-lite and VGG 11 / 16, every norm a
GroupNorm, each with a width multiplier (VGG with its stage table).

Parameters keep flax's names (`DepthwiseSeparable_3.Conv_0.kernel`,
`InvertedResidual_2.SqueezeExcite_0.Dense_1.bias`, ...); a depthwise
convolution is a grouped `hub.Conv` (groups = channels, kernel
`[C, 1, k, k]`). Inputs are NHWC images, viewed as NCHW inside.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .hub import Conv, Dense, GroupNorm, _compute_dtype, _device


def _gn(ch: int, dtype, device) -> GroupNorm:
    """GroupNorm with the largest group count <= 32 that divides `ch`
    (width multipliers give counts such as 72)."""
    g = min(32, ch)
    while ch % g:
        g -= 1
    return GroupNorm(g, ch, dtype, device)


def _hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def _width(width: float):
    return lambda c: max(8, int(c * width))


class DepthwiseSeparable(nn.Module):
    """MobileNetV1 block: 3x3 depthwise, then 1x1 pointwise."""

    def __init__(self, ch_in: int, ch_out: int, stride: int, dtype, device):
        super().__init__()
        self.Conv_0 = Conv(ch_in, ch_in, 3, stride, False, dtype, device,
                           groups=ch_in)
        self.GroupNorm_0 = _gn(ch_in, dtype, device)
        self.Conv_1 = Conv(ch_in, ch_out, 1, 1, False, dtype, device)
        self.GroupNorm_1 = _gn(ch_out, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        return torch.relu(self.GroupNorm_1(self.Conv_1(x)))


class MobileNetV1(nn.Module):
    """Width-multiplied depthwise CNN with a CIFAR stem."""

    CFG = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (1024, 2)]

    def __init__(self, num_classes: int, input_shape: Sequence[int],
                 width: float = 1.0, *, dtype=torch.float32, device=None):
        super().__init__()
        dev, w = _device(device), _width(width)
        c = w(32)
        self.Conv_0 = Conv(input_shape[-1], c, 3, 1, False, dtype, dev)
        self.GroupNorm_0 = _gn(c, dtype, dev)
        self.n_blocks = len(self.CFG)
        for i, (ch, s) in enumerate(self.CFG):
            setattr(self, f"DepthwiseSeparable_{i}",
                    DepthwiseSeparable(c, w(ch), s, dtype, dev))
            c = w(ch)
        self.Dense_0 = Dense(c, num_classes, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(_compute_dtype(self, dtype))
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"DepthwiseSeparable_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, dtype, device, reduce: int = 4):
        super().__init__()
        mid = max(8, ch // reduce)
        self.Dense_0 = Dense(ch, mid, dtype, device)
        self.Dense_1 = Dense(mid, ch, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.Dense_0(x.mean(dim=(2, 3))))
        s = torch.sigmoid(self.Dense_1(s))
        return x * s[:, :, None, None]


class InvertedResidual(nn.Module):
    """MobileNetV3 / EfficientNet MBConv: 1x1 expand, depthwise k x k,
    squeeze-excite when asked, 1x1 project; the residual when the stride
    is 1 and the channels match."""

    def __init__(self, ch_in: int, ch_out: int, expand: int, stride: int,
                 kernel: int, use_se: bool, act: str, dtype, device):
        super().__init__()
        mid = ch_in * expand
        self.act = _hardswish if act == "hswish" else torch.relu
        self.residual = stride == 1 and ch_in == ch_out
        self.Conv_0 = Conv(ch_in, mid, 1, 1, False, dtype, device)
        self.GroupNorm_0 = _gn(mid, dtype, device)
        self.Conv_1 = Conv(mid, mid, kernel, stride, False, dtype, device,
                           groups=mid)
        self.GroupNorm_1 = _gn(mid, dtype, device)
        self.SqueezeExcite_0 = (SqueezeExcite(mid, dtype, device) if use_se
                                else None)
        self.Conv_2 = Conv(mid, ch_out, 1, 1, False, dtype, device)
        self.GroupNorm_2 = _gn(ch_out, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.GroupNorm_0(self.Conv_0(x)))
        h = self.act(self.GroupNorm_1(self.Conv_1(h)))
        if self.SqueezeExcite_0 is not None:
            h = self.SqueezeExcite_0(h)
        h = self.GroupNorm_2(self.Conv_2(h))
        return h + x if self.residual else h


class MobileNetV3Small(nn.Module):
    """MobileNetV3 'small' profile with GroupNorm."""

    # (out, expand, stride, kernel, squeeze-excite, activation)
    CFG = [(16, 1, 2, 3, True, "relu"), (24, 4, 2, 3, False, "relu"),
           (24, 3, 1, 3, False, "relu"), (40, 3, 2, 5, True, "hswish"),
           (40, 3, 1, 5, True, "hswish"), (48, 3, 1, 5, True, "hswish"),
           (96, 6, 2, 5, True, "hswish")]

    def __init__(self, num_classes: int, input_shape: Sequence[int],
                 width: float = 1.0, *, dtype=torch.float32, device=None):
        super().__init__()
        dev, w = _device(device), _width(width)
        c = w(16)
        self.Conv_0 = Conv(input_shape[-1], c, 3, 1, False, dtype, dev)
        self.GroupNorm_0 = _gn(c, dtype, dev)
        self.n_blocks = len(self.CFG)
        for i, (ch, e, s, k, se, a) in enumerate(self.CFG):
            setattr(self, f"InvertedResidual_{i}",
                    InvertedResidual(c, w(ch), e, s, k, se, a, dtype, dev))
            c = w(ch)
        self.Conv_1 = Conv(c, w(576), 1, 1, False, dtype, dev)
        self.GroupNorm_1 = _gn(w(576), dtype, dev)
        self.Dense_0 = Dense(w(576), w(1024), dtype, dev)
        self.Dense_1 = Dense(w(1024), num_classes, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(_compute_dtype(self, dtype))
        x = _hardswish(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x)
        x = _hardswish(self.GroupNorm_1(self.Conv_1(x)))
        x = _hardswish(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(x)


class EfficientNetLite(nn.Module):
    """EfficientNet-lite: no squeeze-excite, relu blocks, relu6 stem and
    head; width and depth multipliers."""

    # (out, expand, stride, kernel, repeats)
    CFG = [(16, 1, 1, 3, 1), (24, 6, 2, 3, 2), (40, 6, 2, 5, 2),
           (80, 6, 2, 3, 3), (112, 6, 1, 5, 3), (192, 6, 2, 5, 4)]

    def __init__(self, num_classes: int, input_shape: Sequence[int],
                 width: float = 1.0, depth: float = 1.0, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        dev, w = _device(device), _width(width)
        c = w(32)
        self.Conv_0 = Conv(input_shape[-1], c, 3, 1, False, dtype, dev)
        self.GroupNorm_0 = _gn(c, dtype, dev)
        n = 0
        for ch, e, s, k, reps in self.CFG:
            for i in range(max(1, int(math.ceil(reps * depth)))):
                setattr(self, f"InvertedResidual_{n}", InvertedResidual(
                    c, w(ch), e, s if i == 0 else 1, k, False, "relu",
                    dtype, dev))
                c, n = w(ch), n + 1
        self.n_blocks = n
        self.Conv_1 = Conv(c, w(1280), 1, 1, False, dtype, dev)
        self.GroupNorm_1 = _gn(w(1280), dtype, dev)
        self.Dense_0 = Dense(w(1280), num_classes, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(_compute_dtype(self, dtype))
        x = F.relu6(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x)
        x = F.relu6(self.GroupNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))


VGG11_STAGES = ((64,), (128,), (256, 256), (512, 512), (512, 512))
VGG16_STAGES = ((64, 64), (128, 128), (256, 256, 256),
                (512, 512, 512), (512, 512, 512))


class VGG(nn.Module):
    """VGG by its stage table (vgg11 by default), GroupNorm after every
    3x3 conv, a 2x2 max pool after every stage, then dense `dense` and
    the head over the NHWC-flattened features."""

    def __init__(self, num_classes: int, input_shape: Sequence[int],
                 stages: Sequence[Sequence[int]] = VGG11_STAGES,
                 dense: int = 512, *, dtype=torch.float32, device=None):
        super().__init__()
        dev = _device(device)
        h, w, c = input_shape
        self.stage_sizes = [len(st) for st in stages]
        n = 0
        for st in stages:
            for ch in st:
                setattr(self, f"Conv_{n}", Conv(c, ch, 3, 1, False, dtype,
                                                dev))
                setattr(self, f"GroupNorm_{n}", _gn(ch, dtype, dev))
                c, n = ch, n + 1
            h, w = h // 2, w // 2
        self.Dense_0 = Dense(h * w * c, dense, dtype, dev)
        self.Dense_1 = Dense(dense, num_classes, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(_compute_dtype(self, dtype))
        n = 0
        for size in self.stage_sizes:
            for _ in range(size):
                x = torch.relu(getattr(self, f"GroupNorm_{n}")(
                    getattr(self, f"Conv_{n}")(x)))
                n += 1
            x = F.max_pool2d(x, 2, 2)
        # flatten in NHWC order, as flax does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))
