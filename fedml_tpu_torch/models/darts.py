"""The DARTS search space of FedNAS (port of `fedml_tpu/models/darts.py`).

Architecture parameters are ordinary parameters (`alpha` leaves, one per
mixed op), so FedAvg over the parameter dict federates the weights and
the architecture together: that is FedNAS's aggregation. A mixed op
computes every candidate and sums them under softmax(alpha);
`discretize` reads the learned alphas back as an architecture.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .hub import Conv, Dense, GroupNorm, _compute_dtype, _device, _param

OPS = ("conv3", "conv1", "skip", "avgpool")


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 "SAME" average pool dividing by 9 at the borders too
    (flax's `avg_pool` counts the padding)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class MixedOp(nn.Module):
    """softmax(alpha)-weighted sum of the candidate ops: conv 3x3 + GN +
    relu, conv 1x1 + GN + relu, skip, and 3x3 average pool (a 1x1 conv
    projects skip and pool when the channels change)."""

    def __init__(self, c_in: int, ch: int, dtype, device):
        super().__init__()
        self.alpha = _param((len(OPS),), dtype, device)
        self.Conv_0 = Conv(c_in, ch, 3, 1, False, dtype, device)
        self.GroupNorm_0 = GroupNorm(8, ch, dtype, device)
        self.Conv_1 = Conv(c_in, ch, 1, 1, False, dtype, device)
        self.GroupNorm_1 = GroupNorm(8, ch, dtype, device)
        self.project = c_in != ch
        if self.project:
            self.Conv_2 = Conv(c_in, ch, 1, 1, False, dtype, device)
            self.Conv_3 = Conv(c_in, ch, 1, 1, False, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(self.alpha.to(x.dtype), dim=0)
        branches = [
            torch.relu(self.GroupNorm_0(self.Conv_0(x))),
            torch.relu(self.GroupNorm_1(self.Conv_1(x))),
            self.Conv_2(x) if self.project else x,
            (self.Conv_3(_avg_pool_same(x)) if self.project
             else _avg_pool_same(x)),
        ]
        return sum(w[i] * b for i, b in enumerate(branches))


class DartsNet(nn.Module):
    """Small DARTS supernet: stem conv + GN + relu, `cells_per_stage`
    mixed ops a stage (a 2x2 max pool between stages), mean pool, dense
    head."""

    def __init__(self, num_classes: int, input_shape: Sequence[int],
                 channels: Sequence[int] = (16, 32), cells_per_stage: int = 1,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        dev = _device(device)
        self.stages = [cells_per_stage] * len(channels)
        self.Conv_0 = Conv(input_shape[-1], channels[0], 3, 1, False, dtype,
                           dev)
        self.GroupNorm_0 = GroupNorm(8, channels[0], dtype, dev)
        c, n = channels[0], 0
        for ch in channels:
            for _ in range(cells_per_stage):
                setattr(self, f"MixedOp_{n}", MixedOp(c, ch, dtype, dev))
                c, n = ch, n + 1
        self.Dense_0 = Dense(c, num_classes, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(_compute_dtype(self, dtype))
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        n = 0
        for si, cells in enumerate(self.stages):
            for _ in range(cells):
                x = getattr(self, f"MixedOp_{n}")(x)
                n += 1
            if si < len(self.stages) - 1:
                x = F.max_pool2d(x, 2, 2)
        return self.Dense_0(x.mean(dim=(2, 3)))


def extract_alphas(params: dict) -> dict:
    """{cell path: softmax(alpha)}, the current architecture beliefs
    (paths joined with "/", as the JAX function names them)."""
    return {name.rpartition(".")[0].replace(".", "/"):
            torch.softmax(p.float(), dim=0)
            for name, p in params.items() if name.rpartition(".")[2] == "alpha"}


def discretize(params: dict) -> dict:
    """The argmax architecture: {cell path: op name}."""
    return {cell: OPS[int(w.argmax())]
            for cell, w in extract_alphas(params).items()}
