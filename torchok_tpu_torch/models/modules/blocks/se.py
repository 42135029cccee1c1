"""Squeeze-excitation channel attention (port of ``SEModule`` and
``make_divisible`` and ``EcaModule`` of
``torchok_tpu.models.modules.blocks.se``)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None,
                   round_limit: float = 0.9) -> int:
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


class SEModule(nn.Module):
    """Channel SE over NCHW: global-avg-pool -> reduce -> expand -> gate."""

    def __init__(self, channels: int, rd_ratio: float = 1.0 / 16,
                 rd_channels: Optional[int] = None, rd_divisor: int = 8,
                 act: Callable[[torch.Tensor], torch.Tensor] = F.relu,
                 gate: Callable[[torch.Tensor], torch.Tensor] = torch.sigmoid,
                 use_bias: bool = True, round_limit: float = 0.9):
        super().__init__()
        rd = rd_channels or make_divisible(channels * rd_ratio, rd_divisor,
                                           round_limit=round_limit)
        self.fc1 = nn.Conv2d(channels, rd, 1, bias=use_bias)
        self.fc2 = nn.Conv2d(rd, channels, 1, bias=use_bias)
        self.act, self.gate = act, gate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        return x * self.gate(self.fc2(self.act(self.fc1(s))))


class EcaModule(nn.Module):
    """Efficient channel attention over NCHW: a 1-D conv (odd kernel, zero
    padding, no bias) over the channel descriptor, then a sigmoid gate."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError(f"EcaModule needs an odd kernel_size, got {kernel_size}")
        self.conv = nn.Conv1d(1, 1, kernel_size, padding=(kernel_size - 1) // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3))[:, None, :]  # (N, 1, C): the conv runs along the channels
        s = torch.sigmoid(self.conv(s))[:, 0]
        return x * s[:, :, None, None]
