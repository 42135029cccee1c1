"""Global pooling (reference: torchok/models/poolings/classification/pooling.py:7-12).

Adaptive global pooling + flatten over NCHW feature maps. ``pooling_type``
matches the reference names: 'avg', 'max', 'catavgmax', 'avgmax'.
"""
from __future__ import annotations

import torch

from torchok_tpu_torch.constructor import POOLINGS
from torchok_tpu_torch.models.base import BaseModel


@POOLINGS.register_class
class Pooling(BaseModel):
    def __init__(self, in_channels: int = 0, pooling_type: str = "avg"):
        super().__init__()
        if pooling_type not in ("avg", "max", "avgmax", "catavgmax"):
            raise ValueError(f"Unknown pooling_type {pooling_type!r}")
        self.in_channels = in_channels
        self.pooling_type = pooling_type

    @property
    def out_channels(self) -> int:
        mult = 2 if self.pooling_type == "catavgmax" else 1
        return self.in_channels * mult

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=(2, 3))
        if self.pooling_type == "avg":
            return avg
        mx = x.amax(dim=(2, 3))
        if self.pooling_type == "max":
            return mx
        if self.pooling_type == "avgmax":
            return 0.5 * (avg + mx)
        return torch.cat([avg, mx], dim=-1)
