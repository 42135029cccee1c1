"""Pooling + linear projection to an embedding (port of
``torchok_tpu.models.poolings.classification.linear``; reference:
torchok/models/poolings/classification/linear.py:8-25)."""
from __future__ import annotations

import torch
from torch import nn

from torchok_tpu_torch.constructor import POOLINGS
from torchok_tpu_torch.models.base import BaseModel
from torchok_tpu_torch.models.poolings.classification.pooling import Pooling
from torchok_tpu_torch.ops.common import variance_scaling_


@POOLINGS.register_class
class PoolingLinear(BaseModel):
    def __init__(self, in_channels: int = 0, out_channels: int = 512,
                 pooling_type: str = "avg", use_bias: bool = True):
        super().__init__()
        self.pooling = Pooling(in_channels=in_channels, pooling_type=pooling_type)
        self.fc = nn.Linear(self.pooling.out_channels, out_channels, bias=use_bias)

    @property
    def out_channels(self) -> int:
        return self.fc.out_features

    def init_weights(self, generator: torch.Generator) -> None:
        """``nn.Dense``'s law: LeCun normal weight, zero bias."""
        variance_scaling_(self.fc.weight, 1.0, self.fc.in_features, generator)
        if self.fc.bias is not None:
            nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.pooling(x))
