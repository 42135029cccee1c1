"""Dropout + linear representation head (port of
``torchok_tpu.models.heads.representation.linear_head``; reference:
torchok/models/heads/representation/linear_head.py:11)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor import HEADS
from torchok_tpu_torch.models.base import BaseModel
from torchok_tpu_torch.ops.common import Dropout, variance_scaling_


@HEADS.register_class
class LinearHead(BaseModel):
    """Dropout, then ``fc``, then (``normalize``) division by the L2 norm
    plus 1e-12, as the JAX head divides."""

    def __init__(self, in_channels: int = 0, out_channels: int = 0, drop_rate: float = 0.0,
                 bias: bool = True, normalize: bool = False):
        super().__init__()
        self.normalize = normalize
        self.drop = Dropout(drop_rate)
        self.fc = nn.Linear(in_channels, out_channels, bias=bias)

    @property
    def out_channels(self) -> int:
        return self.fc.out_features

    def init_weights(self, generator: torch.Generator) -> None:
        """``nn.Dense``'s law: LeCun normal weight, zero bias."""
        variance_scaling_(self.fc.weight, 1.0, self.fc.in_features, generator)
        if self.fc.bias is not None:
            nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.fc(self.drop(x))
        if self.normalize:
            x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        return x
