"""Classification head (reference:
torchok/models/heads/classification/classification_head.py:10-40).

Returns raw logits; squeezes the channel dim for ``num_classes == 1``
(binary classification)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor import HEADS
from torchok_tpu_torch.models.base import BaseModel
from torchok_tpu_torch.ops.common import Dropout


@HEADS.register_class
class ClassificationHead(BaseModel):
    def __init__(self, in_channels: int = 0, num_classes: int = 0,
                 drop_rate: float = 0.0, bias: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.drop = Dropout(drop_rate)
        self.fc = nn.Linear(in_channels, num_classes, bias=bias)

    @property
    def out_channels(self) -> int:
        return self.num_classes

    def forward(self, x: torch.Tensor,
                target: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.fc(self.drop(x))
        if self.num_classes == 1:
            x = x[..., 0]
        return x
