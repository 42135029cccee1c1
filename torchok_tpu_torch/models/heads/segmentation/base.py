"""Segmentation head (reference: torchok/models/heads/segmentation/base.py:12-41;
port of ``torchok_tpu.models.heads.segmentation.base``): a 1x1 conv with a
bias over ``[input_image, features]``, then a bilinear resize to the input's
size. NCHW logits ``(N, C, H, W)``; the channel dim is squeezed for
``num_classes == 1``."""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from torchok_tpu_torch.constructor import HEADS
from torchok_tpu_torch.models.base import BaseModel
from torchok_tpu_torch.ops.common import variance_scaling_
from torchok_tpu_torch.ops.image import resize_bilinear_nchw


@HEADS.register_class
class SegmentationHead(BaseModel):
    def __init__(self, in_channels: int = 0, num_classes: int = 0, do_interpolate: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.do_interpolate = do_interpolate
        self.classifier = nn.Conv2d(in_channels, num_classes, 1)

    @property
    def out_channels(self) -> int:
        return self.num_classes

    def forward(self, x: List[torch.Tensor], target: Optional[torch.Tensor] = None) -> torch.Tensor:
        input_image, features = x
        logits = self.classifier(features)
        if self.do_interpolate:
            logits = resize_bilinear_nchw(logits, input_image.shape[2:])
        if self.num_classes == 1:
            logits = logits[:, 0]
        return logits

    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's default law for ``nn.Conv``: LeCun normal, zero bias."""
        variance_scaling_(self.classifier.weight, 1.0, self.classifier.in_channels, generator)
        nn.init.zeros_(self.classifier.bias)
