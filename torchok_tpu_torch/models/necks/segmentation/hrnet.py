"""HRNet segmentation neck (reference:
torchok/models/necks/segmentation/hrnet.py:17-42; port of
``torchok_tpu.models.necks.segmentation.hrnet``): the three lower branches
upsampled bilinearly to branch 0, concatenated, then a 1x1 ConvBnAct to
``sum(in_channels)``. Returns ``[input_image, feats]``, NCHW."""
from __future__ import annotations

from typing import List, Sequence

import torch

from torchok_tpu_torch.constructor import NECKS
from torchok_tpu_torch.models.backbones.resnet import init_like_flax
from torchok_tpu_torch.models.base import BaseModel
from torchok_tpu_torch.models.modules.bricks.convbnact import ConvBnAct
from torchok_tpu_torch.ops.image import resize_bilinear_nchw


@NECKS.register_class
class HRNetSegmentationNeck(BaseModel):
    def __init__(self, in_channels: Sequence[int] = ()):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.convbnact = ConvBnAct(self.out_channels, self.out_channels, kernel_size=1)

    @property
    def out_channels(self) -> int:
        return int(sum(self.in_channels))

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        input_image, x0, *lower = features
        size = x0.shape[2:]
        feats = torch.cat([x0] + [resize_bilinear_nchw(x, size) for x in lower], dim=1)
        return [input_image, self.convbnact(feats)]

    def init_weights(self, generator: torch.Generator) -> None:
        """ConvBnAct's initial law in the JAX package (:func:`init_like_flax`)."""
        init_like_flax(self, generator)
