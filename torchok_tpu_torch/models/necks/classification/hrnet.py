"""HRNet classification neck (reference:
torchok/models/necks/classification/hrnet.py:13-85; port of
``torchok_tpu.models.necks.classification.hrnet``): per-branch Bottleneck
"incre" modules, a cascade of stride-2 ConvBnActs and a last 1x1 ConvBnAct
to 2048 channels, NCHW.

As in the JAX package, each incre output is summed into the cascade (the
HRNet paper's head); the reference's forward overwrites the cascade with the
next incre output instead (hrnet.py:78-85 there).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from torchok_tpu_torch.constructor import NECKS
from torchok_tpu_torch.models.backbones.resnet import Bottleneck, init_like_flax
from torchok_tpu_torch.models.base import BaseModel
from torchok_tpu_torch.models.modules.bricks.convbnact import ConvBnAct

HEAD_CHANNELS = (32, 64, 128, 256)


@NECKS.register_class
class HRNetClassificationNeck(BaseModel):
    def __init__(self, in_channels: Sequence[int] = ()):
        super().__init__()
        exp = Bottleneck.expansion
        self.num_branches = len(in_channels)
        for i, width in enumerate(in_channels):
            planes = HEAD_CHANNELS[i]
            setattr(self, f"incre_{i}", Bottleneck(width, planes,
                                                   use_downsample=width != planes * exp))
        for i in range(self.num_branches - 1):
            setattr(self, f"down_{i}", ConvBnAct(HEAD_CHANNELS[i] * exp,
                                                 HEAD_CHANNELS[i + 1] * exp, kernel_size=3,
                                                 stride=2))
        self.final = ConvBnAct(HEAD_CHANNELS[self.num_branches - 1] * exp, self.out_channels,
                               kernel_size=1)

    @property
    def out_channels(self) -> int:
        return 2048

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        y = self.incre_0(xs[0])
        for i in range(1, self.num_branches):
            y = getattr(self, f"down_{i - 1}")(y) + getattr(self, f"incre_{i}")(xs[i])
        return self.final(y)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's law for its Bottlenecks and ConvBnActs
        (:func:`init_like_flax`), each incre block's last norm at zero."""
        init_like_flax(self, generator)
