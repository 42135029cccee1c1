"""Feature Pyramid Network neck (reference: torchok/models/necks/detection/fpn.py,
an mmdet FPN subclass; port of ``torchok_tpu.models.necks.detection.fpn``).

1x1 laterals, top-down nearest-upsample sums, 3x3 output convs, and extra
levels from stride-2 3x3 convs on the last input, lateral or output
(``add_extra_convs``) or from max-pool subsampling. NCHW in and out.

The upsample is the JAX package's ``jax.image.resize(method="nearest")``,
which samples pixel centres: torch's ``"nearest-exact"``. Plain ``"nearest"``
agrees only at exact factors of 2 and picks other rows at sizes such as
25 -> 50 after an odd stage. Module names are mmdet's
(``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``, the extra convs
continuing ``fpn_convs``), so mmdet and TorchOk checkpoints name the same
tensors.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.constructor import DETECTION_NECKS, NECKS
from torchok_tpu_torch.models.base import BaseModel
from torchok_tpu_torch.ops.common import variance_scaling_


class ConvModule(nn.Module):
    """A conv under mmcv's ``ConvModule`` name (``.conv``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def lecun_init(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default law for every ``nn.Conv`` of ``module``: LeCun normal
    kernels (truncated, variance 1 / fan_in), zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            variance_scaling_(m.weight, 1.0, fan_in, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


@DETECTION_NECKS.register_class
class FPN(BaseModel):
    def __init__(self, in_channels: Sequence[int] = (), out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0, end_level: int = -1,
                 add_extra_convs: Union[bool, str] = False,
                 relu_before_extra_convs: bool = False, **_):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self._out_channels = out_channels
        self.num_outs = num_outs
        self.start_level = start_level
        self.end_level = len(self.in_channels) if end_level == -1 else end_level
        if add_extra_convs is True:
            add_extra_convs = "on_input"
        if add_extra_convs not in (False, "on_input", "on_lateral", "on_output"):
            raise ValueError(f"add_extra_convs={add_extra_convs!r}: expected False, True, "
                             "'on_input', 'on_lateral' or 'on_output'")
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = self.in_channels[start_level:self.end_level]
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1) for c in used)
        convs = [ConvModule(out_channels, out_channels, 3) for _ in used]
        if add_extra_convs:
            for i in range(num_outs - len(used)):
                src = used[-1] if add_extra_convs == "on_input" and i == 0 else out_channels
                convs.append(ConvModule(src, out_channels, 3, stride=2))
        self.fpn_convs = nn.ModuleList(convs)

    @property
    def out_channels(self) -> int:
        return self._out_channels

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        used = list(inputs[self.start_level:self.end_level])
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            up = F.interpolate(laterals[i], size=laterals[i - 1].shape[2:], mode="nearest-exact")
            laterals[i - 1] = laterals[i - 1] + up
        n = len(laterals)
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        if self.num_outs > n:
            if not self.add_extra_convs:  # extra levels by max-pool subsampling
                for _ in range(self.num_outs - n):
                    outs.append(F.max_pool2d(outs[-1], 1, stride=2))
            else:
                x = {"on_input": used[-1], "on_lateral": laterals[-1],
                     "on_output": outs[-1]}[self.add_extra_convs]
                for i in range(self.num_outs - n):
                    if i > 0 and self.relu_before_extra_convs:
                        x = F.relu(x)
                    x = self.fpn_convs[n + i](x)
                    outs.append(x)
        return outs

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_init(self, generator)


NECKS.register_class(FPN, name="FPNNeck")
