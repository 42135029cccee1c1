"""Conv + BatchNorm + activation brick (reference:
torchok/models/modules/bricks/convbnact.py:8; port of
``torchok_tpu.models.modules.bricks.convbnact``). NCHW."""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d


def _pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_padding(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` along one axis: the output has ``ceil(size / stride)``
    positions and an odd total pads one more at the end (at stride 2 a
    symmetric integer padding would put it at the start)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class ConvBnAct(nn.Module):
    """``padding`` None pads ``(k - 1) // 2 * dilation`` on both sides, an int
    or pair pads that much, ``"SAME"`` / ``"VALID"`` pad as XLA does."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Optional[Union[int, str, Tuple[int, int]]] = None,
                 dilation: Union[int, Tuple[int, int]] = 1, groups: int = 1,
                 use_bias: bool = False, use_norm: bool = True,
                 act: Optional[Callable[[torch.Tensor], torch.Tensor]] = F.relu):
        super().__init__()
        k, d = _pair(kernel_size), _pair(dilation)
        self.same = False
        if padding is None:
            pad = tuple((kk - 1) // 2 * dd for kk, dd in zip(k, d))
        elif isinstance(padding, str):
            if padding.upper() not in ("SAME", "VALID"):
                raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
            self.same = padding.upper() == "SAME"
            pad = (0, 0)
        else:
            pad = _pair(padding)
        self.conv = nn.Conv2d(in_channels, out_channels, k, _pair(stride), pad, d, groups,
                              bias=use_bias)
        self.bn = BatchNorm2d(out_channels) if use_norm else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.same:
            conv = self.conv
            top, bottom = same_padding(x.shape[2], conv.kernel_size[0], conv.stride[0],
                                       conv.dilation[0])
            left, right = same_padding(x.shape[3], conv.kernel_size[1], conv.stride[1],
                                       conv.dilation[1])
            x = F.pad(x, (left, right, top, bottom))
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x
