"""Building blocks of the EfficientNet / MobileNetV3 / LCNet families (port of
``torchok_tpu.models.backbones.efficientnet_blocks``).

NCHW in and out. Each block takes its input channels at construction (the
Flax modules read them from the input). Module names are the JAX package's
(``conv_pw``/``bn1``, ``conv_dw``/``bn2``, ``se.fc1``/``se.fc2``,
``conv_pwl``/``bn3``; ``conv_exp`` in the edge block, ``conv_dw_{i}`` per
kernel size in the mixed block, ``conv``/``bn`` in the plain block), which
are names ``torchok_tpu.utils.torch_convert.map_efficientnet`` accepts.

Two things differ from the port's ResNet bricks and from timm: BatchNorm
takes ``epsilon=1e-3`` (the port's :class:`BatchNorm2d` defaults to 1e-5),
and every conv pads ``(k - 1) // 2`` on both sides, for the ``tf_*`` names
too (no TF "SAME" padding). The mixed block gives the remainder of its
channel split to the *last* kernel size, as the JAX package does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.models.modules.blocks.se import SEModule, make_divisible
from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
from torchok_tpu_torch.ops.common import DropPath

BN_EPS = 1e-3


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "relu6": F.relu6,
    "swish": F.silu,
    "silu": F.silu,
    "hard_swish": hard_swish,
    "hswish": hard_swish,
    "gelu": F.gelu,  # exact (erf), as the JAX package's approximate=False
}


def round_channels(channels: float, multiplier: float = 1.0, divisor: int = 8,
                   channel_min: Optional[int] = None) -> int:
    if not multiplier:
        return int(channels)
    return make_divisible(channels * multiplier, divisor, channel_min)


def _conv(in_chs: int, out_chs: int, kernel: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    """Symmetric zero padding ``(k - 1) // 2``, no bias."""
    return nn.Conv2d(in_chs, out_chs, kernel, stride, (kernel - 1) // 2, groups=groups,
                     bias=False)


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, momentum=0.9, eps=BN_EPS)


def _se(channels: int, rd: int, act: Callable, gate: str = "sigmoid") -> SEModule:
    return SEModule(channels, rd_channels=rd, act=act,
                    gate=hard_sigmoid if gate == "hard_sigmoid" else torch.sigmoid)


class _Residual(nn.Module):
    """What the residual blocks share: the shortcut (with stochastic depth)
    when the stride is 1 and the channels stay."""

    def _init_residual(self, in_chs: int, out_chs: int, stride: int,
                       drop_path_rate: float) -> None:
        self.has_residual = stride == 1 and in_chs == out_chs
        self.drop_path = DropPath(drop_path_rate) if self.has_residual else None

    def _finish(self, x: torch.Tensor, shortcut: torch.Tensor) -> torch.Tensor:
        if self.has_residual:
            x = self.drop_path(x) + shortcut
        return x


class ConvBnActBlock(nn.Module):
    """'cn' block: plain conv-bn-act."""

    def __init__(self, in_chs: int, out_chs: int, kernel: int = 3, stride: int = 1,
                 act: str = "swish"):
        super().__init__()
        self.conv = _conv(in_chs, out_chs, kernel, stride)
        self.bn = _bn(out_chs)
        self.act = ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class DepthwiseSeparable(_Residual):
    """'ds' block: dw conv + SE + pw conv, residual when shapes allow."""

    def __init__(self, in_chs: int, out_chs: int, kernel: int = 3, stride: int = 1,
                 se_ratio: float = 0.0, act: str = "swish", se_gate: str = "sigmoid",
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.conv_dw = _conv(in_chs, in_chs, kernel, stride, groups=in_chs)
        self.bn1 = _bn(in_chs)
        self.act = ACTS[act]
        self.se = _se(in_chs, make_divisible(in_chs * se_ratio), self.act, se_gate) \
            if se_ratio > 0 else None
        self.conv_pw = _conv(in_chs, out_chs, 1)
        self.bn2 = _bn(out_chs)
        self._init_residual(in_chs, out_chs, stride, drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            x = self.se(x)
        return self._finish(self.bn2(self.conv_pw(x)), shortcut)


class InvertedResidual(_Residual):
    """'ir' block (MBConv): pw expand + dw + SE + pw project. MobileNetV3
    (``se_from_exp``) takes the SE width from the expanded channels and a
    ReLU inside the SE."""

    def __init__(self, in_chs: int, out_chs: int, kernel: int = 3, stride: int = 1,
                 exp_ratio: float = 6.0, se_ratio: float = 0.0, act: str = "swish",
                 se_gate: str = "sigmoid", se_from_exp: bool = False,
                 drop_path_rate: float = 0.0):
        super().__init__()
        mid = make_divisible(in_chs * exp_ratio)
        self.act = ACTS[act]
        if mid != in_chs:
            self.conv_pw = _conv(in_chs, mid, 1)
            self.bn1 = _bn(mid)
        else:
            self.conv_pw = self.bn1 = None
        self.conv_dw = _conv(mid, mid, kernel, stride, groups=mid)
        self.bn2 = _bn(mid)
        self.se = None
        if se_ratio > 0:
            base = mid if se_from_exp else in_chs
            self.se = _se(mid, make_divisible(base * se_ratio),
                          F.relu if se_from_exp else self.act, se_gate)
        self.conv_pwl = _conv(mid, out_chs, 1)
        self.bn3 = _bn(out_chs)
        self._init_residual(in_chs, out_chs, stride, drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.conv_pw is not None:
            x = self.act(self.bn1(self.conv_pw(x)))
        x = self.act(self.bn2(self.conv_dw(x)))
        if self.se is not None:
            x = self.se(x)
        return self._finish(self.bn3(self.conv_pwl(x)), shortcut)


class EdgeResidual(_Residual):
    """'er' block (FusedMBConv, EfficientNet-V2 / edge stages)."""

    def __init__(self, in_chs: int, out_chs: int, kernel: int = 3, stride: int = 1,
                 exp_ratio: float = 4.0, se_ratio: float = 0.0, act: str = "swish",
                 drop_path_rate: float = 0.0):
        super().__init__()
        mid = make_divisible(in_chs * exp_ratio)
        self.act = ACTS[act]
        self.conv_exp = _conv(in_chs, mid, kernel, stride)
        self.bn1 = _bn(mid)
        self.se = _se(mid, make_divisible(in_chs * se_ratio), self.act) \
            if se_ratio > 0 else None
        self.conv_pwl = _conv(mid, out_chs, 1)
        self.bn2 = _bn(out_chs)
        self._init_residual(in_chs, out_chs, stride, drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv_exp(x)))
        if self.se is not None:
            x = self.se(x)
        return self._finish(self.bn2(self.conv_pwl(x)), shortcut)


class MixedInvertedResidual(_Residual):
    """'mx' block (MixNet MixConv): an inverted residual whose depthwise stage
    splits the channels over several kernel sizes, the remainder going to the
    last one."""

    def __init__(self, in_chs: int, out_chs: int,
                 kernel: Union[int, Sequence[int]] = (3, 5, 7), stride: int = 1,
                 exp_ratio: float = 6.0, se_ratio: float = 0.0, act: str = "swish",
                 se_gate: str = "sigmoid", drop_path_rate: float = 0.0):
        super().__init__()
        kernels = tuple(kernel) if isinstance(kernel, (tuple, list)) else (kernel,)
        mid = make_divisible(in_chs * exp_ratio)
        self.act = ACTS[act]
        if mid != in_chs:
            self.conv_pw = _conv(in_chs, mid, 1)
            self.bn1 = _bn(mid)
        else:
            self.conv_pw = self.bn1 = None
        base = mid // len(kernels)
        self.splits = [base] * (len(kernels) - 1) + [mid - base * (len(kernels) - 1)]
        for i, (k, ch) in enumerate(zip(kernels, self.splits)):
            self.add_module(f"conv_dw_{i}", _conv(ch, ch, k, stride, groups=ch))
        self.bn2 = _bn(mid)
        self.se = _se(mid, make_divisible(in_chs * se_ratio), self.act, se_gate) \
            if se_ratio > 0 else None
        self.conv_pwl = _conv(mid, out_chs, 1)
        self.bn3 = _bn(out_chs)
        self._init_residual(in_chs, out_chs, stride, drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.conv_pw is not None:
            x = self.act(self.bn1(self.conv_pw(x)))
        parts = torch.split(x, self.splits, dim=1)
        x = torch.cat([getattr(self, f"conv_dw_{i}")(part) for i, part in enumerate(parts)],
                      dim=1)
        x = self.act(self.bn2(x))
        if self.se is not None:
            x = self.se(x)
        return self._finish(self.bn3(self.conv_pwl(x)), shortcut)


BLOCKS = {
    "cn": ConvBnActBlock,
    "ds": DepthwiseSeparable,
    "ir": InvertedResidual,
    "er": EdgeResidual,
    "mx": MixedInvertedResidual,
}
