"""ResNet / ResNeXt / SE-ResNet / ECA-ResNet backbone family (reference:
torchok/models/backbones/resnet.py:408, timm-derived; port of
``torchok_tpu.models.backbones.resnet``).

NCHW in and out, as the port's other backbones. Module and parameter names
are timm's (``conv1``/``bn1``, the deep stem as ``conv1.{0,3,6}`` with its
norms at ``conv1.{1,4}``, ``maxpool.{0,1}`` for the conv that replaces the
stem pool, ``layer{X}.{Y}.conv{N}``/``bn{N}``/``se``, ``downsample.{0,1}`` or,
behind an average pool, ``downsample.{1,2}``), so ``state_dict()`` keys are
the ones ``torchok_tpu.utils.torch_convert.map_resnet`` expects. BatchNorm is
the port's :class:`BatchNorm2d`, which leaves the running statistics the JAX
package leaves; ``norm="gn"`` is ``GroupNorm(32)`` with Flax's ``epsilon=1e-6``.

The JAX ResNet reaches no Pallas kernel (its convs and norms are left to
XLA), so this one reaches no hand-written kernel either: convs and norms go
to PyTorch's library calls. The 1x1-conv and 3x3-conv kernels written for
ResNet-50's shapes are the ops ``conv_bn.matmul_bn`` and
``conv_gemm.conv3x3_gemm``, driven by their probes as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.base import BaseBackbone
from torchok_tpu_torch.models.modules.blocks.se import EcaModule, SEModule
from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
from torchok_tpu_torch.ops.common import DropPath
from torchok_tpu_torch.ops.image import avg_pool, blur_pool, max_pool

# flax's variance_scaling(2.0, "fan_out", "truncated_normal"): a normal cut
# at two standard deviations, rescaled to the asked variance
_TRUNC_STD = 0.87962566103423978


def _norm(kind: str, channels: int, zero_init: bool = False) -> nn.Module:
    """'bn' (default) or 'gn' (resnet*_gn variants: GroupNorm(32))."""
    if kind == "gn":
        norm = nn.GroupNorm(32, channels, eps=1e-6)
        if zero_init:
            nn.init.zeros_(norm.weight)
        norm.zero_init = zero_init
        return norm
    return BatchNorm2d(channels, zero_init=zero_init)


def _conv(in_channels: int, out_channels: int, kernel: int, stride: int = 1, dilation: int = 1,
          groups: int = 1) -> nn.Conv2d:
    pad = (kernel - 1) // 2 * dilation
    return nn.Conv2d(in_channels, out_channels, kernel, stride, pad, dilation, groups, bias=False)


def _attn(kind: Optional[str], channels: int) -> Optional[nn.Module]:
    if kind == "se":
        return SEModule(channels)
    if kind == "eca":
        return EcaModule()
    if kind is not None:
        raise ValueError(f"attn must be None, 'se' or 'eca', got {kind!r}")
    return None


class AvgPool(nn.Module):
    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool(x, window=self.stride, stride=self.stride, padding=0)


def downsample(in_channels: int, out_channels: int, stride: int = 1, dilation: int = 1,
               avg_down: bool = False, kernel_size: int = 1, norm: str = "bn") -> nn.Sequential:
    """The shortcut's projection. ``avg_down`` keeps timm's slot 0 for the
    pool (an identity at stride 1), so the conv and norm sit at 1 and 2."""
    if avg_down:
        pool = AvgPool(stride) if stride > 1 else nn.Identity()
        if stride > 1:
            conv = _conv(in_channels, out_channels, 1, 1)
        else:
            conv = _conv(in_channels, out_channels, kernel_size, stride,
                         dilation if kernel_size > 1 else 1)
        return nn.Sequential(pool, conv, _norm(norm, out_channels))
    conv = _conv(in_channels, out_channels, kernel_size, stride,
                 dilation if kernel_size > 1 else 1)
    return nn.Sequential(conv, _norm(norm, out_channels))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1, aa: bool = False,
                 norm: str = "bn", dilation: int = 1, first_dilation: Optional[int] = None,
                 use_downsample: bool = False, avg_down: bool = False, down_kernel_size: int = 1,
                 reduce_first: int = 1, attn: Optional[str] = None, drop_path_rate: float = 0.0,
                 zero_init_last: bool = True):
        super().__init__()
        first_planes = planes // reduce_first
        out_planes = planes * self.expansion
        fd = first_dilation or dilation
        self.blur_stride = stride if aa and stride > 1 else 0
        self.conv1 = _conv(in_channels, first_planes, 3, 1 if self.blur_stride else stride, fd)
        self.bn1 = _norm(norm, first_planes)
        self.conv2 = _conv(first_planes, out_planes, 3, 1, dilation)
        self.bn2 = _norm(norm, out_planes, zero_init=zero_init_last)
        self.se = _attn(attn, out_planes)
        self.drop_path = DropPath(drop_path_rate)
        self.downsample = downsample(in_channels, out_planes, stride, dilation, avg_down,
                                     down_kernel_size, norm) if use_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        out = F.relu(self.bn1(self.conv1(x)))
        if self.blur_stride:
            out = blur_pool(out, stride=self.blur_stride)
        out = self.bn2(self.conv2(out))
        if self.se is not None:
            out = self.se(out)
        out = self.drop_path(out)
        if self.downsample is not None:
            shortcut = self.downsample(x)
        return F.relu(out + shortcut)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1, aa: bool = False,
                 norm: str = "bn", dilation: int = 1, first_dilation: Optional[int] = None,
                 use_downsample: bool = False, avg_down: bool = False, down_kernel_size: int = 1,
                 reduce_first: int = 1, cardinality: int = 1, base_width: int = 64,
                 attn: Optional[str] = None, drop_path_rate: float = 0.0,
                 zero_init_last: bool = True):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64)) * cardinality)
        first_planes = width // reduce_first
        out_planes = planes * self.expansion
        fd = first_dilation or dilation
        self.blur_stride = stride if aa and stride > 1 else 0
        self.conv1 = _conv(in_channels, first_planes, 1)
        self.bn1 = _norm(norm, first_planes)
        self.conv2 = _conv(first_planes, width, 3, 1 if self.blur_stride else stride, fd,
                           groups=cardinality)
        self.bn2 = _norm(norm, width)
        self.conv3 = _conv(width, out_planes, 1)
        self.bn3 = _norm(norm, out_planes, zero_init=zero_init_last)
        self.se = _attn(attn, out_planes)
        self.drop_path = DropPath(drop_path_rate)
        self.downsample = downsample(in_channels, out_planes, stride, dilation, avg_down,
                                     down_kernel_size, norm) if use_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.blur_stride:
            out = blur_pool(out, stride=self.blur_stride)
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        out = self.drop_path(out)
        if self.downsample is not None:
            shortcut = self.downsample(x)
        return F.relu(out + shortcut)


class ResNet(BaseBackbone):
    """Configurable ResNet-family backbone (NCHW).

    Feature pyramid (``forward_features``): ``[input, act1, layer1..layer4]``
    with strides (1, 2, 4, 8, 16, 32) at ``output_stride=32``.
    """

    def __init__(self, block: str = "basic", layers: Sequence[int] = (2, 2, 2, 2),
                 in_channels: int = 3, output_stride: int = 32, cardinality: int = 1,
                 base_width: int = 64, stem_width: int = 64, stem_type: str = "",
                 replace_stem_pool: bool = False, block_reduce_first: int = 1,
                 down_kernel_size: int = 1, avg_down: bool = False, attn: Optional[str] = None,
                 aa: bool = False, norm: str = "bn", space_to_depth_stem: bool = False,
                 drop_path_rate: float = 0.0, zero_init_last: bool = True):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {block!r}")
        if stem_type not in ("", "deep", "deep_tiered"):
            raise ValueError(f"stem_type must be '', 'deep' or 'deep_tiered', got {stem_type!r}")
        if norm not in ("bn", "gn"):
            raise ValueError(f"norm must be 'bn' or 'gn', got {norm!r}")
        if space_to_depth_stem and "deep" in stem_type:
            raise ValueError("space_to_depth_stem applies to the plain 7x7 stem only "
                             f"(stem_type={stem_type!r} uses 3x3 convs)")
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.layers_per_stage = tuple(layers)
        self.output_stride = output_stride
        self.aa = aa
        self.space_to_depth_stem = space_to_depth_stem
        self.expansion = block_cls.expansion
        self.stem_channels = stem_width * 2 if "deep" in stem_type else stem_width

        if "deep" in stem_type:
            if stem_type == "deep_tiered":
                chs = (3 * (stem_width // 4), stem_width, stem_width * 2)
            else:
                chs = (stem_width, stem_width, stem_width * 2)
            self.conv1 = nn.Sequential(
                _conv(in_channels, chs[0], 3, 2), BatchNorm2d(chs[0]), nn.ReLU(),
                _conv(chs[0], chs[1], 3, 1), BatchNorm2d(chs[1]), nn.ReLU(),
                _conv(chs[1], chs[2], 3, 1))
        elif space_to_depth_stem:
            # 2x2 space-to-depth, then a stride-1 4x4 conv padded (2, 1): the
            # 7x7/s2/pad3 conv exactly, when its kernel is repacked
            self.conv1 = nn.Conv2d(4 * in_channels, stem_width, 4, 1, 0, bias=False)
        else:
            self.conv1 = nn.Conv2d(in_channels, stem_width, 7, 2, 3, bias=False)
        self.bn1 = _norm(norm, self.stem_channels)
        self.maxpool = None
        if replace_stem_pool:
            self.maxpool = nn.Sequential(_conv(self.stem_channels, self.stem_channels, 3, 2),
                                         BatchNorm2d(self.stem_channels), nn.ReLU())

        in_planes = self.stem_channels
        total_blocks = sum(layers)
        block_idx = 0
        for stage_idx, (spec, depth) in enumerate(zip(self._stage_plan(), layers)):
            blocks = []
            for b in range(depth):
                stride = spec["stride"] if b == 0 else 1
                out_planes = spec["planes"] * self.expansion
                kwargs = dict(
                    planes=spec["planes"], stride=stride, dilation=spec["dilation"],
                    first_dilation=spec["first_dilation"] if b == 0 else spec["dilation"],
                    use_downsample=b == 0 and (stride != 1 or in_planes != out_planes),
                    avg_down=avg_down, down_kernel_size=down_kernel_size,
                    reduce_first=block_reduce_first, attn=attn, aa=aa, norm=norm,
                    drop_path_rate=drop_path_rate * block_idx / max(total_blocks - 1, 1),
                    zero_init_last=zero_init_last)
                if block_cls is Bottleneck:
                    kwargs.update(cardinality=cardinality, base_width=base_width)
                blocks.append(block_cls(in_planes, **kwargs))
                in_planes = out_planes
                block_idx += 1
            setattr(self, f"layer{stage_idx + 1}", nn.Sequential(*blocks))

    @property
    def out_encoder_channels(self) -> Tuple[int, ...]:
        exp = self.expansion
        return (self.stem_channels, 64 * exp, 128 * exp, 256 * exp, 512 * exp)

    @property
    def out_channels(self) -> int:
        return 512 * self.expansion

    def _stage_plan(self) -> List[dict]:
        """Static per-stage plan: (planes, stride, dilation, first_dilation)."""
        plan = []
        net_stride, dilation = 4, 1
        prev_dilation = 1
        for i, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if i == 0 else 2
            if net_stride >= self.output_stride and stride > 1:
                dilation *= stride
                stride = 1
            else:
                net_stride *= stride
            plan.append(dict(planes=planes, stride=stride, dilation=dilation,
                             first_dilation=prev_dilation))
            prev_dilation = dilation
        return plan

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        if self.space_to_depth_stem:
            n, c, h, w = x.shape
            if h % 2 or w % 2:
                raise ValueError(f"space_to_depth_stem needs even input H/W, got {h}x{w}")
            # channel (a*2 + b)*C + ch holds pixel (2i + a, 2j + b)
            z = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
            x = F.pad(z.reshape(n, 4 * c, h // 2, w // 2), (2, 1, 2, 1))
        return F.relu(self.bn1(self.conv1(x)))

    def forward_features(self, x: torch.Tensor, rfp_feats: Optional[List] = None
                         ) -> List[torch.Tensor]:
        if rfp_feats is not None:
            raise NotImplementedError("rfp_feats (the detection RFP feedback) is not ported yet")
        features = [x]
        x = self._stem(x)
        features.append(x)
        if self.maxpool is not None:
            x = self.maxpool(x)
        elif self.aa:
            # anti-aliased stem pool: dense max then blur-subsample
            x = blur_pool(max_pool(x, window=3, stride=1, padding=1), stride=2)
        else:
            x = max_pool(x, window=3, stride=2, padding=1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            features.append(x)
        return features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_features(x)[-1]

    def get_stages(self, stage: int) -> List[str]:
        prefixes = ["conv1", "bn1", "maxpool"]
        for i in range(1, min(stage, 4) + 1):
            prefixes.append(f"layer{i}.")
        return prefixes

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial law, drawn from ``generator``: conv
        kernels variance scaling 2.0 over fan_out with a truncated normal, SE
        and ECA convs LeCun normal with zero biases (Flax's default), norms at
        one and zero, the last norm of each block at zero with
        ``zero_init_last``, running statistics at zero and one."""
        attn_convs = {id(m) for mod in self.modules() if isinstance(mod, (SEModule, EcaModule))
                      for m in mod.modules() if isinstance(m, (nn.Conv1d, nn.Conv2d))}
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                receptive = math.prod(m.kernel_size)
                if id(m) in attn_convs:
                    fan = m.in_channels // m.groups * receptive
                    std = math.sqrt(1.0 / fan) / _TRUNC_STD
                else:
                    fan = m.out_channels * receptive
                    std = math.sqrt(2.0 / fan) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.GroupNorm):
                nn.init.constant_(m.weight, 0.0 if getattr(m, "zero_init", False) else 1.0)
                nn.init.zeros_(m.bias)


_B, _BT = "basic", "bottleneck"
_D = dict(stem_width=32, stem_type="deep", avg_down=True)
_T = dict(stem_width=32, stem_type="deep_tiered", avg_down=True)
_X4, _X8 = dict(cardinality=32, base_width=4), dict(cardinality=32, base_width=8)
_RS = dict(_D, replace_stem_pool=True, attn="se")
_VARIANTS: Dict[str, dict] = {
    # classic
    "resnet10t": dict(block=_B, layers=(1, 1, 1, 1), **_T),
    "resnet14t": dict(block=_BT, layers=(1, 1, 1, 1), **_T),
    "resnet18": dict(block=_B, layers=(2, 2, 2, 2)),
    "resnet18d": dict(block=_B, layers=(2, 2, 2, 2), **_D),
    "resnet26": dict(block=_BT, layers=(2, 2, 2, 2)),
    "resnet26d": dict(block=_BT, layers=(2, 2, 2, 2), **_D),
    "resnet26t": dict(block=_BT, layers=(2, 2, 2, 2), **_T),
    "resnet34": dict(block=_B, layers=(3, 4, 6, 3)),
    "resnet34d": dict(block=_B, layers=(3, 4, 6, 3), **_D),
    "resnet50": dict(block=_BT, layers=(3, 4, 6, 3)),
    "resnet50d": dict(block=_BT, layers=(3, 4, 6, 3), **_D),
    "resnet101": dict(block=_BT, layers=(3, 4, 23, 3)),
    "resnet101d": dict(block=_BT, layers=(3, 4, 23, 3), **_D),
    "resnet152": dict(block=_BT, layers=(3, 8, 36, 3)),
    "resnet152d": dict(block=_BT, layers=(3, 8, 36, 3), **_D),
    "resnet200d": dict(block=_BT, layers=(3, 24, 36, 3), **_D),
    # wide
    "wide_resnet50_2": dict(block=_BT, layers=(3, 4, 6, 3), base_width=128),
    "wide_resnet101_2": dict(block=_BT, layers=(3, 4, 23, 3), base_width=128),
    # resnext
    "resnext50_32x4d": dict(block=_BT, layers=(3, 4, 6, 3), **_X4),
    "resnext50d_32x4d": dict(block=_BT, layers=(3, 4, 6, 3), **_X4, **_D),
    "resnext101_32x4d": dict(block=_BT, layers=(3, 4, 23, 3), **_X4),
    "resnext101_32x8d": dict(block=_BT, layers=(3, 4, 23, 3), **_X8),
    "resnext101_64x4d": dict(block=_BT, layers=(3, 4, 23, 3), cardinality=64, base_width=4),
    # SE
    "seresnet18": dict(block=_B, layers=(2, 2, 2, 2), attn="se"),
    "seresnet34": dict(block=_B, layers=(3, 4, 6, 3), attn="se"),
    "seresnet50": dict(block=_BT, layers=(3, 4, 6, 3), attn="se"),
    "seresnet101": dict(block=_BT, layers=(3, 4, 23, 3), attn="se"),
    "seresnet152": dict(block=_BT, layers=(3, 8, 36, 3), attn="se"),
    "seresnext26d_32x4d": dict(block=_BT, layers=(2, 2, 2, 2), **_X4, **_D, attn="se"),
    "seresnext50_32x4d": dict(block=_BT, layers=(3, 4, 6, 3), **_X4, attn="se"),
    "seresnext101_32x8d": dict(block=_BT, layers=(3, 4, 23, 3), **_X8, attn="se"),
    # ECA
    "ecaresnet26t": dict(block=_BT, layers=(2, 2, 2, 2), **_T, attn="eca"),
    "ecaresnet50d": dict(block=_BT, layers=(3, 4, 6, 3), **_D, attn="eca"),
    "ecaresnet50t": dict(block=_BT, layers=(3, 4, 6, 3), **_T, attn="eca"),
    "ecaresnet101d": dict(block=_BT, layers=(3, 4, 23, 3), **_D, attn="eca"),
    # ResNet-RS (replace_stem_pool, se)
    "resnetrs50": dict(block=_BT, layers=(3, 4, 6, 3), **_RS),
    "resnetrs101": dict(block=_BT, layers=(3, 4, 23, 3), **_RS),
    "resnetrs152": dict(block=_BT, layers=(3, 8, 36, 3), **_RS),
    "resnetrs200": dict(block=_BT, layers=(3, 24, 36, 3), **_RS),
    "resnetrs270": dict(block=_BT, layers=(4, 29, 53, 4), **_RS),
    "resnetrs350": dict(block=_BT, layers=(4, 36, 72, 4), **_RS),
    "resnetrs420": dict(block=_BT, layers=(4, 44, 87, 4), **_RS),
    # remaining classic / tiered / gn
    "resnet200": dict(block=_BT, layers=(3, 24, 36, 3)),
    "resnet50t": dict(block=_BT, layers=(3, 4, 6, 3), **_T),
    "resnet50_gn": dict(block=_BT, layers=(3, 4, 6, 3), norm="gn"),
    # anti-aliased (blur-pool) variants
    "resnetblur18": dict(block=_B, layers=(2, 2, 2, 2), aa=True),
    "resnetblur50": dict(block=_BT, layers=(3, 4, 6, 3), aa=True),
    "resnetblur50d": dict(block=_BT, layers=(3, 4, 6, 3), **_D, aa=True),
    "resnetblur101d": dict(block=_BT, layers=(3, 4, 23, 3), **_D, aa=True),
    "resnetaa50": dict(block=_BT, layers=(3, 4, 6, 3), aa=True),
    "resnetaa50d": dict(block=_BT, layers=(3, 4, 6, 3), **_D, aa=True),
    "resnetaa101d": dict(block=_BT, layers=(3, 4, 23, 3), **_D, aa=True),
    # SE additions
    "senet154": dict(block=_BT, layers=(3, 8, 36, 3), cardinality=64, base_width=4,
                     stem_type="deep", stem_width=64, down_kernel_size=3,
                     block_reduce_first=2, attn="se"),
    "seresnet50t": dict(block=_BT, layers=(3, 4, 6, 3), **_T, attn="se"),
    "seresnet152d": dict(block=_BT, layers=(3, 8, 36, 3), **_D, attn="se"),
    "seresnet200d": dict(block=_BT, layers=(3, 24, 36, 3), **_D, attn="se"),
    "seresnet269d": dict(block=_BT, layers=(3, 30, 48, 8), **_D, attn="se"),
    "seresnetaa50d": dict(block=_BT, layers=(3, 4, 6, 3), **_D, attn="se", aa=True),
    "seresnext26t_32x4d": dict(block=_BT, layers=(2, 2, 2, 2), **_X4, **_T, attn="se"),
    "seresnext101_32x4d": dict(block=_BT, layers=(3, 4, 23, 3), **_X4, attn="se"),
    "seresnext101d_32x8d": dict(block=_BT, layers=(3, 4, 23, 3), **_X8, **_D, attn="se"),
    "seresnextaa101d_32x8d": dict(block=_BT, layers=(3, 4, 23, 3), **_X8, **_D, attn="se",
                                  aa=True),
    # ECA additions
    "ecaresnet200d": dict(block=_BT, layers=(3, 24, 36, 3), **_D, attn="eca"),
    "ecaresnet269d": dict(block=_BT, layers=(3, 30, 48, 8), **_D, attn="eca"),
    "ecaresnetlight": dict(block=_BT, layers=(1, 1, 11, 3), stem_width=32, avg_down=True,
                           attn="eca"),
    "ecaresnext26t_32x4d": dict(block=_BT, layers=(2, 2, 2, 2), **_X4, **_T, attn="eca"),
    "ecaresnext50t_32x4d": dict(block=_BT, layers=(2, 2, 2, 2), **_X4, **_T, attn="eca"),
}
# weight-provenance alias (timm registers 26t and 26tn identically)
_VARIANTS["seresnext26tn_32x4d"] = _VARIANTS["seresnext26t_32x4d"]

# Weight-variant aliases: the architecture of a base variant (or its own),
# differing only in where pretrained weights came from.
_WEIGHT_ALIASES = {
    "ssl_resnet18": "resnet18", "swsl_resnet18": "resnet18",
    "ssl_resnet50": "resnet50", "swsl_resnet50": "resnet50",
    "tv_resnet34": "resnet34", "tv_resnet50": "resnet50",
    "tv_resnet101": "resnet101", "tv_resnet152": "resnet152",
    "ssl_resnext50_32x4d": "resnext50_32x4d",
    "swsl_resnext50_32x4d": "resnext50_32x4d",
    "tv_resnext50_32x4d": "resnext50_32x4d",
    "ssl_resnext101_32x4d": "resnext101_32x4d",
    "swsl_resnext101_32x4d": "resnext101_32x4d",
    "ssl_resnext101_32x8d": "resnext101_32x8d",
    "swsl_resnext101_32x8d": "resnext101_32x8d",
    "ig_resnext101_32x8d": "resnext101_32x8d",
    "ssl_resnext101_32x16d": dict(block=_BT, layers=(3, 4, 23, 3), cardinality=32, base_width=16),
    "swsl_resnext101_32x16d": dict(block=_BT, layers=(3, 4, 23, 3), cardinality=32, base_width=16),
    "ig_resnext101_32x16d": dict(block=_BT, layers=(3, 4, 23, 3), cardinality=32, base_width=16),
    "ig_resnext101_32x32d": dict(block=_BT, layers=(3, 4, 23, 3), cardinality=32, base_width=32),
    "ig_resnext101_32x48d": dict(block=_BT, layers=(3, 4, 23, 3), cardinality=32, base_width=48),
}


def variant_config(name: str) -> dict:
    """The constructor keywords of a registered variant or weight alias."""
    if name in _VARIANTS:
        return dict(_VARIANTS[name])
    base = _WEIGHT_ALIASES[name]
    return dict(_VARIANTS[base] if isinstance(base, str) else base)


def _entry(name: str):
    def fn(pretrained: bool = False, in_channels: int = 3, **kwargs) -> ResNet:
        if pretrained:
            raise NotImplementedError(
                f"{name}: pretrained weights are not ported yet; carry Flax weights "
                "over with torchok_tpu_torch.utils.flax_convert and resume_path")
        return ResNet(in_channels=in_channels, **{**variant_config(name), **kwargs})
    fn.__name__ = name
    fn.__doc__ = f"ResNet-family variant '{name}' (config: {variant_config(name)})."
    BACKBONES.register_class(fn, name=name)
    return fn


for _name in (*_VARIANTS, *_WEIGHT_ALIASES):
    _entry(_name)
