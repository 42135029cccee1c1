"""EfficientNet family backbone (B0-B8, V2, lite, TinyNet, MNasNet,
MobileNetV2, EfficientNet-EdgeTPU, MixNet, FBNet; reference:
torchok/models/backbones/efficientnet.py:506, timm-derived; port of
``torchok_tpu.models.backbones.efficientnet``).

A declarative stage table: each stage = (block, repeats, kernel, stride,
exp_ratio, channels, se_ratio); width and depth multipliers scale the table
per variant. NCHW in and out. Feature pyramid (``forward_features``): the
input, the map before each stride-2 stage, and the head conv's output.
Module names are the JAX package's (``conv_stem``/``bn1``,
``blocks.{stage}.{block}``, ``conv_head``/``bn2``), which
``torchok_tpu.utils.torch_convert.map_efficientnet`` accepts.

The JAX EfficientNet reaches no Pallas kernel (its convs and norms are left
to XLA), so this one reaches no hand-written kernel either. The fused
inference MBConv block written for B0's shapes is the op
``ops.mbconv_fused``, driven by its probe as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.base import BaseBackbone
from torchok_tpu_torch.models.backbones.efficientnet_blocks import (ACTS, BLOCKS, _bn, _conv,
                                                                     round_channels)
from torchok_tpu_torch.models.backbones.resnet import init_like_flax

# (block, repeats, kernel, stride, exp_ratio, channels, se_ratio)
EFFICIENTNET_ARCH = (
    ("ds", 1, 3, 1, 1.0, 16, 0.25),
    ("ir", 2, 3, 2, 6.0, 24, 0.25),
    ("ir", 2, 5, 2, 6.0, 40, 0.25),
    ("ir", 3, 3, 2, 6.0, 80, 0.25),
    ("ir", 3, 5, 1, 6.0, 112, 0.25),
    ("ir", 4, 5, 2, 6.0, 192, 0.25),
    ("ir", 1, 3, 1, 6.0, 320, 0.25),
)

EFFICIENTNET_LITE_ARCH = tuple(
    (b, r, k, s, e, c, 0.0) for (b, r, k, s, e, c, _) in EFFICIENTNET_ARCH
)

EFFICIENTNETV2_S_ARCH = (
    ("cn", 2, 3, 1, 1.0, 24, 0.0),
    ("er", 4, 3, 2, 4.0, 48, 0.0),
    ("er", 4, 3, 2, 4.0, 64, 0.0),
    ("ir", 6, 3, 2, 4.0, 128, 0.25),
    ("ir", 9, 3, 1, 6.0, 160, 0.25),
    ("ir", 15, 3, 2, 6.0, 256, 0.25),
)

EFFICIENTNETV2_M_ARCH = (
    ("cn", 3, 3, 1, 1.0, 24, 0.0),
    ("er", 5, 3, 2, 4.0, 48, 0.0),
    ("er", 5, 3, 2, 4.0, 80, 0.0),
    ("ir", 7, 3, 2, 4.0, 160, 0.25),
    ("ir", 14, 3, 1, 6.0, 176, 0.25),
    ("ir", 18, 3, 2, 6.0, 304, 0.25),
    ("ir", 5, 3, 1, 6.0, 512, 0.25),
)

EFFICIENTNETV2_L_ARCH = (
    ("cn", 4, 3, 1, 1.0, 32, 0.0),
    ("er", 7, 3, 2, 4.0, 64, 0.0),
    ("er", 7, 3, 2, 4.0, 96, 0.0),
    ("ir", 10, 3, 2, 4.0, 192, 0.25),
    ("ir", 19, 3, 1, 6.0, 224, 0.25),
    ("ir", 25, 3, 2, 6.0, 384, 0.25),
    ("ir", 7, 3, 1, 6.0, 640, 0.25),
)

MOBILENETV2_ARCH = (
    ("ds", 1, 3, 1, 1.0, 16, 0.0),
    ("ir", 2, 3, 2, 6.0, 24, 0.0),
    ("ir", 3, 3, 2, 6.0, 32, 0.0),
    ("ir", 4, 3, 2, 6.0, 64, 0.0),
    ("ir", 3, 3, 1, 6.0, 96, 0.0),
    ("ir", 3, 3, 2, 6.0, 160, 0.0),
    ("ir", 1, 3, 1, 6.0, 320, 0.0),
)

MNASNET_A1_ARCH = (
    ("ds", 1, 3, 1, 1.0, 16, 0.0),
    ("ir", 2, 3, 2, 6.0, 24, 0.0),
    ("ir", 3, 5, 2, 3.0, 40, 0.25),
    ("ir", 4, 3, 2, 6.0, 80, 0.0),
    ("ir", 2, 3, 1, 6.0, 112, 0.25),
    ("ir", 3, 5, 2, 6.0, 160, 0.25),
    ("ir", 1, 3, 1, 6.0, 320, 0.0),
)

MNASNET_B1_ARCH = (
    ("ds", 1, 3, 1, 1.0, 16, 0.0),
    ("ir", 3, 3, 2, 3.0, 24, 0.0),
    ("ir", 3, 5, 2, 3.0, 40, 0.0),
    ("ir", 3, 5, 2, 6.0, 80, 0.0),
    ("ir", 2, 3, 1, 6.0, 96, 0.0),
    ("ir", 4, 5, 2, 6.0, 192, 0.0),
    ("ir", 1, 3, 1, 6.0, 320, 0.0),
)


class StageTableNet(BaseBackbone):
    """What EfficientNet and MobileNetV3 share: a stem conv, the stages of
    blocks a table gives, a 1x1 head conv. Subclasses give
    :meth:`_block_specs` (per stage: the block name and its keywords) and the
    stem and head widths."""

    def _build(self, in_channels: int, act: str, drop_path_rate: float) -> None:
        self.act = ACTS[act]
        self.conv_stem = _conv(in_channels, self._stem_chs, 3, 2)
        self.bn1 = _bn(self._stem_chs)
        specs = self._block_specs()
        total = sum(len(stage) for stage in specs)
        cur, block_idx = self._stem_chs, 0
        self.downsample_before: List[bool] = []  # stages whose first block has stride > 1
        stages = []
        for stage in specs:
            blocks = []
            for b, (block, kwargs) in enumerate(stage):
                if block != "cn":
                    kwargs["drop_path_rate"] = drop_path_rate * block_idx / max(total - 1, 1)
                blocks.append(BLOCKS[block](cur, **kwargs))
                cur = kwargs["out_chs"]
                block_idx += 1
            self.downsample_before.append(stage[0][1]["stride"] > 1)
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.ModuleList(stages)
        self.conv_head = _conv(cur, self._head_chs, 1)
        self.bn2 = _bn(self._head_chs)

    def _block_specs(self) -> List[List[Tuple[str, dict]]]:
        raise NotImplementedError

    @property
    def _stem_chs(self) -> int:
        raise NotImplementedError

    @property
    def _head_chs(self) -> int:
        raise NotImplementedError

    @property
    def out_channels(self) -> int:
        return self._head_chs

    @property
    def out_encoder_channels(self) -> Tuple[int, ...]:
        """Channels of the pyramid entries after the input: the map before
        each stride-2 stage, then the head conv's output."""
        chans = []
        cur = self._stem_chs
        for stage in self._scaled_arch():
            if stage[3] > 1:
                chans.append(cur)
            cur = stage[5]
        chans.append(self._head_chs)
        return tuple(chans)

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [x]
        x = self.act(self.bn1(self.conv_stem(x)))
        for stage, downsamples in zip(self.blocks, self.downsample_before):
            if downsamples:
                feats.append(x)  # output at the previous stride level
            x = stage(x)
        feats.append(self.act(self.bn2(self.conv_head(x))))
        return feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_features(x)[-1]

    def get_stages(self, stage: int) -> List[str]:
        return ["conv_stem", "bn1"] + [f"blocks.{i}." for i in range(stage)]

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial law (``_conv_init``: variance scaling 2.0
        over fan_out, truncated normal; the SE convs Flax's default)."""
        init_like_flax(self, generator)


class EfficientNet(StageTableNet):
    def __init__(self, arch: Sequence[tuple] = EFFICIENTNET_ARCH, width_mult: float = 1.0,
                 depth_mult: float = 1.0, in_channels: int = 3, stem_size: int = 32,
                 fix_stem: bool = False, num_features: int = 1280, fix_head: bool = False,
                 act: str = "swish", drop_path_rate: float = 0.0, round_chs_divisor: int = 8):
        super().__init__()
        self.arch = tuple(arch)
        self.width_mult, self.depth_mult = width_mult, depth_mult
        self.stem_size, self.fix_stem = stem_size, fix_stem
        self.num_features, self.fix_head = num_features, fix_head
        self.round_chs_divisor = round_chs_divisor
        self.act_name = act
        self._build(in_channels, act, drop_path_rate)

    def _scaled_arch(self) -> List[Tuple]:
        out = []
        for (block, repeats, k, s, e, c, se) in self.arch:
            c2 = round_channels(c, self.width_mult, self.round_chs_divisor)
            r2 = int(math.ceil(repeats * self.depth_mult))
            out.append((block, r2, k, s, e, c2, se))
        return out

    @property
    def _stem_chs(self) -> int:
        if self.fix_stem:
            return self.stem_size
        return round_channels(self.stem_size, self.width_mult, self.round_chs_divisor)

    @property
    def _head_chs(self) -> int:
        if self.fix_head:
            return self.num_features
        return round_channels(self.num_features, self.width_mult,
                              self.round_chs_divisor) if self.width_mult > 1.0 \
            else self.num_features

    def _block_specs(self) -> List[List[Tuple[str, dict]]]:
        specs = []
        for (block, repeats, k, s, e, c, se) in self._scaled_arch():
            stage = []
            for b in range(repeats):
                kwargs = dict(out_chs=c, kernel=k, stride=s if b == 0 else 1, act=self.act_name)
                if block != "cn":
                    kwargs["se_ratio"] = se
                if block in ("ir", "er", "mx"):
                    kwargs["exp_ratio"] = e
                stage.append((block, kwargs))
            specs.append(stage)
        return specs


def _b(width, depth, **kw):
    return dict(width_mult=width, depth_mult=depth, **kw)


_VARIANTS = {
    "efficientnet_b0": _b(1.0, 1.0),
    "efficientnet_b1": _b(1.0, 1.1),
    "efficientnet_b2": _b(1.1, 1.2),
    "efficientnet_b3": _b(1.2, 1.4),
    "efficientnet_b4": _b(1.4, 1.8),
    "efficientnet_b5": _b(1.6, 2.2),
    "efficientnet_b6": _b(1.8, 2.6),
    "efficientnet_b7": _b(2.0, 3.1),
    "efficientnet_b8": _b(2.2, 3.6),
    "efficientnet_l2": _b(4.3, 5.3),
    "tf_efficientnet_b0": _b(1.0, 1.0),
    "tf_efficientnet_b1": _b(1.0, 1.1),
    "tf_efficientnet_b2": _b(1.1, 1.2),
    "tf_efficientnet_b3": _b(1.2, 1.4),
    "tf_efficientnet_b4": _b(1.4, 1.8),
    "tf_efficientnet_b5": _b(1.6, 2.2),
    "tf_efficientnet_b6": _b(1.8, 2.6),
    "tf_efficientnet_b7": _b(2.0, 3.1),
    "efficientnet_lite0": _b(1.0, 1.0, arch=EFFICIENTNET_LITE_ARCH, act="relu6",
                             fix_stem=True, fix_head=True),
    "efficientnet_lite1": _b(1.0, 1.1, arch=EFFICIENTNET_LITE_ARCH, act="relu6",
                             fix_stem=True, fix_head=True),
    "efficientnet_lite2": _b(1.1, 1.2, arch=EFFICIENTNET_LITE_ARCH, act="relu6",
                             fix_stem=True, fix_head=True),
    "efficientnet_lite3": _b(1.2, 1.4, arch=EFFICIENTNET_LITE_ARCH, act="relu6",
                             fix_stem=True, fix_head=True),
    "efficientnet_lite4": _b(1.4, 1.8, arch=EFFICIENTNET_LITE_ARCH, act="relu6",
                             fix_stem=True, fix_head=True),
    "efficientnetv2_s": dict(arch=EFFICIENTNETV2_S_ARCH, stem_size=24, fix_stem=True),
    "efficientnetv2_m": dict(arch=EFFICIENTNETV2_M_ARCH, stem_size=24, fix_stem=True),
    "efficientnetv2_l": dict(arch=EFFICIENTNETV2_L_ARCH, stem_size=32, fix_stem=True),
    "efficientnetv2_rw_s": dict(arch=EFFICIENTNETV2_S_ARCH, stem_size=24, fix_stem=True),
    "tf_efficientnetv2_s": dict(arch=EFFICIENTNETV2_S_ARCH, stem_size=24, fix_stem=True),
    "tf_efficientnetv2_m": dict(arch=EFFICIENTNETV2_M_ARCH, stem_size=24, fix_stem=True),
    "tf_efficientnetv2_l": dict(arch=EFFICIENTNETV2_L_ARCH, stem_size=32, fix_stem=True),
    "mobilenetv2_100": dict(arch=MOBILENETV2_ARCH, act="relu6", stem_size=32),
    "mobilenetv2_110d": dict(arch=MOBILENETV2_ARCH, act="relu6", stem_size=32,
                             width_mult=1.1, depth_mult=1.2),
    "mobilenetv2_120d": dict(arch=MOBILENETV2_ARCH, act="relu6", stem_size=32,
                             width_mult=1.2, depth_mult=1.4),
    "mobilenetv2_140": dict(arch=MOBILENETV2_ARCH, act="relu6", stem_size=32,
                            width_mult=1.4),
    "mnasnet_100": dict(arch=MNASNET_B1_ARCH, act="relu", stem_size=32),
    "semnasnet_075": dict(arch=MNASNET_A1_ARCH, act="relu", stem_size=32, width_mult=0.75),
    "semnasnet_100": dict(arch=MNASNET_A1_ARCH, act="relu", stem_size=32),
    "semnasnet_140": dict(arch=MNASNET_A1_ARCH, act="relu", stem_size=32, width_mult=1.4),
    "mnasnet_small": dict(arch=MNASNET_B1_ARCH, act="relu", stem_size=8,
                          width_mult=0.5),
    "tinynet_a": _b(1.0, 1.2),
    "tinynet_b": _b(0.75, 1.1),
    "tinynet_c": _b(0.54, 0.85),
    "tinynet_d": _b(0.54, 0.695),
    "tinynet_e": _b(0.51, 0.6),
}

# ---------------------------------------------------------------------------
# Extended variant space (completing the reference's registered-name surface,
# reference: torchok/models/backbones/efficientnet.py — 119 entrypoints).
#
# Notes on fidelity:
# * tf_* names are the TensorFlow ports; they differ from the base variants
#   only in padding convention and pretrained-weight provenance — here, as in
#   the JAX package, they share the architecture and its symmetric padding.
# * _ap / _ns / _in21k / _in21ft1k / _475 / b2a / b3a / _miil suffixes are
#   weight-provenance variants of an identical architecture.
# * cc_* (CondConv) and *_gn / *_evos (GroupNorm / EvoNorm) originals swap
#   conv/norm internals; registered here, as in the JAX package, on the base
#   architecture (dense convs + BN).
# * NAS per-block specs (FBNet, SPNASNet, MixNet, FBNetV3) are expressed at
#   stage granularity in our declarative table format.
# ---------------------------------------------------------------------------

EFFICIENTNET_EDGE_ARCH = (
    ("er", 1, 3, 1, 4.0, 24, 0.0),
    ("er", 2, 3, 2, 8.0, 32, 0.0),
    ("er", 4, 3, 2, 8.0, 48, 0.0),
    ("ir", 5, 5, 2, 8.0, 96, 0.0),
    ("ir", 4, 5, 1, 8.0, 144, 0.0),
    ("ir", 2, 5, 2, 8.0, 192, 0.0),
)

EFFICIENTNETV2_BASE_ARCH = (
    ("cn", 1, 3, 1, 1.0, 16, 0.0),
    ("er", 2, 3, 2, 4.0, 32, 0.0),
    ("er", 2, 3, 2, 4.0, 48, 0.0),
    ("ir", 3, 3, 2, 4.0, 96, 0.25),
    ("ir", 5, 3, 1, 6.0, 112, 0.25),
    ("ir", 8, 3, 2, 6.0, 192, 0.25),
)

EFFICIENTNETV2_XL_ARCH = (
    ("cn", 4, 3, 1, 1.0, 32, 0.0),
    ("er", 8, 3, 2, 4.0, 64, 0.0),
    ("er", 8, 3, 2, 4.0, 96, 0.0),
    ("ir", 16, 3, 2, 4.0, 192, 0.25),
    ("ir", 24, 3, 1, 6.0, 256, 0.25),
    ("ir", 32, 3, 2, 6.0, 512, 0.25),
    ("ir", 8, 3, 1, 6.0, 640, 0.25),
)

EFFICIENTNETV2_RW_T_ARCH = (
    ("cn", 2, 3, 1, 1.0, 24, 0.0),
    ("er", 4, 3, 2, 4.0, 40, 0.0),
    ("er", 4, 3, 2, 4.0, 48, 0.0),
    ("ir", 6, 3, 2, 4.0, 104, 0.25),
    ("ir", 9, 3, 1, 6.0, 128, 0.25),
    ("ir", 14, 3, 2, 6.0, 208, 0.25),
)

MIXNET_S_ARCH = (
    ("ds", 1, 3, 1, 1.0, 16, 0.0),
    ("ir", 2, 3, 2, 6.0, 24, 0.0),
    ("mx", 4, (3, 5, 7), 2, 6.0, 40, 0.5),
    ("mx", 3, (3, 5, 7), 2, 6.0, 80, 0.25),
    ("mx", 3, (3, 5, 7, 9), 1, 6.0, 120, 0.5),
    ("mx", 3, (3, 5, 7, 9, 11), 2, 6.0, 200, 0.5),
)

MIXNET_M_ARCH = (
    ("ds", 1, 3, 1, 1.0, 24, 0.0),
    ("mx", 2, (3, 5, 7), 2, 6.0, 32, 0.0),
    ("mx", 4, (3, 5, 7, 9), 2, 6.0, 40, 0.5),
    ("mx", 4, (3, 5, 7), 2, 6.0, 80, 0.25),
    ("mx", 4, (3, 5, 7, 9), 1, 6.0, 120, 0.5),
    ("mx", 4, (3, 5, 7, 9), 2, 6.0, 200, 0.5),
)

FBNETC_ARCH = (
    ("ir", 1, 3, 1, 1.0, 16, 0.0),
    ("ir", 3, 3, 2, 6.0, 24, 0.0),
    ("ir", 4, 5, 2, 6.0, 32, 0.0),
    ("ir", 4, 5, 2, 6.0, 64, 0.0),
    ("ir", 4, 5, 1, 6.0, 112, 0.0),
    ("ir", 4, 5, 2, 6.0, 184, 0.0),
    ("ir", 1, 3, 1, 6.0, 352, 0.0),
)

SPNASNET_ARCH = (
    ("ds", 1, 3, 1, 1.0, 16, 0.0),
    ("ir", 3, 3, 2, 3.0, 24, 0.0),
    ("ir", 4, 5, 2, 3.0, 40, 0.0),
    ("ir", 4, 5, 2, 6.0, 80, 0.0),
    ("ir", 4, 5, 1, 6.0, 96, 0.0),
    ("ir", 4, 5, 2, 6.0, 192, 0.0),
    ("ir", 1, 3, 1, 6.0, 320, 0.0),
)

FBNETV3_B_ARCH = (
    ("ds", 2, 3, 1, 1.0, 16, 0.0),
    ("ir", 3, 3, 2, 4.0, 24, 0.0),
    ("ir", 3, 5, 2, 4.0, 40, 0.25),
    ("ir", 4, 5, 2, 5.0, 72, 0.0),
    ("ir", 4, 3, 1, 5.0, 120, 0.25),
    ("ir", 6, 3, 2, 6.0, 184, 0.25),
    ("ir", 1, 5, 1, 6.0, 224, 0.25),
)

FBNETV3_D_ARCH = (
    ("ds", 2, 3, 1, 1.0, 16, 0.0),
    ("ir", 3, 3, 2, 4.0, 24, 0.0),
    ("ir", 4, 3, 2, 4.0, 40, 0.25),
    ("ir", 4, 3, 2, 5.0, 72, 0.0),
    ("ir", 5, 3, 1, 5.0, 128, 0.25),
    ("ir", 7, 3, 2, 6.0, 208, 0.25),
    ("ir", 1, 5, 1, 6.0, 240, 0.25),
)

FBNETV3_G_ARCH = (
    ("ds", 3, 3, 1, 1.0, 24, 0.0),
    ("ir", 5, 3, 2, 4.0, 40, 0.0),
    ("ir", 5, 5, 2, 4.0, 56, 0.25),
    ("ir", 5, 5, 2, 5.0, 104, 0.0),
    ("ir", 8, 3, 1, 5.0, 160, 0.25),
    ("ir", 9, 3, 2, 6.0, 264, 0.25),
    ("ir", 3, 5, 1, 6.0, 288, 0.25),
)

_EXTRA_VARIANTS = {}

# TF ports / weight-provenance variants of the B-scales
_TF_SCALES = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
    "b8": (2.2, 3.6),
}
for _scale, (_w, _d) in _TF_SCALES.items():
    for _suffix in ("_ap", "_ns"):
        _EXTRA_VARIANTS[f"tf_efficientnet_{_scale}{_suffix}"] = _b(_w, _d)
_EXTRA_VARIANTS["tf_efficientnet_b8"] = _b(2.2, 3.6)
_EXTRA_VARIANTS["tf_efficientnet_l2_ns"] = _b(4.3, 5.3)
_EXTRA_VARIANTS["tf_efficientnet_l2_ns_475"] = _b(4.3, 5.3)
_EXTRA_VARIANTS["efficientnet_b2a"] = _b(1.1, 1.2)
_EXTRA_VARIANTS["efficientnet_b3a"] = _b(1.2, 1.4)

# GroupNorm / EvoNorm experiments (architecture-equal registrations, see note)
for _gn_name, _gn_scale in [("efficientnet_b0_gn", (1.0, 1.0)),
                            ("efficientnet_b0_g8_gn", (1.0, 1.0)),
                            ("efficientnet_b0_g16_evos", (1.0, 1.0)),
                            ("efficientnet_b3_gn", (1.2, 1.4)),
                            ("efficientnet_b3_g8_gn", (1.2, 1.4))]:
    _EXTRA_VARIANTS[_gn_name] = _b(*_gn_scale)

# CondConv variants (dense-conv approximation, see note)
for _cc in ("efficientnet_cc_b0_4e", "efficientnet_cc_b0_8e",
            "efficientnet_cc_b1_8e", "tf_efficientnet_cc_b0_4e",
            "tf_efficientnet_cc_b0_8e", "tf_efficientnet_cc_b1_8e"):
    _EXTRA_VARIANTS[_cc] = _b(1.0, 1.1 if "b1" in _cc else 1.0)

# Edge family
for _pfx in ("", "tf_"):
    _EXTRA_VARIANTS[f"{_pfx}efficientnet_es"] = dict(
        arch=EFFICIENTNET_EDGE_ARCH, act="relu")
    _EXTRA_VARIANTS[f"{_pfx}efficientnet_em"] = dict(
        arch=EFFICIENTNET_EDGE_ARCH, act="relu", width_mult=1.0, depth_mult=1.1)
    _EXTRA_VARIANTS[f"{_pfx}efficientnet_el"] = dict(
        arch=EFFICIENTNET_EDGE_ARCH, act="relu", width_mult=1.2, depth_mult=1.4)

# lite TF ports
for _i, (_w, _d) in enumerate([(1.0, 1.0), (1.0, 1.1), (1.1, 1.2),
                               (1.2, 1.4), (1.4, 1.8)]):
    _EXTRA_VARIANTS[f"tf_efficientnet_lite{_i}"] = _b(
        _w, _d, arch=EFFICIENTNET_LITE_ARCH, act="relu6",
        fix_stem=True, fix_head=True)

# V2 base scales + weight variants
for _i, (_w, _d) in enumerate([(1.0, 1.0), (1.0, 1.1), (1.1, 1.2), (1.2, 1.4)]):
    _EXTRA_VARIANTS[f"tf_efficientnetv2_b{_i}"] = dict(
        arch=EFFICIENTNETV2_BASE_ARCH, stem_size=32, fix_stem=True,
        width_mult=_w, depth_mult=_d)
for _sz, _arch, _stem in [("s", EFFICIENTNETV2_S_ARCH, 24),
                          ("m", EFFICIENTNETV2_M_ARCH, 24),
                          ("l", EFFICIENTNETV2_L_ARCH, 32),
                          ("xl", EFFICIENTNETV2_XL_ARCH, 32)]:
    for _sfx in ("_in21k", "_in21ft1k"):
        _EXTRA_VARIANTS[f"tf_efficientnetv2_{_sz}{_sfx}"] = dict(
            arch=_arch, stem_size=_stem, fix_stem=True)
_EXTRA_VARIANTS["efficientnetv2_xl"] = dict(
    arch=EFFICIENTNETV2_XL_ARCH, stem_size=32, fix_stem=True)
_EXTRA_VARIANTS["tf_efficientnetv2_xl"] = dict(
    arch=EFFICIENTNETV2_XL_ARCH, stem_size=32, fix_stem=True)
_EXTRA_VARIANTS["efficientnetv2_rw_t"] = dict(
    arch=EFFICIENTNETV2_RW_T_ARCH, stem_size=24, fix_stem=True,
    num_features=1024)
_EXTRA_VARIANTS["gc_efficientnetv2_rw_t"] = dict(
    arch=EFFICIENTNETV2_RW_T_ARCH, stem_size=24, fix_stem=True,
    num_features=1024)
_EXTRA_VARIANTS["efficientnetv2_rw_m"] = dict(
    arch=EFFICIENTNETV2_M_ARCH, stem_size=24, fix_stem=True)

# MixNet
_EXTRA_VARIANTS["mixnet_s"] = dict(arch=MIXNET_S_ARCH, stem_size=16,
                                   fix_stem=True, num_features=1536, fix_head=True)
_EXTRA_VARIANTS["mixnet_m"] = dict(arch=MIXNET_M_ARCH, stem_size=24,
                                   fix_stem=True, num_features=1536, fix_head=True)
_EXTRA_VARIANTS["mixnet_l"] = dict(arch=MIXNET_M_ARCH, stem_size=24,
                                   fix_stem=True, num_features=1536, fix_head=True,
                                   width_mult=1.3)
_EXTRA_VARIANTS["mixnet_xl"] = dict(arch=MIXNET_M_ARCH, stem_size=24,
                                    fix_stem=True, num_features=1536, fix_head=True,
                                    width_mult=1.6, depth_mult=1.2)
_EXTRA_VARIANTS["mixnet_xxl"] = dict(arch=MIXNET_M_ARCH, stem_size=24,
                                     fix_stem=True, num_features=1536, fix_head=True,
                                     width_mult=2.4, depth_mult=1.3)
for _m in ("s", "m", "l"):
    _EXTRA_VARIANTS[f"tf_mixnet_{_m}"] = dict(_EXTRA_VARIANTS[f"mixnet_{_m}"])

# MNasNet width series + canonical-name aliases
_EXTRA_VARIANTS["mnasnet_050"] = dict(arch=MNASNET_B1_ARCH, act="relu",
                                      stem_size=32, width_mult=0.5)
_EXTRA_VARIANTS["mnasnet_075"] = dict(arch=MNASNET_B1_ARCH, act="relu",
                                      stem_size=32, width_mult=0.75)
_EXTRA_VARIANTS["mnasnet_140"] = dict(arch=MNASNET_B1_ARCH, act="relu",
                                      stem_size=32, width_mult=1.4)
_EXTRA_VARIANTS["mnasnet_a1"] = dict(arch=MNASNET_A1_ARCH, act="relu", stem_size=32)
_EXTRA_VARIANTS["mnasnet_b1"] = dict(arch=MNASNET_B1_ARCH, act="relu", stem_size=32)
_EXTRA_VARIANTS["semnasnet_050"] = dict(arch=MNASNET_A1_ARCH, act="relu",
                                        stem_size=32, width_mult=0.5)

# MobileNetV2 width series
for _w, _nm in [(0.35, "mobilenetv2_035"), (0.5, "mobilenetv2_050"),
                (0.75, "mobilenetv2_075")]:
    _EXTRA_VARIANTS[_nm] = dict(arch=MOBILENETV2_ARCH, act="relu6",
                                stem_size=32, width_mult=_w)

# FBNet / SPNASNet / FBNetV3
_EXTRA_VARIANTS["fbnetc_100"] = dict(arch=FBNETC_ARCH, act="relu",
                                     stem_size=16, fix_stem=True,
                                     num_features=1984, fix_head=True)
_EXTRA_VARIANTS["spnasnet_100"] = dict(arch=SPNASNET_ARCH, act="relu",
                                       stem_size=32)
_EXTRA_VARIANTS["fbnetv3_b"] = dict(arch=FBNETV3_B_ARCH, act="hard_swish",
                                    stem_size=16, fix_stem=True,
                                    num_features=1344, fix_head=True)
_EXTRA_VARIANTS["fbnetv3_d"] = dict(arch=FBNETV3_D_ARCH, act="hard_swish",
                                    stem_size=24, fix_stem=True,
                                    num_features=1440, fix_head=True)
_EXTRA_VARIANTS["fbnetv3_g"] = dict(arch=FBNETV3_G_ARCH, act="hard_swish",
                                    stem_size=32, fix_stem=True,
                                    num_features=1728, fix_head=True)

_VARIANTS.update(_EXTRA_VARIANTS)


def _entry(name: str) -> Callable[..., EfficientNet]:
    def fn(pretrained: bool = False, in_channels: int = 3, **kwargs) -> EfficientNet:
        if pretrained:
            raise NotImplementedError(
                f"{name}: pretrained weights are not ported yet; carry Flax weights "
                "over with torchok_tpu_torch.utils.flax_convert and resume_path")
        return EfficientNet(in_channels=in_channels, **{**_VARIANTS[name], **kwargs})
    fn.__name__ = name
    fn.__doc__ = f"EfficientNet-family variant '{name}'."
    BACKBONES.register_class(fn, name=name)
    return fn


for _name in _VARIANTS:
    _entry(_name)
