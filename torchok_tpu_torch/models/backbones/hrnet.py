"""HRNet backbone (reference: torchok/models/backbones/hrnet.py:49-322,
timm-derived; port of ``torchok_tpu.models.backbones.hrnet``).

NCHW in and out. ``forward`` returns the list of the four branch maps
(strides 4, 8, 16, 32); ``forward_features`` prepends the input;
``out_channels`` / ``out_encoder_channels`` are the stage-4 branch widths.
The HRNet necks consume the list.

Module and parameter names are timm's (``conv1``/``bn1``/``conv2``/``bn2``,
``layer1.{i}``, ``transition{n}.{i}.{0,1}`` where a branch changes width and
``transition{n}.{i}.0.{0,1}`` for a new branch, ``stage{s}.{m}.branches.{b}.{k}``,
``stage{s}.{m}.fuse_layers.{i}.{j}.{0,1}`` from a lower branch and
``.{i}.{j}.{step}.{0,1}`` from a higher one), so ``state_dict()`` keys are
the ones ``torchok_tpu.utils.torch_convert.map_hrnet`` expects. Every
conditional of the JAX module (a first block's shortcut projection, a
transition's conv) is decided here at construction from the channel counts.

A lower branch is upsampled as the JAX package does, bilinearly with
half-pixel centres, two taps and no antialiasing (timm upsamples nearest).
The JAX HRNet reaches no Pallas kernel, so this one reaches no hand-written
kernel: convs, norms and the resampling are library calls.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.base import BaseBackbone
from torchok_tpu_torch.models.backbones.resnet import BasicBlock, Bottleneck, _conv, init_like_flax
from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
from torchok_tpu_torch.ops.image import resize_bilinear_nchw


def _stage_cfg(modules, branches, block, blocks, channels):
    return dict(NUM_MODULES=modules, NUM_BRANCHES=branches, BLOCK=block,
                NUM_BLOCKS=blocks, NUM_CHANNELS=channels)


def _hrnet_cfg(stem, s1_blocks, s1_ch, s2, s3, s4):
    return dict(STEM_WIDTH=stem,
                STAGE1=_stage_cfg(1, 1, "BOTTLENECK", [s1_blocks], [s1_ch]),
                STAGE2=_stage_cfg(*s2), STAGE3=_stage_cfg(*s3), STAGE4=_stage_cfg(*s4))


def _w_cfg(w, s2_mods=1, s3_mods=4, s4_mods=3, blocks=4, s1_blocks=4):
    b = [blocks] * 4
    return _hrnet_cfg(
        64, s1_blocks, 64,
        (s2_mods, 2, "BASIC", b[:2], [w, 2 * w]),
        (s3_mods, 3, "BASIC", b[:3], [w, 2 * w, 4 * w]),
        (s4_mods, 4, "BASIC", b[:4], [w, 2 * w, 4 * w, 8 * w]),
    )


CFGS: Dict[str, Dict] = {
    "hrnet_w18_small": _hrnet_cfg(
        64, 1, 32,
        (1, 2, "BASIC", [2, 2], [16, 32]),
        (1, 3, "BASIC", [2, 2, 2], [16, 32, 64]),
        (1, 4, "BASIC", [2, 2, 2, 2], [16, 32, 64, 128])),
    "hrnet_w18_small_v2": _hrnet_cfg(
        64, 2, 64,
        (1, 2, "BASIC", [2, 2], [18, 36]),
        (3, 3, "BASIC", [2, 2, 2], [18, 36, 72]),
        (2, 4, "BASIC", [2, 2, 2, 2], [18, 36, 72, 144])),
    "hrnet_w18": _w_cfg(18),
    "hrnet_w30": _w_cfg(30),
    "hrnet_w32": _w_cfg(32),
    "hrnet_w40": _w_cfg(40),
    "hrnet_w44": _w_cfg(44),
    "hrnet_w48": _w_cfg(48),
    "hrnet_w64": _w_cfg(64),
}

_BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _conv_bn(in_channels: int, out_channels: int, kernel: int, stride: int = 1,
             relu: bool = False) -> nn.Sequential:
    layers = [_conv(in_channels, out_channels, kernel, stride), BatchNorm2d(out_channels)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class FuseLayer(nn.ModuleList):
    """Multi-resolution fusion: output branch i sums every input branch,
    a lower one through a 1x1 conv, norm and upsample, a higher one through
    a chain of stride-2 3x3 convs (ReLU between them), then a ReLU. Entry
    ``[i][j]`` is timm's ``fuse_layers[i][j]``."""

    def __init__(self, widths: Sequence[int]):
        rows = []
        for i, oc in enumerate(widths):
            row = []
            for j, ic in enumerate(widths):
                if j > i:
                    row.append(_conv_bn(ic, oc, 1))
                elif j < i:
                    row.append(nn.Sequential(*[
                        _conv_bn(ic, oc if s == i - j - 1 else ic, 3, 2, relu=s < i - j - 1)
                        for s in range(i - j)]))
                else:
                    row.append(nn.Identity())
            rows.append(nn.ModuleList(row))
        super().__init__(rows)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i, row in enumerate(self):
            acc = None
            for j, (x, layer) in enumerate(zip(xs, row)):
                y = layer(x)
                if j > i:
                    y = resize_bilinear_nchw(y, xs[i].shape[2:])
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRModule(nn.Module):
    """Parallel branches of residual blocks, then the fusion (none on a
    single branch)."""

    def __init__(self, in_widths: Sequence[int], block: str, num_blocks: Sequence[int],
                 num_channels: Sequence[int]):
        super().__init__()
        blk = _BLOCKS[block]
        branches = []
        for b, planes in enumerate(num_channels):
            width, layers = in_widths[b], []
            for _ in range(num_blocks[b]):
                layers.append(blk(width, planes, use_downsample=width != planes * blk.expansion))
                width = planes * blk.expansion
            branches.append(nn.Sequential(*layers))
        self.branches = nn.ModuleList(branches)
        self.out_widths = [c * blk.expansion for c in num_channels]
        self.fuse_layers = FuseLayer(self.out_widths) if len(num_channels) > 1 else None

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        return outs if self.fuse_layers is None else self.fuse_layers(outs)


class Transition(nn.ModuleList):
    """Adapts the branch count and widths between stages: a 3x3 conv where
    an existing branch changes width, a stride-2 3x3 conv from the deepest
    branch for a new one (nested, as timm nests it)."""

    def __init__(self, in_widths: Sequence[int], out_widths: Sequence[int]):
        layers = []
        for i, oc in enumerate(out_widths):
            if i < len(in_widths):
                changes = in_widths[i] != oc
                layers.append(_conv_bn(in_widths[i], oc, 3, relu=True) if changes
                              else nn.Identity())
            else:
                layers.append(nn.Sequential(_conv_bn(in_widths[-1], oc, 3, 2, relu=True)))
        super().__init__(layers)
        self.num_in = len(in_widths)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [layer(xs[i] if i < self.num_in else xs[-1]) for i, layer in enumerate(self)]


class HighResolutionNet(BaseBackbone):
    def __init__(self, cfg: Dict = None, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        stem = cfg["STEM_WIDTH"]
        self.conv1 = _conv(in_channels, stem, 3, 2)
        self.bn1 = BatchNorm2d(stem)
        self.conv2 = _conv(stem, 64, 3, 2)
        self.bn2 = BatchNorm2d(64)

        s1 = cfg["STAGE1"]
        blk = _BLOCKS[s1["BLOCK"]]
        planes, width, blocks = s1["NUM_CHANNELS"][0], 64, []
        for i in range(s1["NUM_BLOCKS"][0]):
            blocks.append(blk(width, planes,
                              use_downsample=i == 0 and width != planes * blk.expansion))
            width = planes * blk.expansion
        self.layer1 = nn.Sequential(*blocks)

        widths = [width]
        for stage_idx, key in enumerate(("STAGE2", "STAGE3", "STAGE4"), start=2):
            scfg = cfg[key]
            out = [c * _BLOCKS[scfg["BLOCK"]].expansion for c in scfg["NUM_CHANNELS"]]
            setattr(self, f"transition{stage_idx - 1}", Transition(widths, out))
            modules = []
            for _ in range(scfg["NUM_MODULES"]):
                modules.append(HRModule(out, scfg["BLOCK"], scfg["NUM_BLOCKS"],
                                        scfg["NUM_CHANNELS"]))
                out = modules[-1].out_widths
            setattr(self, f"stage{stage_idx}", nn.Sequential(*modules))
            widths = out

    @property
    def out_channels(self) -> List[int]:
        return list(self.cfg["STAGE4"]["NUM_CHANNELS"])

    @property
    def out_encoder_channels(self) -> Tuple[int, ...]:
        return tuple(self.cfg["STAGE4"]["NUM_CHANNELS"])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for stage_idx in (2, 3, 4):
            xs = getattr(self, f"transition{stage_idx - 1}")(xs)
            xs = getattr(self, f"stage{stage_idx}")(xs)
        return xs

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x] + self(x)

    def get_stages(self, stage: int) -> List[str]:
        groups = [["conv1", "bn1", "conv2", "bn2"], ["layer1."],
                  ["transition1.", "stage2."], ["transition2.", "stage3."],
                  ["transition3.", "stage4."]]
        return [p for g in groups[:stage + 1] for p in g]

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial law (:func:`init_like_flax`), the last
        norm of each residual block at zero."""
        init_like_flax(self, generator)


def _entry(name: str):
    def fn(pretrained: bool = False, in_channels: int = 3, **kwargs) -> HighResolutionNet:
        if pretrained:
            raise NotImplementedError(
                f"{name}: pretrained weights are not ported yet; carry Flax weights "
                "over with torchok_tpu_torch.utils.flax_convert and resume_path")
        return HighResolutionNet(cfg=CFGS[name], in_channels=in_channels, **kwargs)
    fn.__name__ = name
    fn.__doc__ = f"HRNet variant '{name}'."
    BACKBONES.register_class(fn, name=name)
    return fn


for _name in CFGS:
    _entry(_name)
