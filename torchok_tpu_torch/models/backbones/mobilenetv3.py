"""MobileNetV3 / LCNet backbones (reference:
torchok/models/backbones/mobilenetv3.py:108, timm-derived; port of
``torchok_tpu.models.backbones.mobilenetv3``).

The stage-table builder of the EfficientNet family with a per-stage
activation, hard-swish / hard-sigmoid gating, the SE width of the ``ir``
blocks taken from the expanded channels (with a ReLU inside the SE), and the
efficient-head layout: the final 1x1 conv runs before pooling as the
backbone's output (``conv_head``/``bn2``). NCHW in and out.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.backbones.efficientnet import StageTableNet
from torchok_tpu_torch.models.backbones.efficientnet_blocks import round_channels

# (block, repeats, kernel, stride, exp_ratio, channels, se_ratio, act)
MOBILENETV3_LARGE_ARCH = (
    ("ds", 1, 3, 1, 1.0, 16, 0.0, "relu"),
    ("ir", 2, 3, 2, 4.0, 24, 0.0, "relu"),
    ("ir", 3, 5, 2, 3.0, 40, 0.25, "relu"),
    ("ir", 4, 3, 2, 6.0, 80, 0.0, "hard_swish"),
    ("ir", 2, 3, 1, 6.0, 112, 0.25, "hard_swish"),
    ("ir", 3, 5, 2, 6.0, 160, 0.25, "hard_swish"),
)

MOBILENETV3_SMALL_ARCH = (
    ("ds", 1, 3, 2, 1.0, 16, 0.25, "relu"),
    ("ir", 2, 3, 2, 4.5, 24, 0.0, "relu"),
    ("ir", 3, 5, 2, 6.0, 40, 0.25, "hard_swish"),
    ("ir", 2, 3, 1, 6.0, 48, 0.25, "hard_swish"),
    ("ir", 3, 5, 2, 6.0, 96, 0.25, "hard_swish"),
)

LCNET_ARCH = (
    ("ds", 1, 3, 1, 1.0, 32, 0.0, "hard_swish"),
    ("ds", 2, 3, 2, 1.0, 64, 0.0, "hard_swish"),
    ("ds", 2, 3, 2, 1.0, 128, 0.0, "hard_swish"),
    ("ds", 1, 3, 2, 1.0, 256, 0.0, "hard_swish"),
    ("ds", 5, 5, 1, 1.0, 256, 0.0, "hard_swish"),
    ("ds", 2, 5, 2, 1.0, 512, 0.25, "hard_swish"),
)


class MobileNetV3(StageTableNet):
    def __init__(self, arch: Sequence[tuple] = MOBILENETV3_LARGE_ARCH, width_mult: float = 1.0,
                 in_channels: int = 3, stem_size: int = 16, num_features: int = 960,
                 act: str = "hard_swish", se_gate: str = "hard_sigmoid",
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.arch = tuple(arch)
        self.width_mult = width_mult
        self.stem_size, self.num_features = stem_size, num_features
        self.se_gate = se_gate
        self._build(in_channels, act, drop_path_rate)

    def _scaled_arch(self) -> List[Tuple]:
        return [(b, r, k, s, e, round_channels(c, self.width_mult), se, act)
                for (b, r, k, s, e, c, se, act) in self.arch]

    @property
    def _stem_chs(self) -> int:
        return round_channels(self.stem_size, self.width_mult)

    @property
    def _head_chs(self) -> int:
        return round_channels(self.num_features, self.width_mult) \
            if self.width_mult > 1.0 else self.num_features

    def _block_specs(self) -> List[List[Tuple[str, dict]]]:
        specs = []
        for (block, repeats, k, s, e, c, se, act) in self._scaled_arch():
            stage = []
            for b in range(repeats):
                kwargs = dict(out_chs=c, kernel=k, stride=s if b == 0 else 1, act=act,
                              se_ratio=se, se_gate=self.se_gate)
                if block == "ir":
                    kwargs.update(exp_ratio=e, se_from_exp=True)
                stage.append((block, kwargs))
            specs.append(stage)
        return specs


_VARIANTS = {
    "mobilenetv3_large_075": dict(width_mult=0.75),
    "mobilenetv3_large_100": dict(width_mult=1.0),
    "mobilenetv3_rw": dict(width_mult=1.0),
    "mobilenetv3_small_050": dict(arch=MOBILENETV3_SMALL_ARCH, width_mult=0.5,
                                  num_features=576),
    "mobilenetv3_small_075": dict(arch=MOBILENETV3_SMALL_ARCH, width_mult=0.75,
                                  num_features=576),
    "mobilenetv3_small_100": dict(arch=MOBILENETV3_SMALL_ARCH, width_mult=1.0,
                                  num_features=576),
    "tf_mobilenetv3_large_100": dict(width_mult=1.0),
    "tf_mobilenetv3_small_100": dict(arch=MOBILENETV3_SMALL_ARCH, width_mult=1.0,
                                     num_features=576),
    "lcnet_035": dict(arch=LCNET_ARCH, width_mult=0.35, stem_size=16, num_features=1280),
    "lcnet_050": dict(arch=LCNET_ARCH, width_mult=0.5, stem_size=16, num_features=1280),
    "lcnet_075": dict(arch=LCNET_ARCH, width_mult=0.75, stem_size=16, num_features=1280),
    "lcnet_100": dict(arch=LCNET_ARCH, width_mult=1.0, stem_size=16, num_features=1280),
    "lcnet_150": dict(arch=LCNET_ARCH, width_mult=1.5, stem_size=16, num_features=1280),
}


# "minimal" variants: all-3x3 kernels, no SE, plain relu (the TF minimalistic
# ports); derived mechanically from the base tables
def _minimalize(arch):
    return tuple((b, r, 3, s, e, c, 0.0, "relu")
                 for (b, r, k, s, e, c, _se, _act) in arch)


_VARIANTS.update({
    "tf_mobilenetv3_large_075": dict(width_mult=0.75),
    "tf_mobilenetv3_small_075": dict(arch=MOBILENETV3_SMALL_ARCH, width_mult=0.75,
                                     num_features=576),
    "tf_mobilenetv3_large_minimal_100": dict(
        arch=_minimalize(MOBILENETV3_LARGE_ARCH), width_mult=1.0, act="relu"),
    "tf_mobilenetv3_small_minimal_100": dict(
        arch=_minimalize(MOBILENETV3_SMALL_ARCH), width_mult=1.0, act="relu",
        num_features=576),
    # weight-provenance variants (ImageNet-21k MIIL pretraining)
    "mobilenetv3_large_100_miil": dict(width_mult=1.0),
    "mobilenetv3_large_100_miil_in21k": dict(width_mult=1.0),
})


def _entry(name: str) -> Callable[..., MobileNetV3]:
    def fn(pretrained: bool = False, in_channels: int = 3, **kwargs) -> MobileNetV3:
        if pretrained:
            raise NotImplementedError(
                f"{name}: pretrained weights are not ported yet; carry Flax weights "
                "over with torchok_tpu_torch.utils.flax_convert and resume_path")
        return MobileNetV3(in_channels=in_channels, **{**_VARIANTS[name], **kwargs})
    fn.__name__ = name
    fn.__doc__ = f"MobileNetV3-family variant '{name}'."
    BACKBONES.register_class(fn, name=name)
    return fn


for _name in _VARIANTS:
    _entry(_name)
