"""GCViT backbone (reference: torchok/models/backbones/gcvit.py:46-242,
global-context ViT, arXiv:2206.09959; port of
``torchok_tpu.models.backbones.gcvit``).

Stages alternate local window self-attention and global window attention: a
query generator downsamples the stage's feature map to one window's worth of
tokens, and those queries attend into each local window's keys and values.
Both kinds run on the unpartitioned spatial map through
``window_attention_spatial`` (the Hopper kernels on a CUDA tensor): local
blocks the plain dot-product op, global blocks the global-query op, the learned
relative position bias taking its gradient from the ops' backward.

Module and parameter names follow timm 0.6 (``stem.conv1``,
``stem.down.{norm1,conv_block,reduction,norm2}``, ``stages.{i}.downsample`` on
the following stage, ``stages.{i}.global_block.blocks.conv{j}``, per block
``attn.{qkv,rel_pos.relative_position_bias_table,proj}`` and ``ls{1,2}.gamma``,
a stage norm on the last stage), so ``state_dict()`` keys are the ones
``torchok_tpu.utils.torch_convert.map_gcvit`` expects. As in ``torchok_tpu``
(and unlike timm's ``.repeat``), each image's windows pair with that image's
own global queries. Tensors are NCHW at the backbone boundary and between
stages, NHWC inside the attention blocks.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.base import BaseBackbone
from torchok_tpu_torch.models.modules.blocks.se import SEModule
from torchok_tpu_torch.models.modules.bricks.mlp import Mlp
from torchok_tpu_torch.ops.common import DropPath, checkpoint_block
from torchok_tpu_torch.ops.image import max_pool
from torchok_tpu_torch.ops.window_attention_dot import window_attention_spatial


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return y.permute(0, 3, 1, 2)


class MbConvBlock(nn.Module):
    """timm gcvit MbConvBlock: dw3x3 + GELU + SE + pw1x1, residual; the convs
    and the SE are bias-free."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 3, padding=1, groups=dim, bias=False)
        self.se = SEModule(dim, rd_ratio=0.25, act=F.gelu, use_bias=False, round_limit=0.0)
        self.conv_pw = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_pw(self.se(F.gelu(self.conv_dw(x))))


class Downsample2d(nn.Module):
    """timm gcvit Downsample2d: norm1 -> MbConv -> stride-2 conv -> norm2."""

    def __init__(self, dim: int, keep_dim: bool = False):
        super().__init__()
        out_dim = dim if keep_dim else 2 * dim
        self.norm1 = LayerNorm2d(dim, eps=1e-5)
        self.conv_block = MbConvBlock(dim)
        self.reduction = nn.Conv2d(dim, out_dim, 3, stride=2, padding=1, bias=False)
        self.norm2 = LayerNorm2d(out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.reduction(self.conv_block(self.norm1(x))))


class Stem(nn.Module):
    """timm gcvit Stem: 3x3 s2 conv (with bias) + keep-dim Downsample2d."""

    def __init__(self, in_channels: int, embed_dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, embed_dim, 3, stride=2, padding=1)
        self.down = Downsample2d(embed_dim, keep_dim=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.conv1(x))


class FeatureBlock(nn.Module):
    """timm gcvit FeatureBlock (the global query generator): ``max(1, levels)``
    MbConv blocks named conv1..convL, each of the first ``levels`` followed by
    a 3x3/s2 max pool."""

    def __init__(self, dim: int, levels: int):
        super().__init__()
        self.levels = levels
        self.blocks = nn.ModuleDict({f"conv{i + 1}": MbConvBlock(dim)
                                     for i in range(max(1, levels))})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.blocks.values()):
            x = conv(x)
            if i < self.levels:
                x = max_pool(x, window=3, stride=2, padding=1)
        return x


def _rel_pos_index(ws: int) -> np.ndarray:
    """Swin-style relative position index, (L, L) into a (2ws-1)^2 table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


class RelPosBias(nn.Module):
    """Learned relative position bias (timm RelPosBias, no prefix tokens):
    ``relative_position_bias_table`` of shape ((2ws-1)^2, heads), zero at init."""

    def __init__(self, window_size: int, num_heads: int):
        super().__init__()
        self.window_size = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("index", torch.from_numpy(_rel_pos_index(window_size).reshape(-1)),
                             persistent=False)

    def forward(self) -> torch.Tensor:
        """The (H, L, L) f32 bias."""
        L = self.window_size ** 2
        bias = self.relative_position_bias_table[self.index]
        return bias.reshape(L, L, -1).permute(2, 0, 1).float()


class WindowAttentionGlobal(nn.Module):
    """Window attention with relative position bias over a (B, Hp, Wp, C)
    map; with ``use_global`` the queries are the image's shared global tokens
    and the projection (still named ``qkv``, timm naming) emits only k and v."""

    def __init__(self, dim: int, num_heads: int, window_size: int, use_global: bool = False,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.use_global = use_global
        self.qkv = nn.Linear(dim, (2 if use_global else 3) * dim, bias=qkv_bias)
        self.rel_pos = RelPosBias(window_size, num_heads)
        self.proj = nn.Linear(dim, dim)
        # applied to the logits inside the op, as the fused kernels do
        self.register_buffer("scale", torch.full((num_heads,), (dim // num_heads) ** -0.5),
                             persistent=False)

    def forward(self, x: torch.Tensor, q_global: Optional[torch.Tensor]) -> torch.Tensor:
        out = window_attention_spatial(self.qkv(x), self.scale, self.rel_pos(),
                                       ws=self.window_size, nheads=self.num_heads,
                                       q_global=q_global if self.use_global else None)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class GlobalContextVitBlock(nn.Module):
    """Pre-norm block over an NHWC map. The window size is the build-time
    constant; a map that is no multiple of it is padded up and cropped back."""

    def __init__(self, dim: int, num_heads: int, window_size: int, use_global: bool = False,
                 mlp_ratio: float = 3.0, qkv_bias: bool = True,
                 layer_scale: Optional[float] = None, drop_path: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttentionGlobal(dim, num_heads, window_size, use_global, qkv_bias)
        self.ls1 = LayerScale(dim, layer_scale) if layer_scale is not None else nn.Identity()
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, layer_scale) if layer_scale is not None else nn.Identity()
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, q_global: torch.Tensor) -> torch.Tensor:
        _, hgt, wdt, _ = x.shape
        ws = self.window_size
        y = self.norm1(x)
        pad_h = (ws - hgt % ws) % ws
        pad_w = (ws - wdt % ws) % ws
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        y = self.attn(y, q_global)
        if pad_h or pad_w:
            y = y[:, :hgt, :wdt]
        x = x + self.drop_path1(self.ls1(y))
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x))))


class GlobalContextVitStage(nn.Module):
    """One stage (timm GlobalContextVitStage): optional leading downsample, a
    FeatureBlock generating the global query tokens, alternating local/global
    blocks, and a stage norm (last stage). NCHW in, NCHW out."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int, feat_size: int,
                 downsample: bool, stage_norm: bool, mlp_ratio: float, qkv_bias: bool,
                 layer_scale: Optional[float], drop_path: Sequence[float]):
        super().__init__()
        self.window_size = ws = max(window_size, 1)
        self.downsample = Downsample2d(dim // 2, keep_dim=False) if downsample else None
        # feat_size is the configured size (a build-time constant, as in
        # timm), so the FeatureBlock's depth never depends on the input
        levels = max(int(math.log2(max(feat_size // ws, 1))), 0)
        self.global_block = FeatureBlock(dim, levels)
        self.blocks = nn.ModuleList([
            GlobalContextVitBlock(dim, num_heads, ws, use_global=blk % 2 == 1,
                                  mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                                  layer_scale=layer_scale, drop_path=drop_path[blk])
            for blk in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-5) if stage_norm else None

    def global_queries(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> the image's (B, ws*ws, C) query tokens: cropped or
        zero-padded to exactly one window."""
        ws = self.window_size
        qg = self.global_block(x).permute(0, 2, 3, 1)[:, :ws, :ws]
        if qg.shape[1] < ws or qg.shape[2] < ws:
            qg = F.pad(qg, (0, 0, 0, ws - qg.shape[2], 0, ws - qg.shape[1]))
        return qg.reshape(x.shape[0], ws * ws, x.shape[1])


class GlobalContextVit(BaseBackbone):
    def __init__(self, in_channels: int = 3, embed_dim: int = 64,
                 depths: Sequence[int] = (3, 4, 19, 5), num_heads: Sequence[int] = (2, 4, 8, 16),
                 img_size: Union[int, Sequence[int]] = 224,
                 window_size: Optional[Sequence[int]] = None,
                 load_relative_position_bias_table: bool = True,
                 window_ratio: Sequence[int] = (32, 32, 16, 32), mlp_ratio: float = 3.0,
                 qkv_bias: bool = True, layer_scale: Optional[float] = None,
                 drop_path_rate: float = 0.0, grad_checkpointing: bool = False):
        super().__init__()
        # ``load_relative_position_bias_table`` belongs to pretrained loading,
        # which is not ported: accepted for recipe compatibility
        self.grad_checkpointing = grad_checkpointing
        self.dropout_generator: Optional[torch.Generator] = None
        self.encoder_channels = [int(embed_dim * 2 ** i) for i in range(len(depths))]
        self.stem = Stem(in_channels, embed_dim)
        img_min = (min(int(v) for v in img_size) if isinstance(img_size, (tuple, list))
                   else int(img_size))
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        stages, block_idx = [], 0
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            # a fixed window_size wins over the ratio; either way the window is
            # sized from the configured img_size, not from the input
            ws = (window_size[stage] if window_size is not None
                  else max(img_min // window_ratio[stage], 1))
            stages.append(GlobalContextVitStage(
                self.encoder_channels[stage], depth, heads, ws,
                feat_size=max(img_min // 4 // (2 ** stage), 1), downsample=stage != 0,
                stage_norm=stage == len(depths) - 1, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                layer_scale=layer_scale, drop_path=dpr[block_idx:block_idx + depth]))
            block_idx += depth
        self.stages = nn.ModuleList(stages)

    @property
    def out_encoder_channels(self) -> Tuple[int, ...]:
        return tuple(self.encoder_channels)

    @property
    def out_channels(self) -> int:
        return self.encoder_channels[-1]

    def get_stages(self, stage: int) -> List[str]:
        """Parameter-name prefixes of the stem plus the first ``stage`` stages."""
        return ["stem"] + [f"stages.{i}" for i in range(stage)]

    def _block(self, blk: GlobalContextVitBlock, x: torch.Tensor,
               q_global: torch.Tensor) -> torch.Tensor:
        if not (self.grad_checkpointing and self.training and torch.is_grad_enabled()):
            return blk(x, q_global)
        return checkpoint_block(blk, self.dropout_generator, x, q_global)

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        x = self.stem(x)
        for stage in self.stages:
            if stage.downsample is not None:
                x = stage.downsample(x)
            q_global = stage.global_queries(x)
            x = x.permute(0, 2, 3, 1)
            for blk in stage.blocks:
                x = self._block(blk, x, q_global)
            if stage.norm is not None:
                x = stage.norm(x)
            x = x.permute(0, 3, 1, 2)
            features.append(x)
        return features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_features(x)[-1]


def _entry(name: str, **cfg):
    def fn(pretrained: bool = False, in_channels: int = 3, **kwargs) -> GlobalContextVit:
        if pretrained:
            raise NotImplementedError(
                f"{name}: pretrained weights are not ported yet; carry Flax weights "
                "over with torchok_tpu_torch.utils.flax_convert and resume_path")
        return GlobalContextVit(in_channels=in_channels, **{**cfg, **kwargs})
    fn.__name__ = name
    fn.__doc__ = f"GCViT variant '{name}'."
    BACKBONES.register_class(fn, name=name)
    return fn


# reference gcvit.py:196-242 (gcvit_small/base: embed_dim/heads up,
# mlp_ratio=2, layer_scale=1e-5)
_VARIANTS = {
    "gcvit_xxtiny": dict(embed_dim=64, depths=(2, 2, 6, 2), num_heads=(2, 4, 8, 16)),
    "gcvit_xtiny": dict(embed_dim=64, depths=(3, 4, 6, 5), num_heads=(2, 4, 8, 16)),
    "gcvit_tiny": dict(embed_dim=64, depths=(3, 4, 19, 5), num_heads=(2, 4, 8, 16)),
    "gcvit_small": dict(embed_dim=96, depths=(3, 4, 19, 5), num_heads=(3, 6, 12, 24),
                        mlp_ratio=2.0, layer_scale=1e-5),
    "gcvit_base": dict(embed_dim=128, depths=(3, 4, 19, 5), num_heads=(4, 8, 16, 32),
                       mlp_ratio=2.0, layer_scale=1e-5),
}

for _name, _cfg in _VARIANTS.items():
    _entry(_name, **_cfg)
