"""Swin Transformer V2 backbone (reference:
torchok/models/backbones/swin.py:84-283; port of
``torchok_tpu.models.backbones.swin``).

SwinV2 specifics preserved: cosine attention with learned per-head log
temperature, continuous relative position bias (2-layer cpb_mlp on
log-spaced coords), post-norm residual blocks, shifted windows with additive
-100 masks between regions, per-stage feature norms.

The window attention runs on the unpartitioned spatial map through
``fused_swin_attention`` (the Hopper kernel on a CUDA tensor): each block
rolls the thin C-wide activations once before qkv and back after proj, and
the op does partition, attention and reverse in one pass. Module and
parameter names follow timm, so ``state_dict()`` keys are the ones
``torchok_tpu.utils.torch_convert.map_swin`` expects. Tensors are NCHW at
the backbone boundary.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.base import BaseBackbone
from torchok_tpu_torch.models.modules.bricks.mlp import Mlp
from torchok_tpu_torch.ops.common import Dropout, DropPath, checkpoint_block
from torchok_tpu_torch.ops.swin_attention import fused_swin_attention


def _relative_coords_table(ws: int, pretrained_ws: int) -> np.ndarray:
    """Log-spaced relative coordinate table for the cpb MLP, ((2w-1)^2, 2)."""
    coords = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"), axis=-1)
    denom = (pretrained_ws - 1) if pretrained_ws > 0 else (ws - 1)
    if denom > 0:
        table = table / denom
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


def _relative_position_index(ws: int) -> np.ndarray:
    """(L, L) indices into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_window_region_ids(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Region id per window position for shifted-window attention, (nW, L)."""
    img_mask = np.zeros((h, w), np.int64)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(h // ws, ws, w // ws, ws)
    return m.transpose(0, 2, 1, 3).reshape(-1, ws * ws)


def shift_window_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """Compact (nW, L, L) additive mask: -100 between regions, else 0."""
    ids = torch.from_numpy(_shift_window_region_ids(h, w, ws, shift))
    return torch.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0)


class WindowAttention(nn.Module):
    """SwinV2 window attention over a (pre-rolled, padded) spatial map
    (B, Hp, Wp, C) with windows of ``ws`` (the block's effective window,
    which shrinks to the map when the map is smaller; no parameter depends
    on it). ``attn_drop`` is accepted for reference-surface parity but not
    applied (every shipped swinv2 variant uses 0.0)."""

    def __init__(self, dim: int, num_heads: int, pretrained_window_size: int = 0,
                 qkv_bias: bool = True, attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.pretrained_window_size = pretrained_window_size
        self.logit_scale = nn.Parameter(torch.full((num_heads,), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(inplace=True),
                                     nn.Linear(512, num_heads, bias=False))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _coords(self, ws: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (ws, device)
        if key not in self._tables:
            table = _relative_coords_table(ws, self.pretrained_window_size)
            index = _relative_position_index(ws).reshape(-1)
            # built outside inference mode: an eval step may fill the cache
            # and a train step then saves these for its backward
            with torch.inference_mode(False):
                self._tables[key] = (torch.from_numpy(table).to(device),
                                     torch.from_numpy(index).to(device))
        return self._tables[key]

    def relative_position_bias(self, ws: int, device: torch.device) -> torch.Tensor:
        """(H, L, L) f32 continuous position bias, 16 * sigmoid(cpb)."""
        table, index = self._coords(ws, device)
        L = ws * ws
        # the bias is f32 in the reference; keep autocast off this tiny MLP
        with torch.autocast(device.type, enabled=False):
            cpb = self.cpb_mlp(table)  # ((2w-1)^2, H)
            bias = cpb[index].reshape(L, L, -1).permute(2, 0, 1)
            return 16.0 * torch.sigmoid(bias)

    def forward(self, x: torch.Tensor, ws: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
        qkv = self.qkv(x)
        if self.q_bias is not None:
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias]).to(qkv.dtype)
        bias = self.relative_position_bias(ws, x.device)
        out = fused_swin_attention(qkv, self.logit_scale, bias, mask, ws=ws,
                                   nheads=self.num_heads)
        return self.proj_drop(self.proj(out))


class SwinBlock(nn.Module):
    """Post-norm SwinV2 block over (B, h*w, C) tokens."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int = 0, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 pretrained_window_size: int = 0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.attn = WindowAttention(dim, num_heads, pretrained_window_size,
                                    qkv_bias, attn_drop, drop)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.drop_path1 = DropPath(drop_path)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.drop_path2 = DropPath(drop_path)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, hp: int, wp: int, ws: int, shift: int,
              device: torch.device) -> torch.Tensor:
        key = (hp, wp, ws, shift, device)
        if key not in self._masks:
            with torch.inference_mode(False):  # as for the coordinate tables
                self._masks[key] = shift_window_mask(hp, wp, ws, shift).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        hgt, wdt = hw
        b, l, c = x.shape
        x_sp = x.reshape(b, hgt, wdt, c)
        if min(hgt, wdt) <= self.window_size:
            ws, shift = min(hgt, wdt), 0  # window covers the map: no shifting
        else:
            ws, shift = self.window_size, self.shift_size
        pad_h = (ws - hgt % ws) % ws
        pad_w = (ws - wdt % ws) % ws
        if pad_h or pad_w:
            x_sp = F.pad(x_sp, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = hgt + pad_h, wdt + pad_w
        mask = None
        if shift > 0:
            # roll the thin C-wide map once here (roll commutes with the
            # pointwise qkv/proj) instead of rolling 3C-wide copies
            x_sp = torch.roll(x_sp, (-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, ws, shift, x.device)
        x_sp = self.attn(x_sp, ws, mask)
        if shift > 0:
            x_sp = torch.roll(x_sp, (shift, shift), dims=(1, 2))
        if pad_h or pad_w:
            x_sp = x_sp[:, :hgt, :wdt]
        y = x_sp.reshape(b, l, c)
        x = x + self.drop_path1(self.norm1(y))
        x = x + self.drop_path2(self.norm2(self.mlp(x)))
        return x


class PatchMerging(nn.Module):
    """2x2 reduction; SwinV2 order: linear then norm. The 4C concat order is
    (dy, dx) = (0,0), (0,1), (1,0), (1,1), as in ``torchok_tpu``."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)
        self.norm = nn.LayerNorm(out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> Tuple[torch.Tensor, Tuple[int, int]]:
        hgt, wdt = hw
        b, l, c = x.shape
        x = x.reshape(b, hgt, wdt, c)
        pad_h, pad_w = hgt % 2, wdt % 2
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            hgt, wdt = hgt + pad_h, wdt + pad_w
        x = x.reshape(b, hgt // 2, 2, wdt // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (hgt // 2) * (wdt // 2), 4 * c)
        return self.norm(self.reduction(x)), (hgt // 2, wdt // 2)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, embed_dim: int, patch_size: int, norm: bool):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if norm else nn.Identity()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        x = self.proj(x)  # (B, C, gh, gw)
        gh, gw = x.shape[2:]
        return self.norm(x.flatten(2).transpose(1, 2)), (gh, gw)


class SwinStage(nn.Module):
    def __init__(self, blocks: Sequence[SwinBlock], downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformerV2(BaseBackbone):
    def __init__(self, img_size: int = 256, patch_size: int = 4, in_channels: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 ape: bool = False, patch_norm: bool = True,
                 pretrained_window_sizes: Sequence[int] = (0, 0, 0, 0),
                 grad_checkpointing: bool = False):
        super().__init__()
        # recompute each block's activations in the backward instead of
        # keeping them (reference swin.py:77-80: torch.utils.checkpoint per block)
        self.grad_checkpointing = grad_checkpointing
        self.dropout_generator: Optional[torch.Generator] = None
        self.encoder_channels = [int(embed_dim * 2 ** i) for i in range(len(depths))]
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size, patch_norm)
        grid = img_size // patch_size  # sizes the absolute position embedding
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, grid * grid, embed_dim))
            nn.init.trunc_normal_(self.absolute_pos_embed, std=0.02)
        else:
            self.absolute_pos_embed = None
        self.pos_drop = Dropout(drop_rate)

        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        stages, norms = [], []
        block_idx = 0
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = self.encoder_channels[stage]
            blocks = []
            for blk in range(depth):
                blocks.append(SwinBlock(
                    dim, heads, window_size,
                    shift_size=0 if blk % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, drop=drop_rate,
                    attn_drop=attn_drop_rate, drop_path=dpr[block_idx],
                    pretrained_window_size=pretrained_window_sizes[stage]))
                block_idx += 1
            down = None
            if stage < len(depths) - 1:
                down = PatchMerging(dim, self.encoder_channels[stage + 1])
            stages.append(SwinStage(blocks, down))
            norms.append(nn.LayerNorm(dim, eps=1e-5))
        self.layers = nn.ModuleList(stages)
        self.feature_norms = nn.ModuleList(norms)

    @property
    def out_encoder_channels(self) -> Tuple[int, ...]:
        return tuple(self.encoder_channels)

    @property
    def out_channels(self) -> int:
        return self.encoder_channels[-1]

    def no_weight_decay(self) -> List[str]:
        return ["absolute_pos_embed", "cpb_mlp", "logit_scale"]

    def _block(self, blk: SwinBlock, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        if not (self.grad_checkpointing and self.training and torch.is_grad_enabled()):
            return blk(x, hw)
        return checkpoint_block(blk, self.dropout_generator, x, hw)

    def _features(self, x: torch.Tensor, every_stage: bool) -> List[torch.Tensor]:
        features = [x]
        x, hw = self.patch_embed(x)
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.to(x.dtype)
        x = self.pos_drop(x)
        last = len(self.layers) - 1
        for i, (stage, norm) in enumerate(zip(self.layers, self.feature_norms)):
            for blk in stage.blocks:
                x = self._block(blk, x, hw)
            # per-stage normed feature (reference swin.py:219-249); eager
            # PyTorch has no dead-code elimination, so skip unused ones
            if every_stage or i == last:
                feat = norm(x)
                b, _, c = feat.shape
                features.append(feat.transpose(1, 2).reshape(b, c, hw[0], hw[1]))
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
        return features

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self._features(x, every_stage=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._features(x, every_stage=False)[-1]


def _build(name: str, cfg: dict, pretrained: bool, in_channels: int,
           kwargs: dict) -> SwinTransformerV2:
    if pretrained:
        raise NotImplementedError(
            f"{name}: pretrained weights are not ported yet; carry Flax weights "
            "over with torchok_tpu_torch.utils.flax_convert and resume_path")
    return SwinTransformerV2(in_channels=in_channels, **{**cfg, **kwargs})


def _entry(name: str, **cfg):
    def fn(pretrained: bool = False, in_channels: int = 3, **kwargs) -> SwinTransformerV2:
        return _build(name, cfg, pretrained, in_channels, kwargs)
    fn.__name__ = name
    fn.__doc__ = f"SwinV2 variant '{name}'."
    BACKBONES.register_class(fn, name=name)
    return fn


_entry("swinv2_custom")

_VARIANTS = {
    "swinv2_tiny_window8_256": dict(window_size=8, embed_dim=96,
                                    depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swinv2_tiny_window16_256": dict(window_size=16, embed_dim=96,
                                     depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swinv2_small_window8_256": dict(window_size=8, embed_dim=96,
                                     depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swinv2_small_window16_256": dict(window_size=16, embed_dim=96,
                                      depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swinv2_base_window8_256": dict(window_size=8, embed_dim=128,
                                    depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swinv2_base_window16_256": dict(window_size=16, embed_dim=128,
                                     depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swinv2_base_window12_192_22k": dict(window_size=12, img_size=192, embed_dim=128,
                                         depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swinv2_base_window12to16_192to256_22kft1k": dict(
        window_size=16, embed_dim=128, depths=(2, 2, 18, 2),
        num_heads=(4, 8, 16, 32), pretrained_window_sizes=(12, 12, 12, 6)),
    "swinv2_base_window12to24_192to384_22kft1k": dict(
        window_size=24, img_size=384, embed_dim=128, depths=(2, 2, 18, 2),
        num_heads=(4, 8, 16, 32), pretrained_window_sizes=(12, 12, 12, 6)),
    "swinv2_large_window12_192_22k": dict(window_size=12, img_size=192, embed_dim=192,
                                          depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
    "swinv2_large_window12to16_192to256_22kft1k": dict(
        window_size=16, embed_dim=192, depths=(2, 2, 18, 2),
        num_heads=(6, 12, 24, 48), pretrained_window_sizes=(12, 12, 12, 6)),
    "swinv2_large_window12to24_192to384_22kft1k": dict(
        window_size=24, img_size=384, embed_dim=192, depths=(2, 2, 18, 2),
        num_heads=(6, 12, 24, 48), pretrained_window_sizes=(12, 12, 12, 6)),
}

for _name, _cfg in _VARIANTS.items():
    _entry(_name, **_cfg)
