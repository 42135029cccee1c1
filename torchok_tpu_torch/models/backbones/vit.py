"""Vision Transformer backbone (reference: torchok/models/backbones/vit.py:202,
timm-derived; port of ``torchok_tpu.models.backbones.vit``).

NCHW in, as the port's other backbones. ``forward`` returns the cls-token
embedding (the mean token without a class token) after the final norm;
``forward_features`` returns ``[input] + 4x`` the last block's patch grid as
an NCHW map, the ViTDet-style single-scale pyramid of the reference
(vit.py:316-332), without the final norm. Module and parameter names are
timm's (``patch_embed.proj``, ``pos_embed``, ``cls_token``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,mlp.fc1,mlp.fc2,
ls2.gamma}``, ``norm``).

The JAX ViT computes its global attention as plain einsums and a softmax,
outside any Pallas kernel, so this one calls ``F.scaled_dot_product_attention``
(:func:`global_attention`) and no hand-written kernel. A position table
sized for ``img_size`` is resampled to other grids as ``jax.image.resize``
does (:func:`torchok_tpu_torch.ops.image.resize_linear`: antialiased when it
shrinks).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.base import BaseBackbone
from torchok_tpu_torch.models.modules.bricks.mlp import Mlp
from torchok_tpu_torch.ops.common import DropPath, Dropout, checkpoint_block, variance_scaling_
from torchok_tpu_torch.ops.image import resize_linear


def global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor], attn_drop: Dropout) -> torch.Tensor:
    """Softmax attention of (N, H, L, D) q, k, v with an optional additive
    (H, L, L) logit bias: ``F.scaled_dot_product_attention``, the bias as a
    float mask in q's dtype, its rows padded to a multiple of 8 and sliced
    (the memory-efficient backend takes a mask only with unit stride along
    a row, and an aligned row stride spares it a padded copy). With
    attention dropout in training the probabilities go through
    ``attn_drop`` (its generator, never torch's global one): logits and
    softmax in f32, the probabilities cast to v's dtype before the product,
    as the JAX modules take them."""
    if attn_drop.rate > 0.0 and attn_drop.training:
        logits = torch.einsum("nhqd,nhkd->nhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
        if bias is not None:
            logits = logits + bias.float()
        return attn_drop(logits.softmax(-1).to(v.dtype)) @ v
    mask = None
    if bias is not None:
        length = bias.shape[-1]
        mask = F.pad(bias.to(q.dtype), (0, -length % 8))[..., :length]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


class PatchEmbed(nn.Module):
    """A p x p conv of stride p; returns the (N, L, C) tokens and the grid."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int, bias: bool = True):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size, bias=bias)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        x = self.proj(x)
        grid = (x.shape[2], x.shape[3])
        return x.flatten(2).transpose(1, 2), grid


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        qkv = self.qkv(x).reshape(n, l, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        out = global_attention(q, k, v, None, self.attn_drop)
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(n, l, c)))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 init_values: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop)
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop)
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x))))
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x))))


def init_transformer(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's defaults for the parts of a ViT or BEiT that declare no law of
    their own, drawn from ``generator``: Dense kernels LeCun normal (variance
    scaling 1.0 over fan_in, truncated) with zero biases, LayerNorm at one
    and zero, LayerScale at its ``init_values``."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            variance_scaling_(m.weight, 1.0, m.in_features, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, LayerScale):
            nn.init.constant_(m.gamma, m.init_values)


def trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02) -> None:
    """Flax's ``truncated_normal(std)``: a unit normal cut at +-2, times std."""
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


class VisionTransformer(BaseBackbone):
    def __init__(self, img_size: int = 224, patch_size: int = 16, in_channels: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 init_values: Optional[float] = None, class_token: bool = True,
                 no_embed_class: bool = False, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 grad_checkpointing: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.class_token = class_token
        self.no_embed_class = no_embed_class
        # recompute each block's activations in the backward instead of
        # keeping them (timm's grad_checkpointing: torch.utils.checkpoint per block)
        self.grad_checkpointing = grad_checkpointing
        self.dropout_generator: Optional[torch.Generator] = None
        self.base_grid = img_size // patch_size  # the grid the position table holds
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if class_token else None
        embed_len = self.base_grid ** 2 + int(class_token and not no_embed_class)
        self.pos_embed = nn.Parameter(torch.zeros(1, embed_len, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, init_values, drop_rate,
                  attn_drop_rate, dpr[i]) for i in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    @property
    def out_channels(self) -> int:
        return self.embed_dim

    @property
    def out_encoder_channels(self) -> Tuple[int, ...]:
        return (self.embed_dim,) * 4

    def no_weight_decay(self) -> List[str]:
        return ["pos_embed", "cls_token"]

    def get_stages(self, stage: int) -> List[str]:
        """Parameter-name prefixes of the embeddings and the first ``stage``
        blocks."""
        return ["patch_embed", "pos_embed", "cls_token"] + [f"blocks.{i}" for i in range(stage)]

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial law: the patch conv Xavier uniform (Flax
        counts a conv kernel's fans over its receptive field, as torch does),
        ``pos_embed`` truncated normal 0.02, ``cls_token`` normal 1e-6, the
        rest :func:`init_transformer`."""
        init_transformer(self, generator)
        nn.init.xavier_uniform_(self.patch_embed.proj.weight, generator=generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        trunc_normal_(self.pos_embed, generator)
        if self.cls_token is not None:
            nn.init.normal_(self.cls_token, std=1e-6, generator=generator)

    def _resize_grid(self, table: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        g = self.base_grid
        if grid == (g, g):
            return table
        c = table.shape[-1]
        table = table.reshape(1, g, g, c).permute(0, 3, 1, 2)
        table = resize_linear(table, grid)
        return table.permute(0, 2, 3, 1).reshape(1, grid[0] * grid[1], c)

    def _pos_embed(self, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        if self.cls_token is None:
            x = x + self._resize_grid(self.pos_embed, grid).to(x.dtype)
        else:
            cls = self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype)
            if self.no_embed_class:
                x = torch.cat([cls, x + self._resize_grid(self.pos_embed, grid).to(x.dtype)], 1)
            else:
                table = torch.cat([self.pos_embed[:, :1],
                                   self._resize_grid(self.pos_embed[:, 1:], grid)], 1)
                x = torch.cat([cls, x], 1) + table.to(x.dtype)
        return self.pos_drop(x)

    def _block(self, blk: nn.Module, *args) -> torch.Tensor:
        if not (self.grad_checkpointing and self.training and torch.is_grad_enabled()):
            return blk(*args)
        return checkpoint_block(blk, self.dropout_generator, *args)

    def _tokens(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        tokens, grid = self.patch_embed(x)
        tokens = self._pos_embed(tokens, grid)
        for blk in self.blocks:
            tokens = self._block(blk, tokens)
        return tokens, grid

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        tokens, grid = self._tokens(x)
        return [x] + [grid_map(tokens, grid, self.class_token)] * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.norm(self._tokens(x)[0])
        return tokens[:, 0] if self.class_token else tokens.mean(1)


def grid_map(tokens: torch.Tensor, grid: Tuple[int, int], class_token: bool) -> torch.Tensor:
    """The patch tokens of (N, L, C) as an (N, C, gh, gw) map."""
    patches = tokens[:, 1:] if class_token else tokens
    return patches.transpose(1, 2).reshape(tokens.shape[0], -1, grid[0], grid[1])


def _entry(name: str, cfg: dict, family: str,
           build: Callable[..., BaseBackbone]) -> Callable[..., BaseBackbone]:
    def fn(pretrained: bool = False, in_channels: int = 3, **kwargs) -> BaseBackbone:
        if pretrained:
            raise NotImplementedError(
                f"{name}: pretrained weights are not ported yet; carry Flax weights "
                "over with torchok_tpu_torch.utils.flax_convert and resume_path")
        return build(in_channels=in_channels, **{**cfg, **kwargs})
    fn.__name__ = name
    fn.__doc__ = f"{family} variant '{name}'."
    return fn


def register_variants(variants: dict, family: str,
                      build: Callable[..., BaseBackbone]) -> None:
    """One registry entry per name: ``fn(pretrained, in_channels, **kwargs)``
    builds the variant's configuration updated by ``kwargs``."""
    for name, cfg in variants.items():
        BACKBONES.register_class(_entry(name, cfg, family, build), name=name)


def _v(embed_dim, depth, num_heads, patch_size=16, **kw):
    return dict(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                patch_size=patch_size, **kw)


VARIANTS = {
    "vit_tiny_patch16_224": _v(192, 12, 3),
    "vit_tiny_patch16_384": _v(192, 12, 3, img_size=384),
    "vit_small_patch16_224": _v(384, 12, 6),
    "vit_small_patch16_384": _v(384, 12, 6, img_size=384),
    "vit_small_patch32_224": _v(384, 12, 6, patch_size=32),
    "vit_base_patch8_224": _v(768, 12, 12, patch_size=8),
    "vit_base_patch16_224": _v(768, 12, 12),
    "vit_base_patch16_384": _v(768, 12, 12, img_size=384),
    "vit_base_patch32_224": _v(768, 12, 12, patch_size=32),
    "vit_base_patch32_384": _v(768, 12, 12, patch_size=32, img_size=384),
    "vit_large_patch14_224": _v(1024, 24, 16, patch_size=14),
    "vit_large_patch16_224": _v(1024, 24, 16),
    "vit_large_patch16_384": _v(1024, 24, 16, img_size=384),
    "vit_large_patch32_384": _v(1024, 24, 16, patch_size=32, img_size=384),
    "vit_huge_patch14_224": _v(1280, 32, 16, patch_size=14),
    "vit_giant_patch14_224": _v(1408, 40, 16, patch_size=14, mlp_ratio=48 / 11),
    "vit_gigantic_patch14_224": _v(1664, 48, 16, patch_size=14, mlp_ratio=64 / 13),
    "vit_large_patch32_224": _v(1024, 24, 16, patch_size=32),
    "vit_small_patch32_384": _v(384, 12, 6, patch_size=32, img_size=384),
    "vit_small_patch16_36x1_224": _v(384, 36, 6),
    "vit_small_patch16_18x2_224": _v(384, 18, 6),  # parallel-pair depth folded
    "vit_base_patch16_18x2_224": _v(768, 18, 12),
    "vit_base_patch16_rpn_224": _v(768, 12, 12, class_token=False),
    "vit_base_patch16_plus_240": _v(896, 12, 14, img_size=240),
    "vit_base_patch32_plus_256": _v(896, 12, 14, patch_size=32, img_size=256),
}

# weight-provenance names (in21k, dino, sam, miil, clip-laion2b): the same
# architectures under the names the recipes use
WEIGHT_VARIANTS = {
    "vit_tiny_patch16_224_in21k": "vit_tiny_patch16_224",
    "vit_small_patch16_224_in21k": "vit_small_patch16_224",
    "vit_small_patch32_224_in21k": "vit_small_patch32_224",
    "vit_small_patch16_224_dino": "vit_small_patch16_224",
    "vit_small_patch8_224_dino": _v(384, 12, 6, patch_size=8),
    "vit_base_patch16_224_in21k": "vit_base_patch16_224",
    "vit_base_patch32_224_in21k": "vit_base_patch32_224",
    "vit_base_patch8_224_in21k": "vit_base_patch8_224",
    "vit_base_patch8_224_dino": "vit_base_patch8_224",
    "vit_base_patch16_224_dino": "vit_base_patch16_224",
    "vit_base_patch16_224_sam": "vit_base_patch16_224",
    "vit_base_patch32_224_sam": "vit_base_patch32_224",
    "vit_base_patch16_224_miil": "vit_base_patch16_224",
    "vit_base_patch16_224_miil_in21k": "vit_base_patch16_224",
    "vit_base_patch32_224_clip_laion2b": "vit_base_patch32_224",
    "vit_large_patch16_224_in21k": "vit_large_patch16_224",
    "vit_large_patch32_224_in21k": "vit_large_patch32_224",
    "vit_large_patch14_224_clip_laion2b": "vit_large_patch14_224",
    "vit_huge_patch14_224_in21k": "vit_huge_patch14_224",
    "vit_huge_patch14_224_clip_laion2b": "vit_huge_patch14_224",
    "vit_giant_patch14_224_clip_laion2b": "vit_giant_patch14_224",
}
for _alias, _base in WEIGHT_VARIANTS.items():
    VARIANTS[_alias] = dict(VARIANTS[_base]) if isinstance(_base, str) else _base

register_variants(VARIANTS, "ViT", VisionTransformer)
