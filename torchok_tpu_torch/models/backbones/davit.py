"""DaViT backbone (reference: torchok/models/backbones/davit.py:378,
dual-attention ViT, arXiv:2204.03645; port of
``torchok_tpu.models.backbones.davit``).

Each stage alternates a SpatialBlock (window self-attention over patches,
without a bias, through ``window_attention_spatial``: the Hopper kernel on a
CUDA tensor) and a ChannelBlock (attention transposed over the channel groups,
linear in the token count; its two small products stay ``torch.matmul``, as
the JAX package leaves them to XLA). Conv position encodings before each
attention and MLP.

Module names follow the reference (``patch_embeds.{i}.{proj,norm}``,
``main_blocks.{stage}.{block}.{0 spatial | 1 channel}``, ``cpe.{0,1}.proj``,
a final ``norm``), the keys ``torchok_tpu.utils.torch_convert.map_davit``
expects. Tensors are NCHW at the backbone boundary.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.base import BaseBackbone
from torchok_tpu_torch.models.modules.bricks.mlp import Mlp
from torchok_tpu_torch.ops.common import DropPath, checkpoint_block
from torchok_tpu_torch.ops.window_attention_dot import window_attention_spatial


class ConvPosEnc(nn.Module):
    """Depthwise conv positional encoding over (B, h*w, C) tokens (reference
    davit.py:88-114)."""

    def __init__(self, dim: int, kernel: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, kernel, padding=kernel // 2, groups=dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        n, l, c = x.shape
        feat = x.transpose(1, 2).reshape(n, c, hw[0], hw[1])
        return x + self.proj(feat).flatten(2).transpose(1, 2)


class ChannelAttention(nn.Module):
    """Attention over channel groups (reference davit.py:133-165): a (d x d)
    similarity over the token dimension per head."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        h = self.num_heads
        d = c // h
        q, k, v = self.qkv(x).reshape(n, l, 3, h, d).permute(2, 0, 3, 1, 4)  # (n, h, l, d)
        k = k * (d ** -0.5)
        # k^T v accumulates and stays in f32 through the softmax, and only the
        # weights are rounded to the working dtype; autocast would round the
        # product itself
        with torch.autocast(x.device.type, enabled=False):
            attn = torch.matmul(k.transpose(-1, -2).float(), v.float())
            attn = torch.softmax(attn, dim=-1).to(q.dtype)
            out = torch.matmul(q, attn)  # (n, h, l, d)
        return self.proj(out.transpose(1, 2).reshape(n, l, c))


class WindowAttention(nn.Module):
    """Plain window self-attention over a (B, Hp, Wp, C) map (reference
    davit.py:168-208), no position bias."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        # applied to the logits inside the op, as the fused kernels do
        self.register_buffer("scale", torch.full((num_heads,), (dim // num_heads) ** -0.5),
                             persistent=False)

    def forward(self, x: torch.Tensor, ws: int) -> torch.Tensor:
        out = window_attention_spatial(self.qkv(x), self.scale, None, ws=ws,
                                       nheads=self.num_heads)
        return self.proj(out)


class SpatialBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.cpe = nn.ModuleList([ConvPosEnc(dim), ConvPosEnc(dim)])
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, qkv_bias)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        n, l, c = x.shape
        hgt, wdt = hw
        x = self.cpe[0](x, hw)
        sp = self.norm1(x).reshape(n, hgt, wdt, c)
        ws = min(self.window_size, hgt, wdt)
        pad_h = (ws - hgt % ws) % ws
        pad_w = (ws - wdt % ws) % ws
        if pad_h or pad_w:
            # pad tokens attend as any other: their qkv is the projection's bias
            sp = F.pad(sp, (0, 0, 0, pad_w, 0, pad_h))
        sp = self.attn(sp, ws)
        if pad_h or pad_w:
            sp = sp[:, :hgt, :wdt]
        x = x + self.drop_path(sp.reshape(n, l, c))
        x = self.cpe[1](x, hw)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class ChannelBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0):
        super().__init__()
        self.cpe = nn.ModuleList([ConvPosEnc(dim), ConvPosEnc(dim)])
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ChannelAttention(dim, num_heads, qkv_bias)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = self.cpe[0](x, hw)
        x = x + self.drop_path(self.attn(self.norm1(x)))
        x = self.cpe[1](x, hw)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """Overlapping 7x7 s4 stem (stage 0) or 2x2 s2 downsample, then a
    LayerNorm over the tokens."""

    def __init__(self, in_channels: int, dim: int, first: bool):
        super().__init__()
        self.proj = (nn.Conv2d(in_channels, dim, 7, stride=4, padding=3) if first
                     else nn.Conv2d(in_channels, dim, 2, stride=2))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        x = self.proj(x)
        hw = (x.shape[2], x.shape[3])
        return self.norm(x.flatten(2).transpose(1, 2)), hw


class DaViT(BaseBackbone):
    def __init__(self, in_channels: int = 3, embed_dims: Sequence[int] = (96, 192, 384, 768),
                 num_heads: Sequence[int] = (3, 6, 12, 24), depths: Sequence[int] = (1, 1, 3, 1),
                 window_size: int = 7, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.1, grad_checkpointing: bool = False):
        super().__init__()
        self.grad_checkpointing = grad_checkpointing
        self.dropout_generator: Optional[torch.Generator] = None
        self.embed_dims = tuple(embed_dims)
        total = sum(depths) * 2  # depths count dual blocks
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        embeds, stages, block_idx = [], [], 0
        for stage, (dim, heads, depth) in enumerate(zip(embed_dims, num_heads, depths)):
            embeds.append(PatchEmbed(in_channels if stage == 0 else embed_dims[stage - 1], dim,
                                     first=stage == 0))
            duals = []
            for _ in range(depth):
                duals.append(nn.ModuleList([
                    SpatialBlock(dim, heads, window_size, mlp_ratio, qkv_bias, dpr[block_idx]),
                    ChannelBlock(dim, heads, mlp_ratio, qkv_bias, dpr[block_idx + 1])]))
                block_idx += 2
            stages.append(nn.ModuleList(duals))
        self.patch_embeds = nn.ModuleList(embeds)
        self.main_blocks = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(embed_dims[-1], eps=1e-5)

    @property
    def out_encoder_channels(self) -> Tuple[int, ...]:
        return self.embed_dims

    @property
    def out_channels(self) -> int:
        return self.embed_dims[-1]

    def get_stages(self, stage: int) -> List[str]:
        """Parameter-name prefixes of the stem plus the first ``stage`` stages
        (each with the patch embedding that follows it)."""
        prefixes = ["patch_embeds.0"]
        for i in range(stage):
            prefixes.extend([f"main_blocks.{i}", f"patch_embeds.{i + 1}"])
        return prefixes

    def _block(self, blk: nn.Module, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        if not (self.grad_checkpointing and self.training and torch.is_grad_enabled()):
            return blk(x, hw)
        return checkpoint_block(blk, self.dropout_generator, x, hw)

    def _stages(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The un-normed NCHW feature of every stage and the last stage's tokens."""
        features = [x]
        tokens = None
        for embed, duals in zip(self.patch_embeds, self.main_blocks):
            tokens, hw = embed(x)
            for spatial, channel in duals:
                tokens = self._block(spatial, tokens, hw)
                tokens = self._block(channel, tokens, hw)
            n, _, c = tokens.shape
            x = tokens.transpose(1, 2).reshape(n, c, hw[0], hw[1])
            features.append(x)
        return features, tokens

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self._stages(x)[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features, tokens = self._stages(x)
        n, c, hgt, wdt = features[-1].shape
        return self.norm(tokens).transpose(1, 2).reshape(n, c, hgt, wdt)


def _entry(name: str, **cfg):
    def fn(pretrained: bool = False, in_channels: int = 3, **kwargs) -> DaViT:
        if pretrained:
            raise NotImplementedError(
                f"{name}: pretrained weights are not ported yet; carry Flax weights "
                "over with torchok_tpu_torch.utils.flax_convert and resume_path")
        return DaViT(in_channels=in_channels, **{**cfg, **kwargs})
    fn.__name__ = name
    fn.__doc__ = f"DaViT variant '{name}'."
    BACKBONES.register_class(fn, name=name)
    return fn


_VARIANTS = {
    "davit_t": dict(embed_dims=(96, 192, 384, 768), num_heads=(3, 6, 12, 24),
                    depths=(1, 1, 3, 1)),
    "davit_s": dict(embed_dims=(96, 192, 384, 768), num_heads=(3, 6, 12, 24),
                    depths=(1, 1, 9, 1)),
    "davit_b": dict(embed_dims=(128, 256, 512, 1024), num_heads=(4, 8, 16, 32),
                    depths=(1, 1, 9, 1)),
}

for _name, _cfg in _VARIANTS.items():
    _entry(_name, **_cfg)
