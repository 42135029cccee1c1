"""BEiT backbone (reference: torchok/models/backbones/beit.py:61-273, timm-derived;
port of ``torchok_tpu.models.backbones.beit``; arXiv:2106.08254).

What differs from the plain ViT: the qkv projection has no bias of its own
but ``q_bias`` and ``v_bias`` (k takes none), a relative position bias over
the patch grid per block (``blocks.{i}.attn.relative_position_bias_table``)
or shared (``rel_pos_bias.relative_position_bias_table``), LayerScale as
``gamma_1``/``gamma_2`` on the block, and no absolute position embedding
unless ``use_abs_pos_emb``. Names are timm's; the relative position index is
rebuilt from the grid and kept out of the ``state_dict``.

The bias tables and ``pos_embed`` are sized by the patch grid, as the JAX
package sizes them from the example input it initialises with: the grid of
``img_size``, or of the task's ``inputs`` spec (:meth:`Beit.set_input_size`).
A forward at another grid raises. The attention is
:func:`~torchok_tpu_torch.models.backbones.vit.global_attention` with the
bias as SDPA's float mask (the JAX BEiT calls no Pallas kernel).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from torchok_tpu_torch.models.backbones.vit import (PatchEmbed, global_attention, grid_map,
                                                    init_transformer, register_variants,
                                                    trunc_normal_)
from torchok_tpu_torch.models.base import BaseBackbone
from torchok_tpu_torch.models.modules.bricks.mlp import Mlp
from torchok_tpu_torch.ops.common import DropPath, Dropout, checkpoint_block, variance_scaling_


def rel_pos_index(grid: Tuple[int, int]) -> np.ndarray:
    """BEiT's (L + 1, L + 1) relative position index over an (h, w) grid,
    with the three extra entries of the cls token's row, column and corner."""
    h, w = grid
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += h - 1
    rel[..., 1] += w - 1
    rel[..., 0] *= 2 * w - 1
    num_rel = (2 * h - 1) * (2 * w - 1)
    index = np.zeros((h * w + 1, h * w + 1), np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_rel
    index[0:, 0] = num_rel + 1
    index[0, 0] = num_rel + 2
    return index


def table_rows(grid: Tuple[int, int]) -> int:
    return (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3


class RelativeBias(nn.Module):
    """The index of a grid and the lookup of an (rows, heads) table through it."""

    def __init__(self, grid: Tuple[int, int]):
        super().__init__()
        self.grid = tuple(grid)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(rel_pos_index(self.grid)), persistent=False)

    def lookup(self, table: torch.Tensor) -> torch.Tensor:
        """(heads, L + 1, L + 1) bias from ``table``."""
        index = self.relative_position_index
        return table[index.reshape(-1)].reshape(*index.shape, -1).permute(2, 0, 1)


class RelativePositionBias(RelativeBias):
    """The shared table (``use_shared_rel_pos_bias``)."""

    def __init__(self, grid: Tuple[int, int], num_heads: int):
        super().__init__(grid)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(table_rows(grid), num_heads))

    def forward(self) -> torch.Tensor:
        return self.lookup(self.relative_position_bias_table)


class BeitAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim)) if qkv_bias else None
        self.v_bias = nn.Parameter(torch.zeros(dim)) if qkv_bias else None
        self.rel: Optional[RelativeBias] = None
        self.attn_drop = Dropout(attn_drop)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def set_grid(self, grid: Tuple[int, int]) -> None:
        """A relative bias of its own over ``grid`` (timm keeps the table on
        the attention module), at zero."""
        self.rel = RelativeBias(grid)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_rows(grid), self.num_heads))

    def forward(self, x: torch.Tensor, shared_bias: Optional[torch.Tensor]) -> torch.Tensor:
        n, l, c = x.shape
        qkv = self.qkv(x)
        if self.q_bias is not None:
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias]).to(qkv.dtype)
        q, k, v = qkv.reshape(n, l, 3, self.num_heads, c // self.num_heads) \
            .permute(2, 0, 3, 1, 4).unbind(0)
        bias = shared_bias
        if self.rel is not None:
            own = self.rel.lookup(self.relative_position_bias_table)
            bias = own if bias is None else own + bias
        out = global_attention(q, k, v, bias, self.attn_drop)
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(n, l, c)))


class BeitBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 init_values: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.init_values = init_values
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, num_heads, qkv_bias, attn_drop, drop)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop)
        self.drop_path2 = DropPath(drop_path)
        if init_values is not None:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor, shared_bias: Optional[torch.Tensor]) -> torch.Tensor:
        y = self.attn(self.norm1(x), shared_bias)
        x = x + self.drop_path1(y if self.gamma_1 is None else y * self.gamma_1)
        y = self.mlp(self.norm2(x))
        return x + self.drop_path2(y if self.gamma_2 is None else y * self.gamma_2)


class Beit(BaseBackbone):
    def __init__(self, img_size: Union[int, Sequence[int]] = 224, patch_size: int = 16,
                 in_channels: int = 3, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 init_values: Optional[float] = 0.1, use_abs_pos_emb: bool = False,
                 use_rel_pos_bias: bool = True, use_shared_rel_pos_bias: bool = False,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, grad_checkpointing: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.num_heads = num_heads
        self.use_abs_pos_emb = use_abs_pos_emb
        self.use_rel_pos_bias = use_rel_pos_bias
        self.use_shared_rel_pos_bias = use_shared_rel_pos_bias
        self.grad_checkpointing = grad_checkpointing
        self.dropout_generator: Optional[torch.Generator] = None
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList([
            BeitBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, init_values, drop_rate,
                      attn_drop_rate, dpr[i]) for i in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.set_input_size(size)

    def set_input_size(self, size: Sequence[int]) -> None:
        """Size the grid-shaped parameters (``pos_embed``, the relative bias
        tables) for (H, W) inputs, as the JAX package's init sizes them from
        its example input; they are made anew at zero, so call this before
        the weights are drawn."""
        grid = (int(size[0]) // self.patch_size, int(size[1]) // self.patch_size)
        self.grid = grid
        self.pos_embed = nn.Parameter(torch.zeros(1, grid[0] * grid[1] + 1, self.embed_dim)) \
            if self.use_abs_pos_emb else None
        self.rel_pos_bias = RelativePositionBias(grid, self.num_heads) \
            if self.use_shared_rel_pos_bias else None
        if self.use_rel_pos_bias:
            for blk in self.blocks:
                blk.attn.set_grid(grid)

    @property
    def out_channels(self) -> int:
        return self.embed_dim

    @property
    def out_encoder_channels(self) -> Tuple[int, ...]:
        return (self.embed_dim,) * 4

    def no_weight_decay(self) -> List[str]:
        return ["pos_embed", "cls_token", "gamma_1", "gamma_2", "relative_position_bias_table"]

    def get_stages(self, stage: int) -> List[str]:
        """Parameter-name prefixes of the embeddings, the shared bias and the
        first ``stage`` blocks."""
        return (["patch_embed", "cls_token", "pos_embed", "rel_pos_bias"]
                + [f"blocks.{i}" for i in range(stage)])

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial law: the patch conv LeCun normal (Flax's
        default conv init), ``cls_token`` and ``pos_embed`` truncated normal
        0.02, the bias tables and ``q_bias``/``v_bias`` at zero, ``gamma_1``/
        ``gamma_2`` at ``init_values``, the rest :func:`init_transformer`."""
        init_transformer(self, generator)
        proj = self.patch_embed.proj
        variance_scaling_(proj.weight, 1.0, proj.in_channels * proj.kernel_size[0] ** 2,
                          generator)
        nn.init.zeros_(proj.bias)
        trunc_normal_(self.cls_token, generator)
        if self.pos_embed is not None:
            trunc_normal_(self.pos_embed, generator)
        for name, p in self.named_parameters():
            if name.endswith(("relative_position_bias_table", "q_bias", "v_bias")):
                nn.init.zeros_(p)
        for blk in self.blocks:
            if blk.gamma_1 is not None:
                nn.init.constant_(blk.gamma_1, blk.init_values)
                nn.init.constant_(blk.gamma_2, blk.init_values)

    def _block(self, blk: nn.Module, *args) -> torch.Tensor:
        if not (self.grad_checkpointing and self.training and torch.is_grad_enabled()):
            return blk(*args)
        return checkpoint_block(blk, self.dropout_generator, *args)

    def _tokens(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        tokens, grid = self.patch_embed(x)
        if grid != self.grid:
            raise ValueError(
                f"{type(self).__name__}: input grid {grid} but the position tables hold "
                f"{self.grid}; build it with img_size (or the task's inputs) of this size")
        cls = self.cls_token.expand(tokens.shape[0], -1, -1).to(tokens.dtype)
        tokens = torch.cat([cls, tokens], 1)
        if self.pos_embed is not None:
            tokens = tokens + self.pos_embed.to(tokens.dtype)
        tokens = self.pos_drop(tokens)
        shared = self.rel_pos_bias() if self.rel_pos_bias is not None else None
        for blk in self.blocks:
            tokens = self._block(blk, tokens, shared)
        return tokens, grid

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        tokens, grid = self._tokens(x)
        return [x] + [grid_map(tokens, grid, True)] * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self._tokens(x)[0])[:, 0]


VARIANTS = {
    "beit_base_patch16_224": dict(embed_dim=768, depth=12, num_heads=12, init_values=0.1),
    "beit_base_patch16_384": dict(embed_dim=768, depth=12, num_heads=12, init_values=0.1,
                                  img_size=384),
    "beit_base_patch16_224_in22k": dict(embed_dim=768, depth=12, num_heads=12,
                                        init_values=0.1),
    "beit_large_patch16_224": dict(embed_dim=1024, depth=24, num_heads=16, init_values=1e-5),
    "beit_large_patch16_384": dict(embed_dim=1024, depth=24, num_heads=16, init_values=1e-5,
                                   img_size=384),
    "beit_large_patch16_512": dict(embed_dim=1024, depth=24, num_heads=16, init_values=1e-5,
                                   img_size=512),
    "beit_large_patch16_224_in22k": dict(embed_dim=1024, depth=24, num_heads=16,
                                         init_values=1e-5),
}

register_variants(VARIANTS, "BEiT", Beit)
