"""Small shared compute ops (stochastic depth, initializers)."""
from __future__ import annotations

import torch
from torch import nn


def drop_path(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Stochastic depth: drop the entire residual branch per sample."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth; identity in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        return drop_path(x, self.rate)


def trunc_normal_init(module: nn.Module, generator: torch.Generator,
                      std: float = 0.02) -> None:
    """timm's transformer init, drawn from an explicit generator: truncated
    normal weights for Linear and Conv2d, zero biases, unit LayerNorm."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
