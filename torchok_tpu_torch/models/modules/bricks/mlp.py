"""Transformer MLP brick (reference: torchok/models/modules/bricks/mlp.py)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torchok_tpu_torch.ops.common import Dropout


class Mlp(nn.Module):
    """fc1 -> exact (erf) GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, drop: float = 0.0):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.fc1 = nn.Linear(in_features, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, out)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(self.act(self.fc1(x)))
        return self.drop(self.fc2(x))
