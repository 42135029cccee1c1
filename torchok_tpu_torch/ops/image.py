"""Image ops (port of ``torchok_tpu.ops.image.max_pool``; the resize, adaptive
pooling and ``avg_pool`` helpers of that module are not ported yet)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, padding: int = 1) -> torch.Tensor:
    """Max pool on NCHW with implicit -inf padding, as ``F.max_pool2d`` pads."""
    return F.max_pool2d(x, window, stride, padding)
