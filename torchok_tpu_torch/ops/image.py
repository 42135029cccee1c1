"""Image ops on NCHW tensors (port of ``max_pool``, ``avg_pool`` and
``blur_pool`` of ``torchok_tpu.ops.image``; that module's resize, adaptive
pooling and coordinate helpers are not ported yet)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, padding: int = 1) -> torch.Tensor:
    """Max pool on NCHW with implicit -inf padding, as ``F.max_pool2d`` pads."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: int = 2, stride: int = 2, padding: int = 0,
             count_include_pad: bool = True) -> torch.Tensor:
    """Average pool on NCHW, flooring the output size. With
    ``count_include_pad`` the padded zeros count in every window's divisor
    (``window**2``); without it each window divides by its real pixels."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)


def _binomial(kernel: int) -> np.ndarray:
    if kernel == 3:
        k1 = np.array([1.0, 2.0, 1.0])
    elif kernel == 5:
        k1 = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
    else:
        k1 = np.ones((kernel,))
    k2 = np.outer(k1, k1)
    return (k2 / k2.sum()).astype(np.float32)


def blur_pool(x: torch.Tensor, stride: int = 2, kernel: int = 3) -> torch.Tensor:
    """Anti-aliased downsampling (Zhang 2019 "Making Convolutions
    Shift-Invariant Again"): a fixed binomial low-pass depthwise filter before
    subsampling. NCHW; kernel 3 is the outer product of [1, 2, 1]. Reflect
    padding, matching timm's BlurPool2d: zero padding would attenuate every
    border output."""
    c = x.shape[1]
    filt = torch.from_numpy(_binomial(kernel)).to(device=x.device, dtype=x.dtype)
    filt = filt[None, None].expand(c, 1, kernel, kernel)
    pad = (kernel - 1) // 2
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(x, filt, stride=stride, groups=c)
