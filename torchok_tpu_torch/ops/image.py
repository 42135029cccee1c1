"""Image ops (port of ``max_pool``, ``avg_pool``, ``blur_pool``,
``resize_bilinear`` and ``resize_nearest_cv2`` of ``torchok_tpu.ops.image``;
that module's adaptive pooling and coordinate helpers are not ported yet).
The pools, ``resize_bilinear_nchw`` (the models' resampling) and
``resize_linear`` (``jax.image.resize(..., "linear")``, which antialiases
when it shrinks) take NCHW tensors; the other resizes take the data
pipeline's NHWC (or HWC) images."""
from __future__ import annotations

from typing import Tuple

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


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of float NHWC (or HWC) images to ``size=(H, W)`` in the
    half-pixel convention with 2 taps and no antialiasing, also when
    shrinking: cv2's INTER_LINEAR and ``F.interpolate(bilinear)``."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    out = resize_bilinear_nchw(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1).contiguous()
    return out[0] if squeeze else out


def resize_bilinear_nchw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW feature maps to ``size=(H, W)``: half-pixel
    centres, two taps, no antialiasing, as ``torchok_tpu.ops.image.
    resize_bilinear`` resamples the models' NHWC maps."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)


def linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) f32 matrix of ``jax.image.resize``'s "linear"
    method along one axis (``scale_and_translate`` with the triangle kernel
    and ``antialias=True``): half-pixel centres; when shrinking, the kernel
    widens by ``n_in / n_out`` (a low-pass filter); each output's weights are
    normalised over the taps that fall inside the input."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)  # in f32, as JAX computes it
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(
        sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., method="linear")`` of an NCHW tensor: one
    weight matrix an axis (:func:`linear_resize_weights`), so a shrinking
    axis is antialiased where ``resize_bilinear_nchw`` takes two taps; an
    axis whose size stays is left as it is. In ``x``'s dtype, autocast or
    not (the JAX models resample their f32 tables before the cast).
    Differentiable in ``x``."""
    h, w = x.shape[2:]
    with torch.autocast(x.device.type, enabled=False):
        if h != size[0]:
            wh = torch.from_numpy(linear_resize_weights(h, size[0])).to(x.device, x.dtype)
            x = torch.einsum("nchw,hy->ncyw", x, wh)
        if w != size[1]:
            ww = torch.from_numpy(linear_resize_weights(w, size[1])).to(x.device, x.dtype)
            x = torch.einsum("nchw,wx->nchx", x, ww)
    return x


def nearest_cv2_indices(src: int, dst: int) -> np.ndarray:
    """cv2 INTER_NEAREST's source index of each output pixel:
    ``floor(dst_index * src / dst)``, top-left anchored."""
    return np.minimum(np.floor(np.arange(dst) * (src / dst)), src - 1).astype(np.int64)


def resize_nearest_cv2(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize INTER_NEAREST of NHWC (or HWC) images, any dtype."""
    axis_h = x.ndim - 3
    iy = torch.from_numpy(nearest_cv2_indices(x.shape[axis_h], size[0])).to(x.device)
    ix = torch.from_numpy(nearest_cv2_indices(x.shape[axis_h + 1], size[1])).to(x.device)
    return x.index_select(axis_h, iy).index_select(axis_h + 1, ix)
