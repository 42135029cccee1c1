"""Image filters of the photometric transforms (port of the filtering
helpers of ``torchok_tpu.data.transforms.pixelwise``), and their host twins
in numpy without cv2.

* The device functions (torch, batched NHWC, on the trainer's device) take
  per-sample kernels with a reflect-101 border (cv2's ``BORDER_DEFAULT``):
  a kernel shorter than the batch's longest has zero taps outside its
  radius, so one pad serves every sample. They sum the taps one by one in a
  fixed order with separate products and sums (no fused multiply-add, no
  cuDNN algorithm and no TF32), so the same inputs give the same bits on
  the card and on the CPU.
* The host functions (numpy, one HW or HWC image) compute what OpenCV 5.0
  computes: ``cv2.blur`` of uint8 as the integer box sum times
  float32 ``1 / k^2`` rounded half to even; ``cv2.GaussianBlur`` of uint8
  in cv2's fixed point (the kernel's taps in 1/256 by error diffusion, the
  separable sums exact, then rounded half up); ``cv2.medianBlur`` with a
  replicated border; ``cv2.filter2D`` as a float32 fused multiply-add chain
  over the kernel's non-zero taps in row-major order, rounded half to even
  for uint8. Float images differ from cv2's float sums by their order only.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from torchok_tpu_torch.ops import warp

# cv2.getGaussianKernel's fixed taps when sigma <= 0, by radius: ksize <= 9
# on the host; the device path takes them up to 7, as the JAX package's
CV2_SMALL_GAUSS = {
    0: np.array([1.0], np.float32),
    1: np.array([0.25, 0.5, 0.25], np.float32),
    2: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    3: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125], np.float32),
    4: np.array([0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375, 0.19921875, 0.1171875,
                 0.05078125, 0.015625], np.float32),
}


# ------------------------------ device path ------------------------------

def reflect101_pad(x: torch.Tensor, axis: int, lo: int, hi: Optional[int] = None
                   ) -> torch.Tensor:
    """Reflect-101 padding by ``lo`` before and ``hi`` (default ``lo``) after
    one axis, periodic where a pad is wider than the axis."""
    hi = lo if hi is None else hi
    if lo == 0 and hi == 0:
        return x
    n = x.shape[axis]
    idx = warp.reflect101(np.arange(-lo, n + hi), n)
    return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def _taps_sum(x: torch.Tensor, weights, offsets, out_shape) -> torch.Tensor:
    """Sum of ``x`` windows of ``out_shape`` starting at each (dy, dx) of
    ``offsets`` (on axes 1 and 2) times its weight (a float or an (N,)
    tensor), in order."""
    h, w = out_shape
    acc = None
    for wt, (dy, dx) in zip(weights, offsets):
        if isinstance(wt, torch.Tensor):
            wt = wt.view(-1, 1, 1, 1)
        tap = x[:, dy:dy + h, dx:dx + w] * wt
        acc = tap if acc is None else acc + tap
    return acc


def sep_filter_per_sample(img: torch.Tensor, kh: torch.Tensor, kw: torch.Tensor
                          ) -> torch.Tensor:
    """Separable filtering of an NHWC float32 batch with per-sample odd 1-D
    kernels ``kh`` and ``kw`` (N, K), rows then columns, reflect-101."""
    out = img
    h, w = img.shape[1:3]
    for axis, k in ((1, kh), (2, kw)):
        r = (k.shape[1] - 1) // 2
        if r == 0:
            continue
        x = reflect101_pad(out, axis, r)
        k = k.to(img.device, torch.float32)
        offsets = [(t, 0) if axis == 1 else (0, t) for t in range(k.shape[1])]
        out = _taps_sum(x, k.unbind(1), offsets, (h, w))
    return out


def fixed_filter2d(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.filter2D (correlation, reflect-101) of an NHWC float32 batch with
    one 2-D kernel (its non-zero taps, row-major)."""
    kernel = np.asarray(kernel, np.float32)
    kh, kw = kernel.shape
    x = reflect101_pad(reflect101_pad(img, 1, kh // 2), 2, kw // 2)
    taps = np.argwhere(kernel != 0)
    return _taps_sum(x, [float(kernel[dy, dx]) for dy, dx in taps], taps.tolist(),
                     img.shape[1:3])


def median_filter_per_sample(img: torch.Tensor, radii: torch.Tensor, max_r: int
                             ) -> torch.Tensor:
    """cv2.medianBlur (replicated border) of an NHWC batch with per-sample
    odd sizes ``2 radii + 1``: the (2 max_r + 1)^2 shifted views are sorted
    once, with each sample's taps outside its radius replaced by sentinels
    split evenly between the two tails (the ring outside a radius is
    centrally symmetric), so the valid taps' median sits at the middle."""
    if max_r == 0:
        return img
    n, h, w, c = img.shape
    k = 2 * max_r + 1
    if img.is_floating_point():
        x, lo, hi = img.float(), -math.inf, math.inf
    else:  # outside any integer image's values
        x, lo, hi = img.to(torch.int32), -(1 << 20), 1 << 20
    rows = torch.arange(-max_r, h + max_r, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-max_r, w + max_r, device=img.device).clamp(0, w - 1)
    xp = x.index_select(1, rows).index_select(2, cols)
    offs = np.array([(dy, dx) for dy in range(-max_r, max_r + 1)
                     for dx in range(-max_r, max_r + 1)])
    stack = torch.stack([xp[:, max_r + dy:max_r + dy + h, max_r + dx:max_r + dx + w]
                         for dy, dx in offs], dim=-1)  # (N, H, W, C, K^2)
    ring = torch.from_numpy(np.abs(offs).max(axis=1)).to(img.device)
    low_half = torch.from_numpy((offs[:, 0] < 0) | ((offs[:, 0] == 0) & (offs[:, 1] < 0)))
    valid = ring[None, :] <= radii.to(img.device)[:, None]  # (N, K^2)
    sentinel = torch.where(low_half, lo, hi).to(img.device, x.dtype)
    stack = torch.where(valid[:, None, None, None, :], stack, sentinel)
    return stack.sort(dim=-1).values[..., (k * k) // 2].to(img.dtype)


def box_kernels(radii: torch.Tensor, max_r: int) -> torch.Tensor:
    """(N,) radii -> (N, 2 max_r + 1) normalised box kernels."""
    pos = torch.arange(-max_r, max_r + 1, device=radii.device).abs()
    mask = (pos[None, :] <= radii[:, None]).float()
    return mask / mask.sum(dim=1, keepdim=True)


def gauss_kernels(radii: torch.Tensor, sigmas: torch.Tensor, max_r: int) -> torch.Tensor:
    """(N,) radii and sigmas -> (N, 2 max_r + 1) Gaussian kernels as
    cv2.getGaussianKernel makes them: sigma <= 0 takes sigma from the size,
    and then sizes up to 7 take cv2's binomial tables."""
    device = radii.device
    pos = torch.arange(-max_r, max_r + 1, device=device).float()
    rf = radii.float()
    sigma_auto = 0.3 * ((2.0 * rf + 1.0 - 1.0) * 0.5 - 1.0) + 0.8
    sig = torch.where(sigmas.to(device) > 0, sigmas.to(device), sigma_auto)
    w = torch.exp(-0.5 * (pos[None, :] / sig[:, None]) ** 2)
    w = w * (pos.abs()[None, :] <= rf[:, None])
    w = w / w.sum(dim=1, keepdim=True)
    n_tab = min(max_r, 3) + 1
    table = np.zeros((n_tab, 2 * max_r + 1), np.float32)
    for r in range(n_tab):
        table[r, max_r - r:max_r + r + 1] = CV2_SMALL_GAUSS[r]
    tab = torch.from_numpy(table).to(device)[radii.clamp(0, n_tab - 1)]
    return torch.where(((sigmas.to(device) <= 0) & (radii <= 3))[:, None], tab, w)


# ------------------------------- host path -------------------------------

def _hwc(img: np.ndarray) -> np.ndarray:
    return img[..., None] if img.ndim == 2 else img


def _shape_back(out: np.ndarray, img: np.ndarray) -> np.ndarray:
    return out[..., 0] if img.ndim == 2 else out


def _sep_sum(x: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """Correlation of ``x`` with a 1-D ``kernel`` along ``axis`` (0 or 1)
    under a reflect-101 border, in ``x``'s dtype, taps in order."""
    r = len(kernel) // 2
    if r == 0:
        return x * kernel[0]
    n = x.shape[axis]
    xp = np.take(x, warp.reflect101(np.arange(-r, n + r), n), axis=axis)
    acc = None
    for t, wt in enumerate(kernel):
        tap = (xp[t:t + n] if axis == 0 else xp[:, t:t + n]) * wt
        acc = tap if acc is None else acc + tap
    return acc


def _round_to(out: np.ndarray, dtype) -> np.ndarray:
    """A float result in an integer ``dtype``, rounded half to even and
    saturated (cv2's saturate_cast), or in float32."""
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(dtype)
    return out.astype(np.float32)


def blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.blur(img, (ksize, ksize))``: an integer image's integer box sum
    times float32 ``1 / ksize^2``, rounded half to even."""
    x = _hwc(img)
    box = np.ones(ksize, np.int64 if np.issubdtype(img.dtype, np.integer) else np.float64)
    s = _sep_sum(_sep_sum(x.astype(box.dtype), box, 0), box, 1)
    if box.dtype == np.int64:
        out = _round_to(s.astype(np.float32) * np.float32(1.0 / (ksize * ksize)), img.dtype)
    else:
        out = (s / (ksize * ksize)).astype(np.float32)
    return _shape_back(out, img)


def gaussian_kernel_cv2(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` in float64: the fixed
    tables for ksize <= 9 and sigma <= 0, else sigma (from ksize when <= 0)
    and normalised exponentials."""
    r = ksize // 2
    if sigma <= 0 and r in CV2_SMALL_GAUSS:
        return CV2_SMALL_GAUSS[r].astype(np.float64)
    sigma = sigma if sigma > 0 else ksize * 0.15 + 0.35
    # cv2's order: the outer taps' exponentials, their sum twice plus the
    # centre's 1, one reciprocal
    outer = np.exp(np.arange(1 - ksize, 0, 2, dtype=np.float64) ** 2 * (-0.125 / (sigma * sigma)))
    scale = 1.0 / (2.0 * sum(outer.tolist()) + 1.0)
    return np.concatenate([outer, [1.0], outer[::-1]]) * scale


@lru_cache(maxsize=64)
def gaussian_kernel_fixed(ksize: int, sigma: float) -> np.ndarray:
    """cv2's 8-bit Gaussian taps in 1/256 (``getGaussianKernelFixedPoint_ED``):
    the outer taps rounded with the error carried inwards, the centre tap
    what makes the sum 256."""
    k = gaussian_kernel_cv2(ksize, sigma)
    out = np.zeros(ksize, np.int64)
    err, total = 0.0, 0
    for i in range(ksize // 2):
        adj = k[i] * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[ksize - 1 - i] = v
        total += v
    out[ksize // 2] = 256 - 2 * total
    return out


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigmaX=sigma)``, reflect-101:
    uint8 in cv2's fixed point (:func:`gaussian_kernel_fixed` rows then
    columns, exact, then ``(s + 2^15) >> 16``), float images with the
    float32 taps."""
    if ksize // 2 == 0:
        return img.copy()
    x = _hwc(img)
    if img.dtype == np.uint8:
        k = gaussian_kernel_fixed(ksize, float(sigma))
        s = _sep_sum(_sep_sum(x.astype(np.int64), k, 0), k, 1)
        out = np.clip((s + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
    else:
        k = gaussian_kernel_cv2(ksize, sigma).astype(np.float32).astype(np.float64)
        out = _round_to(_sep_sum(_sep_sum(x.astype(np.float64), k, 0), k, 1), img.dtype)
    return _shape_back(out, img)


def median_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.medianBlur(img, ksize)``: the median of each ksize x ksize
    window, the border replicated. As cv2, a float image takes ksize 3 or 5
    only."""
    if img.dtype != np.uint8 and ksize > 5:
        raise ValueError(f"medianBlur of a {img.dtype} image takes ksize 3 or 5 (cv2's "
                         f"rule), not {ksize}")
    x = _hwc(img)
    r = ksize // 2
    h, w = x.shape[:2]
    xp = np.pad(x, ((r, r), (r, r), (0, 0)), mode="edge")
    stack = np.stack([xp[dy:dy + h, dx:dx + w] for dy in range(ksize) for dx in range(ksize)],
                     axis=-1)
    # torch's median of an odd count is its middle value, and it runs faster
    # than numpy's partition over the taps
    return _shape_back(torch.from_numpy(stack).median(dim=-1).values.numpy(), img)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` of a float32 kernel, reflect-101:
    a float32 fused multiply-add chain over the non-zero taps in row-major
    order, an integer image rounded half to even and saturated."""
    kernel = np.asarray(kernel, np.float32)
    x = _hwc(img).astype(np.float32)
    kh, kw = kernel.shape
    h, w = x.shape[:2]
    xp = np.take(np.take(x, warp.reflect101(np.arange(-(kh // 2), h + kh // 2), h), axis=0),
                 warp.reflect101(np.arange(-(kw // 2), w + kw // 2), w), axis=1)
    acc = np.zeros(x.shape, np.float32)
    for dy, dx in np.argwhere(kernel != 0):
        acc = warp.fma(xp[dy:dy + h, dx:dx + w], kernel[dy, dx], acc)
    return _shape_back(_round_to(acc, img.dtype), img)
