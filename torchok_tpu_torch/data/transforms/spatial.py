"""Spatial transforms (port of ``Resize``, ``CenterCrop`` and ``RandomCrop``
of ``torchok_tpu.data.transforms.spatial``): numpy on the host, batched torch
on the trainer's device.

The reference resizes with ``cv2.resize``; the port gives cv2's semantics
without cv2: INTER_LINEAR samples at half-pixel centres with two taps and no
antialiasing when shrinking, and an integer image is rounded half up and
saturated to its dtype; INTER_NEAREST (and every mask) takes
``floor(i * src / dst)``. The host path computes that with numpy, the device
path with ``F.interpolate(..., align_corners=False, antialias=False)``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.data.transforms.base import BaseTransform
from torchok_tpu_torch.ops.image import nearest_cv2_indices, resize_bilinear, resize_nearest_cv2

# cv2's interpolation flags, as the recipes spell them
INTER_NEAREST = 0
INTER_LINEAR = 1
_PORTED_INTERPS = (INTER_NEAREST, INTER_LINEAR)


def _check_interpolation(interpolation: int) -> int:
    if interpolation not in _PORTED_INTERPS:
        raise NotImplementedError(
            f"interpolation={interpolation!r} is not ported yet: only 0 (INTER_NEAREST) "
            "and 1 (INTER_LINEAR) are")
    return interpolation


@lru_cache(maxsize=None)
def _half_pixel_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) 2-tap interpolation matrix sampling at (i + 0.5) src / dst - 0.5."""
    pos = np.clip((np.arange(dst) + 0.5) * src / dst - 0.5, 0.0, src - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    frac = (pos - lo).astype(np.float32)
    m = np.zeros((dst, src), np.float32)
    m[np.arange(dst), lo] += 1.0 - frac
    m[np.arange(dst), hi] += frac
    return m


def saturate_int(x, dtype):
    """cv2's saturate_cast of a float result to an integer dtype: clamp to
    the dtype's range, round half up. numpy arrays or torch tensors."""
    if isinstance(x, torch.Tensor):
        info = torch.iinfo(dtype)
        return torch.floor(x.clamp(info.min, info.max) + 0.5).to(dtype)
    info = np.iinfo(dtype)
    return np.floor(np.clip(x, info.min, info.max) + 0.5).astype(dtype)


def _resize(img: np.ndarray, h: int, w: int, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """cv2.resize of one HWC (or HW) image to (h, w)."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    if _check_interpolation(interpolation) == INTER_NEAREST:
        iy = nearest_cv2_indices(img.shape[0], h)
        ix = nearest_cv2_indices(img.shape[1], w)
        return img[iy][:, ix]
    x = img.astype(np.float32)
    out = np.tensordot(_half_pixel_matrix(img.shape[0], h), x, axes=(1, 0))
    out = np.moveaxis(np.tensordot(_half_pixel_matrix(img.shape[1], w), out, axes=(1, 1)), 0, 1)
    if np.issubdtype(img.dtype, np.integer):
        return saturate_int(out, img.dtype)
    return out.astype(np.float32)


def _device_resize_to(batch: Dict[str, torch.Tensor], th: int, tw: int,
                      interpolation: int = INTER_LINEAR) -> Dict[str, torch.Tensor]:
    """Batched resize of the NHWC image (and mask) to (th, tw): the image
    bilinear or nearest, the mask nearest; an integer image comes back
    rounded and saturated in its dtype, a float one in f32."""
    batch = dict(batch)
    img = batch["image"]
    if tuple(img.shape[1:3]) != (th, tw):
        if _check_interpolation(interpolation) == INTER_NEAREST:
            out = resize_nearest_cv2(img, (th, tw))
            batch["image"] = out.float() if img.is_floating_point() else out
        else:
            out = resize_bilinear(img.float(), (th, tw))
            batch["image"] = out if img.is_floating_point() else saturate_int(out, img.dtype)
    mask = batch.get("mask")
    if mask is not None and tuple(mask.shape[1:3]) != (th, tw):
        batch["mask"] = resize_nearest_cv2(mask[..., None] if mask.ndim == 3 else mask,
                                           (th, tw))
        if mask.ndim == 3:
            batch["mask"] = batch["mask"][..., 0]
    return batch


def crop_batch(batch: Dict[str, torch.Tensor], y0: torch.Tensor, x0: torch.Tensor,
               height: int, width: int) -> Dict[str, torch.Tensor]:
    """Per-sample crops of the NHWC image (and mask): sample i keeps rows
    ``y0[i]:y0[i] + height`` and columns ``x0[i]:x0[i] + width``."""
    batch = dict(batch)
    img = batch["image"]
    n = img.shape[0]
    rows = (y0.to(img.device)[:, None] + torch.arange(height, device=img.device))[:, :, None]
    cols = (x0.to(img.device)[:, None] + torch.arange(width, device=img.device))[:, None, :]
    index = torch.arange(n, device=img.device)[:, None, None]
    batch["image"] = img[index, rows, cols]
    if batch.get("mask") is not None:
        batch["mask"] = batch["mask"][index, rows, cols]
    return batch


@TRANSFORMS.register_class
class Resize(BaseTransform):
    always_apply = True
    device_capable = True
    device_needs_uniform = True  # batched resize needs one input shape

    def __init__(self, height: int, width: int, interpolation: int = INTER_LINEAR,
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.height, self.width = height, width
        self.interpolation = _check_interpolation(interpolation)

    def apply(self, image, **params):
        return _resize(image, self.height, self.width, self.interpolation)

    def apply_to_mask(self, mask, **params):
        return _resize(mask, self.height, self.width, INTER_NEAREST)

    def apply_batch(self, batch, generator):
        return _device_resize_to(batch, self.height, self.width, self.interpolation)


class _CropBase(BaseTransform):
    def __init__(self, height: int, width: int, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.height, self.width = height, width

    def _check_fits(self, h: int, w: int) -> None:
        if h < self.height or w < self.width:
            raise ValueError(
                f"device {type(self).__name__} needs inputs >= ({self.height}, "
                f"{self.width}); got ({h}, {w}): keep the crop on the host")

    def _crop(self, arr, y0, x0):
        return arr[y0:y0 + self.height, x0:x0 + self.width]

    def apply(self, image, y0=0, x0=0, **params):
        return self._crop(image, y0, x0)

    def apply_to_mask(self, mask, y0=0, x0=0, **params):
        return self._crop(mask, y0, x0)


@TRANSFORMS.register_class
class CenterCrop(_CropBase):
    always_apply = True
    device_capable = True
    device_needs_uniform = True

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        return {"y0": max(0, (h - self.height) // 2), "x0": max(0, (w - self.width) // 2)}

    def apply_batch(self, batch, generator):
        h, w = batch["image"].shape[1:3]
        self._check_fits(h, w)
        y0, x0 = (h - self.height) // 2, (w - self.width) // 2
        batch = dict(batch)
        batch["image"] = batch["image"][:, y0:y0 + self.height, x0:x0 + self.width]
        if batch.get("mask") is not None:
            batch["mask"] = batch["mask"][:, y0:y0 + self.height, x0:x0 + self.width]
        return batch


@TRANSFORMS.register_class
class RandomCrop(_CropBase):
    device_needs_uniform = True

    @property
    def device_capable(self):
        # p < 1 would need an identity branch at a different output shape
        return self.p >= 1.0

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        y0 = int(self.rng.integers(0, max(h - self.height, 0) + 1))
        x0 = int(self.rng.integers(0, max(w - self.width, 0) + 1))
        return {"y0": y0, "x0": x0}

    def apply_batch(self, batch, generator: Optional[torch.Generator]):
        img = batch["image"]
        n, h, w = img.shape[:3]
        self._check_fits(h, w)
        device = generator.device if generator is not None else img.device
        y0 = torch.randint(0, h - self.height + 1, (n,), generator=generator, device=device)
        x0 = torch.randint(0, w - self.width + 1, (n,), generator=generator, device=device)
        return crop_batch(batch, y0, x0, self.height, self.width)
