"""Pixel-level transforms (port of the Normalize, ToTensorV2 and
HorizontalFlip part of ``torchok_tpu.data.transforms.pixelwise``): numpy on
the host, batched torch on the trainer's device."""
from __future__ import annotations

import numpy as np
import torch

from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.data.transforms.base import BaseTransform


@TRANSFORMS.register_class
class Normalize(BaseTransform):
    """Albumentations Normalize: (x - mean*max_pixel) / (std*max_pixel), on
    channels-last images (it comes before ToTensorV2)."""

    always_apply = True
    device_capable = True

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 max_pixel_value: float = 255.0, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.max_pixel_value = max_pixel_value

    def apply(self, image, **params):
        img = image.astype(np.float32)
        return (img - self.mean * self.max_pixel_value) / (self.std * self.max_pixel_value)

    def apply_batch(self, batch, generator):
        img = batch["image"]
        mean = torch.as_tensor(self.mean * self.max_pixel_value, device=img.device)
        inv_std = torch.as_tensor(1.0 / (self.std * self.max_pixel_value), device=img.device)
        return {**batch, "image": (img.float() - mean) * inv_std}


@TRANSFORMS.register_class
class ToTensorV2(BaseTransform):
    """HWC -> CHW layout boundary (torch's ToTensorV2): the host path
    transposes one image, the device path permutes an NHWC batch to NCHW.
    Integer images become float32; masks pass through unless
    ``transpose_mask``."""

    always_apply = True
    device_capable = True

    def __init__(self, transpose_mask: bool = False, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.transpose_mask = transpose_mask

    def apply(self, image, **params):
        if image.ndim == 2:
            image = image[..., None]
        return np.ascontiguousarray(image.transpose(2, 0, 1))

    def apply_to_mask(self, mask, **params):
        if self.transpose_mask and mask.ndim == 3:
            return np.ascontiguousarray(mask.transpose(2, 0, 1))
        return mask

    def apply_batch(self, batch, generator):
        img = batch["image"]
        if img.ndim == 3:
            img = img[..., None]
        if not img.is_floating_point():
            img = img.float()
        out = {**batch, "image": img.permute(0, 3, 1, 2)}
        if self.transpose_mask and out.get("mask") is not None and out["mask"].ndim == 4:
            out["mask"] = out["mask"].permute(0, 3, 1, 2)
        return out


@TRANSFORMS.register_class
class HorizontalFlip(BaseTransform):
    """Mirror left to right with probability ``p``: on the host per sample,
    on the device per sample of the batch from the trainer's generator."""

    device_capable = True

    def apply(self, image, **params):
        return np.ascontiguousarray(image[:, ::-1])

    def apply_to_mask(self, mask, **params):
        return np.ascontiguousarray(mask[:, ::-1])

    def apply_batch(self, batch, generator):
        img = batch["image"]
        n = img.shape[0]
        device = generator.device if generator is not None else img.device
        flip = (torch.rand((n,), generator=generator, device=device) < self.p).to(img.device)
        out = {**batch, "image": torch.where(flip.view(n, 1, 1, 1), img.flip(2), img)}
        mask = batch.get("mask")
        if mask is not None:
            out["mask"] = torch.where(flip.view((n,) + (1,) * (mask.ndim - 1)), mask.flip(2), mask)
        return out
