"""Pixel-level transforms (port of Normalize, ToTensorV2, HorizontalFlip,
VerticalFlip, GaussNoise, ColorJitter and FancyPCA of
``torchok_tpu.data.transforms.pixelwise``): numpy on the host, batched torch
on the trainer's device.

A random host path draws from the sample's generator in the JAX package's
order, so one generator gives both packages the same image. A device path
is split in two: ``draw_batch`` makes every per-sample draw from the
``torch.Generator`` (in the order the JAX package draws its keys), and
``apply_drawn`` applies given draws, so the same draws give the same batch
on any device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.data.transforms.base import BaseTransform, draw_device

# BT.601 luma weights of the contrast and saturation terms
_RGB_WEIGHTS = (0.299, 0.587, 0.114)


def _gate(n: int, p: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(N,) booleans, true with probability ``p``."""
    return torch.rand((n,), generator=generator, device=device) < p


def _per_sample(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.view((-1,) + (1,) * (ndim - 1))


@TRANSFORMS.register_class
class Normalize(BaseTransform):
    """Albumentations Normalize: (x - mean*max_pixel) / (std*max_pixel), on
    channels-last images (it comes before ToTensorV2)."""

    always_apply = True
    device_capable = True
    device_preserves_dtype = False

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
    device_preserves_dtype = False

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


class _Flip(BaseTransform):
    """Mirror along ``axis`` (0 rows, 1 columns) with probability ``p``: on
    the host per sample, on the device per sample of the batch."""

    axis = 1
    device_capable = True
    geometric = True
    device_bbox_safe = False  # apply_batch does not flip boxes

    def apply(self, image, **params):
        return np.ascontiguousarray(np.flip(image, self.axis))

    def apply_to_mask(self, mask, **params):
        return np.ascontiguousarray(np.flip(mask, self.axis))

    def apply_to_bboxes(self, bboxes, image_shape, **params):
        b = np.asarray(bboxes, np.float32).reshape(-1, 4).copy()
        lo, hi = (1, 3) if self.axis == 0 else (0, 2)
        b[:, [lo, hi]] = image_shape[self.axis] - b[:, [hi, lo]]
        return b

    def draw_batch(self, n: int, generator, device) -> Tuple[torch.Tensor]:
        return (_gate(n, self.p, generator, draw_device(generator, device)),)

    def apply_drawn(self, batch, flip):
        out = dict(batch)
        for key in ("image", "mask"):
            x = batch.get(key)
            if x is not None:
                out[key] = torch.where(_per_sample(flip.to(x.device), x.ndim),
                                       x.flip(self.axis + 1), x)
        return out

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[0], generator, img.device))


@TRANSFORMS.register_class
class HorizontalFlip(_Flip):
    axis = 1


@TRANSFORMS.register_class
class VerticalFlip(_Flip):
    axis = 0


@TRANSFORMS.register_class
class GaussNoise(BaseTransform):
    """Additive Gaussian noise of a variance drawn from ``var_limit``; a
    uint8 image is clipped and truncated back to uint8, any other comes out
    float32."""

    device_capable = True

    def __init__(self, var_limit=(10.0, 50.0), mean: float = 0.0, per_channel: bool = True,
                 always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.var_limit = (0, var_limit) if isinstance(var_limit, (int, float)) \
            else tuple(var_limit)
        self.mean = mean
        self.per_channel = per_channel

    def apply(self, image, **params):
        sigma = self.rng.uniform(*self.var_limit) ** 0.5
        shape = image.shape if self.per_channel else image.shape[:2] + (1,)
        out = image.astype(np.float32) + self.rng.normal(self.mean, sigma, shape).astype(
            np.float32)
        if image.dtype == np.uint8:
            return np.clip(out, 0, 255).astype(np.uint8)
        return out

    def draw_batch(self, shape, generator, device):
        """Variances (N,), standard normals of the image's shape (one
        channel unless ``per_channel``), the gate."""
        device = draw_device(generator, device)
        n = shape[0]
        lo, hi = self.var_limit
        var = lo + (hi - lo) * torch.rand((n,), generator=generator, device=device)
        noise_shape = tuple(shape) if self.per_channel else tuple(shape[:3]) + (1,)
        noise = torch.randn(noise_shape, generator=generator, device=device)
        return var, noise, _gate(n, self.p, generator, device)

    def apply_drawn(self, batch, var, noise, apply):
        img = batch["image"]
        x = img.float()
        noisy = x + (noise.to(img.device) * _per_sample(var.to(img.device), 4).sqrt()
                     + self.mean)
        out = torch.where(_per_sample(apply.to(img.device), 4), noisy, x)
        if img.dtype == torch.uint8:  # the host clips and casts uint8 only
            out = out.clamp(0, 255).to(torch.uint8)
        return {**batch, "image": out}

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape, generator, img.device))


def _jitter_factors(v, center: float = 1.0, bound=None):
    lo, hi = (center - v, center + v) if isinstance(v, (int, float)) else v
    if bound is not None:
        lo, hi = max(lo, bound[0]), min(hi, bound[1])
    return (max(lo, 0.0) if center == 1.0 else lo, hi)


def _hue_rotation(fh):
    """The coefficients (a, b, c) of the RGB hue rotation by ``fh`` turns,
    in float32: a numpy scalar or a torch tensor."""
    if isinstance(fh, torch.Tensor):
        theta = fh * 2.0 * math.pi
        cos_h, sin_h = torch.cos(theta), torch.sin(theta)
    else:
        theta = np.float32(fh * 2.0 * math.pi)
        cos_h, sin_h = np.cos(theta), np.sin(theta)
    sqrt_third = float(np.sqrt(np.float32(1.0 / 3.0)))
    return (cos_h + (1.0 - cos_h) * (1.0 / 3.0),
            (1.0 / 3.0) * (1.0 - cos_h) - sqrt_third * sin_h,
            (1.0 / 3.0) * (1.0 - cos_h) + sqrt_third * sin_h)


@TRANSFORMS.register_class
class ColorJitter(BaseTransform):
    """Brightness, contrast (about the luma mean), saturation (towards luma)
    and a hue rotation of the RGB cube, in that order, in float32, clipped
    to [0, 255] for uint8 (then truncated) or [0, 1]."""

    device_capable = True

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.2,
                 always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.brightness = _jitter_factors(brightness)
        self.contrast = _jitter_factors(contrast)
        self.saturation = _jitter_factors(saturation)
        self.hue = _jitter_factors(hue, center=0.0, bound=(-0.5, 0.5))

    def apply(self, image, **params):
        fb, fc, fs, fh = (float(self.rng.uniform(*r)) for r in
                          (self.brightness, self.contrast, self.saturation, self.hue))
        max_value = 255.0 if image.dtype == np.uint8 else 1.0
        x = image.astype(np.float32) * fb
        gray = x[..., 0:1] * _RGB_WEIGHTS[0] + x[..., 1:2] * _RGB_WEIGHTS[1] \
            + x[..., 2:3] * _RGB_WEIGHTS[2]
        mean = gray.mean(axis=(-3, -2), keepdims=True, dtype=np.float32)
        x = x * fc + mean * (1.0 - fc)
        x = x * fs + gray * (1.0 - fs)
        a, b, c = _hue_rotation(fh)
        r, g, bl = x[..., 0:1], x[..., 1:2], x[..., 2:3]
        x = np.concatenate([r * a + g * b + bl * c, r * c + g * a + bl * b,
                            r * b + g * c + bl * a], axis=-1)
        out = np.clip(x, 0.0, max_value)
        return out.astype(np.uint8) if image.dtype == np.uint8 else out

    def draw_batch(self, n: int, generator, device):
        """Brightness, contrast, saturation and hue factors (N,), the gate."""
        device = draw_device(generator, device)
        factors = tuple(lo + (hi - lo) * torch.rand((n,), generator=generator, device=device)
                        for lo, hi in (self.brightness, self.contrast, self.saturation,
                                       self.hue))
        return factors + (_gate(n, self.p, generator, device),)

    def apply_drawn(self, batch, fb, fc, fs, fh, apply):
        img = batch["image"]
        fb, fc, fs, fh = (_per_sample(f.to(img.device), 4) for f in (fb, fc, fs, fh))
        max_value = 255.0 if img.dtype == torch.uint8 else 1.0
        x0 = img.float()
        x = x0 * fb
        gray = x[..., 0:1] * _RGB_WEIGHTS[0] + x[..., 1:2] * _RGB_WEIGHTS[1] \
            + x[..., 2:3] * _RGB_WEIGHTS[2]
        x = x * fc + gray.mean(dim=(-3, -2), keepdim=True) * (1.0 - fc)
        x = x * fs + gray * (1.0 - fs)
        a, b, c = _hue_rotation(fh)
        r, g, bl = x[..., 0:1], x[..., 1:2], x[..., 2:3]
        x = torch.cat([r * a + g * b + bl * c, r * c + g * a + bl * b,
                       r * b + g * c + bl * a], dim=-1).clamp(0.0, max_value)
        out = torch.where(_per_sample(apply.to(img.device), 4), x, x0)
        return {**batch, "image": out.to(torch.uint8) if img.dtype == torch.uint8 else out}

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[0], generator, img.device))


@TRANSFORMS.register_class
class FancyPCA(BaseTransform):
    """AlexNet's PCA colour augmentation: each image moves along the
    eigenvectors of its own RGB covariance by ``alpha``-scaled normal draws
    times the eigenvalues, in [0, 1] units (uint8 scaled by 1/255, clipped
    and truncated back)."""

    device_capable = True

    def __init__(self, alpha: float = 0.1, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.alpha = alpha

    def apply(self, image, **params):
        was_uint8 = image.dtype == np.uint8
        img = image.astype(np.float32) / 255.0 if was_uint8 else image.astype(np.float32)
        flat = img.reshape(-1, 3)
        evals, evecs = np.linalg.eigh(np.cov(flat - flat.mean(axis=0), rowvar=False))
        out = img + (evecs @ (self.rng.normal(0, self.alpha, 3) * evals))[None, None, :]
        return np.clip(out * 255.0, 0, 255).astype(np.uint8) if was_uint8 else out

    @staticmethod
    def basis(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eigenvalues (N, C) and eigenvectors (N, C, C) of each image's
        channel covariance, an NHWC float32 batch in [0, 1] units; each
        eigenvector's largest component made positive, so that the same
        draws move an image the same way on every device."""
        n, h, w, c = x.shape
        flat = x.reshape(n, h * w, c)
        xc = flat - flat.mean(dim=1, keepdim=True)
        evals, evecs = torch.linalg.eigh(xc.transpose(1, 2) @ xc / (h * w - 1))
        top = torch.gather(evecs, 1, evecs.abs().argmax(dim=1, keepdim=True))
        return evals, evecs * torch.where(top < 0, -1.0, 1.0)

    def draw_batch(self, shape, generator, device):
        """Standard normals (N, C), the gate."""
        device = draw_device(generator, device)
        return (torch.randn((shape[0], shape[3]), generator=generator, device=device),
                _gate(shape[0], self.p, generator, device))

    def apply_drawn(self, batch, z, apply):
        img = batch["image"]
        is_uint8 = img.dtype == torch.uint8
        x = img.float() / 255.0 if is_uint8 else img.float()
        evals, evecs = self.basis(x)
        noise = (evecs @ (self.alpha * z.to(img.device) * evals)[..., None])[..., 0]
        y = x + noise[:, None, None, :]
        if is_uint8:
            y = (y * 255.0).clamp(0, 255)
        out = torch.where(_per_sample(apply.to(img.device), 4), y, img.float() if is_uint8 else x)
        return {**batch, "image": out.to(torch.uint8) if is_uint8 else out}

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape, generator, img.device))
