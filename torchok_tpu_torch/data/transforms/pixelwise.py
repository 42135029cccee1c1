"""Pixel-level transforms (port of ``torchok_tpu.data.transforms.
pixelwise``): Normalize, ToTensorV2, HorizontalFlip, VerticalFlip,
GaussNoise, ColorJitter and FancyPCA, then the module's first half in file
order, Flip to ToSepia (the brightness, contrast, gamma and colour shifts,
the dropouts, the blurs, CLAHE, Equalize, HueSaturationValue, the JPEG round
trip, Downscale, Sharpen): numpy on the host without cv2 (the filters and
colour conversions of ``ops/filters.py`` and ``ops/color.py``, the JPEG
codec of ``native``), batched torch on the trainer's device.

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

from torchok_tpu_torch import native
from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.data.transforms.base import BaseTransform, draw_device
from torchok_tpu_torch.data.transforms.spatial import INTER_NEAREST, _resize, saturate_int
from torchok_tpu_torch.ops import color, filters
from torchok_tpu_torch.ops.warp import divide

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


# ------------- the module's first half in file order, Flip to ToSepia -------------

def _pair(v) -> Tuple[float, float]:
    """A scalar limit ``v`` as (-v, v), a pair as is."""
    return (-v, v) if isinstance(v, (int, float)) else tuple(v)


def _low_high(v, low) -> Tuple[float, float]:
    """A scalar limit ``v`` as (low, v), a pair as is."""
    return (low, v) if isinstance(v, (int, float)) else tuple(v)


def _uniform(n: int, lo: float, hi: float, generator, device) -> torch.Tensor:
    """(N,) float32 uniforms in [lo, hi), as ``jax.random.uniform(minval=lo,
    maxval=hi)`` draws them."""
    return lo + (hi - lo) * torch.rand((n,), generator=generator, device=device)


def _to_uint8(out: torch.Tensor) -> torch.Tensor:
    """A float result clipped to [0, 255] and truncated, as numpy's and XLA's
    casts of the JAX package truncate."""
    return out.clamp(0, 255).to(torch.uint8)


def _odd_radii(limit: Tuple[int, int]) -> Tuple[int, int]:
    """The radii (ksize // 2) a blur draws from: its limits halved."""
    return limit[0] // 2, limit[1] // 2


def _odd_ksize(rng: np.random.Generator, limit: Tuple[int, int]) -> int:
    lo, hi = _odd_radii(limit)
    return int(rng.integers(lo, hi + 1)) * 2 + 1


def _require_uint8(name: str, dtype) -> None:
    if dtype not in (np.uint8, torch.uint8):
        raise TypeError(f"{name} expects uint8 images (cv2's 8-bit tables); place it before "
                        "ToFloat")


class _Drawn(BaseTransform):
    """A device transform in two halves: ``draw_batch(shape, generator,
    device)`` of the NHWC image's shape, and ``apply_drawn(batch, *draws)``."""

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(tuple(img.shape), generator, img.device))


@TRANSFORMS.register_class
class Flip(_Drawn):
    """Random flip: cv2.flip's code 0 (rows), 1 (columns) or -1 (both), drawn
    uniformly."""

    geometric = True
    device_capable = True
    device_bbox_safe = False

    def get_params(self, sample):
        return {"code": int(self.rng.integers(-1, 2))}

    @staticmethod
    def _flip(x: np.ndarray, code: int) -> np.ndarray:
        if code in (0, -1):
            x = x[::-1]
        if code in (1, -1):
            x = x[:, ::-1]
        return np.ascontiguousarray(x)

    def apply(self, image, code=0, **params):
        return self._flip(image, code)

    def apply_to_mask(self, mask, code=0, **params):
        return self._flip(mask, code)

    def apply_to_bboxes(self, bboxes, image_shape, code=0, **params):
        b = np.asarray(bboxes, np.float32).reshape(-1, 4).copy()
        h, w = image_shape[:2]
        if code in (1, -1):
            b[:, [0, 2]] = w - b[:, [2, 0]]
        if code in (0, -1):
            b[:, [1, 3]] = h - b[:, [3, 1]]
        return b

    def draw_batch(self, shape, generator, device):
        """The gate, then the codes (N,) in {-1, 0, 1}."""
        device = draw_device(generator, device)
        n = shape[0]
        return (_gate(n, self.p, generator, device),
                torch.randint(-1, 2, (n,), generator=generator, device=device))

    def apply_drawn(self, batch, apply, code):
        out = dict(batch)
        for key in ("image", "mask"):
            x = batch.get(key)
            if x is None:
                continue
            a, c = apply.to(x.device), code.to(x.device)
            for axis, codes in ((2, (1, -1)), (1, (0, -1))):
                do = a & ((c == codes[0]) | (c == codes[1]))
                x = torch.where(_per_sample(do, x.ndim), x.flip(axis), x)
            out[key] = x
        return out


@TRANSFORMS.register_class
class RandomBrightnessContrast(_Drawn):
    """``x * (1 + contrast) + brightness * max`` (max 255 for uint8, else 1;
    on the host the image's mean instead of max unless ``brightness_by_max``;
    the device path always takes max, as the JAX package's), uint8 clipped
    and truncated, other dtypes out in float32."""

    device_capable = True

    def __init__(self, brightness_limit=0.2, contrast_limit=0.2, brightness_by_max: bool = True,
                 always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.brightness_limit = _pair(brightness_limit)
        self.contrast_limit = _pair(contrast_limit)
        self.brightness_by_max = brightness_by_max

    def apply(self, image, **params):
        alpha = 1.0 + float(self.rng.uniform(*self.contrast_limit))
        beta = float(self.rng.uniform(*self.brightness_limit))
        max_value = 255.0 if image.dtype == np.uint8 else 1.0
        img = image.astype(np.float32) * alpha
        img = img + beta * (max_value if self.brightness_by_max else img.mean())
        return np.clip(img, 0, 255).astype(np.uint8) if image.dtype == np.uint8 else img

    def draw_batch(self, shape, generator, device):
        """Contrast and brightness (N,), the gate."""
        device = draw_device(generator, device)
        n = shape[0]
        return (_uniform(n, *self.contrast_limit, generator, device),
                _uniform(n, *self.brightness_limit, generator, device),
                _gate(n, self.p, generator, device))

    def apply_drawn(self, batch, contrast, brightness, apply):
        img = batch["image"]
        max_value = 255.0 if img.dtype == torch.uint8 else 1.0
        x = img.float()
        alpha = 1.0 + _per_sample(contrast.to(img.device), 4)
        out = x * alpha + _per_sample(brightness.to(img.device), 4) * max_value
        out = torch.where(_per_sample(apply.to(img.device), 4), out, x)
        return {**batch, "image": _to_uint8(out) if img.dtype == torch.uint8 else out}


@TRANSFORMS.register_class
class RandomBrightness(RandomBrightnessContrast):
    def __init__(self, limit=0.2, **kw):
        super().__init__(brightness_limit=limit, contrast_limit=0.0, **kw)


@TRANSFORMS.register_class
class RandomContrast(RandomBrightnessContrast):
    def __init__(self, limit=0.2, **kw):
        super().__init__(brightness_limit=0.0, contrast_limit=limit, **kw)


@TRANSFORMS.register_class
class CoarseDropout(_Drawn):
    """Rectangles set to ``fill_value``: on the host ``min_holes`` to
    ``max_holes`` of them, on the device always ``max_holes`` (as the JAX
    package's), which also fills masks with ``mask_fill_value`` when it is
    given."""

    device_capable = True

    def __init__(self, max_holes: int = 8, max_height: int = 8, max_width: int = 8,
                 min_holes: Optional[int] = None, min_height: Optional[int] = None,
                 min_width: Optional[int] = None, fill_value: float = 0,
                 mask_fill_value: Optional[float] = None, always_apply: bool = False,
                 p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.max_holes, self.max_height, self.max_width = max_holes, max_height, max_width
        self.min_holes = min_holes or max_holes
        self.min_height = min_height or max_height
        self.min_width = min_width or max_width
        self.fill_value = fill_value
        self.mask_fill_value = mask_fill_value

    def apply(self, image, **params):
        h, w = image.shape[:2]
        out = image.copy()
        for _ in range(int(self.rng.integers(self.min_holes, self.max_holes + 1))):
            hh = int(self.rng.integers(self.min_height, self.max_height + 1))
            ww = int(self.rng.integers(self.min_width, self.max_width + 1))
            y = int(self.rng.integers(0, max(h - hh, 0) + 1))
            x = int(self.rng.integers(0, max(w - ww, 0) + 1))
            out[y:y + hh, x:x + ww] = self.fill_value
        return out

    def draw_batch(self, shape, generator, device):
        """Top and left as uniforms (N, K), heights and widths (N, K), the
        gate."""
        device = draw_device(generator, device)
        n, k = shape[0], self.max_holes
        ys = torch.rand((n, k), generator=generator, device=device)
        xs = torch.rand((n, k), generator=generator, device=device)
        hh = torch.randint(self.min_height, self.max_height + 1, (n, k), generator=generator,
                           device=device)
        ww = torch.randint(self.min_width, self.max_width + 1, (n, k), generator=generator,
                           device=device)
        return ys, xs, hh, ww, _gate(n, self.p, generator, device)

    def apply_drawn(self, batch, ys, xs, hh, ww, apply):
        img = batch["image"]
        n, h, w = img.shape[:3]
        ys, xs, hh, ww = (t.to(img.device).view(n, -1) for t in (ys, xs, hh, ww))
        y0 = (ys * (h - hh)).to(torch.int32)
        x0 = (xs * (w - ww)).to(torch.int32)
        rows = torch.arange(h, device=img.device)[None, None, :]
        cols = torch.arange(w, device=img.device)[None, None, :]
        row_in = (rows >= y0[:, :, None]) & (rows < (y0 + hh)[:, :, None])
        col_in = (cols >= x0[:, :, None]) & (cols < (x0 + ww)[:, :, None])
        hole = (row_in[:, :, :, None] & col_in[:, :, None, :]).any(dim=1)
        hole = hole & apply.to(img.device)[:, None, None]
        fill = torch.tensor(self.fill_value, device=img.device).to(img.dtype)
        out = {**batch, "image": torch.where(hole[..., None], fill, img)}
        mask = batch.get("mask")
        if mask is not None and self.mask_fill_value is not None:
            fill = torch.tensor(self.mask_fill_value, device=mask.device).to(mask.dtype)
            out["mask"] = torch.where(hole if mask.ndim == 3 else hole[..., None], fill, mask)
        return out


@TRANSFORMS.register_class
class Cutout(CoarseDropout):
    def __init__(self, num_holes: int = 8, max_h_size: int = 8, max_w_size: int = 8,
                 fill_value: float = 0, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(max_holes=num_holes, max_height=max_h_size, max_width=max_w_size,
                         fill_value=fill_value, always_apply=always_apply, p=p)


class _Gated(_Drawn):
    """A device transform whose only draw is the per-sample gate."""

    device_capable = True

    def draw_batch(self, shape, generator, device):
        return (_gate(shape[0], self.p, generator, draw_device(generator, device)),)


@TRANSFORMS.register_class
class InvertImg(_Gated):
    """``max - x``: 255 for uint8, else 1."""

    def apply(self, image, **params):
        max_value = 255 if image.dtype == np.uint8 else 1.0
        return (max_value - image).astype(image.dtype)

    def apply_drawn(self, batch, apply):
        img = batch["image"]
        inverted = 255 - img if img.dtype == torch.uint8 else 1.0 - img
        return {**batch, "image": torch.where(_per_sample(apply.to(img.device), 4), inverted,
                                              img)}


@TRANSFORMS.register_class
class ToGray(_Gated):
    """RGB to three equal channels of its luma: on the host cv2's
    ``RGB2GRAY`` and back, on the device BT.601 in float32, cast back to the
    image's dtype (uint8 truncated)."""

    def apply(self, image, **params):
        return np.repeat(color.rgb_to_gray(image)[..., None], 3, axis=-1)

    def apply_drawn(self, batch, apply):
        img = batch["image"]
        x = img.float()
        gray = x[..., 0:1] * _RGB_WEIGHTS[0] + x[..., 1:2] * _RGB_WEIGHTS[1] \
            + x[..., 2:3] * _RGB_WEIGHTS[2]
        out = torch.where(_per_sample(apply.to(img.device), 4), gray.expand_as(x), x)
        return {**batch, "image": out.to(img.dtype)}


@TRANSFORMS.register_class
class RandomGamma(_Drawn):
    """``x ** gamma`` in [0, 1] units, gamma drawn from ``gamma_limit`` / 100;
    the host maps uint8 through a float64 table, the device computes in
    float32, both truncate back to uint8."""

    device_capable = True

    def __init__(self, gamma_limit=(80, 120), always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.gamma_limit = tuple(gamma_limit)

    def apply(self, image, **params):
        gamma = self.rng.uniform(*self.gamma_limit) / 100.0
        if image.dtype == np.uint8:
            table = ((np.arange(256) / 255.0) ** gamma * 255).astype(np.uint8)
            return table[image]
        return np.power(image, gamma)

    def draw_batch(self, shape, generator, device):
        """Gammas (N,), the gate."""
        device = draw_device(generator, device)
        lo, hi = (g / 100.0 for g in self.gamma_limit)
        return _uniform(shape[0], lo, hi, generator, device), _gate(shape[0], self.p,
                                                                      generator, device)

    def apply_drawn(self, batch, gamma, apply):
        img = batch["image"]
        is_uint8 = img.dtype == torch.uint8
        x = divide(img.float(), 255.0) if is_uint8 else img.float()
        out = torch.pow(x.clamp(min=1e-12), _per_sample(gamma.to(img.device), 4))
        out = torch.where(_per_sample(apply.to(img.device), 4), out, x)
        return {**batch, "image": (out * 255.0).to(torch.uint8) if is_uint8 else out}


@TRANSFORMS.register_class
class Solarize(_Gated):
    """``max - x`` where ``x >= threshold`` (max 255 for uint8, else 1)."""

    def __init__(self, threshold=128, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.threshold = threshold

    def apply(self, image, **params):
        max_value = 255 if image.dtype == np.uint8 else 1.0
        return np.where(image >= self.threshold, max_value - image, image).astype(image.dtype)

    def apply_drawn(self, batch, apply):
        img = batch["image"]
        inverted = 255 - img if img.dtype == torch.uint8 else 1.0 - img
        solarized = torch.where(img >= self.threshold, inverted, img)
        return {**batch, "image": torch.where(_per_sample(apply.to(img.device), 4), solarized,
                                              img)}


@TRANSFORMS.register_class
class Posterize(_Gated):
    """The top ``num_bits`` bits of an integer image; the device path leaves
    a float image as it is (and draws nothing for it)."""

    def __init__(self, num_bits: int = 4, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.num_bits = num_bits

    def _mask_value(self):
        return np.uint8(255 ^ (2 ** (8 - self.num_bits) - 1))

    def apply(self, image, **params):
        return (image & self._mask_value()).astype(image.dtype)

    def apply_batch(self, batch, generator):
        if batch["image"].is_floating_point():
            return batch
        return super().apply_batch(batch, generator)

    def apply_drawn(self, batch, apply):
        img = batch["image"]
        if img.is_floating_point():
            return batch
        posterized = img & int(self._mask_value())
        return {**batch, "image": torch.where(_per_sample(apply.to(img.device), 4), posterized,
                                              img)}


@TRANSFORMS.register_class
class ChannelShuffle(_Drawn):
    """A random permutation of the channels (on the device the argsort of
    uniforms)."""

    device_capable = True

    def get_params(self, sample):
        return {"perm": self.rng.permutation(sample["image"].shape[-1])}

    def apply(self, image, perm=None, **params):
        return image[..., perm]

    def draw_batch(self, shape, generator, device):
        """Uniforms (N, C) whose argsort is each sample's order, the gate."""
        device = draw_device(generator, device)
        return (torch.rand((shape[0], shape[3]), generator=generator, device=device),
                _gate(shape[0], self.p, generator, device))

    def apply_drawn(self, batch, keys, apply):
        img = batch["image"]
        perm = keys.to(img.device).argsort(dim=1)
        shuffled = torch.gather(img, 3, perm[:, None, None, :].expand_as(img))
        return {**batch, "image": torch.where(_per_sample(apply.to(img.device), 4), shuffled,
                                              img)}


@TRANSFORMS.register_class
class RGBShift(_Drawn):
    """A shift per channel drawn from its limit, uint8 clipped and
    truncated, other dtypes out in float32."""

    device_capable = True

    def __init__(self, r_shift_limit=20, g_shift_limit=20, b_shift_limit=20,
                 always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.limits = [_pair(r_shift_limit), _pair(g_shift_limit), _pair(b_shift_limit)]

    def apply(self, image, **params):
        shifts = np.array([self.rng.uniform(*lim) for lim in self.limits], np.float32)
        out = image.astype(np.float32) + shifts
        return np.clip(out, 0, 255).astype(np.uint8) if image.dtype == np.uint8 else out

    def draw_batch(self, shape, generator, device):
        """Uniforms in [0, 1) (N, 3), scaled to the limits when applied; the
        gate."""
        device = draw_device(generator, device)
        return (torch.rand((shape[0], 3), generator=generator, device=device),
                _gate(shape[0], self.p, generator, device))

    def apply_drawn(self, batch, u, apply):
        img = batch["image"]
        lo = torch.tensor([lim[0] for lim in self.limits], dtype=torch.float32, device=img.device)
        hi = torch.tensor([lim[1] for lim in self.limits], dtype=torch.float32, device=img.device)
        x = img.float()
        out = x + (u.to(img.device) * (hi - lo) + lo)[:, None, None, :]
        out = torch.where(_per_sample(apply.to(img.device), 4), out, x)
        return {**batch, "image": _to_uint8(out) if img.dtype == torch.uint8 else out}


@TRANSFORMS.register_class
class ToFloat(BaseTransform):
    """float32 ``x / max_value`` (default 255 for uint8, else 1)."""

    always_apply = True
    device_capable = True
    device_preserves_dtype = False

    def __init__(self, max_value: Optional[float] = None, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.max_value = max_value

    def apply(self, image, **params):
        mv = self.max_value or (255.0 if image.dtype == np.uint8 else 1.0)
        return image.astype(np.float32) / mv

    def apply_batch(self, batch, generator):
        img = batch["image"]
        mv = self.max_value or (255.0 if img.dtype == torch.uint8 else 1.0)
        return {**batch, "image": divide(img.float(), float(mv))}


@TRANSFORMS.register_class
class FromFloat(BaseTransform):
    """``x * max_value`` truncated to ``dtype`` (default uint16, max_value
    its largest value)."""

    always_apply = True
    device_capable = True
    device_preserves_dtype = False

    def __init__(self, dtype: str = "uint16", max_value: Optional[float] = None,
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.dtype = np.dtype(dtype)
        self.max_value = max_value

    def _max(self):
        return self.max_value or np.iinfo(self.dtype).max

    def apply(self, image, **params):
        return (image * self._max()).astype(self.dtype)

    def apply_batch(self, batch, generator):
        x = batch["image"] * self._max()
        if self.dtype in (np.uint16, np.uint32):
            # PyTorch's unsigned wide dtypes convert from few types, on CUDA
            # fewer: truncate in a wider signed type, keep the low bits and
            # reinterpret them
            wide, narrow = (torch.int32, torch.int16) if self.dtype == np.uint16 else \
                (torch.int64, torch.int32)
            out = x.to(wide).to(narrow).view(getattr(torch, self.dtype.name))
        else:
            out = x.to(getattr(torch, self.dtype.name))
        return {**batch, "image": out}


# --------------------------------- filters ---------------------------------

@TRANSFORMS.register_class
class Blur(_Drawn):
    """A box blur of an odd size drawn from ``blur_limit`` (reflect-101);
    an integer image is rounded back (on the device half up)."""

    device_capable = True

    def __init__(self, blur_limit=7, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.blur_limit = _low_high(blur_limit, 3)

    def get_params(self, sample):
        return {"ksize": _odd_ksize(self.rng, self.blur_limit)}

    def apply(self, image, ksize=3, **params):
        return filters.blur(image, ksize)

    def _radii(self, n: int, generator, device) -> torch.Tensor:
        lo, hi = _odd_radii(self.blur_limit)
        return torch.randint(lo, hi + 1, (n,), generator=generator, device=device)

    def draw_batch(self, shape, generator, device):
        """Radii (N,), the gate."""
        device = draw_device(generator, device)
        return (self._radii(shape[0], generator, device),
                _gate(shape[0], self.p, generator, device))

    def _kernels(self, radii):
        k = filters.box_kernels(radii, _odd_radii(self.blur_limit)[1])
        return k, k

    def apply_drawn(self, batch, *draws):
        img = batch["image"]
        kh, kw = self._kernels(*draws[:-1])
        x = img.float()
        out = torch.where(_per_sample(draws[-1].to(img.device), 4),
                          filters.sep_filter_per_sample(x, kh, kw), x)
        return {**batch, "image": out if img.is_floating_point() else saturate_int(out,
                                                                                   img.dtype)}


@TRANSFORMS.register_class
class GaussianBlur(Blur):
    """A Gaussian blur of an odd size from ``blur_limit`` and a sigma from
    ``sigma_limit`` (0: from the size, cv2's tables up to 7)."""

    def __init__(self, blur_limit=(3, 7), sigma_limit=0, always_apply: bool = False,
                 p: float = 0.5, **_):
        super().__init__(blur_limit, always_apply, p)
        self.sigma_limit = _low_high(sigma_limit, 0)

    def get_params(self, sample):
        ksize = _odd_ksize(self.rng, self.blur_limit)
        return {"ksize": ksize, "sigma": float(self.rng.uniform(*self.sigma_limit))}

    def apply(self, image, ksize=3, sigma=0.0, **params):
        return filters.gaussian_blur(image, ksize, sigma)

    def draw_batch(self, shape, generator, device):
        """Radii (N,), sigmas (N,), the gate."""
        device = draw_device(generator, device)
        n = shape[0]
        return (self._radii(n, generator, device),
                _uniform(n, *self.sigma_limit, generator, device),
                _gate(n, self.p, generator, device))

    def _kernels(self, radii, sigmas):
        k = filters.gauss_kernels(radii, sigmas, _odd_radii(self.blur_limit)[1])
        return k, k


@TRANSFORMS.register_class
class MedianBlur(Blur):
    """The median of each odd window (from ``blur_limit``), the border
    replicated."""

    def apply(self, image, ksize=3, **params):
        return filters.median_blur(image, ksize)

    def apply_drawn(self, batch, radii, apply):
        img = batch["image"]
        x = filters.median_filter_per_sample(img, radii, _odd_radii(self.blur_limit)[1])
        return {**batch, "image": torch.where(_per_sample(apply.to(img.device), 4), x, img)}


@TRANSFORMS.register_class
class MotionBlur(Blur):
    """A box of an odd size from ``blur_limit`` along the rows or the
    columns, drawn evenly."""

    def get_params(self, sample):
        return {}

    def apply(self, image, **params):
        k = _odd_ksize(self.rng, self.blur_limit)
        kernel = np.zeros((k, k), np.float32)
        if self.rng.random() < 0.5:
            kernel[k // 2, :] = 1.0
        else:
            kernel[:, k // 2] = 1.0
        kernel /= kernel.sum()
        return filters.filter2d(image, kernel)

    def draw_batch(self, shape, generator, device):
        """Radii (N,), directions (N,) (true: along the rows), the gate."""
        device = draw_device(generator, device)
        n = shape[0]
        return (self._radii(n, generator, device),
                torch.rand((n,), generator=generator, device=device) < 0.5,
                _gate(n, self.p, generator, device))

    def _kernels(self, radii, horizontal):
        hi = _odd_radii(self.blur_limit)[1]
        box = filters.box_kernels(radii, hi)
        delta = (torch.arange(-hi, hi + 1, device=box.device) == 0).float().expand_as(box)
        horizontal = horizontal.to(box.device)[:, None]
        return torch.where(horizontal, delta, box), torch.where(horizontal, box, delta)


# ------------------------------ colour and tone ------------------------------

@TRANSFORMS.register_class
class CLAHE(_Drawn):
    """Contrast-limited adaptive histogram equalisation of the L*a*b* L
    channel (a one-channel image directly), the clip limit drawn from
    ``clip_limit``; uint8 only. Its core is cv2's bit for bit. The host
    converts RGB to L*a*b* as cv2's 8-bit path does and back by cv2's float
    formulas (cv2 uses fixed-point tables: within two levels); the device
    path both ways by the float formulas, as the JAX package's."""

    device_capable = True

    def __init__(self, clip_limit=4.0, tile_grid_size=(8, 8), always_apply: bool = False,
                 p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.clip_limit = _low_high(clip_limit, 1.0)
        self.tile_grid_size = tuple(tile_grid_size)

    def apply(self, image, **params):
        clip = torch.tensor([float(self.rng.uniform(*self.clip_limit))])
        _require_uint8("CLAHE", image.dtype)

        def equalized(channel):
            x = torch.from_numpy(channel.astype(np.float32))[None]
            return color.clahe_u8(x, clip, self.tile_grid_size)[0].numpy().astype(np.uint8)

        if image.ndim == 2 or image.shape[-1] == 1:
            return equalized(image.reshape(image.shape[:2])).reshape(image.shape)
        lab = color.rgb_to_lab_u8(image)
        lab[..., 0] = equalized(lab[..., 0])
        return color.lab_u8_to_rgb(lab)

    def draw_batch(self, shape, generator, device):
        """Clip limits (N,), the gate."""
        device = draw_device(generator, device)
        return (_uniform(shape[0], *self.clip_limit, generator, device),
                _gate(shape[0], self.p, generator, device))

    def apply_drawn(self, batch, clip, apply):
        img = batch["image"]
        _require_uint8("CLAHE", img.dtype)
        x = color.clahe_rgb_u8(img, clip.to(img.device), self.tile_grid_size)
        out = torch.where(_per_sample(apply.to(img.device), 4), x, img.float())
        return {**batch, "image": out.to(torch.uint8)}


@TRANSFORMS.register_class
class Equalize(_Gated):
    """Histogram equalisation of each channel; uint8 only. The host gives
    cv2's ``equalizeHist``; the device rounds its table half up, as the JAX
    package's."""

    def apply(self, image, **params):
        _require_uint8("Equalize", image.dtype)
        if image.ndim == 2:
            return color.equalize_hist(image)
        return np.stack([color.equalize_hist(image[..., c]) for c in range(image.shape[-1])],
                        axis=-1)

    def apply_drawn(self, batch, apply):
        img = batch["image"]
        _require_uint8("Equalize", img.dtype)
        n, h, w, c = img.shape
        flat = img.permute(0, 3, 1, 2).reshape(n, c, h * w).long()
        hist = torch.zeros((n, c, 256), dtype=torch.int64, device=img.device)
        hist.scatter_add_(2, flat, torch.ones_like(flat))
        cdf = hist.cumsum(dim=-1)
        total = h * w
        cdf_min = torch.where(hist > 0, cdf, total + 1).min(dim=-1, keepdim=True).values
        denom = (total - cdf_min).clamp(min=1).float()
        lut = torch.floor((cdf - cdf_min).clamp(min=0).float() * 255.0 / denom + 0.5)
        mapped = torch.gather(lut, 2, flat).view(n, c, h, w).permute(0, 2, 3, 1)
        constant = (cdf_min[..., 0] >= total)[:, None, None, :]
        x = torch.where(constant, img.float(), mapped)
        out = torch.where(_per_sample(apply.to(img.device), 4), x, img.float())
        return {**batch, "image": out.to(img.dtype)}


@TRANSFORMS.register_class
class HueSaturationValue(_Drawn):
    """Whole-number shifts of hue (mod 180), saturation and value on cv2's
    uint8 HSV scales, each drawn from its limit and truncated; uint8 only.
    The host converts as cv2 does; the device by float formulas rounded half
    up, as the JAX package's."""

    device_capable = True

    def __init__(self, hue_shift_limit=20, sat_shift_limit=30, val_shift_limit=20,
                 always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.hue_shift_limit = _pair(hue_shift_limit)
        self.sat_shift_limit = _pair(sat_shift_limit)
        self.val_shift_limit = _pair(val_shift_limit)

    def apply(self, image, **params):
        _require_uint8("HueSaturationValue", image.dtype)
        hsv = color.rgb_to_hsv_cv2(image).astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + int(self.rng.uniform(*self.hue_shift_limit))) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + int(self.rng.uniform(*self.sat_shift_limit)), 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] + int(self.rng.uniform(*self.val_shift_limit)), 0, 255)
        return color.hsv_to_rgb_cv2(hsv.astype(np.uint8))

    def draw_batch(self, shape, generator, device):
        """Hue, saturation and value shifts (N,) before truncation, the
        gate."""
        device = draw_device(generator, device)
        n = shape[0]
        return tuple(_uniform(n, *lim, generator, device) for lim in (
            self.hue_shift_limit, self.sat_shift_limit, self.val_shift_limit)) + (
            _gate(n, self.p, generator, device),)

    def apply_drawn(self, batch, dh, ds, dv, apply):
        img = batch["image"]
        _require_uint8("HueSaturationValue", img.dtype)
        dh, ds, dv = (torch.trunc(d.to(img.device)).view(-1, 1, 1) for d in (dh, ds, dv))
        h, s, v = color.rgb_to_hsv_u8(img.float())
        h = torch.remainder(h + dh, 180.0)
        s = (s + ds).clamp(0, 255)
        v = (v + dv).clamp(0, 255)
        x = color.quantize_u8(color.hsv_u8_to_rgb(h, s, v))
        out = torch.where(_per_sample(apply.to(img.device), 4), x, img.float())
        return {**batch, "image": out.to(img.dtype)}


@TRANSFORMS.register_class
class ImageCompression(BaseTransform):
    """A JPEG round trip at a quality drawn from [quality_lower,
    quality_upper], as cv2.imencode(".jpg") and imdecode make it (through
    libjpeg in ``native``, which raises by name where libjpeg is missing);
    host only. A non-uint8 image is first rounded to uint8, as cv2 does."""

    def __init__(self, quality_lower: int = 99, quality_upper: int = 100,
                 compression_type: int = 0, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.quality_lower = quality_lower
        self.quality_upper = quality_upper

    def apply(self, image, **params):
        q = int(self.rng.integers(self.quality_lower, self.quality_upper + 1))
        img = image if image.dtype == np.uint8 else np.clip(np.rint(image), 0, 255).astype(
            np.uint8)
        if img.ndim == 2 or img.shape[-1] == 1:
            dec = native.decode_jpeg(native.encode_jpeg(img, q))[..., 0]
            return dec[..., None] if image.ndim == 3 else dec
        # cv2 reads the channels as BGR: the colour transform weighs them so
        return np.ascontiguousarray(
            native.decode_jpeg(native.encode_jpeg(img[..., ::-1], q))[..., ::-1])


@TRANSFORMS.register_class
class JpegCompression(ImageCompression):
    pass


@TRANSFORMS.register_class
class Downscale(_Drawn):
    """A resize down by a factor from [scale_min, scale_max] and back up
    with ``interpolation``; the device path only for INTER_NEAREST, where
    the two index maps compose into one integer gather."""

    def __init__(self, scale_min: float = 0.25, scale_max: float = 0.25,
                 interpolation: int = INTER_NEAREST, always_apply: bool = False,
                 p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.scale_min, self.scale_max = scale_min, scale_max
        self.interpolation = interpolation
        self.device_capable = interpolation == INTER_NEAREST

    def apply(self, image, **params):
        s = float(self.rng.uniform(self.scale_min, self.scale_max))
        h, w = image.shape[:2]
        small = _resize(image, max(1, int(h * s)), max(1, int(w * s)), self.interpolation)
        return _resize(small, h, w, self.interpolation)

    def draw_batch(self, shape, generator, device):
        """Scales (N,), the gate."""
        device = draw_device(generator, device)
        return (_uniform(shape[0], self.scale_min, self.scale_max, generator, device),
                _gate(shape[0], self.p, generator, device))

    def apply_drawn(self, batch, scale, apply):
        img = batch["image"]
        n, h, w = img.shape[:3]
        scale = scale.to(img.device)

        def index(size):
            small = torch.floor(size * scale).clamp(min=1).to(torch.int64)[:, None]
            i = torch.arange(size, device=img.device)[None, :]
            return (((i * small) // size) * size) // small

        iy, ix = index(h), index(w)
        down = img[torch.arange(n, device=img.device)[:, None, None], iy[:, :, None],
                   ix[:, None, :]]
        return {**batch, "image": torch.where(_per_sample(apply.to(img.device), 4), down, img)}


@TRANSFORMS.register_class
class Sharpen(_Drawn):
    """A blend ``(1 - alpha) x + alpha filter2D(x, k)`` with ``k`` the 3x3
    kernel of -1 around ``8 + lightness``; an integer image's filtered
    values are rounded to its dtype first (the device half up), uint8's
    blend truncated."""

    device_capable = True
    _BASE = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], np.float32)

    def __init__(self, alpha=(0.2, 0.5), lightness=(0.5, 1.0), always_apply: bool = False,
                 p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.alpha = tuple(alpha)
        self.lightness = tuple(lightness)

    def apply(self, image, **params):
        alpha = float(self.rng.uniform(*self.alpha))
        lightness = float(self.rng.uniform(*self.lightness))
        kernel = self._BASE.copy()
        kernel[1, 1] += lightness
        sharp = filters.filter2d(image, kernel)
        out = (1 - alpha) * image.astype(np.float32) + alpha * sharp.astype(np.float32)
        return np.clip(out, 0, 255).astype(np.uint8) if image.dtype == np.uint8 else out

    def draw_batch(self, shape, generator, device):
        """Alphas (N,), lightnesses (N,), the gate."""
        device = draw_device(generator, device)
        n = shape[0]
        return (_uniform(n, *self.alpha, generator, device),
                _uniform(n, *self.lightness, generator, device),
                _gate(n, self.p, generator, device))

    def apply_drawn(self, batch, alpha, lightness, apply):
        img = batch["image"]
        x = img.float()
        alpha = _per_sample(alpha.to(img.device), 4)
        # the kernel is the shared base plus lightness at the centre
        sharp = filters.fixed_filter2d(x, self._BASE) + _per_sample(lightness.to(img.device), 4) * x
        if not img.is_floating_point():
            sharp = saturate_int(sharp, img.dtype).float()
        out = torch.where(_per_sample(apply.to(img.device), 4), (1 - alpha) * x + alpha * sharp, x)
        return {**batch, "image": _to_uint8(out) if img.dtype == torch.uint8 else out}


@TRANSFORMS.register_class
class ToSepia(_Gated):
    """The sepia matrix on RGB, clipped to [0, 255] for uint8 (then
    truncated) or [0, 1]."""

    _M = np.array([[0.393, 0.769, 0.189],
                   [0.349, 0.686, 0.168],
                   [0.272, 0.534, 0.131]], np.float32)

    def apply(self, image, **params):
        out = image.astype(np.float32) @ self._M.T
        if image.dtype == np.uint8:
            return np.clip(out, 0, 255).astype(np.uint8)
        return np.clip(out, 0, 1.0)

    def apply_drawn(self, batch, apply):
        img = batch["image"]
        is_uint8 = img.dtype == torch.uint8
        x = img.float()
        sepia = torch.stack(color.matvec(self._M, x[..., 0], x[..., 1], x[..., 2]), dim=-1)
        sepia = sepia.clamp(0, 255.0 if is_uint8 else 1.0)
        out = torch.where(_per_sample(apply.to(img.device), 4), sepia,
                          x.clamp(0, 255) if is_uint8 else x)
        return {**batch, "image": out.to(torch.uint8) if is_uint8 else out}
