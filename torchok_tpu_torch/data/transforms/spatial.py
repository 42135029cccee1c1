"""Spatial transforms (port of ``torchok_tpu.data.transforms.spatial``):
numpy on the host, without cv2; batched torch on the trainer's device for
every transform whose JAX class has ``apply_batch``.

* Host paths draw from the sample's generator in the JAX classes' order and
  move a sample's pixel xyxy boxes (``apply_to_bboxes``: scaled, shifted
  and clipped, or each box's corners through the warp's matrix and their
  envelope clipped to the frame; rows kept so labels stay aligned). The
  warps without a box handler (ElasticTransform, GridDistortion,
  OpticalDistortion, RandomGridShuffle, PiecewiseAffine) raise on a sample
  with boxes.
* Device paths split their work in two: ``draw_batch(shape, generator,
  device)`` makes the per-sample draws (in the values the JAX package's
  samplers return) and ``apply_drawn(batch, *draws)`` applies them, so the
  same draws can run on the card and on the CPU. None moves boxes, so none
  leaves the host for a dataset with boxes (``device_bbox_safe`` False).
* Each keeps the JAX class's ``device_capable`` gate (bilinear or nearest,
  borders constant, replicate or reflect-101, scalar fills), and
  ``device_needs_uniform``. Masks always sample nearest and fill a constant
  border with ``mask_value``.

The warps sample through :mod:`torchok_tpu_torch.ops.warp`: on the host
OpenCV 5's ``remap``, ``warpAffine`` and ``warpPerspective`` in numpy, on
the device float32 gathers. Resizes give cv2's semantics: INTER_LINEAR
samples at half-pixel centres with two taps and no antialiasing when
shrinking, and an integer image is rounded half up and saturated to its
dtype; INTER_NEAREST (and every mask) takes ``floor(i * src / dst)``. The
host path computes that with numpy, the device path with
``F.interpolate(..., align_corners=False, antialias=False)``. Only those
two interpolations are ported: another raises when the transform is built.
"""
from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.data.transforms.base import BaseTransform, draw_device
from torchok_tpu_torch.ops import warp
from torchok_tpu_torch.ops.image import resize_bilinear, resize_nearest_cv2

# cv2's interpolation flags, as the recipes spell them
INTER_NEAREST = 0
INTER_LINEAR = 1
_PORTED_INTERPS = (INTER_NEAREST, INTER_LINEAR)
# cv2's border modes 0 to 4 (CONSTANT, REPLICATE, REFLECT, WRAP, REFLECT_101)
# as numpy pad modes
BORDER_CONSTANT = 0
BORDER_REPLICATE = 1
BORDER_REFLECT_101 = 4
_NUMPY_BORDERS = {0: "constant", 1: "edge", 2: "symmetric", 3: "wrap", 4: "reflect"}
# what the device paths take, as in the JAX package
_DEVICE_BORDERS = (BORDER_CONSTANT, BORDER_REPLICATE, BORDER_REFLECT_101)


def _scalar_or_none(v) -> bool:
    return v is None or isinstance(v, (int, float))


def _pair(v, around_one: bool = False) -> Tuple[float, float]:
    """A scalar limit ``v`` as (-v, v) (or (1 - v, 1 + v)), a pair as is."""
    if isinstance(v, (int, float)):
        return (1 - v, 1 + v) if around_one else (-v, v)
    return tuple(v)


def _check_border(border_mode: int) -> int:
    if border_mode not in _NUMPY_BORDERS:
        raise NotImplementedError(f"border_mode={border_mode!r}: only cv2's modes 0 to 4 are "
                                  "ported")
    return border_mode


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


@lru_cache(maxsize=None)
def _nearest_indices(src: int, dst: int) -> np.ndarray:
    """cv2.resize INTER_NEAREST's source index of each output pixel on the
    host: ``floor(i * (1 / (dst / src)))`` in float64, as cv2 computes it
    (one below ``floor(i * src / dst)`` where that product is a whole number
    that the reciprocal misses; the device path keeps the JAX package's
    ``ops.image.nearest_cv2_indices``)."""
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))), src - 1).astype(np.int64)


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
        iy = _nearest_indices(img.shape[0], h)
        ix = _nearest_indices(img.shape[1], w)
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


def _shift_clip_bboxes(bboxes, x0: int, y0: int, crop_w: int, crop_h: int) -> np.ndarray:
    b = _as_boxes(bboxes).copy()
    b[:, [0, 2]] = np.clip(b[:, [0, 2]] - x0, 0, crop_w)
    b[:, [1, 3]] = np.clip(b[:, [1, 3]] - y0, 0, crop_h)
    return b


def _as_boxes(bboxes) -> np.ndarray:
    return np.asarray(bboxes, np.float32).reshape(-1, 4)


def _affine_bboxes(bboxes, m, out_w: int, out_h: int) -> np.ndarray:
    """Each box's four corners through a 2x3 affine (or 3x3 projective)
    matrix, their axis-aligned envelope clipped to the output frame."""
    b = _as_boxes(bboxes)
    if len(b) == 0:
        return b
    corners = np.stack([b[:, [0, 1]], b[:, [2, 1]], b[:, [0, 3]], b[:, [2, 3]]], axis=1)
    ones = np.ones(corners.shape[:2] + (1,), np.float32)
    pts = np.concatenate([corners, ones], axis=-1) @ np.asarray(m, np.float32).T
    if pts.shape[-1] == 3:  # projective: divide by the third coordinate
        pts = pts[..., :2] / np.clip(pts[..., 2:3], 1e-9, None)
    out = np.stack([pts[..., 0].min(1), pts[..., 1].min(1),
                    pts[..., 0].max(1), pts[..., 1].max(1)], axis=1)
    out[:, [0, 2]] = np.clip(out[:, [0, 2]], 0, out_w)
    out[:, [1, 3]] = np.clip(out[:, [1, 3]], 0, out_h)
    return out


def _per_mask(mask: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``fn`` of an (N, H, W) or (N, H, W, C) mask, as an NHWC batch."""
    out = fn(mask[..., None] if mask.ndim == 3 else mask)
    return out[..., 0] if mask.ndim == 3 else out


def _keep(applied: Optional[torch.Tensor], out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out`` where ``applied`` (N,), ``x`` elsewhere."""
    if applied is None:
        return out
    return torch.where(applied.to(x.device).view((-1,) + (1,) * (x.ndim - 1)), out, x)


def _from_float(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A float32 result in the input's dtype: an integer rounded half up and
    saturated, as the JAX package's device paths round."""
    return out if like.is_floating_point() else saturate_int(out, like.dtype)


def _device_warp_batch(batch, inv_mats, out_hw, applied, interpolation, border_mode, value,
                       mask_value):
    """Warp the NHWC image (and mask) with per-sample DST->SRC affines
    (N, 2, 3): the image bilinear or nearest (half up), the mask nearest
    with ``mask_value`` filling a constant border; where ``applied`` (N,) is
    false a sample keeps its input (same-size warps only)."""
    batch = dict(batch)
    img = batch["image"]
    border = warp.BORDERS[border_mode]
    method = "nearest" if interpolation == INTER_NEAREST else "bilinear"
    x = img.float()
    out = warp.inverse_affine_sample(x, inv_mats, out_hw, method, border,
                                     0.0 if value is None else float(value))
    batch["image"] = _from_float(_keep(applied, out, x), img)
    if batch.get("mask") is not None:
        fill = 0.0 if mask_value is None else float(mask_value)
        batch["mask"] = _per_mask(batch["mask"], lambda m: _keep(
            applied, warp.inverse_affine_sample(m, inv_mats, out_hw, "nearest", border, fill), m))
    return batch


def _device_crop_batch(batch, rects, out_hw):
    """Per-sample crop-and-resize of the NHWC image (bilinear; an integer
    rect of the output's size is an exact crop) and mask (nearest), rects
    (N, 4) = (y0, x0, ch, cw)."""
    batch = dict(batch)
    img = batch["image"]
    batch["image"] = _from_float(warp.crop_resize_sample(img.float(), rects, out_hw), img)
    if batch.get("mask") is not None:
        batch["mask"] = _per_mask(batch["mask"], lambda m: warp.crop_resize_sample(
            m, rects, out_hw, "nearest"))
    return batch


def _device_pad_batch(arr: torch.Tensor, t: int, b: int, l: int, r: int, border_mode: int,
                      value) -> torch.Tensor:
    """cv2.copyMakeBorder of an (N, H, W[, C]) batch with fixed pads: a
    constant fill (a scalar fills channel 0 of a multi-channel image, as
    cv2's ``Scalar(v, 0, 0, 0)``), replicate or reflect-101 (periodic where
    a pad is wider than the image)."""
    h, w = arr.shape[1:3]
    border = warp.BORDERS[border_mode]
    iy = torch.arange(-t, h + b, device=arr.device)
    ix = torch.arange(-l, w + r, device=arr.device)
    gy, vy = warp.border_index(iy, h, border)
    gx, vx = warp.border_index(ix, w, border)
    out = arr[:, gy][:, :, gx]
    if vy is None:
        return out
    fill = torch.zeros(arr.shape[3:], dtype=arr.dtype, device=arr.device)
    if value:
        if arr.ndim == 4:
            fill[0] = value
        else:
            fill = torch.full((), value, device=arr.device).to(arr.dtype)
    inside = (vy[:, None] & vx[None, :]).view((1,) + tuple(out.shape[1:3]) +
                                              (1,) * (arr.ndim - 3))
    return torch.where(inside, out, fill)


def _device_perspective_batch(batch, mats, out_hw, applied, interpolation):
    """Projective warp of the NHWC image (and mask) with per-sample SRC->DST
    3x3 matrices, cv2.warpPerspective's defaults: a constant border of 0."""
    batch = dict(batch)
    img = batch["image"]
    method = "nearest" if interpolation == INTER_NEAREST else "bilinear"
    x = img.float()
    out = warp.perspective_sample(x, mats, out_hw, method, "constant", 0.0)
    batch["image"] = _from_float(_keep(applied, out, x), img)
    if batch.get("mask") is not None:
        batch["mask"] = _per_mask(batch["mask"], lambda m: _keep(
            applied, warp.perspective_sample(m, mats, out_hw, "nearest", "constant", 0.0), m))
    return batch


def _gate(n: int, p: float, generator, device) -> torch.Tensor:
    """Per-sample application (N,) bool: a uniform against ``p``."""
    return torch.rand((n,), generator=generator, device=device) < p


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    """float32 uniforms in [lo, hi), as ``jax.random.uniform(minval=lo,
    maxval=hi)`` draws them."""
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


@TRANSFORMS.register_class
class Resize(BaseTransform):
    always_apply = True
    device_capable = True
    device_needs_uniform = True  # batched resize needs one input shape
    geometric = True
    device_bbox_safe = False

    def __init__(self, height: int, width: int, interpolation: int = INTER_LINEAR,
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.height, self.width = height, width
        self.interpolation = _check_interpolation(interpolation)

    def apply(self, image, **params):
        return _resize(image, self.height, self.width, self.interpolation)

    def apply_to_mask(self, mask, **params):
        return _resize(mask, self.height, self.width, INTER_NEAREST)

    def apply_to_bboxes(self, bboxes, image_shape, **params):
        h, w = image_shape[:2]
        scale = np.array([self.width / w, self.height / h] * 2, np.float32)
        return np.asarray(bboxes, np.float32) * scale

    def apply_batch(self, batch, generator):
        return _device_resize_to(batch, self.height, self.width, self.interpolation)


class _CropBase(BaseTransform):
    geometric = True
    device_bbox_safe = False

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

    def apply_to_bboxes(self, bboxes, image_shape, y0=0, x0=0, **params):
        h, w = image_shape[:2]
        return _shift_clip_bboxes(bboxes, x0, y0, min(self.width, w - x0),
                                  min(self.height, h - y0))


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


def _scale_bboxes(bboxes, sx: float, sy: float) -> np.ndarray:
    b = _as_boxes(bboxes).copy()
    b[:, [0, 2]] *= sx
    b[:, [1, 3]] *= sy
    return b


@TRANSFORMS.register_class
class FitResize(BaseTransform):
    """Aspect-preserving resize into ``max_height`` x ``max_width``: the side
    that binds (an exact ``Fraction`` test of the aspect ratios) meets its
    limit, the other is scaled by the same factor and rounded (Python's
    ``round``). On the device the size follows the batch's one input shape."""

    always_apply = True
    geometric = True
    device_capable = True
    device_needs_uniform = True
    device_bbox_safe = False

    def __init__(self, max_height: int = 1024, max_width: int = 1024,
                 interpolation: int = INTER_LINEAR, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.max_height, self.max_width = max_height, max_width
        self.interpolation = _check_interpolation(interpolation)
        self.aspect_ratio = Fraction(max_height, max_width)

    def _size(self, h: int, w: int) -> Tuple[int, int]:
        s = self.max_height / h if Fraction(h, w) >= self.aspect_ratio else self.max_width / w
        return max(1, round(h * s)), max(1, round(w * s))

    def apply(self, image, **params):
        return _resize(image, *self._size(*image.shape[:2]), self.interpolation)

    def apply_to_mask(self, mask, **params):
        return _resize(mask, *self._size(*mask.shape[:2]), INTER_NEAREST)

    def apply_to_bboxes(self, bboxes, image_shape, **params):
        h, w = image_shape[:2]
        nh, nw = self._size(h, w)
        return _scale_bboxes(bboxes, nw / w, nh / h)

    def apply_batch(self, batch, generator):
        return _device_resize_to(batch, *self._size(*batch["image"].shape[1:3]),
                                 self.interpolation)


def copy_make_border(arr: np.ndarray, top: int, bottom: int, left: int, right: int,
                     border_mode: int, value=None) -> np.ndarray:
    """``cv2.copyMakeBorder`` of an HWC or HW array: modes 0 to 4 as numpy
    pads (``constant`` with cv2's fill, ``edge``, ``symmetric``, ``wrap``,
    ``reflect``)."""
    if border_mode not in _NUMPY_BORDERS:
        raise NotImplementedError(f"border_mode={border_mode!r}: only cv2's modes 0 to 4 are "
                                  "ported")
    pads = ((top, bottom), (left, right)) + ((0, 0),) * (arr.ndim - 2)
    if border_mode != BORDER_CONSTANT:
        return np.pad(arr, pads, mode=_NUMPY_BORDERS[border_mode])
    fill = warp.border_fill(value, arr.shape[2] if arr.ndim == 3 else None, arr.dtype)
    out = np.empty((arr.shape[0] + top + bottom, arr.shape[1] + left + right) + arr.shape[2:],
                   arr.dtype)
    out[...] = fill
    out[top:top + arr.shape[0], left:left + arr.shape[1]] = arr
    return out


@TRANSFORMS.register_class
class PadIfNeeded(BaseTransform):
    """Pad up to ``min_height`` x ``min_width``, the rows split ``ph // 2``
    on top and the rest below (the columns likewise); ``mask_value`` fills a
    constant border of the mask. On the device the pads follow the batch's
    one input shape."""

    always_apply = True
    geometric = True
    device_needs_uniform = True
    device_bbox_safe = False

    def __init__(self, min_height: int = 1024, min_width: int = 1024,
                 border_mode: int = BORDER_REFLECT_101, value=None, mask_value=None,
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.min_height, self.min_width = min_height, min_width
        self.border_mode = _check_border(border_mode)
        self.value = value
        self.mask_value = mask_value

    @property
    def device_capable(self):
        return (self.border_mode in _DEVICE_BORDERS and _scalar_or_none(self.value)
                and _scalar_or_none(self.mask_value))

    def _pads(self, h: int, w: int) -> Tuple[int, int, int, int]:
        ph = max(self.min_height - h, 0)
        pw = max(self.min_width - w, 0)
        return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2

    def apply(self, image, **params):
        return copy_make_border(image, *self._pads(*image.shape[:2]), self.border_mode,
                                self.value)

    def apply_to_mask(self, mask, **params):
        return copy_make_border(mask, *self._pads(*mask.shape[:2]), self.border_mode,
                                self.mask_value)

    def apply_to_bboxes(self, bboxes, image_shape, **params):
        t, _, l, _ = self._pads(*image_shape[:2])
        b = _as_boxes(bboxes).copy()
        b[:, [0, 2]] += l
        b[:, [1, 3]] += t
        return b

    def apply_batch(self, batch, generator):
        batch = dict(batch)
        for key, value in (("image", self.value), ("mask", self.mask_value)):
            arr = batch.get(key)
            if arr is not None and any(pads := self._pads(*arr.shape[1:3])):
                batch[key] = _device_pad_batch(arr, *pads, self.border_mode, value)
        return batch


def _device_remap_batch(batch: Dict[str, torch.Tensor], map_x: torch.Tensor,
                        map_y: torch.Tensor, applied: torch.Tensor, interpolation: int,
                        border_mode: int) -> Dict[str, torch.Tensor]:
    """Remap the NHWC image (and mask) with per-sample maps (N, H, W) where
    ``applied`` (N,), in float32 (bilinear, or nearest half to even as
    cv2.remap rounds; the mask always nearest), a constant border filled
    with 0; an integer image rounded half up and saturated to its dtype."""
    batch = dict(batch)
    img = batch["image"]
    border = warp.BORDERS[border_mode]
    method = "nearest_even" if interpolation == INTER_NEAREST else "bilinear"
    keep = applied.to(img.device).view(-1, 1, 1, 1)
    x = img.float()
    out = torch.where(keep, warp.remap_sample(x, map_x, map_y, method, border), x)
    batch["image"] = out if img.is_floating_point() else saturate_int(out, img.dtype)
    mask = batch.get("mask")
    if mask is not None:
        m = mask[..., None] if mask.ndim == 3 else mask
        mo = torch.where(keep, warp.remap_sample(m, map_x, map_y, "nearest_even", border), m)
        batch["mask"] = mo[..., 0] if mask.ndim == 3 else mo
    return batch


class _Remap(BaseTransform):
    """A warp by a per-sample dense map: ``get_params`` draws the maps on the
    host, ``draw_batch``/``apply_drawn`` on the device (the same input shape
    across the batch)."""

    geometric = True
    device_bbox_safe = False  # no box handler: a sample with boxes raises
    device_needs_uniform = True

    def __init__(self, interpolation: int = INTER_LINEAR,
                 border_mode: int = warp.BORDER_REFLECT_101, always_apply: bool = False,
                 p: float = 0.5):
        super().__init__(always_apply, p)
        warp.check_remap_flags(interpolation, border_mode)
        self.interpolation = interpolation
        self.border_mode = border_mode

    @property
    def device_capable(self):
        return self.border_mode in _DEVICE_BORDERS

    def apply(self, image, map_x=None, map_y=None, **params):
        return warp.remap(image, map_x, map_y, self.interpolation, self.border_mode)

    def apply_to_mask(self, mask, map_x=None, map_y=None, **params):
        return warp.remap(mask, map_x, map_y, INTER_NEAREST, self.border_mode)

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[:3], generator, img.device))


@TRANSFORMS.register_class
class ElasticTransform(_Remap):
    """Elastic deformation: a uniform [-1, 1] displacement per pixel and
    axis, blurred by a Gaussian of ``sigma`` (``int(3 sigma) | 1`` taps,
    reflect-101) and scaled by ``alpha``. ``alpha_affine`` and ``value`` are
    accepted and unused, as in the JAX package."""

    def __init__(self, alpha: float = 1.0, sigma: float = 50.0, alpha_affine: float = 50.0,
                 interpolation: int = INTER_LINEAR, border_mode: int = warp.BORDER_REFLECT_101,
                 value=None, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(interpolation, border_mode, always_apply, p)
        self.alpha = alpha
        self.sigma = sigma

    @property
    def ksize(self) -> int:
        return int(3 * self.sigma) | 1

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        dx = self.rng.uniform(-1, 1, (h, w)).astype(np.float32)
        dy = self.rng.uniform(-1, 1, (h, w)).astype(np.float32)
        dx = warp.gaussian_blur(dx, self.ksize, self.sigma) * self.alpha
        dy = warp.gaussian_blur(dy, self.ksize, self.sigma) * self.alpha
        xs, ys = np.meshgrid(np.arange(w), np.arange(h))
        return {"map_x": (xs + dx).astype(np.float32), "map_y": (ys + dy).astype(np.float32)}

    def draw_batch(self, shape, generator, device):
        """Displacements dx, dy (N, H, W) in [-1, 1) before the blur, the
        gate (N,)."""
        device = draw_device(generator, device)
        dx, dy = (torch.rand(tuple(shape), generator=generator, device=device) * 2.0 - 1.0
                  for _ in range(2))
        return dx, dy, torch.rand((shape[0],), generator=generator, device=device) < self.p

    def apply_drawn(self, batch, dx, dy, applied):
        img = batch["image"]
        h, w = img.shape[1:3]
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                                torch.arange(w, dtype=torch.float32, device=img.device),
                                indexing="ij")
        dx, dy = (warp.gaussian_blur_batch(d.to(img.device), self.ksize, self.sigma) * self.alpha
                  for d in (dx, dy))
        return _device_remap_batch(batch, xs + dx, ys + dy, applied, self.interpolation,
                                   self.border_mode)


@TRANSFORMS.register_class
class GridDistortion(_Remap):
    """Each axis cut into ``num_steps`` cells, each stretched by 1 + a draw
    from ``distort_limit``; the last partial cell takes the remaining
    pixels. ``value`` is accepted and unused, as in the JAX package."""

    def __init__(self, num_steps: int = 5, distort_limit: float = 0.3,
                 interpolation: int = INTER_LINEAR, border_mode: int = warp.BORDER_REFLECT_101,
                 value=None, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(interpolation, border_mode, always_apply, p)
        self.num_steps = num_steps
        self.distort_limit = (-distort_limit, distort_limit) \
            if isinstance(distort_limit, (int, float)) else tuple(distort_limit)

    @property
    def device_capable(self):
        return self.border_mode in _DEVICE_BORDERS and self.num_steps >= 1

    def _axis_map(self, size: int) -> np.ndarray:
        steps = 1 + self.rng.uniform(*self.distort_limit, self.num_steps + 1)
        step = size // self.num_steps
        coords = np.zeros(size, np.float32)
        prev, x = 0.0, 0
        for i in range(self.num_steps + 1):
            start, end = x, min(x + step, size)
            cur = prev + step * steps[i]
            coords[start:end] = np.linspace(prev, cur, end - start, endpoint=False)
            prev, x = cur, end
        if x < size:
            coords[x:] = prev
        return coords

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        xs = self._axis_map(w)
        ys = self._axis_map(h)
        map_x, map_y = np.meshgrid(xs, ys)
        return {"map_x": map_x.astype(np.float32), "map_y": map_y.astype(np.float32)}

    def draw_batch(self, shape, generator, device):
        """The cells' distortions along x and along y (N, num_steps + 1), in
        ``distort_limit``, the gate (N,)."""
        device = draw_device(generator, device)
        lo, hi = self.distort_limit
        ux, uy = (lo + (hi - lo) * torch.rand((shape[0], self.num_steps + 1),
                                              generator=generator, device=device)
                  for _ in range(2))
        return ux, uy, torch.rand((shape[0],), generator=generator, device=device) < self.p

    def _device_axis_map(self, distort: torch.Tensor, size: int) -> torch.Tensor:
        """:meth:`_axis_map` for every sample: (N, size) coordinates. Cell i
        spans [i step, min((i + 1) step, size)); within it the coordinate is
        prev_i + step steps_i offset / length, steps = 1 + distort."""
        steps = 1 + distort
        n, s = steps.shape[0], self.num_steps
        step = size // s
        if step == 0:  # fewer pixels than cells: the identity, as on the host
            return torch.arange(size, dtype=torch.float32, device=steps.device).expand(n, size)
        j = np.arange(size)
        i = np.minimum(j // step, s)
        off = (j - i * step).astype(np.float32)
        length = np.maximum(np.minimum((i + 1) * step, size) - i * step, 1).astype(np.float32)
        # prev_i = step * (steps_0 + ... + steps_{i-1}), summed in order
        sums = [torch.zeros_like(steps[:, 0])]
        for k in range(s):
            sums.append(sums[-1] + steps[:, k])
        prev = step * torch.stack(sums, 1)
        i = torch.from_numpy(i).to(steps.device)
        return prev[:, i] + step * steps[:, i] * torch.from_numpy(off / length).to(steps.device)

    def apply_drawn(self, batch, ux, uy, applied):
        img = batch["image"]
        n, h, w = img.shape[:3]
        xs = self._device_axis_map(ux.to(img.device), w)
        ys = self._device_axis_map(uy.to(img.device), h)
        return _device_remap_batch(batch, xs[:, None, :].expand(n, h, w),
                                   ys[:, :, None].expand(n, h, w), applied,
                                   self.interpolation, self.border_mode)


# --------------------------- same-size warps ------------------------------

def _center(h: int, w: int) -> Tuple[float, float]:
    """The rotation centre of Rotate, SafeRotate and ShiftScaleRotate."""
    return w / 2 - 0.5, h / 2 - 0.5


def _safe_scale(h: int, w: int, rad):
    """SafeRotate's scale: the turned frame fits back into (h, w). Floats
    (numpy) or float64 tensors."""
    lib = torch if isinstance(rad, torch.Tensor) else np
    new_w = lib.abs(w * lib.cos(rad)) + lib.abs(h * lib.sin(rad))
    new_h = lib.abs(w * lib.sin(rad)) + lib.abs(h * lib.cos(rad))
    return lib.minimum(w / new_w, h / new_h)


class _Warp(BaseTransform):
    """A same-size affine warp: ``warp.warp_affine`` on the host, one batched
    gather on the device. Subclasses give the matrix (``_matrix``, float64
    2x3 on the host; ``_device_mats`` from the draws on the device)."""

    geometric = True
    device_needs_uniform = True
    device_bbox_safe = False

    def __init__(self, interpolation: int, border_mode: int, value, mask_value,
                 always_apply: bool, p: float):
        super().__init__(always_apply, p)
        self.interpolation = _check_interpolation(interpolation)
        self.border_mode = _check_border(border_mode)
        self.value = value
        self.mask_value = mask_value

    @property
    def device_capable(self):
        return (self.border_mode in _DEVICE_BORDERS and _scalar_or_none(self.value)
                and _scalar_or_none(self.mask_value))

    def _matrix(self, h: int, w: int, **params) -> np.ndarray:
        raise NotImplementedError

    def _device_mats(self, h: int, w: int, *draws: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, image, **params):
        h, w = image.shape[:2]
        return warp.warp_affine(image, self._matrix(h, w, **params), (w, h), self.interpolation,
                                self.border_mode, self.value)

    def apply_to_mask(self, mask, **params):
        h, w = mask.shape[:2]
        return warp.warp_affine(mask, self._matrix(h, w, **params), (w, h), INTER_NEAREST,
                                self.border_mode, self.mask_value)

    def apply_to_bboxes(self, bboxes, image_shape, **params):
        h, w = image_shape[:2]
        return _affine_bboxes(bboxes, self._matrix(h, w, **params), w, h)

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[:3], generator, img.device))

    def apply_drawn(self, batch, *draws):
        """The warp of the draws (the last one the gate): the SRC->DST
        matrices in float64, inverted, rounded to float32 once."""
        img = batch["image"]
        h, w = img.shape[1:3]
        *params, applied = draws
        mats = self._device_mats(h, w, *(d.to(img.device, torch.float64) for d in params))
        inv = warp.invert_affine(mats).float()
        return _device_warp_batch(batch, inv, (h, w), applied, self.interpolation,
                                  self.border_mode, self.value, self.mask_value)


@TRANSFORMS.register_class
class Rotate(_Warp):
    """A turn by an angle drawn from ``limit`` (degrees) about the image's
    centre ``(w / 2 - 0.5, h / 2 - 0.5)``."""

    def __init__(self, limit: Union[float, Tuple[float, float]] = 90,
                 interpolation: int = INTER_LINEAR, border_mode: int = BORDER_REFLECT_101,
                 value=None, mask_value=None, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(interpolation, border_mode, value, mask_value, always_apply, p)
        self.limit = _pair(limit)

    def get_params(self, sample):
        return {"angle": float(self.rng.uniform(*self.limit))}

    def _matrix(self, h, w, angle=0.0, **params):
        return warp.get_rotation_matrix_2d(_center(h, w), angle, 1.0)

    def draw_batch(self, shape, generator, device):
        """Angles (N,) in ``limit``, the gate (N,)."""
        device = draw_device(generator, device)
        return (_uniform((shape[0],), *self.limit, generator, device),
                _gate(shape[0], self.p, generator, device))

    def _device_mats(self, h, w, angles):
        return warp.rotation_mats(angles, torch.ones_like(angles), _center(h, w))


@TRANSFORMS.register_class
class SafeRotate(Rotate):
    """Rotate with the frame scaled so that the turned image fits, the
    output size kept."""

    def _matrix(self, h, w, angle=0.0, **params):
        return warp.get_rotation_matrix_2d(_center(h, w), angle,
                                           _safe_scale(h, w, np.deg2rad(angle)))

    def _device_mats(self, h, w, angles):
        return warp.rotation_mats(angles, _safe_scale(h, w, torch.deg2rad(angles)),
                                  _center(h, w))


@TRANSFORMS.register_class
class ShiftScaleRotate(_Warp):
    """A turn, a scale (1 + a draw from ``scale_limit``) and a shift by a
    share of the width and height, about the image's centre."""

    def __init__(self, shift_limit=0.0625, scale_limit=0.1, rotate_limit=45,
                 interpolation: int = INTER_LINEAR, border_mode: int = BORDER_REFLECT_101,
                 value=None, mask_value=None, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(interpolation, border_mode, value, mask_value, always_apply, p)
        self.shift_limit = _pair(shift_limit)
        self.scale_limit = _pair(scale_limit)
        self.rotate_limit = _pair(rotate_limit)

    def get_params(self, sample):
        return {"angle": float(self.rng.uniform(*self.rotate_limit)),
                "scale": 1.0 + float(self.rng.uniform(*self.scale_limit)),
                "dx": float(self.rng.uniform(*self.shift_limit)),
                "dy": float(self.rng.uniform(*self.shift_limit))}

    def _matrix(self, h, w, angle=0.0, scale=1.0, dx=0.0, dy=0.0, **params):
        m = warp.get_rotation_matrix_2d(_center(h, w), angle, scale)
        m[0, 2] += dx * w
        m[1, 2] += dy * h
        return m

    def draw_batch(self, shape, generator, device):
        """Angles, scale offsets (the scale less 1), x and y shifts (each
        (N,)), the gate (N,)."""
        device = draw_device(generator, device)
        n = shape[0]
        return (_uniform((n,), *self.rotate_limit, generator, device),
                _uniform((n,), *self.scale_limit, generator, device),
                _uniform((n,), *self.shift_limit, generator, device),
                _uniform((n,), *self.shift_limit, generator, device),
                _gate(n, self.p, generator, device))

    def _device_mats(self, h, w, angles, scales, dx, dy):
        mats = warp.rotation_mats(angles, 1.0 + scales, _center(h, w))
        return mats + torch.stack([torch.stack([0 * dx, 0 * dx, dx * w], -1),
                                   torch.stack([0 * dy, 0 * dy, dy * h], -1)], 1)


def _affine_limit(v, default, around_one=False):
    """Affine's limits: None gives ``default``, a dict its ``x`` entry, a
    scalar the range about 0 (or 1 for the scale)."""
    if v is None:
        return default
    if isinstance(v, dict):
        return tuple(v.get("x", default))
    return _pair(v, around_one)


@TRANSFORMS.register_class
class Affine(_Warp):
    """Scale and turn about ``(w / 2, h / 2)``, a shear added to m[0, 1] and
    a translation by a share of the size; cv2.warpAffine's defaults (a
    constant border of 0)."""

    def __init__(self, scale=None, translate_percent=None, rotate=None, shear=None,
                 interpolation: int = INTER_LINEAR, always_apply: bool = False,
                 p: float = 0.5, **_):
        super().__init__(interpolation, BORDER_CONSTANT, None, None, always_apply, p)
        self.scale = _affine_limit(scale, (1.0, 1.0), around_one=True)
        self.translate = _affine_limit(translate_percent, (0.0, 0.0))
        self.rotate = _affine_limit(rotate, (0.0, 0.0))
        self.shear = _affine_limit(shear, (0.0, 0.0))

    def get_params(self, sample):
        return {"sc": float(self.rng.uniform(*self.scale)) if self.scale != (1.0, 1.0) else 1.0,
                "tx": float(self.rng.uniform(*self.translate)),
                "ty": float(self.rng.uniform(*self.translate)),
                "ang": float(self.rng.uniform(*self.rotate)),
                "sh": float(self.rng.uniform(*self.shear))}

    def _matrix(self, h, w, sc=1.0, tx=0.0, ty=0.0, ang=0.0, sh=0.0, **params):
        m = warp.get_rotation_matrix_2d((w / 2, h / 2), ang, sc)
        m[0, 2] += tx * w
        m[1, 2] += ty * h
        m[0, 1] += np.tan(np.deg2rad(sh))
        return m

    def draw_batch(self, shape, generator, device):
        """Scales, x and y translations, angles, shears (each (N,)), the gate
        (N,)."""
        device = draw_device(generator, device)
        n = shape[0]
        return tuple(_uniform((n,), *lim, generator, device)
                     for lim in (self.scale, self.translate, self.translate, self.rotate,
                                 self.shear)) + (_gate(n, self.p, generator, device),)

    def _device_mats(self, h, w, sc, tx, ty, ang, sh):
        mats = warp.rotation_mats(ang, sc, (w / 2, h / 2))
        zero = 0 * sh
        return mats + torch.stack([torch.stack([zero, torch.tan(torch.deg2rad(sh)), tx * w], -1),
                                   torch.stack([zero, zero, ty * h], -1)], 1)


@TRANSFORMS.register_class
class Perspective(BaseTransform):
    """Each corner moved by up to a share ``s`` (drawn from ``scale``) of
    the size; cv2.warpPerspective's defaults (a constant border of 0)."""

    geometric = True
    device_needs_uniform = True
    device_bbox_safe = False
    device_capable = True

    def __init__(self, scale=(0.05, 0.1), interpolation: int = INTER_LINEAR,
                 always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.scale = (0, scale) if isinstance(scale, (int, float)) else tuple(scale)
        self.interpolation = _check_interpolation(interpolation)

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        s = self.rng.uniform(*self.scale)
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        jitter = self.rng.uniform(-s, s, (4, 2)).astype(np.float32) * [w, h]
        dst = src + jitter
        return {"matrix": warp.get_perspective_transform(src, dst.astype(np.float32))}

    def apply(self, image, matrix=None, **params):
        h, w = image.shape[:2]
        return warp.warp_perspective(image, matrix, (w, h), self.interpolation)

    def apply_to_mask(self, mask, matrix=None, **params):
        h, w = mask.shape[:2]
        return warp.warp_perspective(mask, matrix, (w, h), INTER_NEAREST)

    def apply_to_bboxes(self, bboxes, image_shape, matrix=None, **params):
        h, w = image_shape[:2]
        return _affine_bboxes(bboxes, matrix, w, h)

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[:3], generator, img.device))

    def draw_batch(self, shape, generator, device):
        """Shares ``s`` (N, 1, 1), corner moves (N, 4, 2) in [-1, 1), the
        gate (N,)."""
        device = draw_device(generator, device)
        n = shape[0]
        return (_uniform((n, 1, 1), *self.scale, generator, device),
                _uniform((n, 4, 2), -1.0, 1.0, generator, device),
                _gate(n, self.p, generator, device))

    def apply_drawn(self, batch, s, jitter, applied):
        img = batch["image"]
        n, h, w = img.shape[:3]
        size = torch.tensor([w, h], dtype=torch.float32, device=img.device)
        src = torch.tensor([[0, 0], [w, 0], [w, h], [0, h]], dtype=torch.float32,
                           device=img.device).expand(n, 4, 2)
        dst = src + jitter.to(img.device) * s.to(img.device) * size
        return _device_perspective_batch(batch, warp.perspective_from_points(src, dst), (h, w),
                                         applied, self.interpolation)


def init_undistort_rectify_map(camera: np.ndarray, dist: np.ndarray,
                               size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.initUndistortRectifyMap(camera, dist, None, None, size,
    cv2.CV_32FC1)`` for the radial model (k1, k2, 0, 0, 0): the new camera
    is ``getDefaultNewCameraMatrix(camera, size, True)`` (the principal
    point moved to the centre), each pixel's ray goes through the distortion
    and back through ``camera``, in float64, then rounded to float32."""
    w, h = size
    camera = np.asarray(camera, np.float64)
    new = camera.copy()
    new[0, 2], new[1, 2] = (w - 1) * 0.5, (h - 1) * 0.5
    ir = np.linalg.inv(new)
    k1, k2 = (float(v) for v in np.asarray(dist, np.float64)[:2])
    ys = np.arange(h, dtype=np.float64)[:, None]
    # cv2 steps along a row by adding ir[0, 0]: a running sum
    steps = np.concatenate([ys * ir[0, 1] + ir[0, 2],
                            np.broadcast_to(ir[0, 0], (h, w - 1))], 1)
    x = np.cumsum(steps, 1)
    y = np.broadcast_to(ys * ir[1, 1] + ir[1, 2], (h, w))
    r2 = x * x + y * y
    kr = 1 + (k2 * r2 + k1) * r2
    return ((camera[0, 0] * (x * kr) + camera[0, 2]).astype(np.float32),
            (camera[1, 1] * (y * kr) + camera[1, 2]).astype(np.float32))


@TRANSFORMS.register_class
class OpticalDistortion(_Remap):
    """Barrel or pincushion distortion: the radial model (k, k, 0, 0, 0) with
    a principal point shifted by a share of the size, through
    :func:`init_undistort_rectify_map` on the host and its closed form on
    the device. ``value`` is accepted and unused, as in the JAX package."""

    def __init__(self, distort_limit: float = 0.05, shift_limit: float = 0.05,
                 interpolation: int = INTER_LINEAR, border_mode: int = warp.BORDER_REFLECT_101,
                 value=None, always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(interpolation, border_mode, always_apply, p)
        self.distort_limit = _pair(distort_limit)
        self.shift_limit = _pair(shift_limit)

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        k = float(self.rng.uniform(*self.distort_limit))
        dx = float(self.rng.uniform(*self.shift_limit)) * w
        dy = float(self.rng.uniform(*self.shift_limit)) * h
        cam = np.array([[w, 0, w / 2 + dx], [0, h, h / 2 + dy], [0, 0, 1]], np.float32)
        dist = np.array([k, k, 0, 0, 0], np.float32)
        map_x, map_y = init_undistort_rectify_map(cam, dist, (w, h))
        return {"map_x": map_x, "map_y": map_y}

    def draw_batch(self, shape, generator, device):
        """Coefficients k, x and y shifts (each (N, 1, 1)), the gate (N,)."""
        device = draw_device(generator, device)
        n = shape[0]
        return (_uniform((n, 1, 1), *self.distort_limit, generator, device),
                _uniform((n, 1, 1), *self.shift_limit, generator, device),
                _uniform((n, 1, 1), *self.shift_limit, generator, device),
                _gate(n, self.p, generator, device))

    def apply_drawn(self, batch, k, dx, dy, applied):
        img = batch["image"]
        h, w = img.shape[1:3]
        k, dx, dy = (t.to(img.device) for t in (k, dx, dy))
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                                torch.arange(w, dtype=torch.float32, device=img.device),
                                indexing="ij")
        x = warp.divide(gx[None] - (w - 1) * 0.5, w)
        y = warp.divide(gy[None] - (h - 1) * 0.5, h)
        r2 = x * x + y * y
        radial = 1.0 + k * r2 + k * r2 * r2
        map_x = x * radial * w + (w / 2 + dx * w)
        map_y = y * radial * h + (h / 2 + dy * h)
        return _device_remap_batch(batch, map_x, map_y, applied, self.interpolation,
                                   self.border_mode)


# ---------------------------- crops and resizes ----------------------------

class _MaxSize(BaseTransform):
    """Aspect-preserving resize that brings one side to ``max_size``; on the
    device the size follows the batch's one input shape."""

    always_apply = True
    geometric = True
    device_capable = True
    device_needs_uniform = True
    device_bbox_safe = False

    def __init__(self, max_size: int = 1024, interpolation: int = INTER_LINEAR,
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.max_size = max_size
        self.interpolation = _check_interpolation(interpolation)

    def _side(self, h: int, w: int) -> int:
        raise NotImplementedError

    def _size(self, h: int, w: int) -> Tuple[int, int]:
        s = self.max_size / self._side(h, w)
        return round(h * s), round(w * s)

    def apply(self, image, **params):
        return _resize(image, *self._size(*image.shape[:2]), self.interpolation)

    def apply_to_mask(self, mask, **params):
        return _resize(mask, *self._size(*mask.shape[:2]), INTER_NEAREST)

    def apply_to_bboxes(self, bboxes, image_shape, **params):
        h, w = image_shape[:2]
        nh, nw = self._size(h, w)
        return _scale_bboxes(bboxes, nw / w, nh / h)

    def apply_batch(self, batch, generator):
        return _device_resize_to(batch, *self._size(*batch["image"].shape[1:3]),
                                 self.interpolation)


@TRANSFORMS.register_class
class LongestMaxSize(_MaxSize):
    def _side(self, h, w):
        return max(h, w)


@TRANSFORMS.register_class
class SmallestMaxSize(_MaxSize):
    def _side(self, h, w):
        return min(h, w)


@TRANSFORMS.register_class
class Crop(BaseTransform):
    """The fixed window [y_min, y_max) x [x_min, x_max), clamped to the image
    as a slice clamps."""

    always_apply = True
    geometric = True
    device_capable = True
    device_needs_uniform = True
    device_bbox_safe = False

    def __init__(self, x_min: int = 0, y_min: int = 0, x_max: int = 1024, y_max: int = 1024,
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.x_min, self.y_min, self.x_max, self.y_max = x_min, y_min, x_max, y_max

    def apply(self, image, **params):
        return image[self.y_min:self.y_max, self.x_min:self.x_max]

    def apply_to_mask(self, mask, **params):
        return mask[self.y_min:self.y_max, self.x_min:self.x_max]

    def apply_to_bboxes(self, bboxes, image_shape, **params):
        h, w = image_shape[:2]
        return _shift_clip_bboxes(bboxes, self.x_min, self.y_min,
                                  max(min(self.x_max, w) - self.x_min, 1),
                                  max(min(self.y_max, h) - self.y_min, 1))

    def apply_batch(self, batch, generator):
        batch = dict(batch)
        for key in ("image", "mask"):
            if batch.get(key) is not None:
                batch[key] = batch[key][:, self.y_min:self.y_max, self.x_min:self.x_max]
        return batch


class _WindowCrop(BaseTransform):
    """A crop of the window (y0, x0, ch, cw) that ``get_params`` draws."""

    geometric = True

    def apply(self, image, y0=0, x0=0, ch=1, cw=1, **params):
        return image[y0:y0 + ch, x0:x0 + cw]

    def apply_to_mask(self, mask, y0=0, x0=0, ch=1, cw=1, **params):
        return mask[y0:y0 + ch, x0:x0 + cw]

    def apply_to_bboxes(self, bboxes, image_shape, y0=0, x0=0, ch=1, cw=1, **params):
        return _shift_clip_bboxes(bboxes, x0, y0, cw, ch)


class _ResizedWindowCrop(_WindowCrop):
    """A window crop resized to (height, width): the image with
    ``interpolation``, the mask nearest, the boxes clipped and scaled."""

    def apply(self, image, y0=0, x0=0, ch=1, cw=1, **params):
        return _resize(image[y0:y0 + ch, x0:x0 + cw], self.height, self.width,
                       self.interpolation)

    def apply_to_mask(self, mask, y0=0, x0=0, ch=1, cw=1, **params):
        return _resize(mask[y0:y0 + ch, x0:x0 + cw], self.height, self.width, INTER_NEAREST)

    def apply_to_bboxes(self, bboxes, image_shape, y0=0, x0=0, ch=1, cw=1, **params):
        return _scale_bboxes(_shift_clip_bboxes(bboxes, x0, y0, cw, ch), self.width / cw,
                             self.height / ch)

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[:3], generator, img.device))


@TRANSFORMS.register_class
class RandomResizedCrop(_ResizedWindowCrop):
    """A window of a share of the area drawn from ``scale`` and an aspect
    drawn log-uniformly from ``ratio`` (ten tries, then the centred square),
    resized to (height, width)."""

    device_needs_uniform = True
    device_bbox_safe = False

    def __init__(self, height: int, width: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation: int = INTER_LINEAR, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.height, self.width = height, width
        self.scale, self.ratio = tuple(scale), tuple(ratio)
        self.interpolation = _check_interpolation(interpolation)

    @property
    def device_capable(self):
        return self.p >= 1.0 and self.interpolation == INTER_LINEAR

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * self.rng.uniform(*self.scale)
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = np.exp(self.rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                y0 = int(self.rng.integers(0, h - ch + 1))
                x0 = int(self.rng.integers(0, w - cw + 1))
                return {"y0": y0, "x0": x0, "ch": ch, "cw": cw}
        cw = ch = min(w, h)
        return {"y0": (h - ch) // 2, "x0": (w - cw) // 2, "ch": ch, "cw": cw}

    def draw_batch(self, shape, generator, device):
        """Area shares and log aspects of ten tries (N, 10), the offsets'
        uniforms along y and x (N,)."""
        device = draw_device(generator, device)
        n = shape[0]
        return (_uniform((n, 10), *self.scale, generator, device),
                _uniform((n, 10), np.log(self.ratio[0]), np.log(self.ratio[1]), generator,
                         device),
                torch.rand((n,), generator=generator, device=device),
                torch.rand((n,), generator=generator, device=device))

    def apply_drawn(self, batch, area_share, log_aspect, uy, ux):
        """The first try that fits (else the centred square), the offsets
        ``floor(u (h - ch + 1))``; in float64, so the card and the CPU cut
        the same windows."""
        img = batch["image"]
        n, h, w = img.shape[:3]
        area_share, log_aspect, uy, ux = (t.to(img.device, torch.float64)
                                          for t in (area_share, log_aspect, uy, ux))
        ta = float(h * w) * area_share
        aspect = torch.exp(log_aspect)
        cw = torch.round(torch.sqrt(ta * aspect))
        ch = torch.round(torch.sqrt(ta / aspect))
        valid = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
        first = valid.int().argmax(1, keepdim=True)
        found = valid.any(1)
        side = float(min(h, w))
        ch = torch.where(found, ch.gather(1, first)[:, 0], side)
        cw = torch.where(found, cw.gather(1, first)[:, 0], side)
        y0 = torch.where(found, torch.floor(uy * (h - ch + 1)), torch.floor((h - ch) / 2))
        x0 = torch.where(found, torch.floor(ux * (w - cw + 1)), torch.floor((w - cw) / 2))
        return _device_crop_batch(batch, torch.stack([y0, x0, ch, cw], -1),
                                  (self.height, self.width))


@TRANSFORMS.register_class
class RandomSizedCrop(_ResizedWindowCrop):
    """A window of a height drawn from ``min_max_height`` and a width of
    ``w2h_ratio`` times it, resized to (height, width)."""

    device_needs_uniform = True
    device_bbox_safe = False

    def __init__(self, min_max_height, height: int, width: int, w2h_ratio: float = 1.0,
                 interpolation: int = INTER_LINEAR, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.min_max_height = tuple(min_max_height)
        self.height, self.width = height, width
        self.w2h_ratio = w2h_ratio
        self.interpolation = _check_interpolation(interpolation)

    @property
    def device_capable(self):
        return self.p >= 1.0 and self.interpolation == INTER_LINEAR

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        crop_h = int(self.rng.integers(self.min_max_height[0], self.min_max_height[1] + 1))
        crop_w = min(int(round(crop_h * self.w2h_ratio)), w)
        crop_h = min(crop_h, h)
        y0 = int(self.rng.integers(0, h - crop_h + 1))
        x0 = int(self.rng.integers(0, w - crop_w + 1))
        return {"y0": y0, "x0": x0, "ch": crop_h, "cw": crop_w}

    def draw_batch(self, shape, generator, device):
        """Window heights (N,) from ``min_max_height``, the offsets'
        uniforms along y and x (N,)."""
        device = draw_device(generator, device)
        n = shape[0]
        return (torch.randint(self.min_max_height[0], self.min_max_height[1] + 1, (n,),
                              generator=generator, device=device),
                torch.rand((n,), generator=generator, device=device),
                torch.rand((n,), generator=generator, device=device))

    def apply_drawn(self, batch, ch, uy, ux):
        img = batch["image"]
        n, h, w = img.shape[:3]
        ch, uy, ux = (t.to(img.device, torch.float64) for t in (ch, uy, ux))
        cw = torch.clamp(torch.round(ch * self.w2h_ratio), max=w)
        ch = torch.clamp(ch, max=h)
        y0, x0 = torch.floor(uy * (h - ch + 1)), torch.floor(ux * (w - cw + 1))
        return _device_crop_batch(batch, torch.stack([y0, x0, ch, cw], -1),
                                  (self.height, self.width))


@TRANSFORMS.register_class
class CropAndPad(BaseTransform):
    """Each side cropped (a negative amount) or padded (a positive one) by
    pixels (``px``) or a share of the size (``percent``): a fixed amount, a
    list of four (top, right, bottom, left), or a range each side draws
    from; back to the input's size when ``keep_size``. On the device only
    fixed amounts (``sample_independently`` is accepted and unused, as in
    the JAX package)."""

    geometric = True
    device_needs_uniform = True
    device_bbox_safe = False

    def __init__(self, px=None, percent=None, pad_mode: int = BORDER_CONSTANT, pad_cval=0,
                 pad_cval_mask=0, keep_size: bool = True, sample_independently: bool = True,
                 interpolation: int = INTER_LINEAR, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.px = px
        self.percent = percent
        self.pad_mode = _check_border(pad_mode)
        self.pad_cval = pad_cval
        self.pad_cval_mask = pad_cval_mask
        self.keep_size = keep_size
        self.interpolation = _check_interpolation(interpolation)

    @property
    def device_capable(self):
        spec = self.px if self.px is not None else self.percent
        fixed = isinstance(spec, (int, float)) or (spec is not None and len(spec) == 4)
        return (self.keep_size and fixed and self.pad_mode in _DEVICE_BORDERS
                and _scalar_or_none(self.pad_cval) and _scalar_or_none(self.pad_cval_mask))

    def _amounts(self, h: int, w: int):
        def draw(spec):
            if isinstance(spec, (int, float)):
                return [spec] * 4
            if len(spec) == 2:
                return [float(self.rng.uniform(spec[0], spec[1])) for _ in range(4)]
            return list(spec)
        if self.px is not None:
            return [int(v) for v in draw(self.px)]
        amounts = draw(self.percent if self.percent is not None else 0)
        return [int(amounts[0] * h), int(amounts[1] * w), int(amounts[2] * h),
                int(amounts[3] * w)]

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        top, right, bottom, left = self._amounts(h, w)
        return {"top": top, "right": right, "bottom": bottom, "left": left,
                "orig_h": h, "orig_w": w}

    @staticmethod
    def _window(h, w, top, right, bottom, left):
        """The crop's rows and columns, then the pads (t, b, l, r)."""
        y0, y1 = max(-top, 0), h - max(-bottom, 0)
        x0, x1 = max(-left, 0), w - max(-right, 0)
        return ((y0, max(y1, y0 + 1), x0, max(x1, x0 + 1)),
                (max(top, 0), max(bottom, 0), max(left, 0), max(right, 0)))

    def _crop_pad(self, arr, top, right, bottom, left, cval, interp):
        h, w = arr.shape[:2]
        (y0, y1, x0, x1), pads = self._window(h, w, top, right, bottom, left)
        out = arr[y0:y1, x0:x1]
        if any(pads):
            out = copy_make_border(out, *pads, self.pad_mode, cval)
        if self.keep_size and out.shape[:2] != (h, w):
            out = _resize(out, h, w, interp)
        return out

    def apply(self, image, top=0, right=0, bottom=0, left=0, **params):
        return self._crop_pad(image, top, right, bottom, left, self.pad_cval,
                              self.interpolation)

    def apply_to_mask(self, mask, top=0, right=0, bottom=0, left=0, **params):
        return self._crop_pad(mask, top, right, bottom, left, self.pad_cval_mask,
                              INTER_NEAREST)

    def apply_to_bboxes(self, bboxes, image_shape, top=0, right=0, bottom=0, left=0,
                        **params):
        h, w = image_shape[:2]
        b = _as_boxes(bboxes).copy()
        b[:, [0, 2]] += left
        b[:, [1, 3]] += top
        new_h = max(h + top + bottom, 1)
        new_w = max(w + left + right, 1)
        b[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, new_w)
        b[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, new_h)
        if self.keep_size and (new_h, new_w) != (h, w):
            b = _scale_bboxes(b, w / new_w, h / new_h)
        return b

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[:3], generator, img.device))

    def draw_batch(self, shape, generator, device):
        """The gate (N,)."""
        return (_gate(shape[0], self.p, generator, draw_device(generator, device)),)

    def apply_drawn(self, batch, applied):
        batch = dict(batch)
        img = batch["image"]
        h, w = img.shape[1:3]
        (y0, y1, x0, x1), pads = self._window(h, w, *self._amounts(h, w))

        def crop_pad(arr, cval):
            out = arr[:, y0:y1, x0:x1]
            return _device_pad_batch(out, *pads, self.pad_mode, cval) if any(pads) else out

        tmp = {"image": crop_pad(img, self.pad_cval)}
        if batch.get("mask") is not None:
            tmp["mask"] = crop_pad(batch["mask"], self.pad_cval_mask)
        tmp = _device_resize_to(tmp, h, w, self.interpolation)
        for key in tmp:
            batch[key] = _keep(applied, tmp[key].to(batch[key].dtype), batch[key])
        return batch


# ------------------------------ permutations ------------------------------

@TRANSFORMS.register_class
class RandomRotate90(BaseTransform):
    """``k`` quarter turns counter-clockwise, k drawn from 0 to 3. On the
    device the batch must be square: per-sample turns of a non-square batch
    would give samples of two shapes."""

    geometric = True
    device_capable = True
    device_needs_uniform = True
    device_bbox_safe = False

    def get_params(self, sample):
        return {"k": int(self.rng.integers(0, 4))}

    def apply(self, image, k=0, **params):
        return np.ascontiguousarray(np.rot90(image, k))

    def apply_to_mask(self, mask, k=0, **params):
        return np.ascontiguousarray(np.rot90(mask, k))

    def apply_to_bboxes(self, bboxes, image_shape, k=0, **params):
        # np.rot90 turns counter-clockwise: (x, y) -> (y, w - x) a turn
        b = _as_boxes(bboxes).copy()
        h, w = image_shape[:2]
        for _ in range(k % 4):
            b = np.stack([b[:, 1], w - b[:, 2], b[:, 3], w - b[:, 0]], axis=1)
            h, w = w, h
        return b

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[:3], generator, img.device))

    def draw_batch(self, shape, generator, device):
        """Turns (N,) in 0 to 3, the gate (N,)."""
        device = draw_device(generator, device)
        return (torch.randint(0, 4, (shape[0],), generator=generator, device=device),
                _gate(shape[0], self.p, generator, device))

    def apply_drawn(self, batch, k, applied):
        batch = dict(batch)
        img = batch["image"]
        h, w = img.shape[1:3]
        if h != w:
            raise ValueError(f"device RandomRotate90 needs square images, got ({h}, {w}); "
                             "resize or crop to a square first, or keep it on the host")
        k = torch.where(applied.to(img.device), k.to(img.device), 0)
        for key in ("image", "mask"):
            x = batch.get(key)
            if x is not None:
                out = x
                for turns in (1, 2, 3):
                    out = _keep(k == turns, torch.rot90(x, turns, dims=(1, 2)), out)
                batch[key] = out
        return batch


@TRANSFORMS.register_class
class Transpose(BaseTransform):
    """Rows and columns swapped. On the device with ``p`` below 1 the batch
    must be square."""

    geometric = True
    device_capable = True
    device_needs_uniform = True
    device_bbox_safe = False

    def apply(self, image, **params):
        return np.ascontiguousarray(image.swapaxes(0, 1))

    def apply_to_mask(self, mask, **params):
        return np.ascontiguousarray(mask.swapaxes(0, 1))

    def apply_to_bboxes(self, bboxes, image_shape, **params):
        return _as_boxes(bboxes)[:, [1, 0, 3, 2]]

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[:3], generator, img.device))

    def draw_batch(self, shape, generator, device):
        """The gate (N,); none is drawn at ``p`` 1."""
        device = draw_device(generator, device)
        if self.p >= 1.0:
            return (torch.ones((shape[0],), dtype=torch.bool, device=device),)
        return (_gate(shape[0], self.p, generator, device),)

    def apply_drawn(self, batch, applied):
        batch = dict(batch)
        h, w = batch["image"].shape[1:3]
        if self.p < 1.0 and h != w:
            raise ValueError(f"device Transpose with p < 1 needs square images, got "
                             f"({h}, {w}); use p=1, square inputs, or keep it on the host")
        for key in ("image", "mask"):
            x = batch.get(key)
            if x is not None:
                swapped = x.transpose(1, 2)
                batch[key] = swapped if self.p >= 1.0 else _keep(applied, swapped, x)
        return batch


@TRANSFORMS.register_class
class RandomGridShuffle(BaseTransform):
    """The cells of a (rows, cols) grid permuted, image and mask alike; each
    cell the size of the smallest (``np.linspace`` cuts), the rest of the
    image in place."""

    geometric = True
    device_capable = True
    device_needs_uniform = True
    device_bbox_safe = False

    def __init__(self, grid=(3, 3), always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.grid = tuple(grid)

    def _cells(self, h: int, w: int):
        """The cells' top-left corners (G, 2) and the cell size."""
        gh, gw = self.grid
        ys = np.linspace(0, h, gh + 1, dtype=int)
        xs = np.linspace(0, w, gw + 1, dtype=int)
        ch = int(np.diff(ys).min()) if gh > 1 else h
        cw = int(np.diff(xs).min()) if gw > 1 else w
        return np.array([(ys[i], xs[j]) for i in range(gh) for j in range(gw)]), ch, cw

    def get_params(self, sample):
        return {"perm": self.rng.permutation(self.grid[0] * self.grid[1])}

    def _shuffle(self, arr, perm):
        cells, ch, cw = self._cells(*arr.shape[:2])
        out = arr.copy()
        for dst, src in enumerate(perm):
            (dy, dx), (sy, sx) = cells[dst], cells[src]
            out[dy:dy + ch, dx:dx + cw] = arr[sy:sy + ch, sx:sx + cw]
        return out

    def apply(self, image, perm=None, **params):
        return image if perm is None else self._shuffle(image, perm)

    def apply_to_mask(self, mask, perm=None, **params):
        return mask if perm is None else self._shuffle(mask, perm)

    def apply_batch(self, batch, generator):
        img = batch["image"]
        return self.apply_drawn(batch, *self.draw_batch(img.shape[:3], generator, img.device))

    def draw_batch(self, shape, generator, device):
        """A permutation of the cells per sample (N, G), the gate (N,)."""
        device = draw_device(generator, device)
        g = self.grid[0] * self.grid[1]
        perm = torch.argsort(torch.rand((shape[0], g), generator=generator, device=device), 1)
        return perm, _gate(shape[0], self.p, generator, device)

    def apply_drawn(self, batch, perm, applied):
        batch = dict(batch)
        img = batch["image"]
        n, h, w = img.shape[:3]
        cells, ch, cw = self._cells(h, w)
        perm = perm.to(img.device)
        yy = torch.arange(h, device=img.device)[None, :, None]
        xx = torch.arange(w, device=img.device)[None, None, :]
        map_y, map_x = yy.expand(n, h, w), xx.expand(n, h, w)
        cell_y = torch.as_tensor(cells[:, 0], device=img.device)
        cell_x = torch.as_tensor(cells[:, 1], device=img.device)
        for dst, (dy, dx) in enumerate(cells.tolist()):
            inside = (yy >= dy) & (yy < dy + ch) & (xx >= dx) & (xx < dx + cw)
            map_y = torch.where(inside, yy - dy + cell_y[perm[:, dst]][:, None, None], map_y)
            map_x = torch.where(inside, xx - dx + cell_x[perm[:, dst]][:, None, None], map_x)
        flat = (map_y * w + map_x).reshape(n, h * w, 1)

        def shuffle(x):
            out = torch.take_along_dim(x.reshape(n, h * w, -1), flat, 1).reshape(x.shape)
            return _keep(applied, out, x)

        batch["image"] = shuffle(img)
        if batch.get("mask") is not None:
            batch["mask"] = _per_mask(batch["mask"], shuffle)
        return batch


# -------------------------------- host only --------------------------------

@TRANSFORMS.register_class
class RandomScale(BaseTransform):
    """A resize by 1 + a draw from ``scale_limit``. Host only: the output
    size follows each image's own."""

    geometric = True

    def __init__(self, scale_limit=0.1, interpolation: int = INTER_LINEAR,
                 always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.scale_limit = _pair(scale_limit)
        self.interpolation = _check_interpolation(interpolation)

    def get_params(self, sample):
        return {"scale": 1.0 + float(self.rng.uniform(*self.scale_limit))}

    def apply(self, image, scale=1.0, **params):
        h, w = image.shape[:2]
        return _resize(image, round(h * scale), round(w * scale), self.interpolation)

    def apply_to_mask(self, mask, scale=1.0, **params):
        h, w = mask.shape[:2]
        return _resize(mask, round(h * scale), round(w * scale), INTER_NEAREST)

    def apply_to_bboxes(self, bboxes, image_shape, scale=1.0, **params):
        h, w = image_shape[:2]
        return _scale_bboxes(bboxes, round(w * scale) / w, round(h * scale) / h)


@TRANSFORMS.register_class
class BBoxSafeRandomCrop(_WindowCrop):
    """A random crop that keeps every box whole: its window reaches from a
    draw left of (above) the boxes' union to one right of (below) it. With
    no boxes, a window of up to ``erosion_rate`` less on each side."""

    def __init__(self, erosion_rate: float = 0.0, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.erosion_rate = erosion_rate

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        bboxes = sample.get("bboxes")
        if bboxes is None or len(bboxes) == 0:
            ch = int(h * (1 - self.erosion_rate * self.rng.random()))
            cw = int(w * (1 - self.erosion_rate * self.rng.random()))
            y0 = int(self.rng.integers(0, h - ch + 1))
            x0 = int(self.rng.integers(0, w - cw + 1))
            return {"y0": y0, "x0": x0, "ch": max(ch, 1), "cw": max(cw, 1)}
        b = _as_boxes(bboxes)
        ux0, uy0 = float(b[:, 0].min()), float(b[:, 1].min())
        ux1, uy1 = float(b[:, 2].max()), float(b[:, 3].max())
        x0 = int(self.rng.uniform(0, ux0)) if ux0 > 0 else 0
        y0 = int(self.rng.uniform(0, uy0)) if uy0 > 0 else 0
        x1 = int(self.rng.uniform(ux1, w)) if ux1 < w else w
        y1 = int(self.rng.uniform(uy1, h)) if uy1 < h else h
        return {"y0": y0, "x0": x0, "ch": max(y1 - y0, 1), "cw": max(x1 - x0, 1)}


@TRANSFORMS.register_class
class RandomSizedBBoxSafeCrop(BBoxSafeRandomCrop):
    """BBoxSafeRandomCrop's window resized to (height, width)."""

    def __init__(self, height: int, width: int, erosion_rate: float = 0.0,
                 interpolation: int = INTER_LINEAR, always_apply: bool = False,
                 p: float = 1.0, **_):
        super().__init__(erosion_rate, always_apply, p)
        self.height, self.width = height, width
        self.interpolation = _check_interpolation(interpolation)

    apply = _ResizedWindowCrop.apply
    apply_to_mask = _ResizedWindowCrop.apply_to_mask
    apply_to_bboxes = _ResizedWindowCrop.apply_to_bboxes


@TRANSFORMS.register_class
class RandomCropFromBorders(_WindowCrop):
    """Up to a share of the size cut from each side."""

    def __init__(self, crop_left: float = 0.1, crop_right: float = 0.1, crop_top: float = 0.1,
                 crop_bottom: float = 0.1, always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.crop_left, self.crop_right = crop_left, crop_right
        self.crop_top, self.crop_bottom = crop_top, crop_bottom

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        x0 = int(self.rng.integers(0, max(int(w * self.crop_left), 0) + 1))
        x1 = w - int(self.rng.integers(0, max(int(w * self.crop_right), 0) + 1))
        y0 = int(self.rng.integers(0, max(int(h * self.crop_top), 0) + 1))
        y1 = h - int(self.rng.integers(0, max(int(h * self.crop_bottom), 0) + 1))
        return {"y0": y0, "x0": x0, "ch": max(y1 - y0, 1), "cw": max(x1 - x0, 1)}


@TRANSFORMS.register_class
class RandomCropNearBBox(_WindowCrop):
    """A crop about the sample's ``cropping_bbox`` (x0, y0, x1, y1), each
    side moved out by up to ``max_part_shift`` of the box's size."""

    def __init__(self, max_part_shift=(0.3, 0.3), cropping_box_key: str = "cropping_bbox",
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.max_part_shift = (max_part_shift, max_part_shift) \
            if isinstance(max_part_shift, (int, float)) else tuple(max_part_shift)
        self.cropping_box_key = cropping_box_key

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        box = sample.get(self.cropping_box_key)
        if box is None:
            return {"y0": 0, "x0": 0, "ch": h, "cw": w}
        bx0, by0, bx1, by1 = [float(v) for v in box]
        sx = (bx1 - bx0) * self.max_part_shift[1]
        sy = (by1 - by0) * self.max_part_shift[0]
        x0 = int(np.clip(bx0 - self.rng.uniform(0, sx), 0, w - 1))
        y0 = int(np.clip(by0 - self.rng.uniform(0, sy), 0, h - 1))
        x1 = int(np.clip(bx1 + self.rng.uniform(0, sx), x0 + 1, w))
        y1 = int(np.clip(by1 + self.rng.uniform(0, sy), y0 + 1, h))
        return {"y0": y0, "x0": x0, "ch": y1 - y0, "cw": x1 - x0}


@TRANSFORMS.register_class
class CropNonEmptyMaskIfExists(_WindowCrop):
    """A (height, width) window about a mask pixel drawn from the non-zero
    ones (``ignore_values`` counted as zero), else anywhere.
    ``ignore_channels`` is accepted and unused, as in the JAX package."""

    def __init__(self, height: int, width: int, ignore_values=None, ignore_channels=None,
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.height, self.width = height, width
        self.ignore_values = ignore_values

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        ch, cw = min(self.height, h), min(self.width, w)
        mask = sample.get("mask")
        if mask is not None:
            m = np.asarray(mask)
            if self.ignore_values is not None:
                m = np.where(np.isin(m, self.ignore_values), 0, m)
            ys, xs = np.nonzero(m if m.ndim == 2 else m.any(-1))
            if len(ys):
                i = int(self.rng.integers(len(ys)))
                cy, cx = int(ys[i]), int(xs[i])
                y0 = int(np.clip(cy - self.rng.integers(0, ch), 0, h - ch))
                x0 = int(np.clip(cx - self.rng.integers(0, cw), 0, w - cw))
                return {"y0": y0, "x0": x0, "ch": ch, "cw": cw}
        y0 = int(self.rng.integers(0, h - ch + 1))
        x0 = int(self.rng.integers(0, w - cw + 1))
        return {"y0": y0, "x0": x0, "ch": ch, "cw": cw}


@TRANSFORMS.register_class
class PiecewiseAffine(BaseTransform):
    """Local distortions: a (nb_rows, nb_cols) grid of normal displacements
    (sigma a draw from ``scale`` times the shorter side), resized bicubically
    to the image and remapped with a reflect-101 border (the JAX package's
    smooth approximation of the skimage original). ``mask_interpolation``
    and ``cval`` are accepted and unused, as in the JAX package."""

    geometric = True

    def __init__(self, scale=(0.03, 0.05), nb_rows: int = 4, nb_cols: int = 4,
                 interpolation: int = INTER_LINEAR, mask_interpolation: int = 0, cval: int = 0,
                 always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.scale = (scale, scale) if isinstance(scale, (int, float)) else tuple(scale)
        self.nb_rows, self.nb_cols = nb_rows, nb_cols
        self.interpolation = _check_interpolation(interpolation)

    def get_params(self, sample):
        h, w = sample["image"].shape[:2]
        scale = float(self.rng.uniform(*self.scale))
        return {"dgrid": self.rng.normal(0, scale * min(h, w), (self.nb_rows, self.nb_cols, 2)
                                         ).astype(np.float32)}

    @staticmethod
    def _maps(h, w, dgrid):
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        return (xx + warp.resize_cubic(dgrid[..., 1], h, w),
                yy + warp.resize_cubic(dgrid[..., 0], h, w))

    def apply(self, image, dgrid=None, **params):
        if dgrid is None:
            return image
        return warp.remap(image, *self._maps(*image.shape[:2], dgrid), self.interpolation,
                          BORDER_REFLECT_101)

    def apply_to_mask(self, mask, dgrid=None, **params):
        if dgrid is None:
            return mask
        return warp.remap(mask, *self._maps(*mask.shape[:2], dgrid), INTER_NEAREST,
                          BORDER_REFLECT_101)


def connected_components(binary: np.ndarray) -> Tuple[int, np.ndarray]:
    """``cv2.connectedComponents(binary)`` (8-connectivity): the count with
    the background, and int32 labels. cv2 scans 2x2 blocks in raster order
    and numbers a component by the first block that holds one of its pixels
    (one block holds one component at most); ``scipy.ndimage.label`` finds
    the components, which are then numbered that way."""
    from scipy import ndimage

    labels, n = ndimage.label(binary, structure=np.ones((3, 3), np.int32))
    h, w = binary.shape
    # the labels in the order cv2 visits them: 2x2 blocks in raster order
    padded = np.pad(labels, ((0, h % 2), (0, w % 2)))
    blocks = padded.reshape(padded.shape[0] // 2, 2, padded.shape[1] // 2, 2)
    found, first = np.unique(blocks.transpose(0, 2, 1, 3).ravel(), return_index=True)
    found, first = found[found > 0], first[found > 0]
    relabel = np.zeros(n + 1, np.int32)
    relabel[found[np.argsort(first)]] = np.arange(1, n + 1)
    return n + 1, relabel[labels]


@TRANSFORMS.register_class
class MaskDropout(BaseTransform):
    """Up to ``max_objects`` connected components (8-connectivity) of the
    mask filled in the image and the mask."""

    def __init__(self, max_objects: int = 1, image_fill_value=0, mask_fill_value=0,
                 always_apply: bool = False, p: float = 0.5, **_):
        super().__init__(always_apply, p)
        self.max_objects = max_objects
        self.image_fill_value = image_fill_value
        self.mask_fill_value = mask_fill_value

    def get_params(self, sample):
        mask = sample.get("mask")
        if mask is None:
            return {"drop": None}
        m = np.asarray(mask)
        n_labels, labels = connected_components((m if m.ndim == 2 else m.any(-1)).astype(np.uint8))
        if n_labels <= 1:
            return {"drop": None}
        k = int(self.rng.integers(1, self.max_objects + 1))
        chosen = self.rng.choice(np.arange(1, n_labels), size=min(k, n_labels - 1),
                                 replace=False)
        return {"drop": np.isin(labels, chosen)}

    @staticmethod
    def _fill(arr, drop, value):
        if drop is None:
            return arr
        out = arr.copy()
        out[drop] = value
        return out

    def apply(self, image, drop=None, **params):
        return self._fill(image, drop, self.image_fill_value)

    def apply_to_mask(self, mask, drop=None, **params):
        return self._fill(mask, drop, self.mask_fill_value)


@TRANSFORMS.register_class
class Lambda(BaseTransform):
    """User callables for the image, the mask and the boxes (only from
    Python: a YAML recipe cannot carry a callable)."""

    def __init__(self, image=None, mask=None, bboxes=None, name=None,
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.image_fn, self.mask_fn, self.bboxes_fn = image, mask, bboxes
        self.name = name

    def apply(self, image, **params):
        return self.image_fn(image) if self.image_fn else image

    def apply_to_mask(self, mask, **params):
        return self.mask_fn(mask) if self.mask_fn else mask

    def apply_to_bboxes(self, bboxes, image_shape, **params):
        return self.bboxes_fn(bboxes) if self.bboxes_fn else bboxes
