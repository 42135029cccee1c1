"""Spatial transforms (port of ``Resize``, ``CenterCrop``, ``RandomCrop``,
``FitResize``, ``PadIfNeeded``, ``ElasticTransform`` and ``GridDistortion``
of ``torchok_tpu.data.transforms.spatial``): numpy on the host, batched torch
on the trainer's device (FitResize and PadIfNeeded on the host only: their
output size follows each image's own). The first five move a sample's pixel
xyxy boxes on the host (``apply_to_bboxes``: scaled, or shifted and clipped
to the crop, rows kept so labels stay aligned); on the device none does, so
none leaves the host for a dataset with boxes. The two warps have no box
handler: a sample with boxes raises.

The warps remap through :mod:`torchok_tpu_torch.ops.warp` (``cv2.remap``
and ``cv2.GaussianBlur`` in numpy on the host). The reference resizes with
``cv2.resize``; the port gives cv2's semantics without cv2: INTER_LINEAR samples at half-pixel centres with two taps and no
antialiasing when shrinking, and an integer image is rounded half up and
saturated to its dtype; INTER_NEAREST (and every mask) takes
``floor(i * src / dst)``. The host path computes that with numpy, the device
path with ``F.interpolate(..., align_corners=False, antialias=False)``.
"""
from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.data.transforms.base import BaseTransform, draw_device
from torchok_tpu_torch.ops import warp
from torchok_tpu_torch.ops.image import nearest_cv2_indices, resize_bilinear, resize_nearest_cv2

# cv2's interpolation flags, as the recipes spell them
INTER_NEAREST = 0
INTER_LINEAR = 1
_PORTED_INTERPS = (INTER_NEAREST, INTER_LINEAR)
# cv2's border modes 0 to 4 (CONSTANT, REPLICATE, REFLECT, WRAP, REFLECT_101)
# as numpy pad modes
BORDER_CONSTANT = 0
BORDER_REFLECT_101 = 4
_NUMPY_BORDERS = {0: "constant", 1: "edge", 2: "symmetric", 3: "wrap", 4: "reflect"}


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


def _shift_clip_bboxes(bboxes, x0: int, y0: int, crop_w: int, crop_h: int) -> np.ndarray:
    b = np.asarray(bboxes, np.float32).reshape(-1, 4).copy()
    b[:, [0, 2]] = np.clip(b[:, [0, 2]] - x0, 0, crop_w)
    b[:, [1, 3]] = np.clip(b[:, [1, 3]] - y0, 0, crop_h)
    return b


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
    b = np.asarray(bboxes, np.float32).reshape(-1, 4).copy()
    b[:, [0, 2]] *= sx
    b[:, [1, 3]] *= sy
    return b


@TRANSFORMS.register_class
class FitResize(BaseTransform):
    """Aspect-preserving resize into ``max_height`` x ``max_width``: the side
    that binds (an exact ``Fraction`` test of the aspect ratios) meets its
    limit, the other is scaled by the same factor and rounded (Python's
    ``round``). Host only."""

    always_apply = True
    geometric = True
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


def _border_fill(value: Union[None, float, Sequence[float]], channels: Optional[int],
                 dtype) -> Union[float, np.ndarray]:
    """cv2's fill of a constant border: a scalar is ``Scalar(v, 0, 0, 0)``, so
    it fills channel 0 of a multi-channel image and leaves the others at 0;
    a sequence fills channel by channel; the result saturated to ``dtype``."""
    seq = [] if value is None else (list(value) if isinstance(value, (list, tuple))
                                    else [value])
    if channels is None:
        fill = np.array(seq[:1] or [0.0], np.float64)
    else:
        fill = np.zeros(channels, np.float64)
        fill[:min(len(seq), channels)] = seq[:channels]
    if np.issubdtype(dtype, np.integer):
        return saturate_int(fill, dtype)
    return fill.astype(dtype)


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
    fill = _border_fill(value, arr.shape[2] if arr.ndim == 3 else None, arr.dtype)
    out = np.empty((arr.shape[0] + top + bottom, arr.shape[1] + left + right) + arr.shape[2:],
                   arr.dtype)
    out[...] = fill
    out[top:top + arr.shape[0], left:left + arr.shape[1]] = arr
    return out


@TRANSFORMS.register_class
class PadIfNeeded(BaseTransform):
    """Pad up to ``min_height`` x ``min_width``, the rows split ``ph // 2``
    on top and the rest below (the columns likewise); ``mask_value`` fills a
    constant border of the mask. Host only."""

    always_apply = True
    geometric = True
    device_bbox_safe = False

    def __init__(self, min_height: int = 1024, min_width: int = 1024,
                 border_mode: int = BORDER_REFLECT_101, value=None, mask_value=None,
                 always_apply: bool = False, p: float = 1.0, **_):
        super().__init__(always_apply, p)
        self.min_height, self.min_width = min_height, min_width
        if border_mode not in _NUMPY_BORDERS:
            raise NotImplementedError(f"border_mode={border_mode!r}: only cv2's modes 0 to 4 "
                                      "are ported")
        self.border_mode = border_mode
        self.value = value
        self.mask_value = mask_value

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
        b = np.asarray(bboxes, np.float32).reshape(-1, 4).copy()
        b[:, [0, 2]] += l
        b[:, [1, 3]] += t
        return b


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
    device_capable = True
    device_needs_uniform = True

    def __init__(self, interpolation: int = INTER_LINEAR,
                 border_mode: int = warp.BORDER_REFLECT_101, always_apply: bool = False,
                 p: float = 0.5):
        super().__init__(always_apply, p)
        warp.check_remap_flags(interpolation, border_mode)
        self.interpolation = interpolation
        self.border_mode = border_mode

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
        return self.num_steps >= 1

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
