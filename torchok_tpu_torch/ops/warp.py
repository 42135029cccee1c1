"""Dense remaps for ElasticTransform and GridDistortion (port of
``torchok_tpu.ops.warp``'s ``remap_sample``, plus ``cv2.remap`` and the
reflect-101 Gaussian blur in numpy for the host path, without cv2).

Conventions are cv2's: pixel centres sit on integer coordinates; borders are
``BORDER_CONSTANT`` (a fill), ``BORDER_REPLICATE`` (clamp) and
``BORDER_REFLECT_101`` (mirror about the edge pixels without repeating them,
periodically where a coordinate lies further out than the image is wide).

* :func:`remap_sample` (torch, batched, on the trainer's device) samples in
  float32 at the map's coordinates, as the JAX package's device path does.
* :func:`remap` (numpy, one image) is ``cv2.remap`` as OpenCV 5 computes it
  (the reference's host path): nearest rounds a coordinate half to even;
  bilinear interpolates in float32 at the unrounded coordinate, x then y,
  with fused multiply-adds, and rounds an integer image half to even.
  (OpenCV 4 rounded bilinear coordinates to 1/32 pixel and weighted uint8
  in 15-bit fixed point instead.)
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# cv2's constants, as the recipes spell them
BORDER_CONSTANT = 0
BORDER_REPLICATE = 1
BORDER_REFLECT_101 = 4
INTER_NEAREST = 0
INTER_LINEAR = 1
BORDERS = {BORDER_CONSTANT: "constant", BORDER_REPLICATE: "replicate",
           BORDER_REFLECT_101: "reflect101"}
INTERPOLATIONS = (INTER_NEAREST, INTER_LINEAR)


def check_remap_flags(interpolation: int, border_mode: int) -> None:
    if interpolation not in INTERPOLATIONS:
        raise NotImplementedError(f"interpolation={interpolation!r} is not ported: only 0 "
                                  "(INTER_NEAREST) and 1 (INTER_LINEAR) are")
    if border_mode not in BORDERS:
        raise NotImplementedError(f"border_mode={border_mode!r} is not ported: only 0 "
                                  "(CONSTANT), 1 (REPLICATE) and 4 (REFLECT_101) are")


def reflect101(idx, n: int):
    """Mirror integer indices (a numpy array or a tensor) into [0, n - 1]
    without repeating the edge, periodically."""
    if n == 1:
        return idx * 0
    period = 2 * (n - 1)
    idx = abs(idx) % period
    return np.where(idx >= n, period - idx, idx) if isinstance(idx, np.ndarray) \
        else torch.where(idx >= n, period - idx, idx)


def border_index(idx, n: int, border: str):
    """Indices inside [0, n - 1] under ``border``, and for ``constant`` the
    mask of those that were inside (else None)."""
    if border == "reflect101":
        return reflect101(idx, n), None
    clipped = idx.clip(0, n - 1)
    return clipped, ((idx >= 0) & (idx <= n - 1) if border == "constant" else None)


# ------------------------------ device path ------------------------------

def _gather(images: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, border: str,
            fill: float) -> torch.Tensor:
    """images (N, H, W, C) at per-sample indices (N, Ho, Wo) -> (N, Ho, Wo, C)."""
    n, h, w = images.shape[:3]
    gy, vy = border_index(iy, h, border)
    gx, vx = border_index(ix, w, border)
    vals = images[torch.arange(n, device=images.device)[:, None, None], gy, gx]
    if vy is not None:
        vals = torch.where((vy & vx)[..., None], vals, torch.full_like(vals, fill))
    return vals


def remap_sample(images: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
                 method: str = "bilinear", border: str = "reflect101",
                 fill: float = 0.0) -> torch.Tensor:
    """cv2.remap with per-sample dense maps: ``images`` (N, H, W, C),
    ``map_x``/``map_y`` (N, Ho, Wo) source coordinates for every output
    pixel -> (N, Ho, Wo, C). ``method``: ``bilinear`` (float32, the
    coordinates unrounded) or ``nearest_even`` (the coordinates rounded half
    to even, as cv2.remap rounds them)."""
    if method == "nearest_even":
        return _gather(images, torch.round(map_y).long(), torch.round(map_x).long(), border,
                       fill)
    x0, y0 = torch.floor(map_x), torch.floor(map_y)
    dx, dy = (map_x - x0)[..., None], (map_y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    top = _gather(images, y0, x0, border, fill) * (1 - dx) \
        + _gather(images, y0, x0 + 1, border, fill) * dx
    bot = _gather(images, y0 + 1, x0, border, fill) * (1 - dx) \
        + _gather(images, y0 + 1, x0 + 1, border, fill) * dx
    return top * (1 - dy) + bot * dy


# ------------------------------- host path -------------------------------

def _taps(src: np.ndarray, iy: np.ndarray, ix: np.ndarray, border: str, fill) -> np.ndarray:
    h, w = src.shape[:2]
    gy, vy = border_index(iy, h, border)
    gx, vx = border_index(ix, w, border)
    vals = src[gy, gx]
    if vy is not None:
        vals = np.where((vy & vx)[..., None], vals, np.asarray(fill, vals.dtype))
    return vals


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          interpolation: int = INTER_LINEAR, border_mode: int = BORDER_REFLECT_101,
          value: float = 0.0) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, interpolation, borderMode=border_mode,
    borderValue=value)`` of one HW or HWC image with float32 maps (Ho, Wo),
    as OpenCV 5 computes it: nearest takes the coordinate rounded half to
    even; bilinear interpolates at the unrounded coordinate in float32, along
    x and then y, each step ``p + a (q - p)`` as one fused multiply-add, and
    an integer image is rounded half to even and saturated."""
    check_remap_flags(interpolation, border_mode)
    border = BORDERS[border_mode]
    src = img[..., None] if img.ndim == 2 else img
    map_x, map_y = np.asarray(map_x, np.float32), np.asarray(map_y, np.float32)
    if interpolation == INTER_NEAREST:
        out = _taps(src, np.rint(map_y).astype(np.int64), np.rint(map_x).astype(np.int64),
                    border, value)
        return out[..., 0] if img.ndim == 2 else out
    x0, y0 = np.floor(map_x), np.floor(map_y)
    ax, ay = (map_x - x0)[..., None], (map_y - y0)[..., None]
    ix, iy = x0.astype(np.int64), y0.astype(np.int64)
    p00, p01, p10, p11 = (_taps(src, iy + dy, ix + dx, border, value).astype(np.float32)
                          for dy in (0, 1) for dx in (0, 1))
    top = _fma(ax, p01 - p00, p00)
    out = _fma(ay, _fma(ax, p11 - p10, p10) - top, top)
    if np.issubdtype(src.dtype, np.integer):
        info = np.iinfo(src.dtype)
        out = np.clip(np.rint(out), info.min, info.max).astype(src.dtype)
    elif src.dtype != np.float32:
        out = out.astype(src.dtype)
    return out[..., 0] if img.ndim == 2 else out


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)``'s taps (sigma > 0), float32."""
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=32)
def blur_matrix(n: int, ksize: int, sigma: float) -> np.ndarray:
    """(n, n) float32 matrix of the ``ksize``-tap Gaussian along an axis of
    ``n`` samples with the reflect-101 border folded in: row i holds the
    weights output i takes from each input."""
    r = ksize // 2
    src = reflect101(np.arange(n)[:, None] + np.arange(-r, r + 1)[None, :], n)
    m = np.zeros((n, n), np.float64)
    np.add.at(m, (np.repeat(np.arange(n), ksize), src.ravel()),
              np.tile(gaussian_kernel(ksize, sigma).astype(np.float64), n))
    return m.astype(np.float32)


def gaussian_blur(field: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(field, (ksize, ksize), sigma)`` of a float32 (H, W)
    field with the reflect-101 border: separable, as a product with
    :func:`blur_matrix` along each axis."""
    if ksize // 2 == 0 or sigma <= 0:
        return field
    h, w = field.shape
    return blur_matrix(h, ksize, sigma) @ (field @ blur_matrix(w, ksize, sigma).T)


def gaussian_blur_batch(field: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """:func:`gaussian_blur` of an (N, H, W) float32 field on its device."""
    if ksize // 2 == 0 or sigma <= 0:
        return field
    h, w = field.shape[1:]
    mh = torch.from_numpy(blur_matrix(h, ksize, sigma)).to(field.device)
    mw = torch.from_numpy(blur_matrix(w, ksize, sigma)).to(field.device)
    return mh @ (field @ mw.T)
