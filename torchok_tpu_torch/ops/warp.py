"""Batched geometric warps for the device augmentation pipeline (port of
``torchok_tpu.ops.warp``), and their host twins in numpy without cv2:
``cv2.remap``, ``warpAffine``, ``warpPerspective``,
``getRotationMatrix2D``, ``getPerspectiveTransform``, the reflect-101
Gaussian blur and the bicubic resize of a small grid.

Conventions are cv2's: an affine (2x3) or projective (3x3) matrix maps
SOURCE to DESTINATION pixels and is inverted for sampling; pixel centres sit
on integer coordinates; the border modes are cv2's 0 to 4: ``constant`` (a
fill), ``replicate`` (clamp), ``reflect`` (mirror, repeating the edge),
``wrap`` (periodic) and ``reflect101`` (mirror about the edge pixels without
repeating them), each periodic where a coordinate lies further out than the
image is wide.

* The device functions (torch, batched, on the trainer's device) sample in
  float32 as the JAX package's do. Their small per-sample matrices are
  computed in float64 and rounded to float32 once, so a matrix, and hence
  every coordinate, is the same on the card and on the CPU.
* The host functions (numpy, one image) compute what OpenCV 5 computes.
  :func:`remap` samples at the map's coordinates: nearest rounds half to
  even; bilinear interpolates in float32 at the unrounded coordinate, x then
  y, with fused multiply-adds, and rounds an integer image half to even.
  :func:`warp_affine` and :func:`warp_perspective` sample the same way at
  float32 coordinates computed from the inverse matrix rounded to float32:
  in blocks of 16 columns ``fma(m0, x, m1 * y + m2)``, in the last partial
  block ``fma(m0, x, m1 * y) + m2`` (and the projective denominator alike,
  then one division). (OpenCV 4 rounded coordinates to 1/32 pixel and
  weighted uint8 in 15-bit fixed point instead.)
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

# cv2's constants, as the recipes spell them
BORDER_CONSTANT = 0
BORDER_REPLICATE = 1
BORDER_REFLECT = 2
BORDER_WRAP = 3
BORDER_REFLECT_101 = 4
INTER_NEAREST = 0
INTER_LINEAR = 1
BORDERS = {BORDER_CONSTANT: "constant", BORDER_REPLICATE: "replicate",
           BORDER_REFLECT: "reflect", BORDER_WRAP: "wrap", BORDER_REFLECT_101: "reflect101"}
INTERPOLATIONS = (INTER_NEAREST, INTER_LINEAR)
# cv2's warps compute coordinates in blocks of this many columns
_WARP_BLOCK = 16


def check_remap_flags(interpolation: int, border_mode: int) -> None:
    if interpolation not in INTERPOLATIONS:
        raise NotImplementedError(f"interpolation={interpolation!r} is not ported: only 0 "
                                  "(INTER_NEAREST) and 1 (INTER_LINEAR) are")
    if border_mode not in BORDERS:
        raise NotImplementedError(f"border_mode={border_mode!r} is not ported: only cv2's "
                                  "modes 0 to 4 are")


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
    if border == "reflect":  # period 2n: ...cba|abc...xyz|zyx...
        idx = idx % (2 * n)
        return (np.where(idx >= n, 2 * n - 1 - idx, idx) if isinstance(idx, np.ndarray)
                else torch.where(idx >= n, 2 * n - 1 - idx, idx)), None
    if border == "wrap":
        return idx % n, None
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
    ``map_x``/``map_y`` (N, Ho, Wo) float32 source coordinates for every
    output pixel -> (N, Ho, Wo, C). ``method``: ``bilinear`` (float32, the
    coordinates unrounded), or one of the two nearest rules as cv2 splits
    them: ``nearest_even`` rounds half to even (remap's ``cvRound``),
    ``nearest`` half up (``floor(x + 0.5)``, the JAX package's warpAffine
    rule)."""
    if method in ("nearest", "nearest_even"):
        if method == "nearest":
            ix, iy = torch.floor(map_x + 0.5), torch.floor(map_y + 0.5)
        else:
            ix, iy = torch.round(map_x), torch.round(map_y)
        return _gather(images, iy.long(), ix.long(), border, fill)
    x0, y0 = torch.floor(map_x), torch.floor(map_y)
    dx, dy = (map_x - x0)[..., None], (map_y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    top = _gather(images, y0, x0, border, fill) * (1 - dx) \
        + _gather(images, y0, x0 + 1, border, fill) * dx
    bot = _gather(images, y0 + 1, x0, border, fill) * (1 - dx) \
        + _gather(images, y0 + 1, x0 + 1, border, fill) * dx
    return top * (1 - dy) + bot * dy


def divide(x: torch.Tensor, scalar: float) -> torch.Tensor:
    """``x / scalar`` rounded once on every device: CUDA turns a division by
    a host scalar into a product with its reciprocal, so the divisor goes
    in as a tensor on ``x``'s device."""
    return x / torch.tensor(scalar, dtype=x.dtype, device=x.device)


def _pixel_grid(out_hw: Tuple[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The output pixels' float32 (x, y) coordinates, each (Ho, Wo)."""
    ho, wo = out_hw
    gy, gx = torch.meshgrid(torch.arange(ho, dtype=torch.float32, device=device),
                            torch.arange(wo, dtype=torch.float32, device=device),
                            indexing="ij")
    return gx, gy


def inverse_affine_sample(images: torch.Tensor, inv_mats: torch.Tensor,
                          out_hw: Tuple[int, int], method: str = "bilinear",
                          border: str = "reflect101", fill: float = 0.0) -> torch.Tensor:
    """Sample with per-sample DST->SRC affines: ``images`` (N, H, W, C)
    float, ``inv_mats`` (N, 2, 3) mapping output pixel (x, y) to its source
    coordinate (in float32) -> (N, Ho, Wo, C)."""
    gx, gy = _pixel_grid(out_hw, images.device)
    m = inv_mats.to(images.device, torch.float32)[:, :, :, None, None]
    src_x = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    src_y = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    return remap_sample(images, src_x, src_y, method, border, fill)


def invert_affine(mats: torch.Tensor) -> torch.Tensor:
    """Invert (N, 2, 3) SRC->DST affines into DST->SRC maps, in their dtype."""
    a, b, tx = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    c, d, ty = mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack([torch.stack([ia, ib, itx], -1), torch.stack([ic, id_, ity], -1)], 1)


def affine_sample(images: torch.Tensor, mats: torch.Tensor, out_hw: Tuple[int, int],
                  method: str = "bilinear", border: str = "reflect101",
                  fill: float = 0.0) -> torch.Tensor:
    """cv2.warpAffine's semantics: ``mats`` (N, 2, 3) map SRC->DST and are
    inverted (in float64, then rounded to float32) for sampling."""
    inv = invert_affine(mats.double()).float()
    return inverse_affine_sample(images, inv, out_hw, method, border, fill)


def rotation_mats(angles_deg: torch.Tensor, scales: torch.Tensor,
                  center_xy: Tuple[float, float]) -> torch.Tensor:
    """Per-sample cv2.getRotationMatrix2D in the angles' dtype: a positive
    angle turns counter-clockwise about ``center_xy``; (N,) angles and
    scales -> (N, 2, 3)."""
    rad = angles_deg * (np.pi / 180.0)
    alpha = scales * torch.cos(rad)
    beta = scales * torch.sin(rad)
    cx, cy = center_xy
    tx = (1 - alpha) * cx - beta * cy
    ty = beta * cx + (1 - alpha) * cy
    return torch.stack([torch.stack([alpha, beta, tx], -1),
                        torch.stack([-beta, alpha, ty], -1)], 1)


def crop_resize_sample(images: torch.Tensor, rects: torch.Tensor, out_hw: Tuple[int, int],
                       method: str = "bilinear") -> torch.Tensor:
    """Per-sample crop-and-resize: ``rects`` (N, 4) = (y0, x0, ch, cw) in
    source pixels; each crop resizes to ``out_hw`` with cv2.resize's
    half-pixel mapping, the coordinates clamped to the crop (cv2 resizes the
    cropped view, so it replicates the crop's edge, not the image's). An
    integer rect of the output's size is an exact crop."""
    gx, gy = _pixel_grid(out_hw, images.device)
    ho, wo = out_hw
    r = rects.to(images.device, torch.float32)[:, :, None, None]
    y0, x0, ch, cw = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    src_x = torch.minimum(torch.maximum(x0 + (gx + 0.5) * divide(cw, wo) - 0.5, x0),
                          x0 + cw - 1)
    src_y = torch.minimum(torch.maximum(y0 + (gy + 0.5) * divide(ch, ho) - 0.5, y0),
                          y0 + ch - 1)
    return remap_sample(images, src_x, src_y, method, "replicate", 0.0)


def perspective_from_points(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Per-sample cv2.getPerspectiveTransform: four point pairs (N, 4, 2)
    -> (N, 3, 3) homographies M with dst ~ M src, the 8x8 system solved in
    float64 (the products of coordinates in float32, as in cv2)."""
    n = src.shape[0]
    x, y = src[..., 0].float(), src[..., 1].float()
    u, v = dst[..., 0].float(), dst[..., 1].float()
    # the products in float32, as cv2 forms them
    xu, yu, xv, yv = ((p * q).double() for p, q in ((x, u), (y, u), (x, v), (y, v)))
    x, y, u, v = x.double(), y.double(), u.double(), v.double()
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    ru = torch.stack([x, y, ones, zeros, zeros, zeros, -xu, -yu], -1)
    rv = torch.stack([zeros, zeros, zeros, x, y, ones, -xv, -yv], -1)
    h = solve(torch.cat([ru, rv], 1), torch.cat([u, v], 1))
    return torch.cat([h, torch.ones((n, 1), dtype=h.dtype, device=h.device)], 1).reshape(n, 3, 3)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with a x = b for (N, K, K) ``a`` and (N, K) ``b``: Gaussian
    elimination with partial pivoting in elementwise ops, so the card and
    the CPU give the same bits (a library solve may differ in the last
    place)."""
    n, k = b.shape
    m = torch.cat([a, b[..., None]], 2)
    rows = torch.arange(n, device=a.device)
    for col in range(k):
        pivot = col + m[:, col:, col].abs().argmax(1)
        top, best = m[:, col].clone(), m[rows, pivot].clone()
        m[:, col], m[rows, pivot] = best, top
        factor = m[:, col + 1:, col] / m[:, col, col][:, None]
        m[:, col + 1:] = m[:, col + 1:] - factor[..., None] * m[:, col][:, None]
    x = torch.zeros_like(b)
    for col in reversed(range(k)):
        acc = m[:, col, k]
        for j in range(col + 1, k):  # in order: a reduction may sum otherwise on the card
            acc = acc - m[:, col, j] * x[:, j]
        x[:, col] = acc / m[:, col, col]
    return x


def invert_3x3(m: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) inverses by cofactors, elementwise, so the card and the CPU
    give the same bits."""
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            r0, r1 = [k for k in range(3) if k != i]
            c0, c1 = [k for k in range(3) if k != j]
            minor = m[:, r0, c0] * m[:, r1, c1] - m[:, r0, c1] * m[:, r1, c0]
            c[i][j] = minor if (i + j) % 2 == 0 else -minor
    det = m[:, 0, 0] * c[0][0] + m[:, 0, 1] * c[0][1] + m[:, 0, 2] * c[0][2]
    return torch.stack([torch.stack([c[j][i] / det for j in range(3)], -1)
                        for i in range(3)], 1)


def perspective_sample(images: torch.Tensor, mats: torch.Tensor, out_hw: Tuple[int, int],
                       method: str = "bilinear", border: str = "constant",
                       fill: float = 0.0) -> torch.Tensor:
    """cv2.warpPerspective's semantics: ``mats`` (N, 3, 3) map SRC->DST and
    are inverted (in float64, then rounded to float32) for sampling."""
    gx, gy = _pixel_grid(out_hw, images.device)
    m = invert_3x3(mats.to(images.device).double()).float()[:, :, :, None, None]
    denom = m[:, 2, 0] * gx + m[:, 2, 1] * gy + m[:, 2, 2]
    src_x = (m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]) / denom
    src_y = (m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]) / denom
    return remap_sample(images, src_x, src_y, method, border, fill)


# ------------------------------- host path -------------------------------

def border_fill(value: Union[None, float, Sequence[float]], channels: Optional[int],
                dtype) -> np.ndarray:
    """cv2's fill of a constant border: a scalar is ``Scalar(v, 0, 0, 0)``, so
    it fills channel 0 of a multi-channel image and leaves the others at 0;
    a sequence fills channel by channel; the result saturated to ``dtype``
    (an integer rounded half to even, as ``saturate_cast`` rounds)."""
    seq = [] if value is None else (list(value) if isinstance(value, (list, tuple))
                                    else [value])
    if channels is None:
        fill = np.array(seq[:1] or [0.0], np.float64)
    else:
        fill = np.zeros(channels, np.float64)
        fill[:min(len(seq), channels)] = seq[:channels]
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(fill), info.min, info.max).astype(dtype)
    return fill.astype(dtype)


def _taps(src: np.ndarray, rows, cols, fill: np.ndarray) -> np.ndarray:
    """``src`` (H, W, C) at the (index, inside mask or None) pairs ``rows``
    and ``cols`` of :func:`border_index`, gathered through flat indices."""
    (gy, vy), (gx, vx) = rows, cols
    vals = src.reshape(-1, src.shape[2])[gy * src.shape[1] + gx]
    if vy is not None:
        vals = np.where((vy & vx)[..., None], vals, fill)
    return vals


def fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product is exact in float64)."""
    out = np.multiply(a, b, dtype=np.float64)
    out += c
    return out.astype(np.float32)


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          interpolation: int = INTER_LINEAR, border_mode: int = BORDER_REFLECT_101,
          value=0.0) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, interpolation, borderMode=border_mode,
    borderValue=value)`` of one HW or HWC image with float32 maps (Ho, Wo),
    as OpenCV 5 computes it: nearest takes the coordinate rounded half to
    even; bilinear interpolates at the unrounded coordinate in float32, along
    x and then y, each step ``p + a (q - p)`` as one fused multiply-add, and
    an integer image is rounded half to even and saturated. A constant
    border takes ``value`` as cv2's ``Scalar`` (:func:`border_fill`)."""
    check_remap_flags(interpolation, border_mode)
    border = BORDERS[border_mode]
    src = img[..., None] if img.ndim == 2 else img
    fill = border_fill(value, src.shape[2] if img.ndim == 3 else None, src.dtype)
    map_x, map_y = np.asarray(map_x, np.float32), np.asarray(map_y, np.float32)
    h, w = src.shape[:2]
    if interpolation == INTER_NEAREST:
        out = _taps(src, border_index(np.rint(map_y).astype(np.int64), h, border),
                    border_index(np.rint(map_x).astype(np.int64), w, border), fill)
        return out[..., 0] if img.ndim == 2 else out
    x0, y0 = np.floor(map_x), np.floor(map_y)
    ax, ay = (map_x - x0)[..., None], (map_y - y0)[..., None]
    ix, iy = x0.astype(np.int64), y0.astype(np.int64)
    rows = [border_index(iy + d, h, border) for d in (0, 1)]
    cols = [border_index(ix + d, w, border) for d in (0, 1)]
    p00, p01, p10, p11 = (_taps(src, rows[dy], cols[dx], fill).astype(np.float32)
                          for dy in (0, 1) for dx in (0, 1))
    ax = ax.astype(np.float64)  # both steps along x take it
    top = fma(ax, p01 - p00, p00)
    out = fma(ay, fma(ax, p11 - p10, p10) - top, top)
    if np.issubdtype(src.dtype, np.integer):
        info = np.iinfo(src.dtype)
        out = np.clip(np.rint(out), info.min, info.max).astype(src.dtype)
    elif src.dtype != np.float32:
        out = out.astype(src.dtype)
    return out[..., 0] if img.ndim == 2 else out


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64, a positive angle (degrees)
    turning counter-clockwise about ``center`` (x, y)."""
    rad = angle * np.pi / 180.0
    alpha, beta = math.cos(rad) * scale, math.sin(rad) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine_transform(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64, as warpAffine inverts."""
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]], np.float64)


def _warp_coord(m: np.ndarray, row: int, xs: np.ndarray, ys: np.ndarray,
                body: np.ndarray) -> np.ndarray:
    """Row ``row`` of the float32 matrix ``m`` at pixels (xs, ys), as cv2's
    warps compute it: ``fma(m0, x, m1 * y + m2)`` in the 16-column blocks
    (``body``), ``fma(m0, x, m1 * y) + m2`` in the last partial block."""
    m0, m1, m2 = m[row]
    yterm = m1 * ys
    return np.where(body, fma(m0, xs, yterm + m2), fma(m0, xs, yterm) + m2)


def _warp_grid(dsize: Tuple[int, int]):
    w, h = dsize
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    return xs, ys, xs < (w // _WARP_BLOCK) * _WARP_BLOCK


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                interpolation: int = INTER_LINEAR, border_mode: int = BORDER_CONSTANT,
                value=0.0) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize=(w, h), flags=interpolation,
    borderMode=border_mode, borderValue=value)`` of one HW or HWC image, as
    OpenCV 5 computes it (the module's docstring)."""
    inv = invert_affine_transform(m).astype(np.float32)
    xs, ys, body = _warp_grid(dsize)
    return remap(img, _warp_coord(inv, 0, xs, ys, body),
                        _warp_coord(inv, 1, xs, ys, body), interpolation, border_mode, value)


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform``: four float32 (x, y) point pairs ->
    the (3, 3) float64 homography M with dst ~ M src. As in cv2, the
    products of coordinates are float32 and the 8x8 system is solved in
    float64."""
    src, dst = np.asarray(src, np.float32), np.asarray(dst, np.float32)
    a = np.zeros((8, 8), np.float64)
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        a[i] = [x, y, 1, 0, 0, 0, -(x * u), -(y * u)]
        a[i + 4] = [0, 0, 0, x, y, 1, -(x * v), -(y * v)]
    h = np.linalg.solve(a, np.concatenate([dst[:, 0], dst[:, 1]]).astype(np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def warp_perspective(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                     interpolation: int = INTER_LINEAR, border_mode: int = BORDER_CONSTANT,
                     value=0.0) -> np.ndarray:
    """``cv2.warpPerspective(img, m, dsize=(w, h), flags=interpolation,
    borderMode=border_mode, borderValue=value)`` of one HW or HWC image, as
    OpenCV 5 computes it: numerators and denominator as in
    :func:`warp_affine`, then one float32 division each."""
    inv = np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)
    xs, ys, body = _warp_grid(dsize)
    denom = _warp_coord(inv, 2, xs, ys, body)
    return remap(img, _warp_coord(inv, 0, xs, ys, body) / denom,
                        _warp_coord(inv, 1, xs, ys, body) / denom, interpolation,
                        border_mode, value)


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """cv2's four INTER_CUBIC taps (a = -0.75) at fractions ``t``, float32."""
    a = np.float32(-0.75)
    t = t.astype(np.float32)
    one = np.float32(1)
    w0 = ((a * (t + one) - 5 * a) * (t + one) + 8 * a) * (t + one) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + one
    w2 = ((a + 2) * (one - t) - (a + 3)) * (one - t) * (one - t) + one
    return np.stack([w0, w1, w2, one - w0 - w1 - w2], -1).astype(np.float32)


def _cubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 weights of cv2.resize's INTER_CUBIC along one axis:
    half-pixel centres, four taps from ``floor(f) - 1``, indices clamped."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f)
    taps = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, src - 1)
    m = np.zeros((dst, src), np.float64)
    np.add.at(m, (np.repeat(np.arange(dst), 4), taps.ravel()),
              _cubic_weights(f - s).astype(np.float64).ravel())
    return m.astype(np.float32)


def resize_cubic(field: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(field, (w, h), interpolation=cv2.INTER_CUBIC)`` of a
    float32 (H, W) field: bicubic (a = -0.75), along x and then y."""
    out = field.astype(np.float32) @ _cubic_matrix(field.shape[1], w).T
    return (_cubic_matrix(field.shape[0], h) @ out).astype(np.float32)


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
