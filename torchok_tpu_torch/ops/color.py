"""Colour conversions and histogram equalisation of the photometric
transforms (port of the colour helpers of
``torchok_tpu.data.transforms.pixelwise``), and host twins of cv2's in numpy.

* The device functions (torch, on the trainer's device) keep the JAX
  package's float32 formulas: cv2's contrast-limited equalisation (CLAHE)
  on a uint8-valued channel, bit-exact against cv2; RGB <-> CIE L*a*b* by
  cv2's float formulas; RGB <-> HSV on cv2's uint8 scales (H in [0, 180)).
  They use exact operations only, so the card gives the CPU's bits:
  divisions by a constant go through :func:`warp.divide`, the sRGB curve
  by tables and comparisons, the cube root by :func:`cbrt`'s Newton
  steps.
* The host functions (numpy, one image) give OpenCV 5.0's bits:
  ``COLOR_RGB2GRAY`` (uint8 in 15-bit fixed point; float32 as
  ``fma(B, .114, fma(R, .299, G * .587))``), ``equalizeHist``,
  ``COLOR_RGB2HSV`` (cv2's integer tables) and ``COLOR_HSV2RGB`` of uint8
  (float32 in blocks of 32 pixels a row, truncated, the rest of a row
  rounded), ``COLOR_RGB2LAB`` of uint8 (cv2's integer tables);
  ``COLOR_LAB2RGB`` of uint8 by cv2's float formulas rounded, where cv2
  uses fixed-point tables (within two levels, one on a tenth of the
  values). The host CLAHE runs the device core on a CPU tensor.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from torchok_tpu_torch.ops import warp
from torchok_tpu_torch.ops.filters import reflect101_pad
from torchok_tpu_torch.ops.warp import divide

# sRGB (D65) to XYZ and back, as cv2's float Lab conversions take them
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float32)
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]], np.float32)
_WHITE_X, _WHITE_Z = np.float32(0.950456), np.float32(1.088754)
_LAB_T = 0.008856
# cv2's RGB2HSV uint8 tables (12-bit fixed point)
_HSV_SHIFT = 12
# pixels a row that cv2's HSV2RGB of uint8 converts in its vector loop (its
# AVX2 build; another instruction set may cut the blocks elsewhere)
_HSV2RGB_BLOCK = 32


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """A float result as uint8 values in float: clipped, rounded half up."""
    return torch.floor(x.clamp(0, 255) + 0.5)


def matvec(m: np.ndarray, c0, c1, c2):
    """Rows of ``m`` (3, 3) applied to three channels, each a sum of three
    products in order."""
    return [c0 * float(r[0]) + c1 * float(r[1]) + c2 * float(r[2]) for r in m]


# ------------------------------ device path ------------------------------

def clahe_luts(hist: torch.Tensor, clip_limit: torch.Tensor, area: int) -> torch.Tensor:
    """cv2's CLAHE tables from per-tile histograms (..., 256): each bin
    clipped at max(trunc(clip * area / 256), 1), the excess spread over all
    bins and its residual one a bin at a stride of max(256 // residual, 1),
    then ``round(cdf * float32(255 / area))``. ``clip_limit`` broadcasts;
    counts are whole numbers in float32 (exact)."""
    limit = torch.clamp(torch.trunc(clip_limit * (area / 256.0)), min=1.0)
    hist = hist.float()
    clipped = torch.minimum(hist, limit)
    excess = (hist - clipped).sum(dim=-1, keepdim=True)
    redist = torch.floor(divide(excess, 256.0))
    residual = excess - redist * 256.0
    hist = clipped + redist
    step = torch.clamp(torch.floor(torch.full_like(residual, 256.0) / residual.clamp(min=1.0)),
                       min=1.0)
    i = torch.arange(256, dtype=torch.float32, device=hist.device)
    bump = ((i % step) == 0) & ((i / step) < residual)
    cdf = torch.cumsum(hist + bump.float(), dim=-1)
    return torch.clamp(torch.round(cdf * float(np.float32(255.0 / area))), 0, 255)


def clahe_u8(v: torch.Tensor, clip_limit: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """``cv2.createCLAHE(clip, grid).apply`` on a batch of uint8-valued
    float channels ``v`` (N, H, W), one clip limit a sample (N,): a ragged
    size is padded at the bottom and right by reflect-101 to a whole number
    of tiles (cv2 then adds a whole tile to a divisible side too), each
    tile's table (:func:`clahe_luts`), the four nearest tiles' tables
    blended with cv2's float32 weights and rounded half to even. ``grid``
    is cv2's tileGridSize (tiles across, tiles down)."""
    n, h, w = v.shape
    gw, gh = int(grid[0]), int(grid[1])
    vp = v
    if h % gh or w % gw:
        vp = reflect101_pad(reflect101_pad(v, 1, 0, gh - h % gh), 2, 0, gw - w % gw)
    th, tw = vp.shape[1] // gh, vp.shape[2] // gw
    area = th * tw
    tiles = vp.reshape(n, gh, th, gw, tw).permute(0, 1, 3, 2, 4).reshape(n * gh * gw, area)
    tiles = tiles.long()
    hist = torch.zeros((n * gh * gw, 256), dtype=torch.int64, device=v.device)
    hist.scatter_add_(1, tiles, torch.ones_like(tiles))
    luts = clahe_luts(hist.view(n, gh, gw, 256), clip_limit.float().view(n, 1, 1, 1), area)
    tables, weights = _clahe_blend(h, w, th, tw, gh, gw)
    luts_flat = luts.reshape(n, gh * gw * 256)
    vi = v.long().reshape(n, h * w)

    def gather(base):
        idx = torch.from_numpy(base).to(v.device).reshape(1, h * w) + vi
        return torch.gather(luts_flat, 1, idx).view(n, h, w)

    tl, tr, bl, br = (gather(b) for b in tables)
    xa, xa1, ya, ya1 = (torch.from_numpy(a).to(v.device) for a in weights)
    res = (tl * xa1 + tr * xa) * ya1 + (bl * xa1 + br * xa) * ya
    return torch.clamp(torch.round(res), 0, 255)


@lru_cache(maxsize=16)
def _clahe_blend(h: int, w: int, th: int, tw: int, gh: int, gw: int):
    """The four tables' offsets (h, w) each and cv2's float32 weights xa,
    1 - xa (1, w) and ya, 1 - ya (h, 1) of CLAHE's interpolation."""
    tyf = np.arange(h, dtype=np.float32) * np.float32(1.0 / th) - np.float32(0.5)
    txf = np.arange(w, dtype=np.float32) * np.float32(1.0 / tw) - np.float32(0.5)
    ty1, tx1 = np.floor(tyf).astype(np.int64), np.floor(txf).astype(np.int64)
    ya, xa = (tyf - ty1).astype(np.float32), (txf - tx1).astype(np.float32)
    rows = [np.clip(ty1, 0, gh - 1), np.clip(ty1 + 1, 0, gh - 1)]
    cols = [np.clip(tx1, 0, gw - 1), np.clip(tx1 + 1, 0, gw - 1)]
    tables = tuple(((r[:, None] * gw + c[None, :]) * 256).astype(np.int64)
                   for r in rows for c in cols)
    one = np.float32(1.0)
    return tables, (xa[None, :], one - xa[None, :], ya[:, None], one - ya[:, None])


def cbrt(t: torch.Tensor) -> torch.Tensor:
    """The cube root of a non-negative float32 tensor from exact operations
    only (Kahan's integer first guess, four Newton steps), so that every
    device gives the same bits; within two ulps of the correctly rounded
    root."""
    y = (t.clamp(min=0.0).view(torch.int32) // 3 + 709921077).view(torch.float32)
    for _ in range(4):
        y = y - (y * y * y - t) / (3.0 * y * y)
    return y


@lru_cache(maxsize=1)
def _srgb_tables():
    """The linear value of each uint8 sRGB level (cv2's float formula, in
    float32), and the 255 linear values, in float64, at which
    ``round(255 * sRGB(linear))`` steps up to 1, 2, ..., 255."""
    f32 = np.float32
    x = np.arange(256, dtype=np.float32) / f32(255)
    lin = np.where(x <= f32(0.04045), x / f32(12.92),
                   ((x + f32(0.055)) / f32(1.055)) ** f32(2.4)).astype(np.float32)
    v = (np.arange(1, 256) - 0.5) / 255.0
    steps = np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)
    return lin, steps


def srgb_u8_to_linear(img: torch.Tensor) -> torch.Tensor:
    """Linear RGB (float32) of a uint8 sRGB tensor, by table."""
    return torch.from_numpy(_srgb_tables()[0]).to(img.device)[img.long()]


def linear_to_srgb_u8(lin: torch.Tensor) -> torch.Tensor:
    """``round(255 * sRGB(lin))`` of linear RGB in [0, 1] as float values,
    counted as the step values ``lin`` reaches: comparisons only, so every
    device gives the same levels."""
    steps = torch.from_numpy(_srgb_tables()[1]).to(lin.device)
    return torch.bucketize(lin.double(), steps, right=True).float()


def linear_to_lab(lin: torch.Tensor):
    """cv2's float linear RGB -> L*a*b* of an (..., 3) float32 tensor: XYZ
    (D65), L in [0, 100], a and b signed."""
    x, y, z = matvec(_RGB2XYZ, lin[..., 0], lin[..., 1], lin[..., 2])
    x, z = divide(x, float(_WHITE_X)), divide(z, float(_WHITE_Z))

    def f(t):
        return torch.where(t > _LAB_T, cbrt(t), 7.787 * t + (16.0 / 116.0))

    fx, fy, fz = f(x), f(y), f(z)
    ll = torch.where(y > _LAB_T, 116.0 * cbrt(y) - 16.0, 903.3 * y)
    return ll, 500.0 * (fx - fy), 200.0 * (fy - fz)


def lab_to_linear(ll: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cv2's float L*a*b* -> linear RGB (the inverse of
    :func:`linear_to_lab`), (..., 3) clipped to [0, 1]."""
    fy = divide(ll + 16.0, 116.0)
    fx = fy + divide(a, 500.0)
    fz = fy - divide(b, 200.0)

    def finv(t):
        cube = t * t * t
        return torch.where(cube > _LAB_T, cube, divide(t - 16.0 / 116.0, 7.787))

    y = torch.where(ll > 903.3 * _LAB_T, fy * fy * fy, divide(ll, 903.3))
    x = finv(fx) * float(_WHITE_X)
    z = finv(fz) * float(_WHITE_Z)
    return torch.stack(matvec(_XYZ2RGB, x, y, z), dim=-1).clamp(0.0, 1.0)


def clahe_rgb_u8(img: torch.Tensor, clip_limit: torch.Tensor, grid: Tuple[int, int]
                 ) -> torch.Tensor:
    """CLAHE of uint8 NHWC images as float values: a single channel
    directly, RGB on the L channel of cv2's float L*a*b* on its 8-bit
    scales. The sRGB curve goes by table both ways and the cube root by
    :func:`cbrt`, so the card gives the CPU's bits."""
    if img.shape[-1] == 1:
        return clahe_u8(img[..., 0].float(), clip_limit, grid)[..., None]
    ll, a, b = linear_to_lab(srgb_u8_to_linear(img))
    l8 = torch.round(ll * float(np.float32(255.0 / 100.0)))
    a8 = torch.clamp(torch.round(a) + 128.0, 0, 255)
    b8 = torch.clamp(torch.round(b) + 128.0, 0, 255)
    l8 = clahe_u8(l8, clip_limit, grid)
    return linear_to_srgb_u8(lab_to_linear(l8 * float(np.float32(100.0 / 255.0)), a8 - 128.0,
                                           b8 - 128.0))


def rgb_to_hsv_u8(imgf: torch.Tensor):
    """cv2's RGB -> HSV on its uint8 scales from a float (..., 3) tensor of
    0 to 255: H in [0, 180) (degrees / 2), S and V in [0, 255], whole
    numbers in float."""
    r, g, b = imgf[..., 0], imgf[..., 1], imgf[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = mx - mn
    safe = torch.where(delta > 0, delta, torch.ones_like(delta))
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = torch.where(delta > 0, torch.remainder(h * 30.0, 180.0), torch.zeros_like(h))
    s = 255.0 * delta / torch.where(mx > 0, mx, torch.ones_like(mx))
    return torch.remainder(torch.floor(h + 0.5), 180.0), torch.floor(s + 0.5), mx


def hsv_u8_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """cv2's HSV -> RGB on its uint8 scales (H in [0, 180)), float (..., 3)."""
    h60 = divide(h * 2.0, 60.0)
    i = torch.remainder(torch.floor(h60), 6)
    f = h60 - torch.floor(h60)
    s01 = divide(s, 255.0)
    p = v * (1 - s01)
    q = v * (1 - s01 * f)
    t = v * (1 - s01 * (1 - f))

    def select(choices, default):
        out = default
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select([v, q, p, p, t], v), select([t, v, v, q, p], p),
                        select([p, p, t, v, v], q)], dim=-1)


# ------------------------------- host path -------------------------------

def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of an (H, W, 3) uint8 or
    float32 image."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    if img.dtype == np.uint8:
        r, g, b = (c.astype(np.int32) for c in (r, g, b))
        return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)
    f32 = np.float32
    x = warp.fma(r, f32(0.299), (g * f32(0.587)).astype(np.float32))
    return warp.fma(b, f32(0.114), x).astype(img.dtype)


def equalize_hist(channel: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of a uint8 (H, W) channel: from the first
    non-empty bin i0, ``lut = round((cdf - hist[i0]) * float32(255 / (n -
    hist[i0])))`` half to even; a constant channel stays as it is."""
    hist = np.bincount(channel.ravel(), minlength=256)
    i0 = int(np.flatnonzero(hist)[0])
    total = channel.size
    if hist[i0] == total:
        return channel.copy()
    scale = np.float32(255.0) / np.float32(total - hist[i0])
    lut = np.clip(np.rint((np.cumsum(hist) - hist[i0]).astype(np.float32) * scale), 0, 255)
    lut[:i0] = 0
    return lut.astype(np.uint8)[channel]


@lru_cache(maxsize=1)
def _lab_tables():
    """cv2's RGB2Lab 8-bit tables: sRGB gamma in 1/8 levels (256 entries)
    and f(t) (the cube root, linear below 216/24389) in 2^-15 over t in
    steps of 1/2040, both float32 rounded half to even, as OpenCV's
    softfloat builds them; its cube root gives one ulp less than the
    correctly rounded float32 at t = 324/2040, whose table value sits on a
    half. And the XYZ rows over the white point in 2^-12."""
    f32 = np.float32
    threshold = np.float64(f32(809) / f32(20000))
    gamma = np.empty(256, np.int32)
    for i in range(256):
        x = np.float64(f32(i) / f32(255))
        g = x / (323 / 25) if x <= threshold else ((x + 11 / 200) / (211 / 200)) ** (12 / 5)
        gamma[i] = int(np.rint(f32(2040) * f32(g)))
    lthresh, lscale, lbias = f32(216) / f32(24389), f32(841) / f32(108), f32(16) / f32(116)
    x = f32(1) / (f32(255) * f32(8)) * np.arange(256 * 3 // 2 * 8, dtype=np.float32)
    linear = warp.fma(x, lscale, np.full_like(x, lbias))
    f = np.where(x < lthresh, linear, np.cbrt(x.astype(np.float64)).astype(np.float32))
    f[324] = np.nextafter(f[324], f32(0))
    cbrt = np.rint(f32(1 << 15) * f).astype(np.int32)
    white = (0.950456, 1.0, 1.088754)
    coeffs = np.rint(4096 * _RGB2XYZ.astype(np.float64).round(6)
                     / np.array(white)[:, None]).astype(np.int32)
    return gamma, cbrt, coeffs


def rgb_to_lab_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2LAB)`` of a uint8 (H, W, 3) image:
    cv2's integer path (gamma table, XYZ in 2^-12, cube-root table in
    2^-15), L scaled to [0, 255], a and b offset by 128."""
    gamma, cbrt, m = _lab_tables()

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    rgb = [gamma[img[..., k]] for k in range(3)]
    fx, fy, fz = (cbrt[descale(rgb[0] * r[0] + rgb[1] * r[1] + rgb[2] * r[2], 12)] for r in m)
    l_scale, l_shift = (116 * 255 + 50) // 100, -((16 * 255 * (1 << 15) + 50) // 100)
    lab = [descale(l_scale * fy + l_shift, 15), descale(500 * (fx - fy) + (128 << 15), 15),
           descale(200 * (fy - fz) + (128 << 15), 15)]
    return np.clip(np.stack(lab, axis=-1), 0, 255).astype(np.uint8)


def lab_u8_to_rgb(lab: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)`` of a uint8 (H, W, 3) image by
    cv2's float formulas (:func:`lab_to_linear`, :func:`linear_to_srgb_u8`)
    where cv2's 8-bit path uses fixed-point tables."""
    x = torch.from_numpy(lab.astype(np.float32))
    ll = x[..., 0] * float(np.float32(100.0 / 255.0))
    return linear_to_srgb_u8(lab_to_linear(ll, x[..., 1] - 128.0, x[..., 2] - 128.0)).to(
        torch.uint8).numpy()


@lru_cache(maxsize=1)
def _hsv_tables():
    i = np.arange(256, dtype=np.float64)
    i[0] = 1.0
    sdiv = np.rint((255 << _HSV_SHIFT) / i).astype(np.int32)
    hdiv = np.rint((180 << _HSV_SHIFT) / (6.0 * i)).astype(np.int32)
    sdiv[0] = hdiv[0] = 0
    return sdiv, hdiv


def rgb_to_hsv_cv2(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a uint8 (H, W, 3) image:
    cv2's integer arithmetic with its 12-bit division tables."""
    sdiv, hdiv = _hsv_tables()
    r, g, b = (img[..., k].astype(np.int32) for k in range(3))
    vmax = np.maximum(np.maximum(r, g), b)
    diff = vmax - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    out = np.empty(img.shape, np.uint8)
    out[..., 1] = (diff * sdiv[vmax] + half) >> _HSV_SHIFT
    out[..., 2] = vmax
    h = np.where(vmax == r, g - b, np.where(vmax == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    out[..., 0] = np.where(h < 0, h + 180, h)
    return out


def hsv_to_rgb_cv2(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of a uint8 (H, W, 3) image:
    S and V scaled to [0, 1] and the sector's terms in float32, the terms
    ``1 - s h`` and ``1 - s (1 - h)`` each one fused multiply-add; the first
    whole blocks of 32 pixels of a row truncate the result times 255 (cv2's
    vector loop), the rest of the row rounds it half to even."""
    f32 = np.float32
    one = f32(1.0)
    hh = hsv[..., 0].astype(np.float32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * f32(1.0 / 255.0)
    sector = np.floor(hh)
    frac = hh - sector
    sector = sector.astype(np.int8) % 6
    tab = (v, v * (one - s), v * warp.fma(-s, frac, one), v * warp.fma(-s, one - frac, one))
    # which of v, v(1 - s), v(1 - s h), v(1 - s (1 - h)) each sector gives r, g and b
    order = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0], [0, 1, 2]])
    vector = np.arange(hsv.shape[1]) < hsv.shape[1] // _HSV2RGB_BLOCK * _HSV2RGB_BLOCK
    out = np.empty(hsv.shape, np.uint8)
    for c in range(3):
        x = np.choose(order[:, c][sector], tab) * f32(255.0)
        x = np.where(vector[None, :], np.trunc(x), np.rint(x))
        out[..., c] = np.clip(x, 0, 255)
    return out
