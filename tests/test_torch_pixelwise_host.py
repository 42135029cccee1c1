"""Host paths of the port's photometric transforms (Flip to ToSepia of
``torchok_tpu_torch.data.transforms.pixelwise``) against ``torchok_tpu``'s
(cv2) on the CPU, under one numpy generator, and the cv2 twins they run on.

Both packages draw from one generator (the port's as a sample's,
``sample_generator``), gate included, in the same order, so the outputs are
compared directly. Equal to the bit on uint8 images: the flips, tables,
shifts, fills and permutations, ``cv2.blur`` (integer box sums times float32
1/k^2), ``cv2.GaussianBlur`` (cv2's 8-bit fixed point), ``cv2.medianBlur``,
``cv2.filter2D`` (a float32 fused multiply-add chain), ``RGB2GRAY``,
``equalizeHist``, ``RGB2HSV``/``HSV2RGB`` and the JPEG round trip (the
same bytes as ``cv2.imencode``). Also equal on float32 images of 0 to 1
where the arithmetic is the same numpy code, and for the median. Bounds:

* float32 filters and the float32 gray: cv2 sums in another order (its
  vector blocks and tails), so within 2e-7 (blurs, the gray) and 1e-6
  (Sharpen, whose taps reach 9);
* CLAHE of an RGB image: the port converts to L*a*b* as cv2's 8-bit path
  does (equal on all 2^24 colours) and equalises L as cv2 does, but comes
  back to RGB by cv2's float formulas where cv2's 8-bit path uses
  fixed-point tables: within 2 levels, on at most 15% of the values (the
  conversion alone differs by one level on a tenth of the L*a*b* values);
  a one-channel image is equal;
* Downscale with INTER_LINEAR: the port's bilinear resizes compute in
  float32 where cv2's use 11-bit weights for uint8, each within one level
  (``tests/test_torch_spatial.py``), so two of them within 2 levels on at
  most 30% of the values; float32 within 2e-7.
"""
import cv2
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX transforms
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu_torch import native
from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.data.transforms.base import sample_generator
from torchok_tpu_torch.ops import color, filters
from tests.test_torch_augment import jax_rngs


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sample(seed, dtype, size=(30, 37)):
    """Smooth gradients with noise (so blurs, CLAHE and JPEG see structure),
    and a three-class mask."""
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 200.0 / w, yy * 200.0 / h, (xx + yy) * 100.0 / (h + w)], -1)
    img = np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)
    img = img if dtype == np.uint8 else (img / 255.0).astype(np.float32)
    return img, rng.integers(0, 3, (h, w)).astype(np.uint8)


U8, F32 = (np.uint8,), (np.uint8, np.float32)
# (name, params, dtypes, float32 tolerance or the uint8 bound's name)
HOST = [
    ("Flip", {}, F32, 0),
    ("RandomBrightnessContrast", {}, F32, 0),
    ("RandomBrightnessContrast", {"brightness_by_max": False, "brightness_limit": (-0.3, 0.1)},
     F32, 0),
    ("RandomBrightness", {"limit": 0.4}, F32, 0),
    ("RandomContrast", {"limit": (0.1, 0.5)}, F32, 0),
    ("CoarseDropout", {"max_holes": 5, "min_holes": 2, "max_height": 9, "min_height": 3,
                       "fill_value": 7}, F32, 0),
    ("Cutout", {"num_holes": 3, "max_h_size": 12, "max_w_size": 5}, F32, 0),
    ("InvertImg", {}, F32, 0),
    ("ToGray", {}, F32, 2e-7),
    ("RandomGamma", {}, F32, 0),
    ("RandomGamma", {"gamma_limit": (40, 250)}, F32, 0),
    ("Solarize", {}, U8, 0),
    ("Solarize", {"threshold": 0.5}, (np.float32,), 0),
    ("Posterize", {"num_bits": 3}, U8, 0),
    ("ChannelShuffle", {}, F32, 0),
    ("RGBShift", {"r_shift_limit": 40, "b_shift_limit": (0, 30)}, F32, 0),
    ("ToFloat", {}, F32, 0),
    ("ToFloat", {"max_value": 100.0}, F32, 0),
    ("FromFloat", {}, (np.float32,), 0),
    ("FromFloat", {"dtype": "uint8", "max_value": 255}, (np.float32,), 0),
    ("Blur", {}, F32, 2e-7),
    ("Blur", {"blur_limit": (3, 11)}, F32, 2e-7),
    ("GaussianBlur", {}, F32, 2e-7),
    ("GaussianBlur", {"blur_limit": (3, 9), "sigma_limit": (0.3, 2.5)}, F32, 2e-7),
    ("MedianBlur", {}, U8, 0),
    ("MedianBlur", {"blur_limit": 5}, (np.float32,), 0),
    ("MotionBlur", {}, F32, 2e-7),
    ("CLAHE", {}, U8, "clahe"),
    ("CLAHE", {"clip_limit": (1, 8), "tile_grid_size": (3, 5)}, U8, "clahe"),
    ("Equalize", {}, U8, 0),
    ("HueSaturationValue", {}, U8, 0),
    ("HueSaturationValue", {"hue_shift_limit": 90, "sat_shift_limit": (-80, 10),
                            "val_shift_limit": 40}, U8, 0),
    ("ImageCompression", {"quality_lower": 40, "quality_upper": 100}, F32, 0),
    ("JpegCompression", {"quality_lower": 10, "quality_upper": 20}, U8, 0),
    ("Downscale", {"scale_min": 0.2, "scale_max": 0.6}, F32, 0),
    ("Downscale", {"scale_min": 0.3, "scale_max": 0.9, "interpolation": 1}, F32, "resize"),
    ("Sharpen", {}, F32, 1e-6),
    ("Sharpen", {"alpha": (0.6, 1.0), "lightness": (0.0, 2.0)}, F32, 1e-6),
    ("ToSepia", {}, F32, 0),
]
CASES = [(name, params, dtype, tol) for name, params, dtypes, tol in HOST for dtype in dtypes]


@pytest.mark.parametrize("name,params,dtype,tol", CASES, ids=[
    f"{n}-{i}-{np.dtype(d).name}" for i, (n, _, d, _) in enumerate(CASES)])
def test_host_path_matches_jax(name, params, dtype, tol):
    ref, port = JAX_TRANSFORMS.get(name)(**params), TRANSFORMS.get(name)(**params)
    for seed in range(4):
        img, mask = sample(seed, dtype)
        jax_rngs(ref, np.random.default_rng(seed))
        want = ref(image=img, mask=mask)
        with sample_generator(np.random.default_rng(seed)):
            got = port(image=img, mask=mask)
        a, b = np.asarray(want["image"]), got["image"]
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        if tol == "clahe":
            assert d.max() <= 2 and (d > 0).mean() <= 0.15, (d.max(), (d > 0).mean())
        elif tol == "resize" and dtype == np.uint8:
            assert d.max() <= 2 and (d > 0).mean() <= 0.3, (d.max(), (d > 0).mean())
        elif tol == "resize":
            assert d.max() <= 2e-7, d.max()
        elif tol and dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(got["mask"], want["mask"])


def test_flip_moves_boxes_as_the_jax_package():
    boxes = np.array([[3, 4, 30, 22], [0, 0, 6, 5]], np.float32)
    ref, port = JAX_TRANSFORMS.get("Flip")(), TRANSFORMS.get("Flip")()
    for code in (-1, 0, 1):
        np.testing.assert_array_equal(ref.apply_to_bboxes(boxes, (28, 40, 3), code=code),
                                      port.apply_to_bboxes(boxes, (28, 40, 3), code=code))


@pytest.mark.parametrize("name", ["CLAHE", "Equalize"])
def test_one_channel_images_equal_cv2(name):
    """A gray image through the CLAHE core and equalizeHist: equal."""
    for seed in range(3):
        img = sample(seed, np.uint8)[0][..., :1]
        for shape in (img.shape, img.shape[:2]):
            x = img.reshape(shape)
            jax_t, port = JAX_TRANSFORMS.get(name)(p=1.0), TRANSFORMS.get(name)(p=1.0)
            jax_rngs(jax_t, np.random.default_rng(seed))
            want = jax_t(image=x)["image"]
            with sample_generator(np.random.default_rng(seed)):
                np.testing.assert_array_equal(port(image=x)["image"], want)


@pytest.mark.parametrize("name", ["CLAHE", "Equalize", "HueSaturationValue"])
def test_uint8_only_transforms_refuse_float_images(name):
    img = sample(0, np.float32)[0]
    with pytest.raises(TypeError, match="uint8"):
        TRANSFORMS.get(name)(p=1.0)(image=img)


@pytest.mark.parametrize("size", [(30, 37), (9, 70), (64, 33)])
def test_the_twins_equal_cv2(size):
    """The host twins against cv2 on uint8 (equal) and float32 (the
    docstring's bounds), at widths below, at and across cv2's vector
    blocks."""
    img, _ = sample(1, np.uint8, size)
    f = (img / 255.0).astype(np.float32)
    for k in (3, 5, 7, 9):
        np.testing.assert_array_equal(filters.blur(img, k), cv2.blur(img, (k, k)))
        np.testing.assert_allclose(filters.blur(f, k), cv2.blur(f, (k, k)), atol=2e-7)
        for sigma in (0.0, 0.8, 2.3):
            np.testing.assert_array_equal(filters.gaussian_blur(img, k, sigma),
                                          cv2.GaussianBlur(img, (k, k), sigmaX=sigma))
            np.testing.assert_allclose(filters.gaussian_blur(f, k, sigma),
                                       cv2.GaussianBlur(f, (k, k), sigmaX=sigma), atol=2e-7)
        np.testing.assert_array_equal(filters.median_blur(img, k), cv2.medianBlur(img, k))
        kernel = np.zeros((k, k), np.float32)
        kernel[:, k // 2] = 1.0 / k
        np.testing.assert_array_equal(filters.filter2d(img, kernel), cv2.filter2D(img, -1, kernel))
    for c in range(3):
        np.testing.assert_array_equal(color.equalize_hist(img[..., c]),
                                      cv2.equalizeHist(img[..., c]))
    np.testing.assert_array_equal(color.rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    np.testing.assert_allclose(color.rgb_to_gray(f), cv2.cvtColor(f, cv2.COLOR_RGB2GRAY),
                               atol=2e-7)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(color.rgb_to_hsv_cv2(img), hsv)
    for shift in (0, 17, 100):
        moved = hsv.copy()
        moved[..., 0] = (moved[..., 0].astype(np.int64) + shift) % 180
        np.testing.assert_array_equal(color.hsv_to_rgb_cv2(moved),
                                      cv2.cvtColor(moved, cv2.COLOR_HSV2RGB))


def test_colour_conversions_equal_cv2_on_every_value():
    """RGB2HSV and RGB2LAB of every RGB colour (a 4096-wide image) and
    HSV2RGB of every uint8 HSV triple are equal; LAB2RGB by the float
    formulas lies within 2 levels of cv2's tables, one on a tenth of the
    values (over every L and a quarter of the a values)."""
    for part in range(8):  # 2^21 colours at a time
        v = np.arange(part << 21, (part + 1) << 21, dtype=np.uint32)
        rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
        rgb = rgb.reshape(512, 4096, 3)
        np.testing.assert_array_equal(color.rgb_to_hsv_cv2(rgb),
                                      cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
        np.testing.assert_array_equal(color.rgb_to_lab_u8(rgb),
                                      cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB))
    ll, a, b = np.meshgrid(np.arange(256), np.arange(0, 256, 4), np.arange(256), indexing="ij")
    lab = np.stack([ll, a, b], -1).astype(np.uint8).reshape(256 * 64, 256, 3)
    d = np.abs(color.lab_u8_to_rgb(lab).astype(np.int64)
               - cv2.cvtColor(lab, cv2.COLOR_LAB2RGB).astype(np.int64))
    assert d.max() <= 2 and (d > 0).mean() <= 0.11, (d.max(), (d > 0).mean())
    h, s, val = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, val], -1).astype(np.uint8).reshape(180 * 256, 256, 3)
    np.testing.assert_array_equal(color.hsv_to_rgb_cv2(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("quality", [50, 90, 100])
def test_jpeg_round_trip_equals_cv2(quality):
    """``native.encode_jpeg`` writes the bytes ``cv2.imencode`` writes (RGB
    given as cv2's BGR, and gray); decoding gives cv2's pixels."""
    img, _ = sample(2, np.uint8, (45, 61))
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok and native.encode_jpeg(img[..., ::-1], quality) == enc.tobytes()
    np.testing.assert_array_equal(native.decode_jpeg(enc.tobytes())[..., ::-1],
                                  cv2.imdecode(enc, cv2.IMREAD_UNCHANGED))
    ok, enc = cv2.imencode(".jpg", img[..., 0], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok and native.encode_jpeg(img[..., 0], quality) == enc.tobytes()
    with pytest.raises(ValueError, match="1 or 3 channels"):
        native.encode_jpeg(np.zeros((4, 4, 2), np.uint8), quality)


@pytest.mark.parametrize("fault", ["no build", "no library"])
def test_jpeg_without_libjpeg_raises_by_name(monkeypatch, tmp_path, fault):
    """Where libjpeg cannot be built against, or a library built elsewhere
    cannot load it, the round trip raises an error that names libjpeg."""
    from torchok_tpu_torch.native import build

    def missing():
        if fault == "no build":
            raise RuntimeError("JPEG decoding and encoding need libjpeg (jpeglib.h and -ljpeg)")
        (tmp_path / "lib.so").write_bytes(b"not a library")
        return tmp_path / "lib.so"
    monkeypatch.setattr(native, "_jpeg", None)
    monkeypatch.setattr(build, "build_jpeg_library", missing)
    with pytest.raises(RuntimeError, match="libjpeg"):
        TRANSFORMS.get("ImageCompression")(p=1.0)(image=sample(0, np.uint8)[0])
