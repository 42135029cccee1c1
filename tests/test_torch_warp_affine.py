"""The port's affine and projective warps (``torchok_tpu_torch.ops.warp``)
against cv2 and ``torchok_tpu.ops.warp`` on the CPU.

Host twins (numpy, no cv2) against this repository's OpenCV 5, bit for bit:
``warp_affine`` and ``warp_perspective`` on uint8 and float32 images of one
and three channels, every border mode and both interpolations, at a width
that leaves a partial block of columns; ``get_rotation_matrix_2d``,
``invert_affine_transform`` and ``get_perspective_transform`` to 1e-12;
``init_undistort_rectify_map`` and ``connected_components`` equal.
``resize_cubic`` sums its taps in another order than cv2: within 1e-5 of
the field's largest value.

Device functions (torch) against the JAX package's on the same float32
inputs: the matrices to 1e-6 relative (the port forms them in float64 and
rounds once), the samples to 1e-3 on images of 0 to 255 (about one float32
step of a coordinate times the image's slope), nearest samples and crops
equal.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401
from torchok_tpu.ops import warp as jax_warp
from torchok_tpu_torch.data.transforms.spatial import (connected_components,
                                                       init_undistort_rectify_map)
from torchok_tpu_torch.ops import warp

H, W = 40, 52  # 52 = three blocks of 16 columns and a partial one


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def image(dtype, channels, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W) + ((channels,) if channels else ())).astype(np.uint8)
    return img if dtype == np.uint8 else img.astype(np.float32) / 7.0


def affine_matrices():
    m1 = cv2.getRotationMatrix2D((W / 2 - 0.5, H / 2 - 0.5), 23.7, 0.9)
    m1[0, 2] += 3.3
    m2 = cv2.getRotationMatrix2D((W / 2, H / 2), -71.0, 1.3)
    m2[0, 1] += 0.2
    m3 = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, -1.5]])  # exact halves: the rounding rule
    return [m1, m2, m3]


def perspective_points(seed):
    rng = np.random.default_rng(seed)
    src = np.float32([[0, 0], [W, 0], [W, H], [0, H]])
    dst = (src + rng.uniform(-0.15, 0.15, (4, 2)) * [W, H]).astype(np.float32)
    return src, dst


KINDS = [(np.uint8, 3), (np.uint8, 0), (np.float32, 3), (np.float32, 1)]


@pytest.mark.parametrize("border", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("interpolation", [0, 1])
def test_host_warp_affine_equals_cv2(border, interpolation):
    for dtype, channels in KINDS:
        img = image(dtype, channels, border)
        for m in affine_matrices():
            for value in ((None, 5.0, (3, 200, 9)) if border == 0 else (None,)):
                want = cv2.warpAffine(img, m, (W, H), flags=interpolation, borderMode=border,
                                      borderValue=0 if value is None else value)
                got = warp.warp_affine(img, m, (W, H), interpolation, border, value)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("border", [0, 1, 4])
@pytest.mark.parametrize("interpolation", [0, 1])
def test_host_warp_perspective_equals_cv2(border, interpolation):
    for seed, (dtype, channels) in enumerate(KINDS):
        img = image(dtype, channels, seed)
        src, dst = perspective_points(seed)
        m = cv2.getPerspectiveTransform(src, dst)
        np.testing.assert_allclose(warp.get_perspective_transform(src, dst), m, rtol=0,
                                   atol=1e-12)
        want = cv2.warpPerspective(img, m, (W, H), flags=interpolation, borderMode=border)
        got = warp.warp_perspective(img, m, (W, H), interpolation, border)
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_host_matrices_equal_cv2():
    for angle, scale, center in ((23.7, 0.9, (25.5, 19.5)), (-180.0, 1.0, (0, 0)),
                                 (90.0, 2.5, (3.25, 7.0))):
        m = cv2.getRotationMatrix2D(center, angle, scale)
        np.testing.assert_allclose(warp.get_rotation_matrix_2d(center, angle, scale), m,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(warp.invert_affine_transform(m),
                                   cv2.invertAffineTransform(m), rtol=0, atol=1e-12)


@pytest.mark.parametrize("rows,cols,h,w", [(4, 4, 64, 72), (3, 5, 256, 256), (2, 6, 33, 300)])
def test_host_resize_cubic_matches_cv2(rows, cols, h, w):
    grid = np.random.default_rng(rows).normal(0, 3, (rows, cols)).astype(np.float32)
    want = cv2.resize(grid, (w, h), interpolation=cv2.INTER_CUBIC)
    got = warp.resize_cubic(grid, h, w)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_host_undistort_map_equals_cv2():
    rng = np.random.default_rng(0)
    for h, w in ((32, 36), (256, 256), (301, 257)):
        k = rng.uniform(-0.5, 0.5)
        cam = np.array([[w, 0, w / 2 + rng.uniform(-0.1, 0.1) * w],
                        [0, h, h / 2 + rng.uniform(-0.1, 0.1) * h], [0, 0, 1]], np.float32)
        dist = np.array([k, k, 0, 0, 0], np.float32)
        want = cv2.initUndistortRectifyMap(cam, dist, None, None, (w, h), cv2.CV_32FC1)
        for a, b in zip(init_undistort_rectify_map(cam, dist, (w, h)), want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(32, 36), (33, 37), (1, 50), (256, 256)])
def test_host_connected_components_equal_cv2(shape):
    rng = np.random.default_rng(shape[0])
    for share in (0.05, 0.3, 0.6):
        binary = (rng.random(shape) < share).astype(np.uint8)
        n, labels = cv2.connectedComponents(binary)
        got_n, got = connected_components(binary)
        assert got_n == n
        np.testing.assert_array_equal(got, labels)


# ------------------------------- device ops -------------------------------

def batch(n=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (n, 20, 24, 2)).astype(np.float32)


def rotation_draws(n=3, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-60, 60, n).astype(np.float32), rng.uniform(0.7, 1.3, n).astype(np.float32))


@pytest.mark.parametrize("method", ["bilinear", "nearest", "nearest_even"])
@pytest.mark.parametrize("border", ["constant", "replicate", "reflect101"])
def test_affine_samples_match_jax(method, border):
    imgs = batch()
    angles, scales = rotation_draws()
    ref_mats = jax_warp.rotation_mats(jnp.asarray(angles), jnp.asarray(scales), (11.5, 9.5))
    mats = warp.rotation_mats(torch.from_numpy(angles).double(),
                              torch.from_numpy(scales).double(), (11.5, 9.5))
    np.testing.assert_allclose(mats.numpy(), np.asarray(ref_mats), rtol=1e-6, atol=1e-5)
    inv = jax_warp.invert_affine(ref_mats)
    np.testing.assert_allclose(warp.invert_affine(torch.from_numpy(np.array(ref_mats))).numpy(),
                               np.asarray(inv), rtol=1e-6, atol=1e-5)
    # the same float32 inverse on both sides: the same coordinates
    want = jax_warp.inverse_affine_sample(jnp.asarray(imgs), inv, (18, 26), method, border, 7.0)
    got = warp.inverse_affine_sample(torch.from_numpy(imgs), torch.from_numpy(np.array(inv)),
                                     (18, 26), method, border, 7.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    if method == "bilinear":  # SRC->DST, inverted inside
        want = jax_warp.affine_sample(jnp.asarray(imgs), ref_mats, (20, 24), method, border, 7.0)
        got = warp.affine_sample(torch.from_numpy(imgs), mats, (20, 24), method, border, 7.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_crop_resize_samples_match_jax(method):
    imgs = batch(4)
    rects = np.array([[0, 0, 20, 24], [3, 5, 9, 13], [2.0, 1.0, 17.0, 7.0], [7, 11, 12, 10]],
                     np.float32)
    want = jax_warp.crop_resize_sample(jnp.asarray(imgs), jnp.asarray(rects), (12, 10), method)
    got = warp.crop_resize_sample(torch.from_numpy(imgs), torch.from_numpy(rects), (12, 10),
                                  method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    # a rect of the output's size is an exact crop
    exact = warp.crop_resize_sample(torch.from_numpy(imgs), torch.from_numpy(rects[3:] * 0 +
                                    np.float32([[7, 11, 12, 10]])), (12, 10), method)
    np.testing.assert_array_equal(exact.numpy()[0], imgs[0, 7:19, 11:21])


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_perspective_matches_jax(method):
    imgs = batch(2)
    pts = [perspective_points(seed) for seed in (3, 4)]
    src = np.stack([p[0] for p in pts]) * np.float32([24 / W, 20 / H])
    dst = np.stack([p[1] for p in pts]) * np.float32([24 / W, 20 / H])
    ref_mats = jax_warp.perspective_from_points(jnp.asarray(src), jnp.asarray(dst))
    mats = warp.perspective_from_points(torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_allclose(mats.numpy(), np.asarray(ref_mats), rtol=1e-4, atol=1e-6)
    for s, d, m in zip(src, dst, mats.numpy()):  # and cv2's, which the host path takes
        np.testing.assert_allclose(m, cv2.getPerspectiveTransform(s, d), rtol=1e-12,
                                   atol=1e-12)
    want = jax_warp.perspective_sample(jnp.asarray(imgs), ref_mats, (20, 24), method,
                                       "constant", 3.0)
    got = warp.perspective_sample(torch.from_numpy(imgs), mats, (20, 24), method, "constant",
                                  3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


def test_device_affine_sample_agrees_with_the_host_twin():
    """The device warp against ``warp_affine`` on one image: bilinear
    within 1e-3 of 255 (float32 coordinates formed in another order)."""
    img = batch(1)[0]
    m = cv2.getRotationMatrix2D((11.5, 9.5), 31.0, 1.1)
    want = warp.warp_affine(img, m, (24, 20), warp.INTER_LINEAR, warp.BORDER_REFLECT_101)
    got = warp.affine_sample(torch.from_numpy(img)[None], torch.from_numpy(m)[None],
                             (20, 24), "bilinear", "reflect101")[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
