"""The port's remaps against cv2 and ``torchok_tpu`` on the CPU:
``ops/warp.remap`` and ``gaussian_blur`` (numpy, no cv2) against
``cv2.remap`` and ``cv2.GaussianBlur`` at 256x256, ``remap_sample`` against
the JAX package's, and ElasticTransform and GridDistortion on both paths.

Tolerances: the host remap equals cv2 (OpenCV 5: float32 bilinear at the
unrounded coordinate, x then y with fused multiply-adds; nearest half to even)
on uint8 and float32 images, borders 0, 1 and 4. The blur is a product with a
banded matrix, so its sums run in another order than cv2's: within 1e-7 of a
field of magnitude 1. A warp's host output equals the JAX package's but where
that blur moves a coordinate across a rounding edge: one level, on at most
0.1% of the values. Device remaps agree with the JAX package's to 1e-4 in
float32 and one level in uint8 (at most 1% of the values), masks exactly.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu.ops import warp as jax_warp
from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.ops import warp
from tests.test_torch_augment import Draws, assert_levels, gate_as_uniform, host_both


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def maps(h, w, seed, spread=0.25):
    """Source coordinates reaching ``spread`` of the size past every edge,
    with exact halves and integers among them."""
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-spread * w, (1 + spread) * w, (h, w)).astype(np.float32)
    my = rng.uniform(-spread * h, (1 + spread) * h, (h, w)).astype(np.float32)
    mx[::7] = np.round(mx[::7] * 2) / 2
    my[:, ::5] = np.round(my[:, ::5])
    return mx, my


@pytest.mark.parametrize("border", [0, 1, 4])
@pytest.mark.parametrize("interpolation", [0, 1])
@pytest.mark.parametrize("dtype,channels", [(np.uint8, 3), (np.uint8, 0), (np.float32, 3)])
def test_host_remap_equals_cv2(border, interpolation, dtype, channels):
    rng = np.random.default_rng(border * 10 + interpolation)
    shape = (256, 256) + ((channels,) if channels else ())
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img = img if dtype == np.uint8 else img.astype(np.float32) / 7.0
    mx, my = maps(256, 256, border + 3 * interpolation)
    want = cv2.remap(img, mx, my, interpolation=interpolation, borderMode=border)
    got = warp.remap(img, mx, my, interpolation, border)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,ksize,sigma", [(256, 151, 50.0), (256, 13, 4.0), (40, 151, 50.0),
                                           (9, 13, 4.0)])
def test_host_blur_matches_cv2(n, ksize, sigma):
    field = np.random.default_rng(n + ksize).uniform(-1, 1, (n, n + 3)).astype(np.float32)
    want = cv2.GaussianBlur(field, (ksize, ksize), sigma)
    got = warp.gaussian_blur(field, ksize, sigma)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(warp.gaussian_blur_batch(torch.from_numpy(field)[None], ksize,
                                                        sigma)[0].numpy(), got, atol=1e-7)
    np.testing.assert_allclose(warp.gaussian_kernel(ksize, sigma),
                               cv2.getGaussianKernel(ksize, sigma, ktype=cv2.CV_32F)[:, 0],
                               rtol=1e-6)


@pytest.mark.parametrize("method", ["bilinear", "nearest_even"])
@pytest.mark.parametrize("border", ["constant", "replicate", "reflect101"])
def test_device_remap_matches_jax(method, border):
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 255, (3, 20, 24, 2)).astype(np.float32)
    mx = np.stack([maps(20, 24, s, spread=1.5)[0] for s in range(3)])
    my = np.stack([maps(20, 24, s, spread=1.5)[1] for s in range(3)])
    want = jax_warp.remap_sample(jnp.asarray(imgs), jnp.asarray(mx), jnp.asarray(my), method,
                                 border, 7.0)
    got = warp.remap_sample(torch.from_numpy(imgs), torch.from_numpy(mx), torch.from_numpy(my),
                            method, border, 7.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_reflect101_is_periodic_past_the_far_edge():
    idx = np.arange(-12, 20)
    want = np.array([cv2.borderInterpolate(int(i), 5, cv2.BORDER_REFLECT_101) for i in idx])
    np.testing.assert_array_equal(warp.reflect101(idx, 5), want)
    np.testing.assert_array_equal(warp.reflect101(torch.from_numpy(idx), 5).numpy(), want)


WARPS = [("ElasticTransform", {"border_mode": 1}), ("ElasticTransform", {"alpha": 40.0,
                                                                        "sigma": 5.0}),
         ("ElasticTransform", {"alpha": 20.0, "sigma": 3.0, "border_mode": 0,
                               "interpolation": 0}),
         ("GridDistortion", {}), ("GridDistortion", {"num_steps": 3, "distort_limit": 0.6,
                                                     "border_mode": 0}),
         ("GridDistortion", {"num_steps": 7, "border_mode": 1, "interpolation": 0})]


@pytest.mark.parametrize("name,params", WARPS)
def test_warp_host_path_matches_jax(name, params):
    for seed in range(3):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (64, 72, 3)).astype(np.uint8)
        mask = rng.integers(0, 4, (64, 72)).astype(np.uint8)
        a, b = host_both(name, params, img, mask, seed)
        assert_levels(a["image"], b["image"], share=1e-3)
        np.testing.assert_array_equal(a["mask"], b["mask"])
        assert b["image"].dtype == np.uint8 and b["mask"].dtype == np.uint8


@pytest.mark.parametrize("name,params", WARPS)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_warp_device_path_matches_jax(monkeypatch, name, params, dtype):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (6, 40, 48, 3)).astype(np.uint8)
    imgs = imgs if dtype == np.uint8 else imgs.astype(np.float32) / 255.0
    masks = rng.integers(0, 4, (6, 40, 48))
    port = TRANSFORMS.get(name)(**params, p=0.6)
    ref = JAX_TRANSFORMS.get(name)(**params, p=0.6)
    batch = {"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)}
    # the first seed whose gate applies the warp to some samples and not others
    seed = next(s for s in range(100) if 0 < int(port.draw_batch(
        imgs.shape[:3], torch.Generator().manual_seed(s), torch.device("cpu"))[2].sum()) < 6)
    draws = port.draw_batch(imgs.shape[:3], torch.Generator().manual_seed(seed),
                            torch.device("cpu"))
    got = port.apply_drawn(batch, *draws)
    again = port.apply_batch(batch, torch.Generator().manual_seed(seed))
    assert all(torch.equal(got[k], again[k]) for k in got)
    fake = Draws(monkeypatch, [draws[0].numpy(), draws[1].numpy(), gate_as_uniform(draws[2])])
    want = ref.apply_batch({"image": jnp.asarray(imgs), "mask": jnp.asarray(masks)},
                           jax.random.PRNGKey(0))
    fake.done()
    if dtype == np.uint8:
        assert_levels(got["image"].numpy(), np.asarray(want["image"]))
    else:
        np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), atol=1e-4)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert got["image"].dtype == batch["image"].dtype


@pytest.mark.parametrize("name", ["ElasticTransform", "GridDistortion"])
def test_warps_refuse_boxes_and_unported_flags(name):
    img = np.zeros((16, 16, 3), np.uint8)
    for registry in (TRANSFORMS, JAX_TRANSFORMS):
        with pytest.raises(NotImplementedError, match="bbox handler"):
            registry.get(name)(p=1.0)(image=img, bboxes=np.zeros((1, 4), np.float32))
    with pytest.raises(NotImplementedError, match="interpolation"):
        TRANSFORMS.get(name)(interpolation=2)
    with pytest.raises(NotImplementedError, match="border_mode"):
        TRANSFORMS.get(name)(border_mode=5)
    port, ref = TRANSFORMS.get(name)(), JAX_TRANSFORMS.get(name)()
    for flag in ("geometric", "device_bbox_safe", "device_needs_uniform", "device_capable",
                 "device_preserves_dtype"):
        assert getattr(port, flag) == getattr(ref, flag), flag
