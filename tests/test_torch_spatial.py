"""The port's spatial transforms (``torchok_tpu_torch.data.transforms.
spatial``) against ``torchok_tpu`` on the CPU, on images and masks.

Host paths: both packages draw from one numpy generator (the port's as a
sample's, ``sample_generator``), so the parameters must be equal; the JAX
package's are then pinned and applied by both. The warps, crops,
permutations and fills are equal to the JAX package's (cv2) on uint8 and
float32 images. The bilinear resizes lie within one level of cv2's uint8
fixed-point weights (on up to a fifth of the values) and within 2e-7 of
float32 images of 0 to 1. PiecewiseAffine's bicubic grid sums in another
order than cv2 (1e-5 apart), so its remap lies one level off on at most
0.1% of the uint8 values and within 1e-5 in float32. Masks are equal.

Device paths: the port's ``draw_batch`` draws from a ``torch.Generator``;
``jax.random``'s samplers are patched to hand the JAX ``apply_batch`` (one
compiled function) the same draws in the order it asks for them. The port
forms its matrices in float64 and the JAX package in float32, and XLA
contracts the compiled reference's arithmetic, so float32 images agree to
1e-5 of their range of 1 and uint8 images within one level on at most 2% of
the values; masks are equal. The device paths that draw nothing are held in
``tests/test_torch_spatial_boxes.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.data.transforms.base import sample_generator
from tests.test_torch_augment import Draws, assert_levels, gate_as_uniform, jax_rngs


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sample(seed, dtype):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (32, 36, 3)).astype(np.uint8)
    img = img if dtype == np.uint8 else img.astype(np.float32) / 255.0
    mask = ((rng.random((32, 36)) < 0.15) * rng.integers(1, 4, (32, 36))).astype(np.uint8)
    return {"image": img, "mask": mask, "cropping_bbox": [5, 6, 20, 25]}


def assert_params_equal(a, b):
    """Equal draws; a float64 matrix that cv2 and the port solve or form in
    another order to 1e-12 of its largest entry."""
    assert set(a) == set(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if x.dtype == np.float64 and x.ndim == 2:
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12 * np.abs(y).max(), err_msg=key)
        else:
            np.testing.assert_array_equal(x, y, err_msg=key)


# (name, params, tolerance): "equal", "resize" or "bicubic" (the docstring)
HOST = [
    ("Rotate", {"limit": 30}, "equal"),
    ("Rotate", {"limit": 45, "border_mode": 0, "value": 7, "mask_value": 3,
                "interpolation": 0}, "equal"),
    ("Rotate", {"limit": 45, "border_mode": 2}, "equal"),
    ("Rotate", {"limit": 45, "border_mode": 3}, "equal"),
    ("SafeRotate", {"limit": 60, "border_mode": 1}, "equal"),
    ("ShiftScaleRotate", {}, "equal"),
    ("ShiftScaleRotate", {"shift_limit": 0.2, "scale_limit": (-0.3, 0.1), "rotate_limit": 90,
                          "border_mode": 0, "value": [10, 20, 30], "mask_value": 5}, "equal"),
    ("Affine", {"scale": 0.2, "translate_percent": 0.1, "rotate": 20, "shear": 10}, "equal"),
    ("Affine", {"scale": {"x": (0.8, 1.2)}, "rotate": (-5, 5), "interpolation": 0}, "equal"),
    ("Perspective", {"scale": (0.05, 0.15)}, "equal"),
    ("OpticalDistortion", {"distort_limit": 0.5, "shift_limit": 0.1}, "equal"),
    ("OpticalDistortion", {"distort_limit": 0.8, "border_mode": 0, "interpolation": 0},
     "equal"),
    ("Crop", {"x_min": 3, "y_min": 2, "x_max": 20, "y_max": 30}, "equal"),
    ("RandomResizedCrop", {"height": 16, "width": 20}, "resize"),
    ("RandomSizedCrop", {"min_max_height": (10, 22), "height": 16, "width": 20}, "resize"),
    ("LongestMaxSize", {"max_size": 20}, "resize"),
    ("SmallestMaxSize", {"max_size": 30, "interpolation": 0}, "equal"),
    ("FitResize", {"max_height": 20, "max_width": 40}, "resize"),
    ("PadIfNeeded", {"min_height": 40, "min_width": 41, "border_mode": 0, "value": 5,
                     "mask_value": 9}, "equal"),
    ("CropAndPad", {"px": [-2, 3, 4, -1]}, "resize"),
    ("CropAndPad", {"percent": (-0.2, 0.2), "pad_mode": 4}, "resize"),
    ("CropAndPad", {"px": (-3, 5), "keep_size": False, "pad_cval": 9}, "equal"),
    ("RandomRotate90", {}, "equal"),
    ("Transpose", {}, "equal"),
    ("RandomGridShuffle", {"grid": (3, 2)}, "equal"),
    ("RandomScale", {"scale_limit": 0.3}, "resize"),
    ("BBoxSafeRandomCrop", {"erosion_rate": 0.2}, "equal"),
    ("RandomSizedBBoxSafeCrop", {"height": 16, "width": 16, "erosion_rate": 0.2}, "resize"),
    ("RandomCropFromBorders", {}, "equal"),
    ("RandomCropNearBBox", {}, "equal"),
    ("CropNonEmptyMaskIfExists", {"height": 12, "width": 14}, "equal"),
    ("CropNonEmptyMaskIfExists", {"height": 12, "width": 14, "ignore_values": [1, 2]},
     "equal"),
    ("PiecewiseAffine", {"scale": (0.03, 0.05)}, "bicubic"),
    ("MaskDropout", {"max_objects": 3}, "equal"),
]


@pytest.mark.parametrize("name,params,tolerance", HOST,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(HOST)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_host_path_matches_jax(name, params, tolerance, dtype):
    for seed in range(2):
        s = sample(seed, dtype)
        ref, port = JAX_TRANSFORMS.get(name)(**params), TRANSFORMS.get(name)(**params)
        jax_rngs(ref, np.random.default_rng(seed))
        pinned = ref.get_params(s)
        with sample_generator(np.random.default_rng(seed)):
            assert_params_equal(port.get_params(s), pinned)  # the same draws in order
        want, got = ref.apply(s["image"], **pinned), port.apply(s["image"], **pinned)
        assert got.dtype == want.dtype and got.shape == want.shape
        if tolerance == "equal":
            np.testing.assert_array_equal(got, want)
        elif dtype == np.uint8:
            assert_levels(want, got, share=1e-3 if tolerance == "bicubic" else 0.2)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 if tolerance == "bicubic" else 2e-7)
        np.testing.assert_array_equal(port.apply_to_mask(s["mask"], **pinned),
                                      ref.apply_to_mask(s["mask"], **pinned))


def test_lambda_calls_the_users_functions():
    img = sample(0, np.uint8)["image"]
    fns = {"image": lambda x: x[::-1], "mask": lambda m: m + 1, "bboxes": lambda b: b * 2}
    ref, port = JAX_TRANSFORMS.get("Lambda")(**fns), TRANSFORMS.get("Lambda")(**fns)
    boxes = np.array([[1, 2, 3, 4]], np.float32)
    for t in (ref, port):
        out = t(image=img, mask=np.zeros((32, 36), np.uint8), bboxes=boxes)
        np.testing.assert_array_equal(out["image"], img[::-1])
        np.testing.assert_array_equal(out["mask"], 1)
        np.testing.assert_array_equal(out["bboxes"], boxes * 2)
    assert TRANSFORMS.get("Lambda")()(image=img)["image"] is img


# --------------------------------- device ---------------------------------

def gated(draws):
    """The port's draws with the gate (last) as the uniforms JAX compares."""
    return [d.numpy() for d in draws[:-1]] + [gate_as_uniform(draws[-1])]


# (name, params, how the port's draws reach the JAX samplers)
DEVICE = [
    ("Rotate", {"limit": 30}, gated),
    ("Rotate", {"limit": 45, "border_mode": 0, "value": 7, "mask_value": 3,
                "interpolation": 0}, gated),
    ("SafeRotate", {"limit": 60, "border_mode": 1}, gated),
    ("ShiftScaleRotate", {}, gated),
    ("ShiftScaleRotate", {"shift_limit": 0.2, "rotate_limit": 90, "border_mode": 0,
                          "value": 0.5, "mask_value": 5}, gated),
    ("Affine", {"scale": 0.2, "translate_percent": 0.1, "rotate": 20, "shear": 10}, gated),
    ("Perspective", {"scale": (0.05, 0.15)}, gated),
    ("Perspective", {"scale": 0.1, "interpolation": 0}, gated),
    ("OpticalDistortion", {"distort_limit": 0.5, "shift_limit": 0.1}, gated),
    ("OpticalDistortion", {"distort_limit": 0.8, "border_mode": 0, "interpolation": 0}, gated),
    ("RandomResizedCrop", {"height": 16, "width": 20}, lambda d: [x.numpy() for x in d]),
    ("RandomResizedCrop", {"height": 30, "width": 30, "scale": (0.9, 1.6)},
     lambda d: [x.numpy() for x in d]),  # some tries fail, some samples fall back
    ("RandomSizedCrop", {"min_max_height": (10, 30), "height": 16, "width": 20},
     lambda d: [x.numpy() for x in d]),
    ("RandomRotate90", {}, gated),
    ("Transpose", {}, gated),
    ("RandomGridShuffle", {"grid": (3, 2)}, gated),
    ("CropAndPad", {"px": [-2, 3, 4, -1]}, gated),
    ("CropAndPad", {"percent": [0.1, -0.1, 0.2, 0.05], "pad_mode": 4, "pad_cval_mask": 3},
     gated),
    ("CropAndPad", {"px": 3, "pad_mode": 0, "pad_cval": 9, "pad_cval_mask": 2,
                    "interpolation": 0}, gated),
]


def device_batches(n=6, seed=4, width=24):
    """A uint8 and a float32 batch of the same pixels, with int32 masks."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 24, width, 3)).astype(np.uint8)
    masks = rng.integers(0, 4, (n, 24, width)).astype(np.int32)
    return [(imgs, masks), (imgs.astype(np.float32) / 255.0, masks)]


def jax_apply(ref, batches):
    """The JAX ``apply_batch`` of each batch, all in one compiled function
    (eager, each of its primitives would compile on its own); patched draws
    enter it as constants."""
    def run(*arrays):
        return [ref.apply_batch({"image": arrays[i], "mask": arrays[i + 1]},
                                jax.random.PRNGKey(0)) for i in range(0, len(arrays), 2)]
    return jax.jit(run)(*(jnp.asarray(a) for pair in batches for a in pair))


def assert_device_close(got, want):
    """The tolerances of the docstring; XLA contracts the compiled JAX
    reference's float32 arithmetic, so a uint8 image may lie one level off
    on up to 2% of the values."""
    assert got["image"].shape == tuple(want["image"].shape)
    if got["image"].dtype == torch.uint8:
        assert_levels(got["image"].numpy(), np.asarray(want["image"]), share=0.02)
    else:
        np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))


@pytest.mark.parametrize("name,params,to_jax", DEVICE,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(DEVICE)])
def test_device_path_matches_jax(monkeypatch, name, params, to_jax):
    """uint8 and float32 images under the same draws."""
    batches = device_batches()
    n = len(batches[0][0])
    port = TRANSFORMS.get(name)(**{**params, "p": params.get("p", 0.6)}) \
        if "Crop" not in name or name == "CropAndPad" else TRANSFORMS.get(name)(**params)
    ref = JAX_TRANSFORMS.get(name)(**{**params, "p": port.p})
    assert port.device_capable and ref.device_capable

    def draw(seed):
        return port.draw_batch((n, 24, 24), torch.Generator().manual_seed(seed),
                               torch.device("cpu"))
    # the first seed whose gate keeps some samples and applies to others
    seed = next(s for s in range(100) if port.p >= 1 or 0 < int(draw(s)[-1].sum()) < n)
    draws = draw(seed)
    fake = Draws(monkeypatch, to_jax(draws) * len(batches))
    monkeypatch.setattr(jax.random, "permutation", fake._next)
    wants = jax_apply(ref, batches)
    fake.done()
    for (imgs, masks), want in zip(batches, wants):
        batch = {"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)}
        got = port.apply_drawn(batch, *draws)
        again = port.apply_batch(batch, torch.Generator().manual_seed(seed))
        assert all(torch.equal(got[k], again[k]) for k in got)
        assert got["image"].dtype == batch["image"].dtype and got["mask"].dtype == torch.int32
        assert_device_close(got, want)


@pytest.mark.parametrize("name,params", [("RandomRotate90", {}), ("Transpose", {"p": 0.5})])
def test_per_sample_permutation_of_a_non_square_batch_raises(name, params):
    imgs = np.zeros((2, 8, 10, 3), np.uint8)
    with pytest.raises(ValueError, match="square"):
        TRANSFORMS.get(name)(**params).apply_batch({"image": torch.from_numpy(imgs)}, None)
    with pytest.raises(ValueError, match="square"):
        JAX_TRANSFORMS.get(name)(**params).apply_batch({"image": jnp.asarray(imgs)},
                                                       jax.random.PRNGKey(0))
