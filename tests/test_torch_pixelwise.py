"""Device paths of the port's photometric transforms (Flip to ToSepia of
``torchok_tpu_torch.data.transforms.pixelwise``) against ``torchok_tpu``'s
``apply_batch`` on the CPU, and the filter and colour helpers they run on.

The port's ``draw_batch`` draws from a ``torch.Generator``;
``jax.random``'s samplers are patched to hand the JAX ``apply_batch`` (one
compiled function for the uint8 and the float32 batch) the same draws in
the order it asks for them. Float32 images of 0 to 1 agree to 1e-5; uint8
images lie within one level on at most 1% of the values (XLA contracts the
compiled reference's float32 arithmetic and sums its filter taps in another
order; the port's powers and cube roots are PyTorch's). Masks are equal.
``CLAHE`` goes through the L*a*b* float formulas both ways, whose powers
and cube roots round differently in XLA and PyTorch: an L value one level
off lands in the next bin of its tile's histogram, whose table steps by
255 / (tile area) a count, so within 2 levels on at most 1% of the values.
The always-applied casts: XLA turns ToFloat's division by a constant into
a product with its reciprocal where the port divides (as the host does),
so within 1e-7; FromFloat and Posterize's pass-through are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu.data.transforms import pixelwise as jax_pixelwise
from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.ops import color, filters
from tests.test_torch_augment import Draws, assert_levels, numpy_draws


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def device_batches(n=6, h=24, w=28, seed=4):
    """A uint8 and a float32 batch of the same pixels (smooth gradients with
    noise), with int32 masks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 200.0 / w, yy * 200.0 / h, (xx + yy) * 100.0 / (h + w)], -1)
    imgs = np.clip(base[None] + rng.normal(0, 30, (n, h, w, 3)), 0, 255).astype(np.uint8)
    masks = rng.integers(0, 4, (n, h, w)).astype(np.int32)
    return [(imgs, masks), ((imgs / 255.0).astype(np.float32), masks)]


def jax_apply(ref, batches):
    """The JAX ``apply_batch`` of each batch in one compiled function;
    patched draws enter it as constants."""
    def run(*arrays):
        return [ref.apply_batch({"image": arrays[i], "mask": arrays[i + 1]},
                                jax.random.PRNGKey(0)) for i in range(0, len(arrays), 2)]
    return jax.jit(run)(*(jnp.asarray(a) for pair in batches for a in pair))


U8 = "uint8"
# (name, params, dtypes); every case draws with p 0.6 unless it sets p
DEVICE = [
    ("Flip", {}, None),
    ("RandomBrightnessContrast", {}, None),
    ("RandomBrightness", {"limit": 0.4}, None),
    ("RandomContrast", {"limit": (0.1, 0.5)}, None),
    ("CoarseDropout", {"max_holes": 4, "max_height": 9, "min_height": 3, "max_width": 12,
                       "fill_value": 7, "mask_fill_value": 2}, None),
    ("Cutout", {"num_holes": 3, "max_h_size": 12, "max_w_size": 5}, None),
    ("InvertImg", {}, None),
    ("ToGray", {}, None),
    ("RandomGamma", {"gamma_limit": (40, 250)}, None),
    ("Solarize", {"threshold": 100}, None),
    ("Posterize", {"num_bits": 3}, U8),
    ("ChannelShuffle", {}, None),
    ("RGBShift", {"r_shift_limit": 40, "b_shift_limit": (0, 30)}, None),
    ("Blur", {}, None),
    ("GaussianBlur", {}, None),
    ("GaussianBlur", {"blur_limit": (3, 9), "sigma_limit": (0.3, 2.5)}, None),
    ("MedianBlur", {}, None),
    ("MotionBlur", {}, None),
    ("CLAHE", {"clip_limit": (1, 8), "tile_grid_size": (4, 3)}, U8),
    ("Equalize", {}, U8),
    ("HueSaturationValue", {"hue_shift_limit": 90, "sat_shift_limit": (-80, 10),
                            "val_shift_limit": 40}, U8),
    ("Downscale", {"scale_min": 0.2, "scale_max": 0.7}, None),
    ("Sharpen", {"alpha": (0.6, 1.0), "lightness": (0.0, 2.0)}, None),
    ("ToSepia", {}, None),
]


@pytest.mark.parametrize("name,params,only", DEVICE,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(DEVICE)])
def test_device_path_matches_jax(monkeypatch, name, params, only):
    batches = device_batches()[:1] if only == U8 else device_batches()
    n = len(batches[0][0])
    params = {"p": 0.6, **params}
    port, ref = TRANSFORMS.get(name)(**params), JAX_TRANSFORMS.get(name)(**params)
    assert port.device_capable and ref.device_capable

    def draw(seed):
        return port.draw_batch(batches[0][0].shape, torch.Generator().manual_seed(seed),
                               torch.device("cpu"))
    # the first seed whose gate applies to some samples and not to others
    seed = next(s for s in range(100) if 0 < int(draw(s)[-1].sum()) < n)
    draws = draw(seed)
    to_jax = numpy_draws(draws)
    if name in ("CoarseDropout", "Cutout"):  # JAX asks for (N, holes, 1)
        to_jax = [d[..., None] for d in to_jax[:4]] + to_jax[4:]
    fake = Draws(monkeypatch, to_jax * len(batches))
    wants = jax_apply(ref, batches)
    fake.done()
    for (imgs, masks), want in zip(batches, wants):
        batch = {"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)}
        got = port.apply_drawn(batch, *draws)
        again = port.apply_batch(batch, torch.Generator().manual_seed(seed))
        assert all(torch.equal(got[k], again[k]) for k in got)
        a, b = got["image"], np.asarray(want["image"])
        assert str(a.dtype).split(".")[-1] == b.dtype.name and a.shape == b.shape
        if name == "CLAHE":
            d = np.abs(a.numpy().astype(np.int64) - b.astype(np.int64))
            assert d.max() <= 2 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
        elif a.dtype == torch.uint8:
            assert_levels(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))


@pytest.mark.parametrize("name,params,dtype", [
    ("ToFloat", {}, np.uint8), ("ToFloat", {"max_value": 100.0}, np.float32),
    ("FromFloat", {}, np.float32), ("FromFloat", {"dtype": "uint8", "max_value": 255},
                                    np.float32),
    ("Posterize", {"p": 1.0}, np.float32)])
def test_device_path_without_draws_matches_jax(name, params, dtype):
    """Always-applied casts, and a float image that Posterize leaves."""
    imgs, masks = device_batches()[0 if dtype == np.uint8 else 1]
    port, ref = TRANSFORMS.get(name)(**params), JAX_TRANSFORMS.get(name)(**params)
    want = jax_apply(ref, [(imgs, masks)])[0]["image"]
    got = port.apply_batch({"image": torch.from_numpy(imgs)}, torch.Generator())["image"]
    assert str(got.dtype).split(".")[-1] == np.asarray(want).dtype.name
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7 if name == "ToFloat" else 0)


@pytest.mark.parametrize("name", ["CLAHE", "Equalize", "HueSaturationValue"])
def test_uint8_only_device_paths_refuse_float_batches(name):
    imgs = device_batches()[1][0]
    with pytest.raises(TypeError, match="uint8"):
        TRANSFORMS.get(name)().apply_batch({"image": torch.from_numpy(imgs)}, torch.Generator())
    with pytest.raises(TypeError, match="uint8"):
        JAX_TRANSFORMS.get(name)().apply_batch({"image": jnp.asarray(imgs)},
                                               jax.random.PRNGKey(0))


def test_downscale_is_device_capable_only_at_nearest():
    for interpolation in (0, 1, 3):
        port = TRANSFORMS.get("Downscale")(interpolation=interpolation)
        assert port.device_capable == JAX_TRANSFORMS.get("Downscale")(
            interpolation=interpolation).device_capable == (interpolation == 0)


def test_from_float_to_uint16_keeps_the_high_values():
    x = torch.tensor([[0.0, 0.5, 0.61, 1.0]])
    out = TRANSFORMS.get("FromFloat")().apply_batch({"image": x}, None)["image"]
    assert out.dtype == torch.uint16
    np.testing.assert_array_equal(out.numpy(), (x.numpy() * 65535).astype(np.uint16))


# ------------------------------ the helpers ------------------------------

def test_filters_match_the_jax_helpers():
    """The per-sample filters against the JAX package's (one compiled
    function) on one batch: the separable and the 3x3 ones within 1e-5 of
    their range (sums in another order), the median and the pads equal."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, 11, 13, 3)).astype(np.float32)
    radii = np.array([0, 2, 3])
    sigmas = np.array([0.0, 1.3, 0.0], np.float32)
    sharp = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], np.float32)

    def reference(x, xi, r, s):
        box, gauss = jax_pixelwise._box_kernels(r, 3), jax_pixelwise._gauss_kernels(r, s, 3)
        return ([jax_pixelwise._reflect101_pad(x, axis, 15, 2) for axis in (1, 2)],
                [box, gauss] + [jax_pixelwise._sep_filter_per_sample(x, kk, kk[:, ::-1])
                                for kk in (box, gauss)],
                jax_pixelwise._fixed_filter2d(x, sharp),
                [jax_pixelwise._median_filter_per_sample(v, r, 3) for v in (x, xi)])

    pads, sep, fixed, medians = jax.jit(reference)(img, img.astype(np.uint8), radii, sigmas)
    x = torch.from_numpy(img)
    for axis, want in zip((1, 2), pads):
        np.testing.assert_array_equal(filters.reflect101_pad(x, axis, 15, 2).numpy(), want)
    box = filters.box_kernels(torch.from_numpy(radii), 3)
    gauss = filters.gauss_kernels(torch.from_numpy(radii), torch.from_numpy(sigmas), 3)
    for mine, want in zip((box, gauss), sep[:2]):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    for mine, want in zip((box, gauss), sep[2:]):
        np.testing.assert_allclose(filters.sep_filter_per_sample(x, mine, mine.flip(1)).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-5 * 255)
    np.testing.assert_allclose(filters.fixed_filter2d(x, sharp).numpy(), np.asarray(fixed),
                               rtol=0, atol=1e-5 * 255 * 16)
    for dtype, want in zip((np.float32, np.uint8), medians):
        np.testing.assert_array_equal(
            filters.median_filter_per_sample(torch.from_numpy(img.astype(dtype)),
                                             torch.from_numpy(radii), 3).numpy(),
            np.asarray(want))


def test_colour_helpers_match_the_jax_helpers():
    """RGB to HSV equal to the JAX helper (compiled together), HSV to RGB
    within 1.2e-6 of its range of 255 (XLA contracts the compiled
    products); RGB to L*a*b* within 2e-4 of its range of 100 (the port's
    sRGB table and Newton cube root against XLA's powers), and back to
    uint8 levels within one level on at most 1% of the values."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, 9, 10, 3)).astype(np.uint8)

    def reference(x):
        hsv = jax_pixelwise._rgb_to_hsv_u8(x)
        lab = jax_pixelwise._rgb_to_lab_f(x / 255.0)
        return (hsv, jax_pixelwise._hsv_u8_to_rgb(*hsv), lab,
                jnp.round(jax_pixelwise._lab_f_to_rgb(*lab) * 255.0))

    hsv, rgb, lab, back = jax.jit(reference)(img.astype(np.float32))
    h, s, v = color.rgb_to_hsv_u8(torch.from_numpy(img).float())
    for a, b in zip((h, s, v), hsv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(color.hsv_u8_to_rgb(h, s, v).numpy(), np.asarray(rgb), rtol=0,
                               atol=3e-4)
    mine = color.linear_to_lab(color.srgb_u8_to_linear(torch.from_numpy(img)))
    for a, b in zip(mine, lab):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-4)
    assert_levels(color.linear_to_srgb_u8(color.lab_to_linear(*mine)).numpy(), np.asarray(back))


def test_the_cube_root_is_within_two_ulps():
    t = torch.from_numpy(np.random.default_rng(2).uniform(0.008, 1.2, 100000).astype(np.float32))
    want = np.cbrt(t.numpy().astype(np.float64))
    np.testing.assert_allclose(color.cbrt(t).numpy(), want, rtol=2.4e-7, atol=0)
