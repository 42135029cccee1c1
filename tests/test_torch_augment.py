"""The recipes' augmentations in the port against ``torchok_tpu`` on the CPU:
VerticalFlip, GaussNoise, ColorJitter, FancyPCA, OneOf and SomeOf.

Host paths: the JAX transform draws from one numpy generator, the port's from
the same generator as a sample's (``sample_generator``); the draws come in the
same order, so the outputs must be equal (ColorJitter: the JAX package runs
its float32 arithmetic through XLA, so its uint8 output may lie one level
from the port's on at most 1% of the values; none did when this was written).

Device paths: the port's ``draw_batch`` makes the per-sample draws from a
``torch.Generator``; ``jax.random``'s samplers are patched to hand the JAX
``apply_batch`` the same draws, in the order it asks for them. Float outputs
agree to 1e-5 of the image's range (XLA and PyTorch reduce in other orders);
uint8 outputs lie within one level on at most 1% of the values.
"""
from typing import List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX transforms
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.data.transforms.base import (BaseTransform, forced_batch,
                                                       sample_generator)

JITTER = dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def image(h=48, w=40, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return img if dtype == np.uint8 else (img / 255.0).astype(dtype)


def jax_rngs(t, rng):
    """Point every transform of the JAX tree ``t`` at the generator ``rng``."""
    t._local.rng = rng
    for child in getattr(t, "transforms", []):
        jax_rngs(child, rng)


def host_both(name, params, img, mask, seed, force=True):
    ref = JAX_TRANSFORMS.get(name)(**params)
    port = TRANSFORMS.get(name)(**params)
    jax_rngs(ref, np.random.default_rng(seed))
    a = ref(force_apply=force, image=img, mask=mask)
    with sample_generator(np.random.default_rng(seed)):
        b = port(force_apply=force, image=img, mask=mask)
    return a, b


def assert_levels(a, b, share=0.01):
    """uint8 arrays within one level, and on at most ``share`` of the values."""
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("name,params", [
    ("VerticalFlip", {}), ("GaussNoise", {}), ("GaussNoise", {"per_channel": False}),
    ("GaussNoise", {"var_limit": 400.0, "mean": 3.0}), ("ColorJitter", JITTER),
    ("ColorJitter", {}), ("FancyPCA", {}), ("FancyPCA", {"alpha": 2.0})])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_host_path_matches_jax(name, params, dtype):
    for seed in range(4):
        img = image(seed=seed, dtype=dtype)
        mask = np.random.default_rng(seed).integers(0, 3, img.shape[:2])
        a, b = host_both(name, params, img, mask, seed, force=False)
        assert np.asarray(a["image"]).dtype == b["image"].dtype
        if name == "ColorJitter" and dtype == np.uint8:
            assert_levels(a["image"], b["image"])
        elif name == "ColorJitter":
            np.testing.assert_allclose(a["image"], b["image"], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])


def test_vertical_flip_moves_boxes_as_the_jax_package():
    boxes = np.array([[3, 4, 30, 22], [0, 0, 6, 5]], np.float32)
    ref, port = JAX_TRANSFORMS.get("VerticalFlip")(), TRANSFORMS.get("VerticalFlip")()
    np.testing.assert_array_equal(ref.apply_to_bboxes(boxes, (48, 40, 3)),
                                  port.apply_to_bboxes(boxes, (48, 40, 3)))
    assert not port.device_bbox_safe and port.geometric


class Draws:
    """``jax.random``'s samplers patched to return given arrays in order."""

    def __init__(self, monkeypatch, draws: List[np.ndarray]):
        self.queue = [np.asarray(d) for d in draws]
        for name in ("uniform", "normal", "bernoulli", "choice", "randint"):
            monkeypatch.setattr(jax.random, name, self._next)

    def _next(self, key, *args, shape=None, **kwargs):
        value = self.queue.pop(0)
        if shape is None:  # bernoulli(key, p, shape) and choice(key, a, shape)
            shape = args[-1] if args and isinstance(args[-1], tuple) else value.shape
        size = int(np.prod(shape))
        assert value.size == size, (value.shape, shape)
        return jnp.asarray(value.reshape(shape))

    def done(self):
        assert not self.queue, f"{len(self.queue)} draws left unused"


def gate_as_uniform(gate):
    """A boolean gate as the uniforms a JAX ``uniform(...) < p`` turns into it."""
    return np.where(gate.numpy(), -1.0, 2.0).astype(np.float32)


def numpy_draws(draws):
    """The port's draws as the JAX ``apply_batch`` asks for them: the same
    order and values (a gate as ``bernoulli``'s booleans)."""
    return [x.numpy() for x in draws]


def batch_of(n=6, h=24, w=20, dtype=np.uint8, seed=0):
    imgs = np.stack([image(h, w, seed + i, dtype) for i in range(n)])
    masks = np.random.default_rng(seed).integers(0, 4, (n, h, w))
    return imgs, masks


def run_both_device(monkeypatch, name, params, imgs, masks, jax_draws=None, seed=3):
    port = TRANSFORMS.get(name)(**params)
    ref = JAX_TRANSFORMS.get(name)(**params)
    batch = {"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)}
    shape = imgs.shape if name in ("GaussNoise", "FancyPCA") else imgs.shape[0]
    draws = port.draw_batch(shape, torch.Generator().manual_seed(seed), torch.device("cpu"))
    got = port.apply_drawn(batch, *draws)
    again = port.apply_batch(batch, torch.Generator().manual_seed(seed))
    for k in got:
        torch.testing.assert_close(got[k], again[k], rtol=0, atol=0)
    fake = Draws(monkeypatch, (jax_draws or numpy_draws)(draws))
    want = ref.apply_batch({"image": jnp.asarray(imgs), "mask": jnp.asarray(masks)},
                           jax.random.PRNGKey(0))
    fake.done()
    return got, {k: np.asarray(v) for k, v in want.items()}, draws


@pytest.mark.parametrize("name,params", [
    ("VerticalFlip", {}), ("HorizontalFlip", {}), ("GaussNoise", {}),
    ("GaussNoise", {"var_limit": (5.0, 900.0), "mean": -4.0}), ("ColorJitter", JITTER),
    ("ColorJitter", {"hue": 0.5, "p": 1.0})])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_device_path_matches_jax_apply_batch(monkeypatch, name, params, dtype):
    imgs, masks = batch_of(dtype=dtype)
    got, want, _ = run_both_device(monkeypatch, name, params, imgs, masks)
    assert got["image"].dtype == torch.from_numpy(want["image"]).dtype
    if dtype == np.uint8 and name in ("GaussNoise", "ColorJitter"):
        assert_levels(got["image"].numpy(), want["image"])
    else:
        np.testing.assert_allclose(got["image"].numpy(), want["image"], rtol=0,
                                   atol=1e-5 * (255 if dtype == np.uint8 else 1))
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("alpha", [0.1, 3.0])
def test_fancy_pca_device_path_matches_jax(monkeypatch, dtype, alpha):
    """The eigenvectors' signs are arbitrary: the basis is compared by each
    eigenvalue and the projector v v^T, and the JAX ``apply_batch`` gets the
    normal draws with the port's eigenvectors' signs."""
    imgs, masks = batch_of(dtype=dtype)
    port = TRANSFORMS.get("FancyPCA")(alpha=alpha)
    x = torch.from_numpy(imgs).float() / (255.0 if dtype == np.uint8 else 1.0)
    evals, evecs = port.basis(x)
    flat = jnp.asarray(x.numpy()).reshape(x.shape[0], -1, 3)
    xc = flat - flat.mean(axis=1, keepdims=True)
    ref_evals, ref_evecs = jnp.linalg.eigh(jnp.einsum("bnc,bnd->bcd", xc, xc)
                                           / (flat.shape[1] - 1))
    ref_evals, ref_evecs = np.asarray(ref_evals), np.asarray(ref_evecs)
    np.testing.assert_allclose(evals.numpy(), ref_evals, rtol=1e-4, atol=1e-7)
    proj = np.einsum("bik,bjk->bkij", evecs.numpy(), evecs.numpy())
    ref_proj = np.einsum("bik,bjk->bkij", ref_evecs, ref_evecs)
    np.testing.assert_allclose(proj, ref_proj, atol=1e-3)
    signs = np.sign(np.einsum("bik,bik->bk", evecs.numpy(), ref_evecs))

    def jax_draws(draws):
        z, apply = draws
        return [z.numpy() * signs, apply.numpy()]

    got, want, _ = run_both_device(monkeypatch, "FancyPCA", {"alpha": alpha}, imgs, masks,
                                   jax_draws)
    if dtype == np.uint8:
        assert_levels(got["image"].numpy(), want["image"])
    else:
        np.testing.assert_allclose(got["image"].numpy(), want["image"], rtol=0, atol=1e-5)


def oneof_params(kind, p=1.0):
    children = [{"name": "GaussNoise", "p": 0.5}, {"name": "ColorJitter", "p": 1.0},
                {"name": "VerticalFlip", "p": 0.25}]
    return children, {"p": p} if kind == "OneOf" else {"p": p, "n": 1}


def build(registry, kind, children, params):
    kids = [registry.get(c["name"])(p=c["p"]) for c in children]
    return registry.get(kind)(transforms=kids, **params)


@pytest.mark.parametrize("kind", ["OneOf", "SomeOf"])
def test_selecting_container_host_path_matches_jax(kind):
    children, params = oneof_params(kind, p=0.8)
    if kind == "SomeOf":
        params["n"] = 2
    for seed in range(12):
        img = image(seed=seed)
        mask = np.random.default_rng(seed).integers(0, 3, img.shape[:2])
        ref, port = build(JAX_TRANSFORMS, kind, children, params), \
            build(TRANSFORMS, kind, children, params)
        jax_rngs(ref, np.random.default_rng(seed))
        a = ref(image=img, mask=mask)
        with sample_generator(np.random.default_rng(seed)):
            b = port(image=img, mask=mask)
        assert_levels(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])


class Mark(BaseTransform):
    """Paints the image with its own number."""

    def __init__(self, k, p):
        super().__init__(p=p)
        self.k = k

    def apply(self, image, **params):
        return np.full_like(image, self.k)


@pytest.mark.parametrize("kind", ["OneOf", "SomeOf"])
def test_selecting_container_host_frequencies(kind):
    """Over 4000 samples OneOf(p 0.8) applies child i (forced) with
    probability 0.8 p_i / sum(p); SomeOf(p 0.8, n 1) picks it with 0.8 / 3
    and applies it with its own p_i: each count within 4.5 standard
    deviations."""
    ps = (0.5, 1.0, 0.25)
    params = {"p": 0.8} if kind == "OneOf" else {"p": 0.8, "n": 1}
    port = TRANSFORMS.get(kind)(transforms=[Mark(i + 1, q) for i, q in enumerate(ps)], **params)
    n = 4000
    img = np.zeros((2, 2, 3), np.uint8)
    counts = np.zeros(4, np.int64)
    with sample_generator(np.random.default_rng(0)):
        for _ in range(n):
            counts[port(image=img)["image"][0, 0, 0]] += 1
    want = 0.8 * np.array(ps) / sum(ps) if kind == "OneOf" else 0.8 / 3 * np.array(ps)
    for i, q in enumerate(want):
        assert abs(counts[i + 1] - n * q) <= 4.5 * np.sqrt(n * q * (1 - q)), (counts, want)


@pytest.mark.parametrize("kind", ["OneOf", "SomeOf"])
def test_selecting_container_device_frequencies(kind):
    children, params = oneof_params(kind, p=0.8)
    port = build(TRANSFORMS, kind, children, params)
    n = 4000
    gate, choice = port.draw_batch(n, torch.Generator().manual_seed(0), torch.device("cpu"))
    probs = np.array([c["p"] for c in children], np.float64)
    probs = probs / probs.sum() if kind == "OneOf" else np.full(3, 1 / 3)
    for i, q in enumerate(0.8 * probs):
        count = int((gate & (choice == i)).sum())
        assert abs(count - n * q) <= 4.5 * np.sqrt(n * q * (1 - q)), (i, count, n * q)


@pytest.mark.parametrize("kind", ["OneOf", "SomeOf"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_selecting_container_device_path_matches_jax(monkeypatch, kind, dtype):
    children, params = oneof_params(kind, p=0.7)
    port = build(TRANSFORMS, kind, children, params)
    ref = build(JAX_TRANSFORMS, kind, children, params)
    imgs, masks = batch_of(n=12, dtype=dtype)
    batch = {"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)}
    got = port.apply_batch(batch, torch.Generator().manual_seed(5))
    # the same draws again from the same seed, in the order apply_batch made them
    gen = torch.Generator().manual_seed(5)
    cpu = torch.device("cpu")
    gate, choice = port.draw_batch(len(imgs), gen, cpu)
    feed = [gate_as_uniform(gate), choice.numpy()]
    for child in port.transforms:
        if kind == "OneOf":
            child._local.forced = 1
        shape = imgs.shape if type(child).__name__ == "GaussNoise" else len(imgs)
        feed += numpy_draws(child.draw_batch(shape, gen, cpu))
        child._local.forced = 0
    fake = Draws(monkeypatch, feed)
    want = ref.apply_batch({"image": jnp.asarray(imgs), "mask": jnp.asarray(masks)},
                           jax.random.PRNGKey(0))
    fake.done()
    if dtype == np.uint8:
        assert_levels(got["image"].numpy(), np.asarray(want["image"]))
    else:
        np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), atol=1e-5)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert gate.any() and (~gate).any()


def test_forcing_reads_p_as_one_in_this_thread_only():
    flip = TRANSFORMS.get("VerticalFlip")(p=0.0)
    batch = {"image": torch.arange(24.0).view(1, 4, 2, 3)}
    out = forced_batch(flip, batch, torch.Generator().manual_seed(0))
    torch.testing.assert_close(out["image"], batch["image"].flip(1))
    assert flip.p == 0.0
    assert torch.equal(flip.apply_batch(batch, None)["image"], batch["image"])


@pytest.mark.parametrize("kind,multiplier", [("OneOf", 999_983), ("SomeOf", 999_979),
                                             ("Compose", 1_000_003)])
def test_seed_reaches_children_as_in_the_jax_package(kind, multiplier):
    kids = [TRANSFORMS.get("GaussNoise")(), TRANSFORMS.get("VerticalFlip")()]
    parent = TRANSFORMS.get(kind)(transforms=kids)
    parent.seed(11)
    for i, child in enumerate(kids):
        assert child._seed == 11 * multiplier + i
        assert child.rng.random() == np.random.default_rng(11 * multiplier + i).random()


def test_selecting_containers_move_to_the_device_as_in_the_jax_package():
    for registry in (TRANSFORMS, JAX_TRANSFORMS):
        jitter = registry.get("ColorJitter")()
        normalize = registry.get("Normalize")()
        resize = registry.get("Resize")(height=8, width=8)
        assert registry.get("OneOf")(transforms=[jitter]).device_capable
        assert not registry.get("OneOf")(transforms=[jitter, normalize]).device_capable
        assert not registry.get("OneOf")(transforms=[jitter, resize]).device_capable
        assert registry.get("Compose")(transforms=[jitter, resize]).device_capable
        assert not registry.get("SomeOf")(transforms=[jitter], n=2).device_capable
        assert registry.get("SomeOf")(transforms=[jitter], n=1).device_capable


def test_select_batch_refuses_a_child_that_changes_dtype():
    from torchok_tpu_torch.data.transforms.base import select_batch
    a = {"image": torch.zeros(2, 4, 4, 3, dtype=torch.uint8)}
    with pytest.raises(TypeError, match="keep the batch"):
        select_batch(a, {"image": a["image"].float()}, torch.tensor([True, False]))
