"""The port's data modules of the shapes recipe against ``torchok_tpu``:
``SyntheticShapesDataset`` bit for bit, the resize, crop and flip transforms
(host path against the reference's cv2 path, device path against its batched
JAX path) and CIFAR-10/100 read from CIFAR-format pickles written here.

Tolerances: the shapes data, the crops, the flips and every mask are exact.
cv2's INTER_LINEAR on uint8 computes in fixed point, the port in f32, so a
resized uint8 pixel may differ by one level. The device resizes: uint8
within one level (a half-way value may round either way), f32 images in
[0, 1] within 1e-5 (``F.interpolate`` and the reference's interpolation
matrices place the taps with other f32 roundings).
"""
import hashlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.data.datasets.examples import cifar as jax_cifar
from torchok_tpu.data.datasets.examples.synthetic import SyntheticShapesDataset as JaxShapes
from torchok_tpu.data.transforms import pixelwise as jax_pixelwise
from torchok_tpu.data.transforms import spatial as jax_spatial
from torchok_tpu_torch.constructor import DATASETS, TRANSFORMS
from torchok_tpu_torch.data.datasets.examples import cifar
from torchok_tpu_torch.data.transforms import spatial

# (input h, w, output h, w): up, down, mixed, integer factors, odd sizes
RESIZES = [(32, 32, 24, 40), (37, 29, 64, 64), (64, 48, 17, 23), (40, 40, 20, 20),
           (100, 80, 33, 61), (16, 16, 32, 32)]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("hardness", [0.0, 0.6])
def test_shapes_dataset_equals_torchok_tpu_bit_for_bit(train, hardness):
    ref = JaxShapes(None, num_samples=64, train=train, hardness=hardness, seed=3)
    got = DATASETS.get("SyntheticShapesDataset")(None, num_samples=64, train=train,
                                                 hardness=hardness, seed=3)
    assert got.images.dtype == ref.images.dtype == np.uint8
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.targets, ref.targets)
    np.testing.assert_array_equal(got.masks, ref.masks)
    batch = got.get_batch(np.arange(8))
    np.testing.assert_array_equal(batch["image"], ref.images[:8])
    np.testing.assert_array_equal(batch["target"], ref.targets[:8])


def _image(h, w, seed, channels=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, channels), dtype=np.uint8)


@pytest.mark.parametrize("h,w,oh,ow", RESIZES)
def test_resize_host_path_is_cv2s(h, w, oh, ow):
    img = _image(h, w, h * w)
    mask = np.random.default_rng(1).integers(0, 11, (h, w)).astype(np.uint8)
    for interpolation in (0, 1):
        ref = jax_spatial.Resize(oh, ow, interpolation=interpolation)
        got = TRANSFORMS.get("Resize")(oh, ow, interpolation=interpolation)
        want, have = ref.apply(img), got.apply(img)
        assert have.dtype == want.dtype and have.shape == want.shape
        tol = 1 if interpolation == 1 else 0
        assert np.abs(have.astype(int) - want.astype(int)).max() <= tol
        np.testing.assert_array_equal(got.apply_to_mask(mask), ref.apply_to_mask(mask))
    gray = img[..., :1]
    assert TRANSFORMS.get("Resize")(oh, ow).apply(gray).shape == (oh, ow, 1)
    float_img = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(TRANSFORMS.get("Resize")(oh, ow).apply(float_img),
                               jax_spatial.Resize(oh, ow).apply(float_img), atol=1e-5)


@pytest.mark.parametrize("h,w,oh,ow", RESIZES)
def test_resize_device_path_is_the_reference_batch_path(h, w, oh, ow):
    imgs = np.stack([_image(h, w, s) for s in range(3)])
    masks = np.random.default_rng(2).integers(0, 11, (3, h, w)).astype(np.int64)
    for interpolation in (0, 1):
        ref = jax_spatial.Resize(oh, ow, interpolation=interpolation).apply_batch(
            {"image": jnp.asarray(imgs), "mask": jnp.asarray(masks)}, None)
        got = TRANSFORMS.get("Resize")(oh, ow, interpolation=interpolation).apply_batch(
            {"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)}, None)
        assert got["image"].dtype == torch.uint8
        assert np.abs(got["image"].numpy().astype(int)
                      - np.asarray(ref["image"]).astype(int)).max() <= 1
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref["mask"]))
        unit = imgs.astype(np.float32) / 255.0
        ref = jax_spatial.Resize(oh, ow, interpolation=interpolation).apply_batch(
            {"image": jnp.asarray(unit)}, None)
        got = TRANSFORMS.get("Resize")(oh, ow, interpolation=interpolation).apply_batch(
            {"image": torch.from_numpy(unit)}, None)
        np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref["image"]), atol=1e-5)


def test_resize_refuses_the_interpolations_not_ported():
    with pytest.raises(NotImplementedError, match="interpolation=3"):
        TRANSFORMS.get("Resize")(8, 8, interpolation=3)


@pytest.mark.parametrize("h,w,ch,cw", [(32, 32, 24, 24), (37, 29, 20, 28), (20, 20, 20, 20)])
def test_center_crop_host_and_device_paths(h, w, ch, cw):
    img = _image(h, w, 5)
    mask = np.random.default_rng(3).integers(0, 11, (h, w)).astype(np.int64)
    ref = jax_spatial.CenterCrop(ch, cw)
    got = TRANSFORMS.get("CenterCrop")(ch, cw)
    want = ref(image=img, mask=mask)
    have = got(image=img, mask=mask)
    np.testing.assert_array_equal(have["image"], want["image"])
    np.testing.assert_array_equal(have["mask"], want["mask"])
    imgs = np.stack([img, _image(h, w, 6)])
    masks = np.stack([mask, mask[::-1]])
    ref_b = ref.apply_batch({"image": jnp.asarray(imgs), "mask": jnp.asarray(masks)}, None)
    got_b = got.apply_batch({"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)},
                            None)
    np.testing.assert_array_equal(got_b["image"].numpy(), np.asarray(ref_b["image"]))
    np.testing.assert_array_equal(got_b["mask"].numpy(), np.asarray(ref_b["mask"]))
    assert got.device_capable and got.device_needs_uniform


def test_random_crop_at_fixed_corners():
    img, mask = _image(30, 26, 7), np.arange(30 * 26).reshape(30, 26)
    ref, got = jax_spatial.RandomCrop(16, 12), TRANSFORMS.get("RandomCrop")(16, 12)
    for y0, x0 in ((0, 0), (14, 14), (3, 9)):
        np.testing.assert_array_equal(got.apply(img, y0=y0, x0=x0), ref.apply(img, y0=y0, x0=x0))
        np.testing.assert_array_equal(got.apply_to_mask(mask, y0=y0, x0=x0),
                                      ref.apply_to_mask(mask, y0=y0, x0=x0))
    # the device path at fixed corners: the reference's crop-resize at the rects
    imgs = np.stack([_image(30, 26, s) for s in range(3)])
    masks = np.stack([mask] * 3)
    y0, x0 = np.array([0, 14, 3]), np.array([0, 14, 9])
    rects = jnp.asarray(np.stack([y0, x0, np.full(3, 16), np.full(3, 12)], -1))
    ref_b = jax_spatial._device_crop_batch(
        {"image": jnp.asarray(imgs), "mask": jnp.asarray(masks)}, rects, (16, 12))
    got_b = spatial.crop_batch({"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)},
                               torch.from_numpy(y0), torch.from_numpy(x0), 16, 12)
    np.testing.assert_array_equal(got_b["image"].numpy(), np.asarray(ref_b["image"]))
    np.testing.assert_array_equal(got_b["mask"].numpy(), np.asarray(ref_b["mask"]))
    # drawn corners: every sample is a window of its own image
    generator = torch.Generator().manual_seed(0)
    out = got.apply_batch({"image": torch.from_numpy(imgs)}, generator)["image"].numpy()
    for i in range(3):
        windows = np.lib.stride_tricks.sliding_window_view(imgs[i], (16, 12, 3))[..., 0, :, :, :]
        assert (windows == out[i]).all(axis=(-3, -2, -1)).any()
    assert got.device_capable and not TRANSFORMS.get("RandomCrop")(16, 12, p=0.5).device_capable


def test_horizontal_flip_host_and_device_paths():
    img, mask = _image(9, 7, 8), np.arange(63).reshape(9, 7)
    ref, got = jax_pixelwise.HorizontalFlip(p=1.0), TRANSFORMS.get("HorizontalFlip")(p=1.0)
    np.testing.assert_array_equal(got.apply(img), ref.apply(img))
    np.testing.assert_array_equal(got.apply_to_mask(mask), ref.apply_to_mask(mask))
    imgs = np.stack([img, _image(9, 7, 9)])
    masks = np.stack([mask, mask])
    for p in (1.0, 0.0):
        ref_b = jax_pixelwise.HorizontalFlip(p=p).apply_batch(
            {"image": jnp.asarray(imgs), "mask": jnp.asarray(masks)}, jax.random.PRNGKey(0))
        got_b = TRANSFORMS.get("HorizontalFlip")(p=p).apply_batch(
            {"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)},
            torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(got_b["image"].numpy(), np.asarray(ref_b["image"]))
        np.testing.assert_array_equal(got_b["mask"].numpy(), np.asarray(ref_b["mask"]))


def _write_cifar(root, folder, files, label_key, names_file, names_key, n_classes):
    """Tiny CIFAR-format batches: (file name, md5) lists and the meta's md5."""
    base = root / folder
    base.mkdir(parents=True)
    rng = np.random.default_rng(len(files))
    listed = []
    for i, name in enumerate(files):
        entry = {"data": rng.integers(0, 256, (5 + i, 3 * 32 * 32), dtype=np.uint8),
                 label_key: rng.integers(0, n_classes, 5 + i).tolist()}
        (base / name).write_bytes(pickle.dumps(entry))
        listed.append([name, hashlib.md5((base / name).read_bytes()).hexdigest()])
    (base / names_file).write_bytes(pickle.dumps({names_key: [f"c{i}" for i in range(n_classes)]}))
    return listed, hashlib.md5((base / names_file).read_bytes()).hexdigest()


@pytest.mark.parametrize("name", ["CIFAR10", "CIFAR100"])
def test_cifar_reads_the_batches_on_disk_as_the_reference_does(name, tmp_path, monkeypatch):
    port_cls, ref_cls = getattr(cifar, name), getattr(jax_cifar, name)
    files = [f for f, _ in port_cls.train_list + port_cls.test_list]
    label_key = "labels" if name == "CIFAR10" else "fine_labels"
    listed, meta_md5 = _write_cifar(tmp_path, port_cls.base_folder, files, label_key,
                                    port_cls.meta["filename"], port_cls.meta["key"],
                                    10 if name == "CIFAR10" else 100)
    n_train = len(port_cls.train_list)
    for cls in (port_cls, ref_cls):  # the same patch on both classes
        monkeypatch.setattr(cls, "train_list", listed[:n_train])
        monkeypatch.setattr(cls, "test_list", listed[n_train:])
        monkeypatch.setattr(cls, "meta", {**cls.meta, "md5": meta_md5})
        monkeypatch.setattr(cls, "url", "http://invalid.invalid/never-fetched")
    for train in (True, False):
        # download=True with the batches present and intact fetches nothing
        kwargs = dict(train=train, download=True, data_folder=str(tmp_path), transform=None)
        ref = ref_cls(**kwargs)
        got = port_cls(**kwargs, reader_library="pillow", image_format="bgr")
        np.testing.assert_array_equal(got.images, ref.images)
        np.testing.assert_array_equal(got.targets, ref.targets)
        assert got.images.shape[1:] == (32, 32, 3) and got.classes == ref.classes
        np.testing.assert_array_equal(got.get_batch(np.arange(3))["image"], ref.images[:3])
        assert got[1]["target"] == ref.targets[1]
    (tmp_path / port_cls.base_folder / files[0]).write_bytes(b"corrupt")
    with pytest.raises(RuntimeError, match="not found or corrupted"):
        port_cls(train=True, download=False, data_folder=str(tmp_path), transform=None)
