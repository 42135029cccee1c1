"""The port's image reading, file datasets and box-carrying transforms
against ``torchok_tpu`` on the CPU, and the detection recipe dicts of
``chip_smoke.py``.

* PNG files written here by cv2 and Pillow (all five row filters, gray, gray
  + alpha, RGB, RGBA, palette with and without tRNS, 1, 2 and 16 bits)
  decode bit-equal to ``torchok_tpu.native.decode_file`` (libpng); a JPEG
  bit-equal too (both through libjpeg); an Adam7 file raises.
* ``_convert_image_format`` equal for every format and input layout.
* ``ImageClassificationDataset`` and ``DetectionDataset`` samples equal on
  files written here; Resize, CenterCrop, RandomCrop and HorizontalFlip move
  boxes as the JAX transforms do; the host/device split under ``bbox_mode``
  is the JAX one, and a geometric op without a box handler raises.
* The toy-set writer of ``chip_smoke.py`` paints bit-equal to
  ``cv2.rectangle`` and writes the files ``tools/gen_toy_detection.py``
  writes; ``FCOS_RECIPE`` equals ``configs/detection_toy_fcos.yaml``.
"""
import copy
import importlib.util
import json
import struct
import types
import zlib
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest
from PIL import Image

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu import native as jax_native
from torchok_tpu.constructor import DATASETS as JAX_DATASETS
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu.data.datasets.base import ImageDataset as JaxImageDataset
from torchok_tpu_torch import native
from torchok_tpu_torch.constructor import DATASETS, TRANSFORMS
from torchok_tpu_torch.constructor.config import config_from_dict, load_config, load_yaml
from torchok_tpu_torch.data.datasets.base import ImageDataset
from torchok_tpu_torch.data.transforms.base import BaseTransform, Compose

REPO = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)


def _image(h=37, w=53, seed=0):
    """Gradients (which libpng's adaptive filter codes with every filter
    type) beside noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 5 + yy * 3) % 256
    return np.stack([base, (base * 3) % 256, rng.integers(0, 256, base.shape)], -1).astype(np.uint8)


def _row_filters(path):
    data = Path(path).read_bytes()
    chunks = dict(native._chunks(data))
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    row = (w * native._CHANNELS[color] * depth + 7) // 8 + 1
    raw = zlib.decompress(b"".join(body for kind, body in native._chunks(data) if kind == b"IDAT"))
    return set(raw[::row][:h])


def test_png_files_decode_bit_equal_to_libpng(tmp_path):
    img = _image()
    rng = np.random.default_rng(1)
    files = {"rgb": img, "gray": img[..., 0], "rgba": np.concatenate([img, img[..., :1]], -1),
             "rgb16": img.astype(np.uint16) * 257 + rng.integers(0, 256, img.shape, np.uint16)}
    for name, arr in files.items():
        cv2.imwrite(str(tmp_path / f"{name}.png"), arr)
    pil = Image.fromarray(img)
    pil.save(tmp_path / "rgb_adaptive.png", optimize=True)
    pil.convert("P").save(tmp_path / "palette.png")
    pil.convert("P").save(tmp_path / "palette_trns.png", transparency=5)
    pil.convert("P", palette=Image.ADAPTIVE, colors=4).save(tmp_path / "palette2.png", bits=2)
    pil.convert("LA").save(tmp_path / "gray_alpha.png")
    pil.convert("1").save(tmp_path / "bits1.png")
    pil.save(tmp_path / "rgb_trns.png", transparency=(10, 20, 30))
    Image.fromarray(img[..., 0]).save(tmp_path / "gray_trns.png", transparency=7)
    Image.fromarray(img[..., 0].astype(np.uint16) * 250).save(tmp_path / "gray16.png")
    (tmp_path / "written.png").write_bytes(native.encode_png(img))
    paths = sorted(tmp_path.glob("*.png"))
    assert len(paths) == 14
    assert set().union(*map(_row_filters, paths)) == {0, 1, 2, 3, 4}
    for path in paths:
        got, want = native.decode_file(str(path)), jax_native.decode_file(str(path))
        assert got.dtype == np.uint8 and got.shape == want.shape == img.shape[:2] + (4,), path
        np.testing.assert_array_equal(got, want, err_msg=path.name)

    data = bytearray(native.encode_png(img))
    data[28] = 1  # IHDR's interlace method: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    (tmp_path / "adam7.png").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="Adam7"):
        native.decode_file(str(tmp_path / "adam7.png"))
    (tmp_path / "image.bmp").write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="only JPEG and PNG"):
        native.decode_file(str(tmp_path / "image.bmp"))


def test_jpeg_decodes_bit_equal_through_libjpeg(tmp_path):
    for i, quality in enumerate((95, 60)):
        cv2.imwrite(str(tmp_path / f"{i}.jpg"), _image(41, 67, i),
                    [cv2.IMWRITE_JPEG_QUALITY, quality])
        got = native.decode_file(str(tmp_path / f"{i}.jpg"))
        assert got.shape == (41, 67, 3)
        np.testing.assert_array_equal(got, jax_native.decode_file(str(tmp_path / f"{i}.jpg")))


@pytest.mark.parametrize("fmt", ["rgb", "rgba", "bgr", "gray"])
@pytest.mark.parametrize("color", [0, (10, 200, 30)])
def test_convert_image_format_matches_jax(fmt, color):
    img = _image()
    alpha = np.random.default_rng(2).integers(0, 256, img.shape[:2] + (1,), dtype=np.uint8)
    fake = types.SimpleNamespace(image_format=fmt, rgba_layout_color=color)
    for layout in (img[..., 0], np.concatenate([img[..., :1], alpha], -1), img,
                   np.concatenate([img, alpha], -1)):
        fake._composite_over = lambda rgb, a: JaxImageDataset._composite_over(fake, rgb, a)
        want = JaxImageDataset._convert_image_format(fake, layout.copy())
        fake._composite_over = lambda rgb, a: ImageDataset._composite_over(fake, rgb, a)
        got = ImageDataset._convert_image_format(fake, layout.copy())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{fmt} from {layout.shape}")


def _write_images(root, n, seed, size=(40, 56)):
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        name = f"img_{i}.png" if i % 3 else f"img_{i}.jpg"
        cv2.imwrite(str(root / name), img)
        names.append(name)
    return names


def _to_numpy_sample(sample):
    return {k: np.asarray(v) for k, v in sample.items()}


def test_image_classification_dataset_matches_jax(tmp_path):
    names = _write_images(tmp_path, 6, 3)
    pd.DataFrame({"image_path": names, "label": [0, 2, 1, 2, 0, 1],
                  "tags": ["0 2", "1", "2,0", "1 2", "0", "2"]}).to_csv(tmp_path / "ann.csv",
                                                                       index=False)
    pd.read_csv(tmp_path / "ann.csv").to_pickle(tmp_path / "ann.pkl")
    cases = [dict(annotation_path="ann.csv", num_classes=3),
             dict(annotation_path="ann.pkl", image_format="gray"),
             dict(annotation_path="ann.csv", num_classes=3, multilabel=True,
                  target_column="tags", target_dtype="float32"),
             dict(annotation_path="ann.csv", test_mode=True, image_format="bgr")]
    for params in cases:
        ref = JAX_DATASETS.get("ImageClassificationDataset")(
            str(tmp_path), [JAX_TRANSFORMS.get("CenterCrop")(32, 32)], **params)
        port = DATASETS.get("ImageClassificationDataset")(
            str(tmp_path), [TRANSFORMS.get("CenterCrop")(32, 32)], **params)
        assert len(port) == len(ref) == 6
        for i in range(6):
            got, want = _to_numpy_sample(port[i]), _to_numpy_sample(ref[i])
            assert got.keys() == want.keys(), params
            for k in want:
                assert got[k].dtype == want[k].dtype, (k, params)
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {params}")
    with pytest.raises(ValueError, match="more than num_classes"):
        DATASETS.get("ImageClassificationDataset")(str(tmp_path), None,
                                                   annotation_path="ann.csv", num_classes=2)


BOXES = np.array([[3, 4, 30, 22], [20, 10, 55, 39], [0, 0, 6, 5]], np.float32)


@pytest.mark.parametrize("name,params,extra", [
    ("Resize", {"height": 32, "width": 24}, {}),
    ("CenterCrop", {"height": 30, "width": 20}, None),
    ("RandomCrop", {"height": 25, "width": 30}, {"y0": 7, "x0": 22}),
    ("HorizontalFlip", {"p": 1.0}, {}),
])
def test_bbox_transforms_move_boxes_as_jax(name, params, extra):
    image = _image(40, 56)
    ref, port = JAX_TRANSFORMS.get(name)(**params), TRANSFORMS.get(name)(**params)
    if extra is None:  # the op's own parameters
        extra = ref.get_params({"image": image})
        assert port.get_params({"image": image}) == extra
    want = ref.apply_to_bboxes(BOXES, image.shape, **extra)
    got = port.apply_to_bboxes(BOXES, image.shape, **extra)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # cv2's uint8 bilinear resize rounds fixed-point weights: at most 1 from
    # the exact resize the port computes
    np.testing.assert_allclose(port.apply(image, **extra), ref.apply(image, **extra), rtol=0,
                               atol=1 if name == "Resize" else 0)
    assert port.geometric and not port.device_bbox_safe


class _Warp(BaseTransform):
    """A geometric op with no box handler."""
    always_apply = True
    device_capable = True
    geometric = True

    def apply(self, image, **params):
        return image


def test_bbox_mode_split_matches_jax_and_the_guard_raises():
    def names(parts):
        return [type(t).__name__ for t in parts]

    pipelines = [[("HorizontalFlip", {}), ("Normalize", {}), ("ToTensorV2", {})],
                 [("Resize", {"height": 32, "width": 32}), ("Normalize", {}),
                  ("HorizontalFlip", {}), ("ToTensorV2", {})],
                 [("CenterCrop", {"height": 32, "width": 32}), ("Normalize", {})]]
    for spec_ in pipelines:
        for bbox_mode in (False, True):
            for uniform in (False, True):
                jax_host, jax_dev = JAX_TRANSFORMS.get("Compose")(
                    [JAX_TRANSFORMS.get(n)(**p) for n, p in spec_]).split_device_suffix(
                        bbox_mode=bbox_mode, uniform_shapes=uniform)
                host, dev = Compose([TRANSFORMS.get(n)(**p) for n, p in spec_]).split_device_suffix(
                    bbox_mode=bbox_mode, uniform_shapes=uniform)
                assert names(host.transforms) == names(jax_host.transforms), (spec_, bbox_mode)
                assert names(dev) == names(jax_dev), (spec_, bbox_mode, uniform)
    # the recipe's pipeline: the flip on the host, the rest on the device
    host, dev = Compose([TRANSFORMS.get(n)(**p) for n, p in pipelines[0]]).split_device_suffix(
        bbox_mode=True)
    assert names(host.transforms) == ["HorizontalFlip"] and names(dev) == ["Normalize",
                                                                           "ToTensorV2"]
    host, dev = Compose([_Warp(), TRANSFORMS.get("Normalize")()]).split_device_suffix(
        bbox_mode=True, uniform_shapes=True)
    assert names(host.transforms) == ["_Warp"]
    with pytest.raises(NotImplementedError, match="no bbox handler"):
        _Warp()(image=_image(), bboxes=BOXES)
    assert _Warp()(image=_image())["image"].shape == (37, 53, 3)


def _write_detection_set(root, n=6):
    names = _write_images(root, n, 4, size=(48, 64))
    boxes = [[[4, 5, 20, 18], [30, 2, 33, 40]], [], [[60, 40, 10, 8]], [[1, 1, 46, 30]],
             [[10, 10, 0, 5], [8, 30, 12, 12]], [[50, 0, 13, 20]]][:n]
    labels = [[1, 0], [], [2], [0], [1, 2], [0]][:n]
    pd.DataFrame({"image_path": names, "bbox": [json.dumps(b) for b in boxes],
                  "label": [json.dumps(v) for v in labels]}).to_csv(root / "ann.csv", index=False)


@pytest.mark.parametrize("case", ["plain", "flip", "crop", "pascal", "test_mode"])
def test_detection_dataset_samples_match_jax(tmp_path, case):
    _write_detection_set(tmp_path)
    params = {"data_folder": str(tmp_path), "annotation_path": "ann.csv", "max_boxes": 3}
    augment, transform = None, [("Normalize", {}), ("ToTensorV2", {})]
    if case == "flip":
        augment = [("HorizontalFlip", {"p": 1.0})]
    elif case == "crop":  # clips boxes, the one outside the crop is dropped
        transform = [("CenterCrop", {"height": 32, "width": 40})] + transform
    elif case == "pascal":
        params.update(bbox_format="pascal_voc", min_area=30.0)
    elif case == "test_mode":
        params.update(test_mode=True)

    def build(datasets, transforms):
        make = (lambda specs: None if specs is None
                else [transforms.get(n)(**p) for n, p in specs])
        return datasets.get("DetectionDataset")(transform=make(transform),
                                                augment=make(augment), **params)

    ref, port = build(JAX_DATASETS, JAX_TRANSFORMS), build(DATASETS, TRANSFORMS)
    assert len(port) == len(ref) == 6
    assert [type(t).__name__ for t in port.device_pipeline.transforms] == \
        [type(t).__name__ for t in ref.device_pipeline.transforms]
    for i in range(6):
        got, want = _to_numpy_sample(port[i]), _to_numpy_sample(ref[i])
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{case} {i} {k}")
    if case == "crop":
        assert (port[2]["label"] == -1).all()  # its one box lies outside the crop


def test_toy_painter_equals_cv2_rectangle():
    for thickness in (-1, 3):
        for w in range(16, 36):
            for h in range(16, 36):
                for x0, y0 in ((2, 2), (93 - w, 93 - h)):
                    want = np.zeros((96, 96, 3), np.uint8)
                    cv2.rectangle(want, (x0, y0), (x0 + w, y0 + h), (200,) * 3, thickness)
                    got = np.zeros((96, 96, 3), np.uint8)
                    chip_smoke.paint_rectangle(got, x0, y0, x0 + w, y0 + h, 200, thickness)
                    np.testing.assert_array_equal(got, want, err_msg=f"{thickness} {w}x{h}")


def test_toy_writer_writes_what_gen_toy_detection_writes(tmp_path, monkeypatch):
    spec_ = importlib.util.spec_from_file_location("gen_toy_detection",
                                                   REPO / "tools" / "gen_toy_detection.py")
    gen = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(gen)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    gen.gen("valid", 24, 2)
    want_root = tmp_path / "home" / ".cache" / "torchok_tpu" / "toydet" / "valid"
    assert chip_smoke.write_toy_detection(str(tmp_path / "valid"), "valid", 24, 2) == 24
    want, got = pd.read_csv(want_root / "ann.csv"), pd.read_csv(tmp_path / "valid" / "ann.csv")
    pd.testing.assert_frame_equal(got, want)
    for name in want["image_path"]:
        np.testing.assert_array_equal(native.decode_file(str(tmp_path / "valid" / name)),
                                      jax_native.decode_file(str(want_root / name)), err_msg=name)
    assert chip_smoke.TOYDET_SPLITS == (("train", 2000, 1), ("valid", 400, 2))


def test_the_fcos_recipes_equal_the_yaml_files():
    assert load_yaml(REPO / "configs" / "detection_toy_fcos.yaml") == chip_smoke.FCOS_RECIPE
    assert chip_smoke.FCOS_OVERRIDES == ["trainer.max_epochs=8"]
    baselines = json.loads((REPO / "tools" / "north_star_baselines.json").read_text())["fcos"]
    assert (chip_smoke.FCOS_REFERENCE, chip_smoke.FCOS_TOLERANCE) == \
        (baselines["short"]["value"], baselines["short"]["tol"])
    assert baselines["short"]["overrides"] == chip_smoke.FCOS_OVERRIDES
    overrides = chip_smoke.FCOS_OVERRIDES + [
        "data.TRAIN.0.dataset.params.data_folder=/data/train",
        "data.VALID.0.dataset.params.data_folder=/data/valid", "logger.log_dir=/logs"]
    want = load_config(REPO / "configs", "detection_toy_fcos", overrides)
    assert config_from_dict(chip_smoke.fcos_config("/data", "/logs")) == want
    assert chip_smoke.FCOS_STEPS == 8 * (2000 // 32)
    # the full-width case: the COCO recipe's model, losses and optimizer
    coco = load_yaml(REPO / "configs" / "detection" / "fcos_resnet50_coco.yaml")
    r50 = chip_smoke.fcos_r50_config("/data")
    task = copy.deepcopy(coco["task"])
    task["params"]["backbone_params"]["pretrained"] = False
    assert r50["task"] == task
    assert r50["joint_loss"] == coco["joint_loss"]
    optimizer = copy.deepcopy(coco["optimization"][0])
    del optimizer["optimizer"]["paramwise_cfg"]
    assert r50["optimization"] == [optimizer]
    for key in ("precision", "gradient_clip_val", "gradient_clip_algorithm"):
        assert r50["trainer"][key] == coco["trainer"][key]
    assert r50["metrics"][0] == {**coco["metrics"][0], "phases": ["VALID"]}
