"""Boxes and the host/device split of the port's spatial transforms against
``torchok_tpu`` on the CPU, with the device paths that draw nothing.

* Boxes: a sample with pixel xyxy boxes goes through both packages' host
  paths with one generator; the boxes come out equal (float32, the same
  arithmetic), rows kept; the transforms without a box handler raise in
  both.
* Flags and split: every spatial transform's flags (``geometric``,
  ``device_capable``, ``device_needs_uniform``, ``device_bbox_safe``, its
  box handler) equal the JAX class's, with default and other parameters, so
  ``split_device_suffix`` cuts a pipeline at the same place in bbox mode and
  with uniform shapes or not; the SwinV2 spatial recipe runs its whole
  TRAIN pipeline on the device.
* Registry: every name the JAX package's ``spatial.py`` registers is in the
  port's ``TRANSFORMS``.
* Device paths without draws (FitResize, PadIfNeeded, the max-size
  resizes, Crop, and the warps at degenerate limits and ``p`` 1) against
  the JAX ``apply_batch`` on a batch that is not square, with the
  tolerances of ``tests/test_torch_spatial.py``.
"""
import copy
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu.constructor.constructor import Constructor as JaxConstructor
from torchok_tpu.data.transforms import spatial as jax_spatial
from torchok_tpu.data.transforms.base import BaseTransform as JaxBaseTransform
from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.constructor.config import load_yaml
from torchok_tpu_torch.constructor.constructor import Constructor
from torchok_tpu_torch.data.transforms.base import sample_generator
from tests.test_torch_augment import jax_rngs
from tests.test_torch_detection_data import chip_smoke
from tests.test_torch_spatial import assert_device_close, device_batches, jax_apply

REPO = Path(__file__).resolve().parent.parent
BOXES = np.array([[3, 4, 20, 25], [10, 2, 30, 12], [0, 0, 5, 5], [30, 20, 36, 32]],
                 np.float32)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WITH_BOXES = [
    ("Rotate", {"limit": 40}), ("SafeRotate", {"limit": 70}), ("ShiftScaleRotate", {}),
    ("Affine", {"scale": 0.2, "translate_percent": 0.1, "rotate": 20, "shear": 10}),
    ("Perspective", {"scale": (0.05, 0.15)}), ("RandomResizedCrop", {"height": 16, "width": 20}),
    ("RandomSizedCrop", {"min_max_height": (10, 22), "height": 16, "width": 20}),
    ("LongestMaxSize", {"max_size": 20}), ("SmallestMaxSize", {"max_size": 30}),
    ("FitResize", {"max_height": 20, "max_width": 40}),
    ("PadIfNeeded", {"min_height": 40, "min_width": 41}),
    ("Crop", {"x_min": 3, "y_min": 2, "x_max": 20, "y_max": 30}),
    ("CropAndPad", {"px": [-2, 3, 4, -1]}), ("CropAndPad", {"percent": (-0.2, 0.2)}),
    ("CropAndPad", {"px": (-3, 5), "keep_size": False}), ("RandomRotate90", {}),
    ("Transpose", {}), ("RandomScale", {"scale_limit": 0.3}),
    ("BBoxSafeRandomCrop", {"erosion_rate": 0.2}),
    ("RandomSizedBBoxSafeCrop", {"height": 16, "width": 16}), ("RandomCropFromBorders", {}),
    ("RandomCropNearBBox", {}), ("CropNonEmptyMaskIfExists", {"height": 12, "width": 14}),
]


@pytest.mark.parametrize("name,params", WITH_BOXES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(WITH_BOXES)])
def test_boxes_move_as_in_the_jax_package(name, params):
    ref, port = JAX_TRANSFORMS.get(name)(**params), TRANSFORMS.get(name)(**params)
    assert port.handles_bboxes and handles_bboxes(ref) and ref.geometric == port.geometric
    for seed in range(4):
        rng = np.random.default_rng(seed)
        sample = {"image": rng.integers(0, 256, (32, 36, 3)).astype(np.uint8),
                  "mask": (rng.random((32, 36)) < 0.2).astype(np.uint8),
                  "bboxes": BOXES[seed % 2:], "cropping_bbox": [5, 6, 20, 25]}
        jax_rngs(ref, np.random.default_rng(seed))
        want = ref(force_apply=True, **sample)
        with sample_generator(np.random.default_rng(seed)):
            got = port(force_apply=True, **sample)
        assert got["bboxes"].dtype == np.float32 and got["bboxes"].shape == want["bboxes"].shape
        np.testing.assert_array_equal(got["bboxes"], want["bboxes"])
        assert got["image"].shape == want["image"].shape


def test_quarter_turns_move_boxes_for_every_k():
    ref, port = JAX_TRANSFORMS.get("RandomRotate90")(), TRANSFORMS.get("RandomRotate90")()
    for k in range(5):
        np.testing.assert_array_equal(port.apply_to_bboxes(BOXES, (32, 36, 3), k=k),
                                      ref.apply_to_bboxes(BOXES, (32, 36, 3), k=k))


def handles_bboxes(t) -> bool:
    """Whether a JAX transform overrides ``apply_to_bboxes``."""
    return type(t).apply_to_bboxes is not JaxBaseTransform.apply_to_bboxes


@pytest.mark.parametrize("name", ["OpticalDistortion", "RandomGridShuffle", "PiecewiseAffine"])
def test_warps_without_a_box_handler_refuse_boxes(name):
    img = np.zeros((16, 16, 3), np.uint8)
    assert not handles_bboxes(JAX_TRANSFORMS.get(name)())
    for registry in (TRANSFORMS, JAX_TRANSFORMS):
        t = registry.get(name)(p=1.0)
        assert t.geometric
        with pytest.raises(NotImplementedError, match="bbox handler"):
            t(image=img, bboxes=np.zeros((1, 4), np.float32))


def spatial_names():
    return sorted(n for n, c in vars(jax_spatial).items()
                  if inspect.isclass(c) and c.__module__ == jax_spatial.__name__
                  and n in JAX_TRANSFORMS)


def test_every_name_of_the_jax_spatial_module_is_registered():
    names = spatial_names()
    assert len(names) == 31
    assert [n for n in names if n not in TRANSFORMS] == []


FLAGS = ("geometric", "device_capable", "device_needs_uniform", "device_bbox_safe",
         "device_preserves_dtype", "always_apply")
REQUIRED = {"Resize": {"height": 8, "width": 8}, "CenterCrop": {"height": 8, "width": 8},
            "RandomCrop": {"height": 8, "width": 8},
            "RandomResizedCrop": {"height": 8, "width": 8},
            "RandomSizedCrop": {"min_max_height": (4, 8), "height": 8, "width": 8},
            "RandomSizedBBoxSafeCrop": {"height": 8, "width": 8},
            "CropNonEmptyMaskIfExists": {"height": 8, "width": 8}}
VARIANTS = [("RandomResizedCrop", {"height": 8, "width": 8, "p": 0.5}),
            ("RandomSizedCrop", {"min_max_height": (4, 8), "height": 8, "width": 8,
                                 "interpolation": 0}),
            ("RandomCrop", {"height": 8, "width": 8, "p": 0.5}),
            ("CropAndPad", {"px": (-2, 2)}), ("CropAndPad", {"percent": 0.1, "keep_size": False}),
            ("CropAndPad", {"px": 2, "pad_mode": 3}), ("CropAndPad", {"px": 2, "pad_cval": [1, 2]}),
            ("PadIfNeeded", {"value": [1, 2, 3]}), ("PadIfNeeded", {"border_mode": 2}),
            ("Rotate", {"border_mode": 3}), ("Rotate", {"value": [1, 2]}),
            ("SafeRotate", {"mask_value": (1,)}), ("ShiftScaleRotate", {"border_mode": 2}),
            ("OpticalDistortion", {"border_mode": 3}), ("ElasticTransform", {"border_mode": 2}),
            ("GridDistortion", {"num_steps": 0}), ("Transpose", {"p": 1.0})]


@pytest.mark.parametrize("name,params", [(n, REQUIRED.get(n, {})) for n in spatial_names()]
                         + VARIANTS)
def test_flags_equal_the_jax_packages(name, params):
    ref, port = JAX_TRANSFORMS.get(name)(**params), TRANSFORMS.get(name)(**params)
    for flag in FLAGS:
        assert getattr(port, flag) == getattr(ref, flag), flag
    assert port.handles_bboxes == handles_bboxes(ref)


PIPELINES = {
    "geometry": [{"name": "RandomResizedCrop", "params": {"height": 24, "width": 24}},
                 {"name": "HorizontalFlip"}, {"name": "ShiftScaleRotate"},
                 {"name": "Perspective"}, {"name": "RandomRotate90"},
                 {"name": "Normalize"}, {"name": "ToTensorV2"}],
    "detection": [{"name": "LongestMaxSize", "params": {"max_size": 64}},
                  {"name": "PadIfNeeded", "params": {"min_height": 64, "min_width": 64,
                                                     "border_mode": 0}},
                  {"name": "RandomScale"}, {"name": "Rotate", "params": {"limit": 10}},
                  {"name": "Normalize"}, {"name": "ToTensorV2"}],
    "host_warp": [{"name": "Affine", "params": {"rotate": 5}},
                  {"name": "PiecewiseAffine"}, {"name": "CropAndPad", "params": {"px": 2}},
                  {"name": "RandomGridShuffle"}, {"name": "Normalize"}],
}


@pytest.mark.parametrize("pipeline", list(PIPELINES))
@pytest.mark.parametrize("bbox_mode", [False, True])
@pytest.mark.parametrize("uniform", [False, True])
def test_device_split_matches_jax(pipeline, bbox_mode, uniform):
    steps = PIPELINES[pipeline]
    port = Constructor._create_transforms(copy.deepcopy(steps))
    ref = JaxConstructor._create_transforms(copy.deepcopy(steps))
    host, device = port.split_device_suffix(bbox_mode=bbox_mode, uniform_shapes=uniform)
    ref_host, ref_device = ref.split_device_suffix(bbox_mode=bbox_mode, uniform_shapes=uniform)
    assert [type(t).__name__ for t in host.transforms] == \
        [type(t).__name__ for t in ref_host.transforms]
    assert [type(t).__name__ for t in device] == [type(t).__name__ for t in ref_device]


def test_the_spatial_recipe_runs_its_whole_train_pipeline_on_the_device():
    recipe = load_yaml(REPO / "configs" / "classification_swinv2_tiny_spatial_aug_train.yaml")
    assert recipe == chip_smoke.SPATIAL_TRAIN_CONFIG
    dataset = recipe["data"]["TRAIN"][0]["dataset"]
    steps = (dataset.get("augment") or []) + dataset["transform"]
    host, device = Constructor._create_transforms(copy.deepcopy(steps)).split_device_suffix(
        uniform_shapes=True)
    assert host.transforms == []
    assert [type(t).__name__ for t in device] == chip_smoke.SPATIAL_SUFFIX
    assert recipe["task"]["params"]["backbone_name"] == "swinv2_tiny_window8_256"


DETERMINISTIC = [
    ("FitResize", {"max_height": 20, "max_width": 16}),
    ("FitResize", {"max_height": 30, "max_width": 40, "interpolation": 0}),
    ("PadIfNeeded", {"min_height": 30, "min_width": 27}),
    ("PadIfNeeded", {"min_height": 29, "min_width": 31, "border_mode": 0, "value": 7,
                     "mask_value": 3}),
    ("PadIfNeeded", {"min_height": 80, "min_width": 26, "border_mode": 1}),
    ("LongestMaxSize", {"max_size": 17}),
    ("SmallestMaxSize", {"max_size": 40, "interpolation": 0}),
    ("Crop", {"x_min": 3, "y_min": 2, "x_max": 20, "y_max": 30}),
    # degenerate limits and p 1: no draw needs pinning
    ("Rotate", {"limit": (30, 30), "p": 1.0}),
    ("SafeRotate", {"limit": (-50, -50), "p": 1.0, "border_mode": 0}),
    ("ShiftScaleRotate", {"shift_limit": (0.1, 0.1), "scale_limit": (0.2, 0.2),
                          "rotate_limit": (10, 10), "p": 1.0}),
    ("Affine", {"scale": (1.1, 1.1), "translate_percent": (0.05, 0.05), "rotate": (7, 7),
                "shear": (4, 4), "p": 1.0}),
    ("OpticalDistortion", {"distort_limit": (0.3, 0.3), "shift_limit": (0.05, 0.05),
                           "p": 1.0}),
    ("Transpose", {"p": 1.0}),
]


@pytest.mark.parametrize("name,params", DETERMINISTIC,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(DETERMINISTIC)])
def test_device_path_without_draws_matches_jax(name, params):
    batches = [(imgs[:3], masks[:3]) for imgs, masks in device_batches(width=20)]
    port, ref = TRANSFORMS.get(name)(**params), JAX_TRANSFORMS.get(name)(**params)
    assert port.device_capable and ref.device_capable
    for (imgs, masks), want in zip(batches, jax_apply(ref, batches)):
        got = port.apply_batch({"image": torch.from_numpy(imgs),
                                "mask": torch.from_numpy(masks)}, torch.Generator())
        assert got["image"].dtype == torch.from_numpy(imgs).dtype
        assert_device_close(got, want)
