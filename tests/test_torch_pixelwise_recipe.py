"""The registry of the port's photometric transforms and the recipe that
trains through them, on the CPU.

* All 27 names of the first half of ``torchok_tpu``'s ``pixelwise.py``
  (Flip to ToSepia) resolve in the port, with the JAX classes' flags; the
  port registers 70 of the JAX package's 94 transforms, and the 24 it lacks
  are the second half of ``pixelwise.py``.
* ``configs/classification_gcvit_tiny_photometric_aug_train.yaml`` equals
  ``chip_smoke.PHOTOMETRIC_TRAIN_CONFIG``, its whole TRAIN pipeline goes to
  the device suffix in both packages, and the recipe cut to a narrowed
  gcvit at 32x32 trains two steps on the CPU through the plain attention.
"""
import copy
import inspect
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu.constructor.constructor import Constructor as JaxConstructor
from torchok_tpu.data.transforms.base import BaseTransform as JaxBaseTransform
from torchok_tpu.data.transforms import pixelwise as jax_pixelwise
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.constructor import TRANSFORMS
from torchok_tpu_torch.constructor.config import load_yaml
from torchok_tpu_torch.constructor.constructor import Constructor
from torchok_tpu_torch.ops import window_attention_dot as dot
from tests.test_torch_detection_data import chip_smoke

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "configs" / "classification_gcvit_tiny_photometric_aug_train.yaml"
FIRST, LAST = "Flip", "ToSepia"
# ported by earlier slices, between and after those two in the file
EARLIER = ("GaussNoise", "ColorJitter", "FancyPCA")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pixelwise_names():
    """The JAX module's registered classes in file order."""
    return [n for n, c in vars(jax_pixelwise).items()
            if inspect.isclass(c) and c.__module__ == jax_pixelwise.__name__
            and n in JAX_TRANSFORMS]


def slice_names():
    names = pixelwise_names()
    return [n for n in names[names.index(FIRST):names.index(LAST) + 1] if n not in EARLIER]


def test_the_27_names_resolve_and_the_rest_of_the_module_is_what_is_missing():
    names = slice_names()
    assert len(names) == 27 and all(n in TRANSFORMS for n in names)
    missing = sorted(n for n in JAX_TRANSFORMS.entries if n not in TRANSFORMS)
    assert len(JAX_TRANSFORMS.entries) == 94 and len(missing) == 24
    rest = pixelwise_names()[pixelwise_names().index(LAST) + 1:]
    assert missing == sorted(n for n in rest if n not in EARLIER)


FLAGS = ("geometric", "device_capable", "device_needs_uniform", "device_bbox_safe",
         "device_preserves_dtype", "always_apply")
VARIANTS = [("Downscale", {"interpolation": 1}), ("Downscale", {"interpolation": 3}),
            ("RandomBrightness", {"p": 1.0}), ("ToFloat", {"max_value": 10.0, "p": 0.3}),
            ("FromFloat", {"dtype": "uint8"}), ("Posterize", {"always_apply": True})]


@pytest.mark.parametrize("name,params", [(n, {}) for n in slice_names()] + VARIANTS)
def test_flags_equal_the_jax_packages(name, params):
    ref, port = JAX_TRANSFORMS.get(name)(**params), TRANSFORMS.get(name)(**params)
    for flag in FLAGS + ("p",):
        assert getattr(port, flag) == getattr(ref, flag), flag
    assert port.handles_bboxes == (type(ref).apply_to_bboxes
                                   is not JaxBaseTransform.apply_to_bboxes)


def suffix_names(constructor, bbox_mode=False):
    dataset = load_yaml(RECIPE)["data"]["TRAIN"][0]["dataset"]
    host, device = constructor._create_transforms(
        copy.deepcopy(dataset["augment"] + dataset["transform"])).split_device_suffix(
        bbox_mode=bbox_mode, uniform_shapes=True)
    return [type(t).__name__ for t in host.transforms], [type(t).__name__ for t in device]


@pytest.mark.parametrize("bbox_mode", [False, True])
def test_the_recipe_runs_its_whole_train_pipeline_on_the_device(bbox_mode):
    assert load_yaml(RECIPE) == chip_smoke.PHOTOMETRIC_TRAIN_CONFIG
    host, device = suffix_names(Constructor, bbox_mode)
    assert host == [] and device == chip_smoke.PHOTOMETRIC_SUFFIX
    assert suffix_names(JaxConstructor, bbox_mode) == (host, device)


def test_the_cut_recipe_trains_two_steps_through_the_plain_attention():
    """gcvit narrowed (the registry entry gcvit_xxtiny at 16 wide, two
    stages) on 32x32 images, bs 4, f32 on the CPU, the recipe's device
    suffix untouched."""
    cfg = copy.deepcopy(chip_smoke.PHOTOMETRIC_TRAIN_CONFIG)
    cfg["task"]["params"].update(
        backbone_name="gcvit_xxtiny", inputs=[{"shape": [3, 32, 32], "dtype": "float32"}],
        backbone_params=dict(embed_dim=16, depths=[2, 2], num_heads=[2, 4], img_size=32,
                             window_ratio=[8, 8], pretrained=False))
    for split, n in (("TRAIN", 8), ("VALID", 4)):
        loader = cfg["data"][split][0]
        loader["dataloader"].update(batch_size=4, num_workers=0)
        loader["dataset"]["params"].update(num_samples=n, image_size=[32, 32])
    cfg["trainer"].update(accelerator="cpu", precision=32, limit_train_batches=2)
    before = dict(dot.LAUNCHES)
    trainer, logs = run(cfg, "train")
    assert trainer.global_step == 2 and math.isfinite(logs["train/loss"])
    launched = {k: v - before.get(k, 0) for k, v in dot.LAUNCHES.items()}
    assert launched.get(dot.PLAIN, 0) > 0 and launched.get(dot.PLAIN_BWD, 0) > 0
    assert not any(launched.get(k) for k in dot.KERNELS)
    images = trainer.task.train_dataloader()[0].dataset.get_batch(np.arange(4))["image"]
    assert images.dtype == np.uint8 and images.shape == (4, 32, 32, 3)
