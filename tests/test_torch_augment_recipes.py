"""The recipes' augmentation pipelines in the port against ``torchok_tpu`` on
the CPU: the host/device split of every recipe that uses the new transforms,
the whole TRAIN pipeline of ``configs/segmentation_sweet_pepper.yaml`` with
one shared generator a sample, and ``chip_smoke.py``'s copy of that recipe.

The sweet-pepper pipeline's uint8 images equal the JAX package's but where
ElasticTransform's blurred field (a product with a banded matrix in the port,
cv2's own sums in the JAX package's, 1e-7 apart) moves a coordinate across a
rounding edge: one level on at most 0.1% of the values. Masks are equal.
"""
import copy
from pathlib import Path

import numpy as np
import pytest

import torchok_tpu  # noqa: F401
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor.constructor import Constructor as JaxConstructor
from torchok_tpu_torch.constructor.config import load_yaml
from torchok_tpu_torch.constructor.constructor import Constructor
from torchok_tpu_torch.data.datasets.examples.synthetic import SyntheticShapesSegmentationDataset
from torchok_tpu_torch.data.transforms.base import sample_generator
from tests.test_torch_augment import assert_levels, jax_rngs
from tests.test_torch_detection_data import chip_smoke

REPO = Path(__file__).resolve().parent.parent
RECIPES = ("segmentation_sweet_pepper", "representation_arcface_sop", "pairwise_sop",
           "classification_imagenet")


def train_pipeline(recipe):
    dataset = load_yaml(REPO / "configs" / f"{recipe}.yaml")["data"]["TRAIN"][0]["dataset"]
    return (dataset.get("augment") or []) + (dataset.get("transform") or [])


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("bbox_mode", [False, True])
@pytest.mark.parametrize("uniform", [False, True])
def test_device_split_matches_jax(recipe, bbox_mode, uniform):
    steps = train_pipeline(recipe)
    port = Constructor._create_transforms(copy.deepcopy(steps))
    ref = JaxConstructor._create_transforms(copy.deepcopy(steps))
    host, device = port.split_device_suffix(bbox_mode=bbox_mode, uniform_shapes=uniform)
    ref_host, ref_device = ref.split_device_suffix(bbox_mode=bbox_mode, uniform_shapes=uniform)
    assert [type(t).__name__ for t in host.transforms] == \
        [type(t).__name__ for t in ref_host.transforms]
    assert [type(t).__name__ for t in device] == [type(t).__name__ for t in ref_device]


def test_sweet_pepper_warps_stay_on_the_host():
    host, device = Constructor._create_transforms(
        train_pipeline("segmentation_sweet_pepper")).split_device_suffix(uniform_shapes=True)
    assert [type(t).__name__ for t in device] == ["Resize", "Normalize", "ToTensorV2"]
    assert [type(t).__name__ for t in host.transforms][-2:] == ["OneOf", "OneOf"]


def test_sweet_pepper_host_pipeline_matches_jax():
    steps = load_yaml(REPO / "configs" / "segmentation_sweet_pepper.yaml")[
        "data"]["TRAIN"][0]["dataset"]["augment"]
    data = SyntheticShapesSegmentationDataset(None, num_samples=12, image_size=(256, 256))
    port = Constructor._create_transforms(copy.deepcopy(steps))
    ref = JaxConstructor._create_transforms(copy.deepcopy(steps))
    changed = 0
    for i in range(len(data)):
        image, mask = data.images[i], data.masks[i]
        jax_rngs(ref, np.random.default_rng([7, i]))
        want = ref(image=image, mask=mask)
        with sample_generator(np.random.default_rng([7, i])):
            got = port(image=image, mask=mask)
        assert got["image"].dtype == np.uint8 and got["image"].shape == (256, 256, 3)
        assert_levels(want["image"], got["image"], share=1e-3)
        np.testing.assert_array_equal(np.asarray(want["mask"]), got["mask"])
        changed += not np.array_equal(got["image"], image)
    assert changed >= len(data) - 2


def test_chip_smoke_holds_the_sweet_pepper_recipe():
    assert load_yaml(REPO / "configs" / "segmentation_sweet_pepper.yaml") == \
        chip_smoke.SWEET_PEPPER_RECIPE
    cfg, cuts = chip_smoke.sweet_pepper_config("/logs", "/data")
    train = cfg["data"]["TRAIN"][0]
    assert train["dataset"]["augment"] == chip_smoke.SWEET_PEPPER_RECIPE["data"]["TRAIN"][0][
        "dataset"]["augment"]
    assert train["dataloader"] == {"batch_size": 8, "num_workers": 4, "drop_last": True,
                                   "shuffle": True}
    assert train["dataset"]["name"] == "SweetPepper" and len(cuts) == 4
    assert train["dataset"]["params"]["data_folder"] == "/data"
    # the recipe's callbacks verbatim, ModelCheckpointWithOnnx included
    assert cfg["callbacks"] == chip_smoke.SWEET_PEPPER_RECIPE["callbacks"]
    assert cfg["task"] == {**chip_smoke.SWEET_PEPPER_RECIPE["task"], "params": {
        **chip_smoke.SWEET_PEPPER_RECIPE["task"]["params"],
        "backbone_params": {"pretrained": False, "in_channels": 3}}}
    images, masks = chip_smoke.sweet_pepper_arrays(64, True, size=16)
    base = SyntheticShapesSegmentationDataset(None, num_samples=64, image_size=(16, 16))
    np.testing.assert_array_equal(images, base.images)
    assert set(np.unique(masks)) == {0, 1, 2} and masks.dtype == np.uint8
    np.testing.assert_array_equal(masks == 0, base.masks == 0)
