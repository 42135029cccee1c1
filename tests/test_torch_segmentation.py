"""The port's segmentation path against ``torchok_tpu``, f32 on the CPU:
``HRNetSegmentationNeck``, ``SegmentationHead``, CrossEntropyLoss over
``(N, C, H, W)`` logits, ``DiceLoss``, the five confusion-matrix metrics,
``SyntheticShapesSegmentationDataset`` and the trainer's ``mask`` ->
``target`` rename, and the north star ``configs/segmentation_shapes.yaml``.

The port takes NCHW logits, the JAX package the same logits channels-last;
the Flax variables are carried across by ``flax_convert``.

* Neck and head: within 1e-4 of the output's largest magnitude, in eval and
  train mode.
* Losses: every option of both losses within 1e-6 (relative) of the JAX
  value; a class dim elsewhere than dim 1 raises by name.
* Metrics: ConfusionMatrix, CohenKappa, MatthewsCorrCoef, JaccardIndex and
  Dice within 1e-9 of the JAX value over two updates, also where the width
  equals the class count (which the old last-dim argmax misread).
* Dataset: images and masks bit-equal to the JAX dataset's.
* The recipe: ``chip_smoke.py``'s dict equals the YAML, with the short
  budget's overrides.
* ``ClassificationTask`` wires backbone -> neck -> pooling -> head: its keys
  and shapes are the JAX task's variables carried by ``flax_convert``.

``test_torch_segmentation_fit.py`` fits the cut recipe in both packages.
"""
import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
from torchok_tpu.constructor import LOSSES as JAX_LOSSES
from torchok_tpu.constructor import METRICS as JAX_METRICS
from torchok_tpu.constructor import TASKS as JAX_TASKS
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.config_structure import merge_structured as jax_merge
from torchok_tpu.data.datasets.examples.synthetic import \
    SyntheticShapesSegmentationDataset as JaxShapesSegmentation
from torchok_tpu.models.backbones import hrnet as jax_hrnet
from torchok_tpu.models.heads.segmentation.base import SegmentationHead as FlaxSegmentationHead
from torchok_tpu.models.necks.segmentation.hrnet import \
    HRNetSegmentationNeck as FlaxSegmentationNeck
from torchok_tpu_torch.constructor import DATASETS, LOSSES, METRICS, TASKS, TRANSFORMS
from torchok_tpu_torch.constructor.config import config_from_dict, load_config, load_yaml
from torchok_tpu_torch.constructor.config_structure import merge_structured
from torchok_tpu_torch.constructor.runner import create_trainer
from torchok_tpu_torch.data.transforms import Compose
from torchok_tpu_torch.models.backbones import hrnet as port_hrnet
from torchok_tpu_torch.models.heads.segmentation.base import SegmentationHead
from torchok_tpu_torch.models.necks.segmentation.hrnet import HRNetSegmentationNeck
from torchok_tpu_torch.utils.flax_convert import flax_to_state_dict, task_flax_to_state_dict
from tests.test_torch_hrnet import CUT, assert_maps_close, draw_variables, nchw, random_variables

REPO = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: at these sizes more threads only
    contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(module, variables):
    state = flax_to_state_dict(type(module).__name__, variables)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return module


def test_segmentation_neck_matches_torchok_tpu():
    rng = np.random.default_rng(0)
    widths = (16, 32, 64, 128)
    image = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    xs = [rng.normal(size=(4, 8 >> i, 8 >> i, w)).astype(np.float32)
          for i, w in enumerate(widths)]
    inputs = [jnp.asarray(a) for a in [image] + xs]
    flax_neck = FlaxSegmentationNeck(in_channels=widths)
    variables = random_variables(flax_neck, rng, inputs, False)
    neck = _load(HRNetSegmentationNeck(in_channels=widths), variables)
    assert neck.out_channels == sum(widths)
    for train in (False, True):
        (want_image, want), _ = flax_neck.apply(variables, inputs, train, mutable=["batch_stats"])
        neck.train(train)
        with torch.no_grad():
            got_image, got = neck([nchw(a) for a in [image] + xs])
        assert torch.equal(got_image, nchw(image))
        assert_maps_close(got, want, what=f"train={train}")


@pytest.mark.parametrize("num_classes,do_interpolate", [(11, True), (11, False), (1, True)])
def test_segmentation_head_matches_torchok_tpu(num_classes, do_interpolate):
    rng = np.random.default_rng(1)
    image = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 8, 8, 24)).astype(np.float32)
    inputs = [jnp.asarray(image), jnp.asarray(feats)]
    flax_head = FlaxSegmentationHead(in_channels=24, num_classes=num_classes,
                                     do_interpolate=do_interpolate)
    variables = random_variables(flax_head, rng, inputs)
    head = _load(SegmentationHead(24, num_classes, do_interpolate), variables)
    want = np.asarray(flax_head.apply(variables, inputs))
    with torch.no_grad():
        got = head([nchw(image), nchw(feats)])
    if num_classes == 1:
        assert got.shape == (2, 32, 32)
        got, want = got[:, None], want[..., None]
    assert_maps_close(got, want)
    generator = torch.Generator()
    generator.manual_seed(2)
    head.init_weights(generator)  # Flax's default: LeCun normal, zero bias
    assert not head.classifier.bias.any()
    assert head.classifier.weight.std().item() == pytest.approx(24 ** -0.5, rel=0.5)


def _logits(rng, n=2, c=5, h=6, w=7):
    nhwc = rng.normal(size=(n, h, w, c)).astype(np.float32) * 3
    return nhwc, nchw(nhwc)


CE_CASES = {
    "plain": {},
    "sum": {"reduction": "sum"},
    "none": {"reduction": "none"},
    "ignore": {"ignore_index": 3},
    "smoothing": {"label_smoothing": 0.2},
    "weight": {"weight": [0.5, 1.0, 2.0, 0.25, 1.5]},
    "weight_ignore_smoothing": {"weight": [0.5, 1.0, 2.0, 0.25, 1.5], "ignore_index": 0,
                                "label_smoothing": 0.1},
    "weight_sum": {"weight": [0.5, 1.0, 2.0, 0.25, 1.5], "reduction": "sum"},
    "probabilities": {"probabilities": True},
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_pixel_cross_entropy_matches_torchok_tpu(case):
    params = dict(CE_CASES[case])
    probabilities = params.pop("probabilities", False)
    rng = np.random.default_rng(3)
    nhwc, logits = _logits(rng)
    if probabilities:
        target_nhwc = rng.dirichlet(np.ones(5), size=(2, 6, 7)).astype(np.float32)
        target = nchw(target_nhwc)
    else:
        target_nhwc = rng.integers(0, 5, size=(2, 6, 7))
        target = torch.from_numpy(target_nhwc)
    want = np.asarray(JAX_LOSSES.get("CrossEntropyLoss")(**params)(
        jnp.asarray(nhwc), jnp.asarray(target_nhwc)))
    got = LOSSES.get("CrossEntropyLoss")(**params)(logits, target).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_a_class_dim_out_of_place_raises_by_name():
    rng = np.random.default_rng(4)
    nhwc, logits = _logits(rng, c=5, h=6, w=5)
    target = torch.from_numpy(rng.integers(0, 5, size=(2, 6, 5)))
    with pytest.raises(ValueError, match="CrossEntropyLoss.*dim 1"):
        LOSSES.get("CrossEntropyLoss")()(torch.from_numpy(nhwc), target)
    with pytest.raises(ValueError, match="DiceLoss.*dim 1"):
        LOSSES.get("DiceLoss")("multiclass")(torch.from_numpy(nhwc), target)
    with pytest.raises(ValueError, match="classes at dim 1"):
        metric = METRICS.get("JaccardIndex")(num_classes=5)
        metric.update(metric.empty_state("cpu"), preds=torch.from_numpy(nhwc), target=target)


DICE_CASES = {
    "multiclass": {"mode": "multiclass"},
    "multiclass_classes_log": {"mode": "multiclass", "classes": [1, 3], "log_loss": True},
    "multiclass_smooth": {"mode": "multiclass", "smooth": 1.0},
    "multilabel": {"mode": "multilabel"},
    "multilabel_probs": {"mode": "multilabel", "from_logits": False},
    "binary": {"mode": "binary"},
    "binary_log": {"mode": "binary", "log_loss": True, "smooth": 0.5},
}


@pytest.mark.parametrize("case", sorted(DICE_CASES))
def test_dice_loss_matches_torchok_tpu(case):
    params = DICE_CASES[case]
    rng = np.random.default_rng(5)
    nhwc, logits = _logits(rng)
    if params["mode"] == "multiclass":
        # class 4 has no true pixel: its channel is zeroed in both
        target_nhwc = rng.integers(0, 4, size=(2, 6, 7))
        target = torch.from_numpy(target_nhwc)
    elif params["mode"] == "multilabel":
        target_nhwc = (rng.random((2, 6, 7, 5)) < 0.4).astype(np.int64)
        target_nhwc[..., 2] = 0
        target = nchw(target_nhwc)
        if not params.get("from_logits", True):
            nhwc = 1.0 / (1.0 + np.exp(-nhwc))
            logits = nchw(nhwc)
    else:
        nhwc, logits = nhwc[..., 0], logits[:, 0]
        target_nhwc = (rng.random((2, 6, 7)) < 0.4).astype(np.int64)
        target = torch.from_numpy(target_nhwc)
    want = float(JAX_LOSSES.get("DiceLoss")(**params)(jnp.asarray(nhwc),
                                                      jnp.asarray(target_nhwc)))
    got = float(LOSSES.get("DiceLoss")(**params)(logits, target))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


CONFUSION = ("ConfusionMatrix", "CohenKappa", "MatthewsCorrCoef", "JaccardIndex", "Dice")
METRIC_CASES = {
    "recipe": ({"num_classes": 11, "ignore_index": 0}, (4, 11, 9, 8)),
    "width_is_num_classes": ({"num_classes": 11, "ignore_index": 0}, (4, 11, 6, 11)),
    "micro": ({"num_classes": 5, "average": "micro"}, (3, 5, 7, 6)),
    "macro": ({"num_classes": 5, "average": "macro"}, (3, 5, 7, 6)),
    "none": ({"num_classes": 5, "average": "none"}, (3, 5, 7, 6)),
    "binary": ({"task": "binary"}, (3, 7, 6)),
}


@pytest.mark.parametrize("name", CONFUSION)
@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_confusion_metrics_match_torchok_tpu(name, case):
    params, shape = METRIC_CASES[case]
    rng = np.random.default_rng(6)
    ours, theirs = METRICS.get(name)(**params), JAX_METRICS.get(name)(**params)
    state, ref_state = ours.empty_state("cpu"), theirs.empty_state()
    num_classes = params.get("num_classes", 2)
    for _ in range(2):
        if params.get("task") == "binary":
            preds_nhwc = rng.random(shape).astype(np.float32)
            preds = torch.from_numpy(preds_nhwc)
            target_nhwc = rng.integers(0, 2, size=shape)
        else:
            preds_nhwc, preds = _logits(rng, *shape[:1], *shape[1:2], *shape[2:])
            target_nhwc = rng.integers(0, num_classes, size=(shape[0],) + shape[2:])
            # predictions that agree with the target often enough to matter
            hit = rng.random(target_nhwc.shape) < 0.6
            np.put_along_axis(preds_nhwc, target_nhwc[..., None],
                              np.where(hit, 9.0, -9.0)[..., None].astype(np.float32), axis=-1)
            preds = nchw(preds_nhwc)
        state = ours.update(state, preds=preds, target=torch.from_numpy(target_nhwc))
        ref_state = theirs.update(ref_state, jnp.asarray(preds_nhwc), jnp.asarray(target_nhwc))
    np.testing.assert_array_equal(state["cm"].numpy(), np.asarray(ref_state["cm"]))
    got, want = ours.compute(state), theirs.compute(ref_state)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=0, abs=1e-9), key
    else:
        assert got == pytest.approx(want, rel=0, abs=1e-9)


@pytest.mark.parametrize("params", [{"task": "multiclass", "num_classes": 6, "average": "macro"},
                                    {"task": "multiclass"}])
def test_accuracy_takes_the_classes_at_dim_1_of_a_pixel_prediction(params):
    rng = np.random.default_rng(7)
    nhwc, preds = _logits(rng, n=3, c=6, h=5, w=6)
    target = rng.integers(0, 6, size=(3, 5, 6))
    ours, theirs = METRICS.get("Accuracy")(**params), JAX_METRICS.get("Accuracy")(**params)
    state = ours.update(ours.empty_state("cpu"), preds=preds, target=torch.from_numpy(target))
    want = theirs.compute(theirs.update(theirs.empty_state(), jnp.asarray(nhwc),
                                        jnp.asarray(target)))
    assert ours.compute(state) == pytest.approx(want, rel=0, abs=1e-6)


def _dataset(**params):
    """The dataset with the recipe's transforms: Resize, Normalize and
    ToTensorV2, all three on the device."""
    transform = Compose([TRANSFORMS.get(t["name"])(**t.get("params", {}))
                         for t in chip_smoke.SEGMENTATION_RECIPE["data"]["VALID"][0]["dataset"][
                             "transform"]])
    return DATASETS.get("SyntheticShapesSegmentationDataset")(transform, **params)


@pytest.mark.parametrize("train", [True, False])
def test_the_dataset_equals_torchok_tpus_and_rides_the_device_pipeline_as_mask(train):
    params = {"num_samples": 24, "train": train, "image_size": (32, 32)}
    ours = _dataset(**params)
    theirs = JaxShapesSegmentation(None, **params)
    np.testing.assert_array_equal(ours.images, theirs.images)
    np.testing.assert_array_equal(ours.masks, theirs.masks)
    assert ours.masks.min() == 0 and ours.masks.max() == 10 and ours.masks.dtype == np.int64
    assert ours.host_pipeline_empty and ours.device_pipeline
    assert set(ours.get_batch(np.arange(4))) == {"image", "index", "mask"}
    sample = ours[3]
    assert set(sample) == {"image", "index", "mask"}
    np.testing.assert_array_equal(sample["mask"], theirs.masks[3])
    plain = DATASETS.get("SyntheticShapesSegmentationDataset")(None, **params)
    assert set(plain[3]) == {"image", "index", "target"}
    np.testing.assert_array_equal(plain[3]["target"], theirs.masks[3])


def _recipe(**trainer):
    cfg = copy.deepcopy(chip_smoke.SEGMENTATION_RECIPE)
    cfg["trainer"].update(accelerator="cpu", **trainer)
    return cfg


def test_the_trainer_renames_mask_to_target_after_the_device_pipeline():
    trainer = create_trainer(config_from_dict(_recipe()))
    dataset = _dataset(num_samples=8, train=False)
    batch = trainer._make_device_fn(dataset, False)(dataset.get_batch(np.arange(4)))
    assert sorted(batch) == ["image", "index", "target"]
    assert batch["target"].dtype == torch.int64 and batch["image"].shape == (4, 3, 32, 32)
    np.testing.assert_array_equal(batch["target"].numpy(), dataset.masks[:4])


def test_the_recipe_equals_chip_smoke_config():
    assert load_yaml(REPO / "configs" / "segmentation_shapes.yaml") == \
        chip_smoke.SEGMENTATION_RECIPE
    overrides = ["trainer.max_epochs=5", "data.TRAIN.0.dataset.params.num_samples=8000"]
    assert chip_smoke.SEGMENTATION_OVERRIDES == overrides
    want = load_config(REPO / "configs", "segmentation_shapes",
                       overrides + ["logger.log_dir=/somewhere"])
    assert config_from_dict(chip_smoke.segmentation_config("/somewhere")) == want
    assert want.trainer.steps_per_execution == 8 and want.trainer.precision == 32


def test_classification_task_wires_the_neck_as_torchok_tpu_does(monkeypatch):
    """backbone -> neck -> pooling -> head from the config: the port's
    state_dict keys and shapes are the JAX task's variables carried by
    ``task_flax_to_state_dict``, and the logits come out (N, 10)."""
    monkeypatch.setitem(jax_hrnet.CFGS, "hrnet_w18_small", CUT)
    monkeypatch.setitem(port_hrnet.CFGS, "hrnet_w18_small", CUT)
    cfg = {"task": {"name": "ClassificationTask",
                    "params": {"backbone_name": "hrnet_w18_small",
                               "neck_name": "HRNetClassificationNeck",
                               "pooling_name": "Pooling", "head_name": "ClassificationHead",
                               "head_params": {"num_classes": 10}}},
           "data": {}, "trainer": {"accelerator": "cpu", "precision": 32}}
    config = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
    ref = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    batch = {"image": jnp.zeros((2, 32, 32, 3))}
    shapes = jax.eval_shape(lambda r: ref.model.init(r, batch, False), jax.random.PRNGKey(0))
    variables = draw_variables(shapes, np.random.default_rng(6))
    state = task_flax_to_state_dict("hrnet_w18_small", variables)

    port_cfg = merge_structured(config_from_dict(copy.deepcopy(cfg)))
    task = TASKS.get(port_cfg.task.name)(port_cfg, **port_cfg.task.params.to_dict())
    generator = torch.Generator()
    generator.manual_seed(0)
    task.init_weights(generator)
    assert not task.model.neck.incre_0.bn3.weight.any()  # zero-initialised last norm
    assert {k: tuple(v.shape) for k, v in task.model.state_dict().items()} == \
        {k: v.shape for k, v in state.items()}
    task.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    with torch.no_grad():
        out = task.model.eval()({"image": torch.zeros(2, 3, 32, 32)})
    assert out["prediction"].shape == (2, 10) and out["embeddings"].shape == (2, 2048)
