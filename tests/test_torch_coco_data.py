"""The COCO data path of the DETR COCO recipes in the port against
``torchok_tpu`` on the CPU: ``FitResize`` and ``PadIfNeeded`` (every border
mode, on the image, the mask and the boxes), ``COCODetection`` and
``COCOSegmentation`` on a COCO tree written here (records, samples,
``download`` with ``annotations/`` present, the ``.pkl`` cache with and
without pandas), the ``DETR_RECIPE`` dict of ``chip_smoke.py`` against
``configs/detection_toy_detr.yaml``, the DETR COCO recipes' component names,
and the DETR-GCViT task's ``paramwise_cfg`` groups against the JAX package's
labels.

cv2's uint8 bilinear resize rounds fixed-point weights, so a fit-resized
image lies within one level of the exact resize the port computes (after
Normalize: one level over the channel's std x 255); boxes, labels and masks
are equal.
"""
import builtins
import copy
import json
import pickle
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import DATASETS as JAX_DATASETS
from torchok_tpu.constructor import TASKS as JAX_TASKS
from torchok_tpu.constructor import TRANSFORMS as JAX_TRANSFORMS
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.config_structure import merge_structured as jax_merge
from torchok_tpu.data.datasets.examples import coco as jax_coco
from torchok_tpu_torch import constructor as registries
from torchok_tpu_torch.constructor import DATASETS, TASKS, TRANSFORMS
from torchok_tpu_torch.constructor.config import (ConfigNode, config_from_dict, load_config,
                                                  load_yaml)
from torchok_tpu_torch.constructor.config_structure import merge_structured
from torchok_tpu_torch.constructor.constructor import Constructor, norm_parameter_names
from torchok_tpu_torch.data.datasets.examples import coco
from torchok_tpu_torch.utils.flax_convert import task_name_map
from tests.test_torch_detection_data import chip_smoke
from tests.test_torch_losses_optim import _jax_labels

REPO = Path(__file__).resolve().parent.parent
BOXES = np.array([[3, 4, 30, 22], [20, 10, 55, 39], [0, 0, 6, 5]], np.float32)
STD_LEVEL = 1.0 / (0.224 * 255.0)  # one uint8 level after Normalize, at the smallest std


def _image(h, w, seed=0, channels=3, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    shape = (h, w) + ((channels,) if channels else ())
    return rng.integers(0, 256, shape).astype(dtype)


@pytest.mark.parametrize("h,w", [(300, 800), (800, 300), (400, 672), (200, 336), (517, 611),
                                 (37, 91)])
def test_fit_resize_matches_jax(h, w):
    img = _image(h, w, h + w)
    mask = _image(h, w, 1, channels=0) % 7
    ref = JAX_TRANSFORMS.get("FitResize")(max_height=400, max_width=672)
    port = TRANSFORMS.get("FitResize")(max_height=400, max_width=672)
    want, got = ref.apply(img), port.apply(img)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(port.apply_to_mask(mask), ref.apply_to_mask(mask))
    np.testing.assert_array_equal(port.apply_to_bboxes(BOXES, img.shape),
                                  ref.apply_to_bboxes(BOXES, img.shape))
    float_img = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(port.apply(float_img), ref.apply(float_img), rtol=0, atol=1e-5)
    assert port.geometric and not port.device_bbox_safe
    assert port.device_capable == ref.device_capable and port.device_needs_uniform


@pytest.mark.parametrize("border_mode", [0, 1, 2, 3, 4])
def test_pad_if_needed_matches_jax(border_mode):
    """cv2.copyMakeBorder in every mode, on uint8 and f32 images of 1 and 3
    channels and masks, with no value, a scalar (cv2 fills channel 0 only), a
    per-channel value and one that saturates uint8."""
    for dtype in (np.uint8, np.float32):
        for channels in (None, 3, 1):
            img = _image(7, 9, 3, channels, dtype)
            for value in (None, 0, 5, (3, 4, 5), 300):
                kw = dict(min_height=12, min_width=16, border_mode=border_mode, value=value,
                          mask_value=value)
                ref, port = JAX_TRANSFORMS.get("PadIfNeeded")(**kw), \
                    TRANSFORMS.get("PadIfNeeded")(**kw)
                want, got = ref.apply(img), port.apply(img)
                assert got.dtype == want.dtype, (dtype, channels, value)
                np.testing.assert_array_equal(got, want.reshape(got.shape))
    mask = _image(5, 20, 4, None, np.uint8) % 9
    for mask_value in (None, 0, 7):
        kw = dict(min_height=11, min_width=20, border_mode=border_mode, value=1,
                  mask_value=mask_value)
        ref, port = JAX_TRANSFORMS.get("PadIfNeeded")(**kw), TRANSFORMS.get("PadIfNeeded")(**kw)
        np.testing.assert_array_equal(port.apply_to_mask(mask), ref.apply_to_mask(mask))
        # int64 masks: the values (cv2 hands them back as int32)
        np.testing.assert_array_equal(port.apply_to_mask(mask.astype(np.int64)),
                                      ref.apply_to_mask(mask.astype(np.int64)))
        for shape in ((5, 20, 3), (30, 40, 3)):  # padded, and already large enough
            np.testing.assert_array_equal(port.apply_to_bboxes(BOXES, shape),
                                          ref.apply_to_bboxes(BOXES, shape))
    with pytest.raises(NotImplementedError):
        TRANSFORMS.get("PadIfNeeded")(border_mode=5)


SPLITS = (("train2017", 6, 3), ("val2017", 4, 4))
TRANSFORM = [{"name": "FitResize", "params": {"max_height": 100, "max_width": 168}},
             {"name": "Normalize"},
             {"name": "PadIfNeeded", "params": {"min_height": 100, "min_width": 168,
                                                "border_mode": 0, "value": 0}},
             {"name": "ToTensorV2"}]


@pytest.fixture(scope="module")
def coco_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    chip_smoke.write_coco_tree(str(root), SPLITS)
    return root


def _transforms(registry, specs):
    return [registry.get(t["name"])(**t.get("params", {})) for t in specs]


def _datasets(name, root, train, **kwargs):
    """(JAX dataset, port dataset) of ``name`` over ``root``'s COCO tree with
    the recipe's pipeline (fit into 100x168), each on its own copy of the
    tree's annotations (so neither reads the other's pickle)."""
    out = []
    for registry, transforms in ((JAX_DATASETS, JAX_TRANSFORMS), (DATASETS, TRANSFORMS)):
        out.append(registry.get(name)(
            train=train, download=False, data_folder=str(root),
            transform=_transforms(transforms, TRANSFORM), input_dtype="bfloat16",
            bbox_dtype="bfloat16", image_format="rgb", **kwargs))
    return out


def _fresh_copy(src, dst):
    import shutil
    shutil.copytree(src / "COCO", dst / "COCO")
    for pkl in (dst / "COCO").glob("*.pkl"):
        pkl.unlink()
    return dst


def test_coco_records_match_jax(coco_tree, tmp_path):
    for split, n, _ in SPLITS:
        ann = coco_tree / "COCO" / "annotations" / f"instances_{split}.json"
        want = jax_coco._coco_json_to_df(ann, Path(split))
        got = coco.coco_records(ann, Path(split))
        assert list(got) == list(want.columns)
        for column in got:
            assert got[column] == want[column].tolist(), column
        assert len(got["image_path"]) == n
        coco_json = json.loads(ann.read_text())
        crowd = sum(a["iscrowd"] for a in coco_json["annotations"])
        assert crowd > 0 and sum(map(len, got["label"])) == len(coco_json["annotations"]) - crowd
        assert [] in got["bbox"]  # the image without annotations is kept
        ids = sorted(c["id"] for c in coco_json["categories"])
        assert len(ids) == 80 and ids[-1] == 90  # COCO's gapped ids -> labels 0 to 79
        assert all(0 <= lab < 80 for labels in got["label"] for lab in labels)


@pytest.mark.parametrize("train", [True, False])
def test_coco_detection_samples_match_jax(coco_tree, tmp_path, train):
    root = _fresh_copy(coco_tree, tmp_path)
    ref, port = _datasets("COCODetection", root, train)
    assert len(port) == len(ref) == SPLITS[0 if train else 1][1]
    # the device suffix is ToTensorV2 alone in both: boxes keep the host geometry
    assert [type(t).__name__ for t in port.device_pipeline.transforms] == ["ToTensorV2"]
    for i in range(len(port)):
        want, got = ref[i], port[i]
        assert got.keys() == want.keys()
        assert got["image"].shape == want["image"].shape == (100, 168, 3)
        assert got["image"].dtype == want["image"].dtype == np.float32
        assert np.abs(got["image"] - want["image"]).max() <= STD_LEVEL + 1e-5
        # bbox_dtype bfloat16 leaves the boxes in f32, unrounded, in both
        assert got["bboxes"].dtype == want["bboxes"].dtype == np.float32
        for key in ("bboxes", "label", "orig_img_shape", "index"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert any(np.any(port[i]["bboxes"] % 1 != 0) for i in range(len(port)))


def _cv2_rectangle_via_int32(monkeypatch):
    """This OpenCV (5.0) refuses to draw on int64 arrays, which the JAX
    reader's masks are: draw on an int32 copy and write it back (the labels
    fit)."""
    import cv2
    rectangle = cv2.rectangle

    def draw(img, pt1, pt2, color, thickness):
        tmp = img.astype(np.int32)
        rectangle(tmp, pt1, pt2, color, thickness)
        img[...] = tmp
        return img

    monkeypatch.setattr(cv2, "rectangle", draw)
    return rectangle


def test_coco_segmentation_samples_match_jax(coco_tree, tmp_path, monkeypatch):
    _cv2_rectangle_via_int32(monkeypatch)
    root = _fresh_copy(coco_tree, tmp_path)
    ref, port = _datasets("COCOSegmentation", root, True)
    for i in range(len(port)):
        want, got = ref[i], port[i]
        assert got.keys() == want.keys() == {"image", "index", "target"}
        np.testing.assert_array_equal(got["target"], want["target"])
        assert got["target"].dtype == np.int64
        assert np.abs(got["image"] - want["image"]).max() <= STD_LEVEL + 1e-5
    assert any(port[i]["target"].max() > 0 for i in range(len(port)))


def test_fill_rectangle_is_cv2s():
    import cv2
    rng = np.random.default_rng(0)
    for _ in range(50):
        mask, ref = np.zeros((20, 30), np.int64), np.zeros((20, 30), np.int32)
        x0, x1 = (int(v) for v in rng.integers(-10, 40, 2))
        y0, y1 = (int(v) for v in rng.integers(-10, 30, 2))
        coco.fill_rectangle(mask, x0, y0, x1, y1, 3)
        cv2.rectangle(ref, (x0, y0), (x1, y1), 3, -1)
        np.testing.assert_array_equal(mask, ref)


def test_pickle_cache_with_and_without_pandas(coco_tree, tmp_path, monkeypatch):
    """With pandas the port writes the JAX package's ``.pkl`` (which it reads
    back) and reads one the JAX package wrote; without pandas it parses the
    JSON and writes nothing."""
    root = _fresh_copy(coco_tree, tmp_path / "a")
    port = _datasets("COCODetection", root, True)[1]
    pkl = root / "COCO" / "train_detection.pkl"
    assert pkl.exists()
    ref = JAX_DATASETS.get("COCODetection")(train=True, download=False, data_folder=str(root),
                                            transform=_transforms(JAX_TRANSFORMS, TRANSFORM))
    assert ref.df["image_path"].tolist() == port.paths
    # a pickle the JAX package wrote, read back by the port
    root_b = _fresh_copy(coco_tree, tmp_path / "b")
    ref_b = _datasets("COCODetection", root_b, False)[0]
    with open(root_b / "COCO" / "valid_detection.pkl", "rb") as f:
        assert pickle.load(f)["bbox"].tolist() == ref_b.df["bbox"].tolist()
    port_b = DATASETS.get("COCODetection")(train=False, download=False, data_folder=str(root_b),
                                           transform=_transforms(TRANSFORMS, TRANSFORM))
    assert port_b.boxes == ref_b.df["bbox"].tolist()

    real_import = builtins.__import__

    def no_pandas(name, *args, **kwargs):
        if name == "pandas" or name.startswith("pandas."):
            raise ImportError("no pandas")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    root_c = _fresh_copy(coco_tree, tmp_path / "c")
    port_c = DATASETS.get("COCODetection")(train=True, download=False, data_folder=str(root_c),
                                           transform=_transforms(TRANSFORMS, TRANSFORM))
    assert not list((root_c / "COCO").glob("*.pkl"))
    assert port_c.paths == port.paths and port_c.boxes == port.boxes
    assert port_c.labels == port.labels


def test_download_with_annotations_present_reaches_no_network(coco_tree, tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the network was asked for")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    root = _fresh_copy(coco_tree, tmp_path)
    port = DATASETS.get("COCODetection")(train=False, download=True, data_folder=str(root),
                                         transform=_transforms(TRANSFORMS, TRANSFORM))
    assert len(port) == SPLITS[1][1]
    with pytest.raises(RuntimeError, match="download=True"):
        DATASETS.get("COCODetection")(train=False, download=False,
                                      data_folder=str(tmp_path / "missing"),
                                      transform=_transforms(TRANSFORMS, TRANSFORM))
    with pytest.raises(AssertionError, match="network"):
        DATASETS.get("COCODetection")(train=False, download=True,
                                      data_folder=str(tmp_path / "empty"),
                                      transform=_transforms(TRANSFORMS, TRANSFORM))


def test_the_detr_recipe_equals_the_yaml_file():
    assert load_yaml(REPO / "configs" / "detection_toy_detr.yaml") == chip_smoke.DETR_RECIPE
    baselines = json.loads((REPO / "tools" / "north_star_baselines.json").read_text())["detr"]
    assert baselines["short"]["overrides"] == chip_smoke.DETR_OVERRIDES
    assert (chip_smoke.DETR_REFERENCE, chip_smoke.DETR_TOLERANCE) == \
        (baselines["short"]["value"], baselines["short"]["tol"])
    overrides = chip_smoke.DETR_OVERRIDES + [
        "data.TRAIN.0.dataset.params.data_folder=/data/train",
        "data.VALID.0.dataset.params.data_folder=/data/valid", "logger.log_dir=/logs",
        "callbacks.1.params.dirpath=/logs/ckpt"]
    want = load_config(REPO / "configs", "detection_toy_detr", overrides)
    assert config_from_dict(chip_smoke.detr_config("/data", "/logs")) == want
    # 2000 images in super-batches of 4 x 32 with drop_last: 15 executions of 4
    assert chip_smoke.DETR_STEPS == 100 * (2000 // 128) * 4
    assert chip_smoke.DETR_VALIDATIONS == 100 // want.trainer.check_val_every_n_epoch


def test_the_full_width_detr_config_is_the_coco_recipes():
    recipe = load_yaml(REPO / "configs" / "detection" / "detr_gcvit-t_coco.yaml")
    cfg = chip_smoke.detr_gcvit_config("/data", "/logs")
    task = copy.deepcopy(recipe["task"])
    task["params"]["backbone_params"]["pretrained"] = False
    assert cfg["task"] == task
    for key in ("joint_loss", "optimization", "metrics"):
        assert cfg[key] == recipe[key], key
    for phase in ("TRAIN", "VALID"):
        want = copy.deepcopy(recipe["data"][phase])
        want[0]["dataset"]["params"]["data_folder"] = "/data"
        assert cfg["data"][phase] == want, phase
    for key in ("precision", "num_sanity_val_steps", "accelerator"):
        assert cfg["trainer"][key] == recipe["trainer"][key]
    assert [c["name"] for c in cfg["callbacks"]] == [c["name"] for c in recipe["callbacks"]]
    assert len(chip_smoke.COCO_CATEGORY_IDS) == 80


def _names(recipe):
    """(registry, name) of every component a recipe asks for."""
    task = recipe["task"]["params"]
    yield registries.TASKS, recipe["task"]["name"]
    yield registries.BACKBONES, task["backbone_name"]
    yield registries.HEADS, task["head_name"]
    if task.get("neck_name"):
        yield registries.DETECTION_NECKS, task["neck_name"]
    for loss in recipe["joint_loss"]["losses"]:
        yield registries.LOSSES, loss["name"]
    for opt in recipe["optimization"]:
        yield registries.OPTIMIZERS, opt["optimizer"]["name"]
        if opt.get("scheduler"):
            yield registries.SCHEDULERS, opt["scheduler"]["name"]
    for phase in recipe["data"].values():
        for entry in phase:
            yield registries.DATASETS, entry["dataset"]["name"]
            for t in entry["dataset"].get("transform", []) + entry["dataset"].get("augment", []):
                yield registries.TRANSFORMS, t["name"]
    for metric in recipe["metrics"]:
        yield registries.METRICS, metric["name"]
    for cb in recipe.get("callbacks", []):
        yield registries.CALLBACKS, cb["name"]
    yield registries.LOGGERS, recipe["logger"]["name"]


@pytest.mark.parametrize("name", ["detr_resnet50_coco", "detr_gcvit-t_coco"])
def test_the_detr_coco_recipes_resolve_every_component(name):
    """After ``import torchok_tpu_torch`` and the CLI's module (which registers
    the loggers)."""
    import torchok_tpu_torch.__main__  # noqa: F401
    recipe = load_yaml(REPO / "configs" / "detection" / f"{name}.yaml")
    names = list(_names(recipe))
    for registry, component in names:
        assert registry.get(component) is not None, component
    assert {"COCODetection", "FitResize", "PadIfNeeded", "DETRHead"} <= {n for _, n in names}


def test_paramwise_groups_of_the_detr_gcvit_task_equal_jax_labels():
    """The recipe's paramwise_cfg (bias lr x2 without decay, the backbone at
    lr x0.1 and decay x0.002) over a narrowed gcvit + DETR task: every port
    parameter's group equals the JAX package's label of its leaf."""
    cfg = chip_smoke.detr_gcvit_config("/data", "/logs")
    params = cfg["task"]["params"]
    params["backbone_params"].update(depths=[1, 2, 2, 1])
    params["head_params"].update(num_encoder_layers=2, num_decoder_layers=2)
    spec = cfg["optimization"][0]["optimizer"]
    config = jax_merge(JaxConfigNode(copy.deepcopy({**cfg, "data": {}})))
    jax_task = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    import jax
    variables = jax.eval_shape(lambda k: jax_task.init_variables(k), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), variables["params"])
    ref, ref_lrs = _jax_labels(tree, JaxConfigNode(copy.deepcopy(spec)),
                               jax_task.no_weight_decay())
    port_config = merge_structured(ConfigNode(copy.deepcopy({**cfg, "data": {}})))
    task = TASKS.get(port_config.task.name)(port_config, **port_config.task.params.to_dict())
    model = task.model
    got = Constructor.param_labels(list(model.named_parameters()),
                                   ConfigNode(copy.deepcopy(spec)), task.no_weight_decay(),
                                   norm_names=norm_parameter_names(model))
    name_map = task_name_map("gcvit_tiny", {"params": tree})
    assert sorted(name_map) == sorted(got)
    for key, path in name_map.items():
        assert got[key] == ref[path], f"{key} <- {'.'.join(path)}"
    assert set(got.values()) == set(ref_lrs) == {"lr0.1_wd0.002", "lr1.0_wd0.0", "lr1.0_wd1.0",
                                                 "lr2.0_wd0.0"}
    head = "bbox_head.transformer.decoder.layers.1.attentions.1.attn."
    assert got[head + "in_proj_bias"] == "lr2.0_wd0.0"
    assert got[head + "in_proj_weight"] == got["bbox_head.query_embedding.weight"] == \
        "lr1.0_wd1.0"
    assert got["backbone.stages.0.blocks.0.attn.qkv.bias"] == "lr0.1_wd0.002"


def test_worker_processes_load_the_batches_worker_threads_do(coco_tree, tmp_path):
    """On a card the engine loads samples in worker processes: the recipe's
    train pipeline (with its random flip) gives the same batches epoch by
    epoch as worker threads, and ``close`` stops the processes."""
    from torchok_tpu_torch.data.loader import DataLoader
    root = _fresh_copy(coco_tree, tmp_path)
    port = DATASETS.get("COCODetection")(train=True, download=False, data_folder=str(root),
                                         transform=_transforms(TRANSFORMS, TRANSFORM),
                                         augment=_transforms(TRANSFORMS,
                                                             [{"name": "HorizontalFlip"}]))
    loader = DataLoader(port, batch_size=6, shuffle=True, num_workers=2, seed=3)
    batches = {}
    for processes in (False, True):
        loader.worker_processes = processes
        for epoch in range(2):
            loader.set_epoch(epoch)
            batches[processes, epoch] = list(loader)
    pool = loader._process_pool
    assert pool is not None
    loader.close()
    assert loader._process_pool is None and not any(p.is_alive() for p in
                                                    (pool._processes or {}).values())
    for epoch in range(2):
        for a, b in zip(batches[False, epoch], batches[True, epoch]):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert not all(np.array_equal(a["image"], b["image"])
                   for a, b in zip(batches[False, 0], batches[False, 1]))
