"""The SOP, retrieval, contrastive and sweet-pepper datasets of the port
against ``torchok_tpu`` on files the tests write, and multi-view batches
through the engine, on the CPU.

* ``SOP`` (train and test labels from 1 and 11319), ``TRIPLET_SOP``,
  ``RetrievalDataset`` (with and without scores and a gallery, a query
  without relevants, both errors), ``UnsupervisedContrastiveDataset`` and
  ``SweetPepper``: every uint8 sample equal to the JAX package's.
* Masks: ``read_gray_png`` equals ``cv2.imread(IMREAD_GRAYSCALE)`` on gray,
  gray + alpha, 16-bit gray, RGB, RGBA and palette PNGs.
* Views: the two views of a contrastive pair and the three images of a
  triplet draw apart, and alike across reruns; a one-view sample keeps the
  stream ``[seed, index]``.
* The engine runs the device suffix once per image key of a multi-view
  batch, each with draws of its own; a triplet fit (super-batches of two
  steps) and a SimCLR fit with a validation run through ``run(...,
  "train")``.
* ``chip_smoke.py``'s three SOP recipe dicts equal the YAML files.
"""
import copy
import csv
import importlib.util
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import DATASETS as JAX_DATASETS
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.constructor import DATASETS, TRANSFORMS
from torchok_tpu_torch.constructor.config import config_from_dict, load_yaml
from torchok_tpu_torch.constructor.runner import create_trainer
from torchok_tpu_torch.data.datasets.segmentation.image_segmentation import read_gray_png
from torchok_tpu_torch.data.transforms.base import sample_generator

REPO = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sop_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sop")
    chip_smoke.write_sop_tree(str(root), classes=(3, 2), per_class=4, triplets=6, sizes=(20, 36))
    return str(root)


def _equal_samples(got, want, keys):
    for key in keys:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("train", [True, False])
def test_sop_matches_jax(sop_root, train):
    args = dict(train=train, download=True, data_folder=sop_root, transform=None,
                input_dtype="uint8")
    got, want = DATASETS.get("SOP")(**args), JAX_DATASETS.get("SOP")(**args)
    assert len(got) == len(want) == (12 if train else 8)
    for i in range(len(got)):
        _equal_samples(got[i], want[i], ("image", "target", "index"))
    assert sorted(set(got.targets)) == (list(range(3)) if train else list(range(2)))


def test_triplet_sop_matches_jax(sop_root):
    args = dict(download=True, data_folder=sop_root, transform=None, input_dtype="uint8")
    got = DATASETS.get("TRIPLET_SOP")(train=True, **args)  # the recipe's argument
    want = JAX_DATASETS.get("TRIPLET_SOP")(**args)
    assert len(got) == len(want) == 6
    for i in range(len(got)):
        _equal_samples(got[i], want[i], ("anchor", "positive", "negative", "index"))


def test_download_is_a_no_op_when_the_folder_is_there(sop_root, tmp_path, monkeypatch):
    def no_network(*_):
        raise AssertionError("download attempted")

    monkeypatch.setattr("urllib.request.urlretrieve", no_network)
    DATASETS.get("SOP")(train=True, download=True, data_folder=sop_root, transform=None)
    with pytest.raises(RuntimeError, match="Dataset not found"):
        DATASETS.get("SOP")(train=True, download=False, data_folder=str(tmp_path),
                            transform=None)


# ----------------------------------------------------------------------
# retrieval
# ----------------------------------------------------------------------

def _write_png(path, seed, size=(12, 16)):
    from torchok_tpu_torch import native
    path.parent.mkdir(parents=True, exist_ok=True)
    pixels = np.random.default_rng(seed).integers(0, 256, (*size, 3), dtype=np.uint8)
    path.write_bytes(native.encode_png(pixels))


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


@pytest.fixture(scope="module")
def retrieval_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("retrieval")
    for i in range(1, 9):
        _write_png(root / "images" / f"{i}.png", i)
    for i in range(20, 23):
        _write_png(root / "gallery" / f"{i}.png", i)
    _write_csv(root / "images.csv", ["id", "image_path", "label"],
               [[i, f"images/{i}.png", i % 3] for i in range(1, 9)])
    _write_csv(root / "gallery" / "gallery.csv", ["id", "image_path"],
               [[i, f"{i}.png"] for i in range(20, 23)])
    _write_csv(root / "matches.csv", ["query", "relevant"], [[1, "2 3"], [4, "5"], [6, "2 7"]])
    _write_csv(root / "scores.csv", ["query", "relevant", "scores"],
               [[1, "2 3", "1.0 0.5"], [4, "5", "0.25"], [6, "2 7", "2 1"]])
    _write_csv(root / "empty.csv", ["query", "relevant"], [[1, "2 3"], [4, ""], [6, "7"]])
    _write_csv(root / "mismatch.csv", ["query", "relevant", "scores"], [[1, "2 3", "1.0"]])
    return str(root)


def _retrieval(registry, root, matches, gallery, **extra):
    kwargs = dict(data_folder=root, matches_csv_path=matches, img_list_csv_path="images.csv",
                  transform=None, input_dtype="uint8", **extra)
    if gallery:
        kwargs.update(gallery_folder=os.path.join(root, "gallery"),
                      gallery_list_csv_path="gallery.csv")
    return registry.get("RetrievalDataset")(**kwargs)


@pytest.mark.parametrize("matches", ["matches.csv", "scores.csv"])
@pytest.mark.parametrize("gallery", [False, True])
def test_retrieval_dataset_matches_jax(retrieval_root, matches, gallery):
    got = _retrieval(DATASETS, retrieval_root, matches, gallery)
    want = _retrieval(JAX_DATASETS, retrieval_root, matches, gallery)
    assert len(got) == len(want) == 8 + 3 * gallery
    assert (got.n_queries, got.n_not_query) == (want.n_queries, want.n_not_query) == (3, 5)
    for key in ("scores", "query_idxs", "group_labels"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    for i in range(len(got)):
        _equal_samples(got[i], want[i], ("image", "index", "query_idxs", "scores",
                                         "group_labels"))


def test_retrieval_dataset_errors_and_empty_queries(retrieval_root):
    for registry in (DATASETS, JAX_DATASETS):
        with pytest.raises(ValueError, match="query without relevant"):
            _retrieval(registry, retrieval_root, "empty.csv", False)
        with pytest.raises(ValueError, match="must match relevance scores"):
            _retrieval(registry, retrieval_root, "mismatch.csv", False)
    got = _retrieval(DATASETS, retrieval_root, "empty.csv", False,
                     use_query_without_relevants=True)
    want = _retrieval(JAX_DATASETS, retrieval_root, "empty.csv", False,
                      use_query_without_relevants=True)
    assert got.relevant_arr == want.relevant_arr and got.relevant_arr[1] == []
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.group_labels, want.group_labels)


# ----------------------------------------------------------------------
# views
# ----------------------------------------------------------------------

def _noisy(size=16):
    """A host pipeline that draws (GaussNoise before a Resize, which keeps
    both on the host for images of mixed sizes)."""
    return ([TRANSFORMS.get("GaussNoise")(var_limit=(100.0, 400.0), p=1.0)],
            [TRANSFORMS.get("Resize")(height=size, width=size)])


@pytest.fixture(scope="module")
def contrastive_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("contrastive")
    for i in range(4):
        _write_png(root / f"{i}.png", 40 + i, size=(18 + i, 20))
    _write_csv(root / "list.csv", ["image_path"], [[f"{i}.png"] for i in range(4)])
    return str(root)


def test_contrastive_dataset_matches_jax(contrastive_root):
    args = dict(data_folder=contrastive_root, annotation_path="list.csv", transform=None,
                input_dtype="uint8")
    got = DATASETS.get("UnsupervisedContrastiveDataset")(**args)
    want = JAX_DATASETS.get("UnsupervisedContrastiveDataset")(**args)
    assert len(got) == len(want) == 4
    for i in range(4):
        _equal_samples(got[i], want[i], ("image_0", "image_1", "index"))
    with pytest.raises(ValueError, match="annotation_path"):
        DATASETS.get("UnsupervisedContrastiveDataset")(data_folder=contrastive_root,
                                                       transform=None)


def test_two_views_draw_apart_and_alike_across_reruns(contrastive_root):
    augment, transform = _noisy()
    dataset = DATASETS.get("UnsupervisedContrastiveDataset")(
        data_folder=contrastive_root, annotation_path="list.csv", transform=transform,
        augment=augment, input_dtype="uint8")
    dataset.seed(11)
    first = [dataset[i] for i in range(4)]
    dataset.seed(11)
    again = [dataset[i] for i in range(4)]
    for a, b in zip(first, again):
        _equal_samples(a, b, ("image_0", "image_1"))
        assert not np.array_equal(a["image_0"], a["image_1"])


def test_three_triplet_images_draw_apart(sop_root, tmp_path):
    root = tmp_path / "Stanford_Online_Products"
    root.mkdir()
    path = "class_00001/000001.png"
    (root / "class_00001").mkdir()
    (root / path).write_bytes((Path(sop_root) / "Stanford_Online_Products" / path).read_bytes())
    (root / "Ebay_triplets.txt").write_text(f"anchor positive negative\n{path} {path} {path}\n")
    augment, transform = _noisy()
    dataset = DATASETS.get("TRIPLET_SOP")(download=False, data_folder=str(tmp_path),
                                          transform=transform, augment=augment,
                                          input_dtype="uint8")
    dataset.seed(5)
    sample = dataset[0]
    dataset.seed(5)
    _equal_samples(dataset[0], sample, ("anchor", "positive", "negative"))
    keys = ("anchor", "positive", "negative")
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert not np.array_equal(sample[a], sample[b]), (a, b)


def test_one_view_keeps_its_stream(contrastive_root):
    augment, transform = _noisy()
    dataset = DATASETS.get("ImageClassificationDataset")(
        data_folder=contrastive_root, annotation_path="list.csv", transform=transform,
        augment=augment, input_dtype="uint8", test_mode=True)
    dataset.seed(3)
    got = dataset[2]["image"]
    image = dataset._image(2)
    with sample_generator(np.random.default_rng(np.random.SeedSequence([3, 2]))):
        want = dataset._host_pipeline(image=image)["image"]
    np.testing.assert_array_equal(got, want)
    # SeedSequence pads its entropy with zeros, so view 0's stream is this one
    views = [dataset.apply_host_pipeline({"image": image}, 2, view=v)["image"] for v in (0, 1)]
    np.testing.assert_array_equal(views[0], got)
    assert not np.array_equal(views[1], got)


# ----------------------------------------------------------------------
# sweet pepper and masks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_sweet_pepper_matches_jax(tmp_path, train):
    chip_smoke.write_sweet_pepper_tree(str(tmp_path), train=4, valid=3, size=24)
    args = dict(train=train, download=True, data_folder=str(tmp_path), transform=None,
                input_dtype="uint8")
    got, want = DATASETS.get("SweetPepper")(**args), JAX_DATASETS.get("SweetPepper")(**args)
    assert len(got) == len(want) == (4 if train else 3)
    for i in range(len(got)):
        _equal_samples(got[i], want[i], ("image", "target", "index"))
    assert set(np.unique(np.concatenate([got[i]["target"].ravel() for i in range(len(got))]))) \
        <= {0, 1, 2}


def test_masks_read_as_cv2_reads_them_in_gray(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    files = {"rgb.png": rgb[..., ::-1], "gray.png": rgb[..., 0],
             "rgba.png": np.concatenate([rgb[..., ::-1], rgb[..., :1]], -1),
             "gray16.png": rng.integers(0, 65536, (40, 48), dtype=np.uint16)}
    for name, pixels in files.items():
        cv2.imwrite(str(tmp_path / name), pixels)
    Image.fromarray(rgb[..., :2].max(-1) // 16 * 16, "L").convert("P").save(tmp_path / "p.png")
    Image.fromarray(np.stack([rgb[..., 0], rgb[..., 1]], -1), "LA").save(tmp_path / "la.png")
    for name in list(files) + ["p.png", "la.png"]:
        want = cv2.imread(str(tmp_path / name), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(read_gray_png(str(tmp_path / name)), want, err_msg=name)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

def test_each_image_key_takes_the_device_suffix_with_draws_of_its_own():
    pipe = [TRANSFORMS.get("GaussNoise")(var_limit=(100.0, 400.0), p=1.0),
            TRANSFORMS.get("Normalize")(), TRANSFORMS.get("ToTensorV2")()]

    class Triplets:
        device_pipeline = torchok_tpu_torch.data.transforms.DeviceTransformPipeline(pipe)

    trainer = create_trainer(config_from_dict({"trainer": {"accelerator": "cpu"}}))
    image = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    host = {"anchor": image, "positive": image.copy(), "negative": image.copy(),
            "index": np.arange(2)}
    got = trainer._make_device_fn(Triplets(), train=False)(dict(host))
    generator = torch.Generator().manual_seed(trainer.seed + 31)
    for key in ("anchor", "negative", "positive"):  # sorted: the order of the draws
        want = Triplets.device_pipeline({"image": torch.from_numpy(host[key])}, generator)
        assert got[key].dtype == torch.float32 and got[key].shape == (2, 3, 8, 8)
        assert torch.equal(got[key], want["image"]), key
    assert not torch.equal(got["anchor"], got["positive"])
    assert not torch.equal(got["positive"], got["negative"])


def _tiny(cfg, size=32):
    p = cfg["task"]["params"]
    p["backbone_params"] = {"in_channels": 3, "layers": [1, 1, 1, 1]}
    p["head_params"]["out_channels"] = 16
    p["inputs"][0]["shape"] = [3, size, size]
    cfg["trainer"]["accelerator"] = "cpu"
    for loaders in cfg["data"].values():
        for loader in loaders:
            loader["dataloader"]["num_workers"] = 0
            dataset = loader["dataset"]
            dataset["transform"][0]["params"].update(height=size, width=size)
            dataset.pop("augment", None)
    return cfg


def test_a_triplet_fit_runs_through_the_engine(sop_root, tmp_path):
    cfg, _ = chip_smoke.sop_config("triplet_sop", sop_root, str(tmp_path))
    cfg = _tiny(cfg)
    cfg["trainer"].update(limit_train_batches=None, steps_per_execution=2)
    cfg["data"]["TRAIN"][0]["dataloader"]["batch_size"] = 2
    cfg["data"]["VALID"][0]["dataloader"]["batch_size"] = 4
    trainer, logs = run(cfg, "train")
    assert trainer.last_fit["steps"] == 2  # 6 triplets: one super-batch of 2 x 2, drop_last
    assert np.isfinite(logs["train/loss"]) and 0 <= logs["valid/HitAtKMeter"] <= 1
    assert trainer.last_eval["images"] == 8


def test_a_simclr_fit_with_a_validation_runs_through_the_engine(contrastive_root, tmp_path):
    data = {"dataloader": {"batch_size": 2, "num_workers": 0, "drop_last": True,
                           "shuffle": True},
            "dataset": {"name": "UnsupervisedContrastiveDataset",
                        "params": {"data_folder": contrastive_root, "annotation_path": "list.csv"},
                        "augment": [{"name": "GaussNoise", "params": {"p": 1.0}}],
                        "transform": [{"name": "Resize", "params": {"height": 32, "width": 32}},
                                      {"name": "Normalize"}, {"name": "ToTensorV2"}]}}
    cfg = {"task": {"name": "SimCLRTask", "params": {
        "backbone_name": "resnet18", "pooling_name": "Pooling", "head_name": "LinearHead",
        "head_params": {"out_channels": 16}, "inputs": [{"shape": [3, 32, 32]}]}},
        "joint_loss": {"losses": [{"name": "NT_XentLoss", "params": {"temperature": 0.5},
                                   "mapping": {"emb1": "emb1", "emb2": "emb2"}}]},
        "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 1e-3}}}],
        "data": {"TRAIN": [data], "VALID": [copy.deepcopy(data)]},
        "trainer": {"accelerator": "cpu", "max_epochs": 1, "num_sanity_val_steps": 0},
        "logger": {"name": "CSVLogger", "log_dir": str(tmp_path)}}
    cfg["task"]["params"]["backbone_params"] = {"layers": [1, 1, 1, 1]}
    trainer, logs = run(cfg, "train")
    assert trainer.last_fit["steps"] == 2
    assert np.isfinite(logs["train/loss"]) and np.isfinite(logs["valid/loss"])
    assert trainer.last_eval["images"] == 4


@pytest.mark.parametrize("recipe", sorted(chip_smoke.SOP_RECIPES))
def test_chip_smoke_holds_the_sop_recipes(recipe):
    assert load_yaml(REPO / "configs" / f"{recipe}.yaml") == chip_smoke.SOP_RECIPES[recipe]
    cfg, cuts = chip_smoke.sop_config(recipe, "/data", "/logs")
    want = copy.deepcopy(chip_smoke.SOP_RECIPES[recipe])
    assert cfg["task"]["params"]["backbone_params"]["pretrained"] is False
    assert cfg["callbacks"] == want["callbacks"] and cfg["metrics"] == want["metrics"]
    for phase, loaders in cfg["data"].items():
        dataset, ref = loaders[0]["dataset"], want["data"][phase][0]["dataset"]
        assert dataset["params"].pop("data_folder") == "/data"
        ref["params"].pop("data_folder")
        assert dataset == ref and loaders[0]["dataloader"] == want["data"][phase][0]["dataloader"]
    assert len(cuts) == 5 and "hydra" not in cfg


def test_chip_smoke_recounts_hit_at_k_apart_from_the_meter():
    from torchok_tpu_torch.constructor import METRICS
    rng = np.random.default_rng(3)
    meter = METRICS.get("HitAtKMeter")(**chip_smoke._SOP_METER["params"])
    state = meter.empty_state("cpu")
    labels = rng.permutation(np.repeat(np.arange(32), 8))
    # a class's vectors share a direction, so about half the queries hit
    centres = rng.normal(size=(32, 32))
    vectors = centres[labels] + 1.2 * rng.normal(size=(256, 32))
    for lo in range(0, 256, 64):
        state = meter.update(state, vectors=torch.from_numpy(vectors[lo:lo + 64]).float(),
                             group_labels=labels[lo:lo + 64])
    value = meter.compute(state)
    assert 0.1 < value < 0.9
    assert chip_smoke.witness_hit(state) == pytest.approx(value, abs=1e-9)


def test_chip_smoke_holds_accuracy_on_planted_targets():
    rng = np.random.default_rng(4)
    batches = [(rng.normal(size=(64, 500)).astype(np.float32), rng.integers(0, 500, 64))
               for _ in range(3)]
    assert chip_smoke.witness_accuracy(batches) < 0.05
    value, recount = chip_smoke.check_accuracy_planted("test", batches, torch.device("cpu"))
    assert 0.3 < value < 0.7 and value == pytest.approx(recount, abs=1e-9)


def test_chip_smoke_holds_hit_at_k_on_collinear_embeddings_centred():
    from torchok_tpu_torch.constructor import METRICS
    rng = np.random.default_rng(5)
    labels = rng.permutation(np.repeat(np.arange(32), 8))
    # one direction with class structure 1e-5 below it, as a random frozen
    # backbone gives: f32 search cannot order these neighbours
    centres = rng.normal(size=(32, 64))
    vectors = 1.0 + 1e-5 * (centres[labels] + 0.5 * rng.normal(size=(256, 64)))
    params = chip_smoke._SOP_METER["params"]
    meter = METRICS.get("HitAtKMeter")(**params)
    state = meter.empty_state("cpu")
    state = meter.update(state, vectors=torch.from_numpy(vectors), group_labels=labels)
    spread, value, recount = chip_smoke.check_hit("test", state, params, torch.device("cpu"))
    assert spread < chip_smoke.HIT_RESOLVABLE
    assert value == pytest.approx(recount, abs=1e-9) and value > 0.9
    assert chip_smoke.witness_hit(state) > 0.9
